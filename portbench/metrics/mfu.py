"""The whole step's share of the chip's peak: the least time of the
window's work at the peaks of its precisions (frozen counts under
``portbench/counts/``, as the cell's driver sums them into
``least_s``: a synthesis batch's acoustic model and generator, each
utterance's own symbols and frames; a fine-tuning iteration's generator,
discriminators and loss mel, forwards and backwards), over the window's
wall time. One reader for every ``mfu.<kind>`` metric."""


def read(record):
    if 'least_s' not in record:
        return None
    return 100.0 * record['least_s'] / record['window_s']
