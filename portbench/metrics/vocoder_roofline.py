"""The generator's least time over the traced stretch's batches (frozen
counts: its convolutions at the tier's peak, its mel and waveform bytes
at the memory rate, each utterance's own frames) over the device time of
the kernels inside the benchmark's ``vocoder`` range. It reads the
same work whatever computes it."""


def read(record):
    tr = record.get('trace')
    if not tr or 'least_voc_s' not in tr:
        return None
    t = tr['range_kernel_s'].get('vocoder')
    if not t:
        return None
    return 100.0 * tr['least_voc_s'] / t
