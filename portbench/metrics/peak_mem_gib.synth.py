"""The device memory peak over the window (``max_memory_allocated`` after
a reset at its start), GiB."""


def read(record):
    if record.get('kind') != 'synth' or 'window_peak_bytes' not in record:
        return None
    return record['window_peak_bytes'] / 2 ** 30
