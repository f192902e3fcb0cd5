"""Set-up: process start to the first timed batch or step (host clock)."""


def read(record):
    return record.get('setup_s')
