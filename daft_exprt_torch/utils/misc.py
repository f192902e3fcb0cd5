"""Sequence helpers (copy of ``daft_exprt_tpu/utils/misc.py``'s ``chunker``)."""


def chunker(seq, size):
    """Split a sequence into chunks of at most ``size`` items."""
    return (seq[pos:pos + size] for pos in range(0, len(seq), size))
