"""Published dense peaks of one NVIDIA H100 SXM (data sheet, without
sparsity, at the 700 W limit): operations per second by precision and
HBM bytes per second."""
PEAK_OPS = {
    'bfloat16': 989e12,
    'float16': 989e12,
    'int8': 1979e12,
    'fp8': 1979e12,
    'tf32': 494.7e12,
    'float32': 67e12,        # outside the tensor cores
}
PEAK_BYTES = 3.35e12


def least_seconds(ops_by_precision, nbytes=0.0):
    """The least time of a piece of work: the larger of its operations at
    their precisions' peaks and its bytes at the memory rate."""
    t_ops = sum(n / PEAK_OPS[p] for p, n in ops_by_precision.items())
    return max(t_ops, nbytes / PEAK_BYTES)
