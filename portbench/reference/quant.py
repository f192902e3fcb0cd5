"""Lower-precision arithmetic for the controls: the reference put in the
program's place and computed one precision below what the configuration
states (bfloat16 -> fp8 e4m3, int8 -> int4). Each function rounds a
tensor to the lower precision and returns it in float32, so the plain
reference computes with the rounded operands."""
import torch

FP8_MAX = 448.0


def int_symmetric(bits):
    """Symmetric integer rounding with one scale per slice along ``axis``
    (the output channel of a weight, the channel of an activation: the
    per-channel scales of the int8 tiers), at ``bits`` bits."""
    top = 2 ** (bits - 1) - 1

    def q(t, axis=None):
        t = t.float()
        if axis is None or t.dim() < 2:
            amax = t.abs().amax()
        else:
            dims = [d for d in range(t.dim()) if d != axis]
            amax = t.abs().amax(dim=dims, keepdim=True)
        scale = torch.clamp(amax, min=1e-12) / top
        return torch.clamp(torch.round(t / scale), -top, top) * scale
    return q


def fp8_e4m3(t, axis=None):
    """Rounding to float8 e4m3 with one scale per tensor (amax to 448)."""
    t = t.float()
    scale = torch.clamp(t.abs().amax(), min=1e-12) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


CONTROLS = {'int4': int_symmetric(4), 'int8': int_symmetric(8),
            'fp8': fp8_e4m3}
