"""Device resolution for the port's entry points.

``cuda`` is the default. The CPU is used only when the caller asks for it
(``device='cpu'``): an entry point never carries on on the CPU by itself.
"""
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``. Raises if CUDA is asked for (explicitly or by
    default) and no CUDA device is present."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type not in ('cuda', 'cpu'):
        raise ValueError(f'unsupported device {dev!s}: use cuda or cpu')
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device is available; pass device="cpu" to run the '
            'plain PyTorch versions of the kernels on the CPU')
    return dev
