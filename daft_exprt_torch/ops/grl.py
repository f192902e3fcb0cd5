"""Gradient reversal (PyTorch port of ``daft_exprt_tpu/ops/grl.py``).

Identity in the forward pass; the backward multiplies the upstream gradient
by ``-lambda_`` (Ganin & Lempitsky, ICML 2015).
"""
import torch


class _GradientReversal(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, lambda_):
        ctx.lambda_ = lambda_
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.lambda_ * g, None


def gradient_reversal(x, lambda_=1.0):
    """x in the forward pass; ``-lambda_ * g`` as its gradient."""
    return _GradientReversal.apply(x, lambda_)
