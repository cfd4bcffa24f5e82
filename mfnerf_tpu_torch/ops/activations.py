"""Truncated-exponential density activation.

Port of ``mfnerf_tpu/ops/activations.py::trunc_exp``: the forward is exp(x)
in float32; the backward multiplies the cotangent by exp(clamp(x, -15, 15)),
so a huge density cannot produce an overflowing gradient.
"""
import torch


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x = x.to(torch.float32)
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def trunc_exp(x):
    return _TruncExp.apply(x)
