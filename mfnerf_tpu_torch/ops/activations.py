"""Truncated-exponential density activation.

Port of ``mfnerf_tpu/ops/activations.py::trunc_exp``, forward only: exp(x)
in float32. Its clamped backward (exp(clamp(x, -15, 15))) comes with the
training slice.
"""
import torch


def trunc_exp(x):
    return torch.exp(x.to(torch.float32))
