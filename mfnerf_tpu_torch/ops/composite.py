"""Front-to-back volume compositing over padded (N, S) sample rows.

Port of ``mfnerf_tpu/ops/composite.py``:

* :func:`composite_train` (the reference's ``composite_train_fw/bw``): the
  transmittance before each sample is an exclusive cumulative product of
  ``1 - alpha``, differentiated by autograd through ``cumprod``, as the JAX
  package differentiates it.
* :func:`composite_test_step` (the reference's ``composite_test_fw``): each
  ray resumes from its accumulated transmittance ``1 - opacity`` and folds a
  new block of samples into its accumulators.

A sample contributes iff the transmittance before it exceeds
``T_threshold``.
"""
from typing import NamedTuple

import torch


class CompositeResults(NamedTuple):
    opacity: torch.Tensor     # (N,)
    depth: torch.Tensor       # (N,)
    rgb: torch.Tensor         # (N, 3)
    ws: torch.Tensor          # (N, S) per-sample weights
    vr_samples: torch.Tensor  # () int64 composited samples (train/vr_s)


def _exclusive_transmittance(one_minus):
    """T before each sample: cumprod of [1, 1-alpha_0, ..., 1-alpha_{S-2}]."""
    return torch.cumprod(
        torch.cat([torch.ones_like(one_minus[:, :1]), one_minus[:, :-1]],
                  dim=1), dim=1)


def composite_train(sigmas, rgbs, deltas, ts, mask, T_threshold=1e-4):
    """Composite padded sample rows front to back.

    Args:
        sigmas, deltas, ts: (N, S); rgbs: (N, S, 3).
        mask: (N, S) bool sample validity.
    Returns:
        :class:`CompositeResults`, differentiable in sigmas and rgbs. A sample
        with sigma * delta beyond ~88 has ``1 - alpha == 0`` exactly; torch's
        cumprod backward takes its zero-aware path there.
    """
    alpha = torch.where(mask, 1.0 - torch.exp(
        -sigmas.to(torch.float32) * deltas.to(torch.float32)), 0.0)
    t_excl = _exclusive_transmittance(1.0 - alpha)
    include = (t_excl > T_threshold) & mask
    w = torch.where(include, alpha * t_excl, 0.0)
    return CompositeResults(
        opacity=w.sum(dim=1), depth=(w * ts).sum(dim=1),
        rgb=(w[..., None] * rgbs.to(torch.float32)).sum(dim=1), ws=w,
        vr_samples=include.sum())


def composite_test_step(sigmas, rgbs, deltas, ts, mask, opacity, depth, rgb,
                        alive, T_threshold):
    """One compositing round.

    Args:
        sigmas, deltas, ts, mask: (N, S) new samples; rgbs (N, S, 3).
        opacity, depth: (N,); rgb: (N, 3) running accumulators.
        alive: (N,) bool rays still marching.
    Returns:
        (opacity, depth, rgb, alive); a ray dies when its transmittance after
        the block is <= T_threshold.
    """
    mask = mask & alive[:, None]
    alpha = torch.where(mask, 1.0 - torch.exp(
        -sigmas.to(torch.float32) * deltas.to(torch.float32)), 0.0)
    one_minus = 1.0 - alpha
    t_excl = (1.0 - opacity)[:, None] * _exclusive_transmittance(one_minus)
    include = (t_excl > T_threshold) & mask
    w = torch.where(include, alpha * t_excl, 0.0)

    opacity = opacity + w.sum(dim=1)
    depth = depth + (w * ts).sum(dim=1)
    rgb = rgb + (w[..., None] * rgbs.to(torch.float32)).sum(dim=1)

    t_final = t_excl[:, -1] * one_minus[:, -1]
    alive = alive & (t_final > T_threshold)
    return opacity, depth, rgb, alive
