"""Incremental front-to-back compositing for the test renderer.

Port of ``mfnerf_tpu/ops/composite.py::composite_test_step`` (the reference's
``composite_test_fw``): each ray resumes from its accumulated transmittance
``1 - opacity`` and folds a new block of samples into its accumulators.
"""
import torch


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
    t_start = (1.0 - opacity)[:, None]
    t_excl = t_start * torch.cumprod(
        torch.cat([torch.ones_like(one_minus[:, :1]), one_minus[:, :-1]],
                  dim=1), dim=1)
    include = (t_excl > T_threshold) & mask
    w = torch.where(include, alpha * t_excl, 0.0)

    opacity = opacity + w.sum(dim=1)
    depth = depth + (w * ts).sum(dim=1)
    rgb = rgb + (w[..., None] * rgbs.to(torch.float32)).sum(dim=1)

    t_final = t_excl[:, -1] * one_minus[:, -1]
    alive = alive & (t_final > T_threshold)
    return opacity, depth, rgb, alive
