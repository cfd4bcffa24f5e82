"""Compositing, plain.

Frozen copies of the port's ``ops/composite.py`` (as of the benchmark's
first version): ``_weights``, ``composite_train_fwd_plain`` /
``composite_train_plain`` (differentiated by autograd through
``cumprod``, as the JAX package differentiates it) and
``composite_test_step_plain``.
"""
import torch


def _weights(sigmas, deltas, mask, T_threshold, t_start=None):
    """(1 - alpha, T before each sample, w) of a block of samples."""
    alpha = torch.where(mask, 1.0 - torch.exp(
        -sigmas.to(torch.float32) * deltas.to(torch.float32)), 0.0)
    one_minus = 1.0 - alpha
    t_excl = torch.cumprod(torch.cat(
        [torch.ones_like(one_minus[:, :1]), one_minus[:, :-1]], dim=1), dim=1)
    if t_start is not None:
        t_excl = t_start[:, None] * t_excl
    include = (t_excl > T_threshold) & mask
    return one_minus, t_excl, torch.where(include, alpha * t_excl, 0.0)


def composite_train(sigmas, rgbs, deltas, ts, mask, T_threshold):
    """(opacity, depth, rgb) of (N, S) sample rows, differentiable."""
    _, _, w = _weights(sigmas, deltas, mask, T_threshold)
    return (w.sum(dim=1), (w * ts).sum(dim=1),
            (w[..., None] * rgbs.to(torch.float32)).sum(dim=1))


def composite_test_step(sigmas, rgbs, deltas, ts, mask, opacity, depth, rgb,
                        alive, T_threshold):
    """One window of the serving composite: the accumulators and which
    rays stay alive (transmittance above the threshold)."""
    mask = mask & alive[:, None]
    one_minus, t_excl, w = _weights(sigmas, deltas, mask, T_threshold,
                                    1.0 - opacity)
    opacity = opacity + w.sum(dim=1)
    depth = depth + (w * ts).sum(dim=1)
    rgb = rgb + (w[..., None] * rgbs.to(torch.float32)).sum(dim=1)
    alive = alive & (t_excl[:, -1] * one_minus[:, -1] > T_threshold)
    return opacity, depth, rgb, alive
