"""Marching step-size schedule and cascade (mip) selection.

Port of ``mfnerf_tpu/ops/stepping.py``. The march visits a fixed "t-ladder"
``t_{k+1} = t_k + calc_dt(t_k)`` that depends only on the start ``t_0``; the
ladder has a closed form, so rung ``k`` is evaluated directly instead of by
accumulating ``t += dt`` (an accumulating loop drifts by ulps and moves
samples across cell boundaries relative to the JAX march).
"""
import math

import torch

SQRT3 = 1.7320508075688772


def true_div(x, s):
    """``x / s`` for a Python float ``s``, divided as IEEE division on
    every device. On a CUDA tensor torch evaluates ``tensor / python_float``
    as a multiply by the float reciprocal, which rounds differently (the
    CPU, the JAX package and the march kernels divide): a 0-d tensor on
    ``x``'s device takes the true division."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def calc_dt(t, exp_step_factor, max_samples, grid_size, scale):
    """Step size at distance ``t``: clamp(t * e, SQRT3/max_samples,
    2*SQRT3*scale/grid_size)."""
    dt_min = SQRT3 / max_samples
    dt_max = SQRT3 * 2.0 * scale / grid_size
    return torch.clamp(t * exp_step_factor, dt_min, dt_max)


def _frexp_exponent(x):
    """frexp() exponent of |x| read from the float32 exponent bits.

    |x| = m * 2^e with m in [0.5, 1); returns e (int32). Zero and subnormals
    give a large negative value, which callers clamp to 0.
    """
    bits = x.abs().to(torch.float32).view(torch.int32)
    return ((bits >> 23) & 0xFF) - 126


def mip_from_pos(xyz, cascades):
    """Cascade from position: |xyz| in [0,.5)->0, [.5,1)->1, [1,2)->2..."""
    mx = xyz.abs().amax(dim=-1)
    return torch.clamp(_frexp_exponent(mx) + 1, 0, cascades - 1)


def mip_from_dt(dt, grid_size, cascades):
    """Cascade from step size: dt*gs in [0,1)->0, [1,2)->1, [2,4)->2..."""
    return torch.clamp(_frexp_exponent(dt * grid_size), 0, cascades - 1)


def t_ladder(t0, ks, exp_step_factor, max_samples, grid_size, scale):
    """Closed form of the recurrence ``t_{k+1} = t_k + calc_dt(t_k)``.

    Args:
        t0: (N,) start distances.
        ks: (K,) or (N, K) integer rung indices.
    Returns:
        (N, K) float32 t values; rung 0 is ``t0``.

    With a = SQRT3/max_samples, b = 2*SQRT3*scale/grid_size and e the step
    factor, the ladder runs linear (+a) below a/e, geometric (*(1+e)) up to
    b/e, and linear (+b) above.
    """
    a = SQRT3 / max_samples
    b = SQRT3 * 2.0 * scale / grid_size
    e = exp_step_factor

    t0 = t0.to(torch.float32)
    ks = torch.as_tensor(ks, device=t0.device)
    if t0.dim() == 1:
        t0 = t0[:, None]
        if ks.dim() == 1:
            ks = ks[None, :]
    ks = ks.to(torch.float32)

    if e == 0.0:
        return t0 + ks * a

    ta = a / e
    tb = b / e
    # true divisions throughout (:func:`true_div`): torch evaluates
    # ``scalar / tensor`` as a reciprocal times the scalar, and on CUDA
    # ``tensor / scalar`` as a multiply by the reciprocal
    n1 = torch.ceil(true_div(torch.clamp_min(ta - t0, 0.0), a))
    t_g0 = t0 + n1 * a
    log1pe = math.log1p(e)
    m2 = torch.ceil(true_div(torch.clamp_min(torch.log(torch.clamp_min(
        torch.full_like(t_g0, tb) / t_g0, 1.0)), 0.0), log1pe))

    k1 = torch.minimum(ks, n1)
    kg = torch.clamp(ks - n1, min=0.0)
    kg = torch.minimum(kg, m2)
    kb = torch.clamp_min(ks - n1 - m2, 0.0)
    return (t0 + k1 * a) * torch.exp(kg * log1pe) + kb * b


def max_ladder_steps(t_start_min, t_end_max, exp_step_factor, max_samples,
                     grid_size, scale):
    """Upper bound on the ladder rungs needed to march from any
    t >= t_start_min to t_end_max (a Python int)."""
    a = SQRT3 / max_samples
    b = SQRT3 * 2.0 * scale / grid_size
    e = exp_step_factor
    if e == 0.0:
        return max(1, int(math.ceil((t_end_max - t_start_min) / a)) + 1)
    t = max(t_start_min, 0.0)
    k = 0
    while t < t_end_max:
        t += min(max(t * e, a), b)
        k += 1
        if k > 16 * max_samples:
            break
    return max(1, k + 1)
