"""Occupancy-grid ray marching on the closed-form t-ladder.

Port of ``mfnerf_tpu/ops/ray_march.py``: ``_occupancy_at``,
``march_rays_train`` (the training march, with the stratified start jitter
``noise``; the dense test oracle runs it with zero noise and rank windows)
and ``march_rays_window`` (the cursor-window march of the alive-ray
renderer). A ray visits the rungs ``t_ladder(t_start, k)``; occupancy only
selects which rungs emit samples, so marching is: evaluate the rungs, look
up their cells in the bitfield, keep the first occupied ones.

Test-time bug parity: the reference test kernel passes ``cascades`` where
``calc_dt`` expects ``scale``; callers pass that as ``dt_scale``.

The strata budgets of the JAX training marches, which ``render_train`` runs
on every scene they fit: the ladder is cut into strata of ``stratum``
rungs; stage A marks a stratum live by a superset test on a coarser grid;
a ray samples only ``s_strata`` of its live strata, spread evenly along
the ray when it has more, so early training (most of the grid still
occupied) does not spend every sample near the camera. Under the budget
the march equals the exact one. Two stage-A tests, one a march:

* the two-level march (``march_rays_train_twolevel``: one cascade, uniform
  steps) probes each stratum at :func:`stage_a_probes` on the fine grid
  pooled by ``pool`` and dilated by one cell (:func:`stage_a_grid`);
* the cascade march (``march_rays_train_cascades``: several cascades,
  exponential steps) tests one cell of the dilated world-space union of
  every cascade (``morton.union_bitfield``) at each stratum's t-midpoint
  (:func:`cascades_stratum`).

The port applies the budget to its exact march (``strata=``) without the
TPU's neighbourhood-row tables and block sums: the samples are the JAX
march's, sample for sample.

On CUDA tensors :func:`march_rays_train` and :func:`march_rays_window_into`
(and :func:`march_rays_window`, its form over every row) launch the
hand-written kernels of ``csrc/raymarch.cu`` (the training march a warp a
ray, which walks only the chosen strata's rungs; the window march a few
lanes a ray, in place on the frame's rows, up to an optional alive count
in device memory, which at one cascade skips the strata that the
two-level stage-A grid proves empty: :class:`WindowSkip`),
each stopping at the buffer's end or the ray's exit, bit for bit their
plain versions :func:`march_rays_train_plain` and
:func:`march_rays_window_plain`; on CPU tensors they run the plain
versions, which evaluate every rung as (N, K) tensors.
:func:`march_rays_window_skip_plain` models the window kernel's skip
(which strata it tests, its cell arithmetic) in torch. Every division by a
Python float is a true division (``stepping.true_div``), as in the
kernels, the JAX package and on the CPU.
"""
import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import build
from .morton import (bitfield_lookup, morton3d, morton_values_to_spatial,
                     unpack_bits_morton)
from .stepping import (SQRT3, calc_dt, mip_from_dt, mip_from_pos, t_ladder,
                       true_div)

NBR_SPAN = 8   # the JAX march's neighbourhood-row width in cells


class Strata(NamedTuple):
    """A strata budget for :func:`march_rays_train`: the two-level march's
    (``stage_a`` a :func:`stage_a_grid`) or, with ``union``, the cascade
    march's (``stage_a`` a ``morton.union_bitfield``)."""
    stage_a: torch.Tensor    # (g, g, g) bool [z, y, x], or (G^3/8,) uint8
    stratum: int             # rungs a stratum
    s_strata: int            # live strata a ray samples
    dir_norm: float          # bound on |rays_d| over every ray
    union: bool = False      # the cascade march's stage A


class WindowSkip(NamedTuple):
    """The serving window march's empty-space skip (one cascade, uniform
    steps): the window is cut into strata of ``stratum`` rungs from each
    ray's cursor, and only the strata whose probes find an occupied cell
    of the two-level march's :func:`stage_a_grid` have their rungs tested.
    With no budget the march's results are the rung-by-rung march's
    (:func:`window_params` derives why)."""
    stage_a: torch.Tensor    # (g, g, g) bool [z, y, x]
    stratum: int             # rungs a stratum
    dir_norm: float          # bound on |rays_d| the grid was sized for


class MarchResults(NamedTuple):
    xyzs: torch.Tensor       # (N, S, 3) sample positions
    deltas: torch.Tensor     # (N, S) integration steps
    ts: torch.Tensor         # (N, S) sample distances
    mask: torch.Tensor       # (N, S) bool sample validity
    n_samples: torch.Tensor  # (N,) int64 valid samples per ray (<= S)
    k_idx: torch.Tensor      # (N, S) int64 ladder rung of each sample
    rm_samples: torch.Tensor  # () int64 marched samples (train/rm_s)
    t_start: torch.Tensor    # (N,) jittered ladder origin (t at rung 0)


class WindowMarchResults(NamedTuple):
    xyzs: torch.Tensor       # (C, S, 3)
    deltas: torch.Tensor     # (C, S)
    ts: torch.Tensor         # (C, S)
    mask: torch.Tensor       # (C, S) bool
    n_samples: torch.Tensor  # (C,) int64 emitted this window (<= S)
    cursor: torch.Tensor     # (C,) int64 next rung to inspect
    exhausted: torch.Tensor  # (C,) bool ray passed its exit at the cursor
    k_idx: torch.Tensor      # (C, S) int64 global ladder rung per sample


def _occupancy_at(xyz, dt, density_bitfield, cascades, scale, grid_size):
    """Occupancy of the (mip-selected) grid cell containing each position."""
    mip = torch.maximum(mip_from_pos(xyz, cascades),
                        mip_from_dt(dt, grid_size, cascades))
    mip_bound = torch.clamp_max(torch.exp2(mip.to(torch.float32) - 1.0),
                                scale)
    nxyz = torch.clamp(
        0.5 * (xyz / mip_bound[..., None] + 1.0) * grid_size,
        0.0, grid_size - 1.0).to(torch.int32)
    idx = mip.to(torch.int64) * grid_size ** 3 + morton3d(nxyz)
    return bitfield_lookup(density_bitfield, idx)


def twolevel_stratum(exp_step_factor, max_samples, scale, grid_size,
                     cascades, dir_norm=1.0):
    """Rungs a stratum of the two-level march, or 0 where the JAX package
    does not run it (several cascades or exponential steps: see
    :func:`cascades_stratum`): the most rungs whose cells, at the worst
    spatial step (``dir_norm`` bounds |rays_d|), fit one ``NBR_SPAN``-cell
    window of the fine grid, at most 32."""
    if exp_step_factor != 0.0 or cascades != 1:
        return 0
    dt_eff = SQRT3 / max_samples * dir_norm
    cell_fine = 2.0 * min(0.5, scale) / grid_size
    stratum = min(int((NBR_SPAN - 1.0) * cell_fine / dt_eff) + 1, 32)
    return stratum if stratum >= 2 else 0


def cascades_stratum(exp_step_factor, scale, cascades, stratum=8,
                     dir_norm=1.0):
    """(stratum, dilate) of the cascade march, or (0, 0) where the JAX
    package marches exactly: one cascade, uniform steps, or a ``scale``
    whose 2*scale is not a power of two (the cascades would not pool into
    the union grid on cell boundaries).

    Every rung of a stratum lies within half its t-span of its t-midpoint,
    and the span is at most ``stratum`` steps of at most
    sqrt(3)*2*dt_worst/G, so the union grid (cell 2*scale/G) dilated by
    ceil(stratum*sqrt(3)/2*dt_worst*dir_norm/scale) + 1 cells covers it;
    dt_worst = max(scale, cascades) covers the test march's ``cascades``
    step-size bug parity.
    """
    if cascades == 1 or exp_step_factor == 0.0:
        return 0, 0
    if abs(math.log2(2 * scale) - round(math.log2(2 * scale))) > 1e-9:
        return 0, 0
    dt_worst = max(scale, cascades)
    d = math.ceil(stratum * SQRT3 / 2.0 * dt_worst * dir_norm / scale) + 1
    return stratum, d


def stage_a_probes(stratum, dt_eff, cell):
    """Fractional rung offsets of a stratum's probe points: enough, evenly
    spaced, that every rung lies within one stage-A ``cell`` of one."""
    p = max(1, math.ceil(((stratum - 1) / 2.0) * dt_eff / cell))
    return [(stratum - 1) * (2 * i + 1) / (2.0 * p) for i in range(p)]


def superstrata_len(stratum, dt_min, cell):
    """Consecutive strata whose probes fit one neighbourhood row of the
    stage-A grid; the JAX march pads its strata to a multiple of it."""
    s = 1
    while s < 16 and ((s + 1) * stratum - 1) * dt_min \
            <= (NBR_SPAN - 1.0) * cell:
        s += 1
    return s


def stage_a_grid(density_bitfield, grid_size, pool):
    """(g, g, g) bool [z, y, x], g = grid_size / pool: cascade 0's cells
    pooled ``pool`` to a side (any occupied), then dilated by one cell on
    each axis with wrap-around, as the JAX package's ``coarse_nbr``
    (``pool`` 2) and ``pool_nbr`` (``--pool_a``) tables hold them."""
    g = grid_size
    fine = morton_values_to_spatial(
        unpack_bits_morton(density_bitfield[:g ** 3 // 8], g ** 3), g)
    gp = g // pool
    d = fine.reshape(gp, pool, gp, pool, gp, pool).any(5).any(3).any(1)
    for axis in range(3):
        d = d | torch.roll(d, 1, axis) | torch.roll(d, -1, axis)
    return d


def _live_twolevel(rays_o, rays_d, t_start, t2, strata, scale, max_samples,
                   grid_size, n_rungs):
    """(N, n_strata) bool stage A of the two-level march: a stratum is live
    when one of its probes lies in an occupied stage-A cell."""
    n = rays_o.shape[0]
    g_c = strata.stage_a.shape[0]
    dt_min = SQRT3 / max_samples * strata.dir_norm
    cell = 2.0 * scale / g_c
    st = strata.stratum
    s_a = superstrata_len(st, dt_min, cell)
    offs = torch.tensor(stage_a_probes(st, dt_min, cell),
                        device=rays_o.device)
    n_cover = -(-n_rungs // st)                  # strata over the ladder
    n_strata = -(-n_cover // s_a) * s_a          # padded as the JAX march
    first = torch.arange(n_strata, device=rays_o.device,
                         dtype=torch.float32) * st
    t_c = t_ladder(t_start, (first[:, None] + offs[None, :]).reshape(-1),
                   0.0, max_samples, grid_size, scale)
    xyz_c = rays_o[:, None, :] + t_c[..., None] * rays_d[:, None, :]
    nxyz = torch.clamp(0.5 * (true_div(xyz_c, scale) + 1.0) * g_c, 0.0,
                       g_c - 1.0).to(torch.int64)
    live = strata.stage_a[nxyz[..., 2], nxyz[..., 1], nxyz[..., 0]]
    live = live.reshape(n, n_strata, -1).any(2)
    t_first = t_ladder(t_start, first, 0.0, max_samples, grid_size, scale)
    return live & (t_first < t2[:, None])


def _live_union(rays_o, rays_d, t_start, t2, strata, scale, exp_step_factor,
                max_samples, grid_size, n_rungs, dt_scale):
    """(N, n_strata) bool stage A of the cascade march: the union-grid cell
    at each stratum's t-midpoint is occupied and the stratum starts before
    the exit."""
    st = strata.stratum
    first = torch.arange(-(-n_rungs // st), device=rays_o.device,
                         dtype=torch.float32) * st
    t_lo = t_ladder(t_start, first, exp_step_factor, max_samples, grid_size,
                    dt_scale)
    t_hi = t_ladder(t_start, first + st, exp_step_factor, max_samples,
                    grid_size, dt_scale)
    t_mid = 0.5 * (t_lo + t_hi)
    xyz_c = rays_o[:, None, :] + t_mid[..., None] * rays_d[:, None, :]
    nxyz = torch.clamp(0.5 * (true_div(xyz_c, scale) + 1.0) * grid_size, 0.0,
                       grid_size - 1.0).to(torch.int32)
    live = bitfield_lookup(strata.stage_a, morton3d(nxyz))
    return live & (t_lo < t2[:, None])


def _take_budget(live, s_strata):
    """The strata a ray samples: all its live ones, or ``s_strata`` of them
    at even ranks when it has more."""
    n_strata = live.shape[1]
    csum = torch.cumsum(live.to(torch.int32), dim=1)
    n_live = csum[:, -1:].to(torch.int64)
    jj = torch.arange(s_strata, device=live.device)[None, :]
    ranks = torch.where(n_live > s_strata, jj * n_live // s_strata + 1,
                        jj + 1)
    j_sel = torch.clamp_max(_rung_of_rank(csum, ranks), n_strata - 1)
    chosen = jj + 1 <= torch.clamp_max(n_live, s_strata)
    return torch.zeros_like(live, dtype=torch.int32).scatter_add_(
        1, j_sel, chosen.to(torch.int32)) > 0


def _rung_of_rank(csum, ranks):
    """Rung index of each 1-based occupied rank: #{k : csum[n, k] < rank}."""
    return torch.searchsorted(csum, ranks.to(csum.dtype).contiguous())


def _jittered_start(hits_t, noise, exp_step_factor, max_samples, grid_size,
                    dt_scale):
    """Each ray's ladder origin: its entry t1 plus ``noise`` steps, or 0
    where the ray misses the box."""
    t1 = hits_t[:, 0]
    dt0 = calc_dt(t1, exp_step_factor, max_samples, grid_size, dt_scale)
    return torch.where(t1 >= 0, t1 + dt0 * noise, 0.0)


def _samples_at(rays_o, rays_d, t_start, k_idx, mask, exp_step_factor,
                max_samples, grid_size, dt_scale):
    """(ts, deltas, xyzs) at the selected rungs, zero where masked out."""
    ts = t_ladder(t_start, k_idx, exp_step_factor, max_samples, grid_size,
                  dt_scale)
    deltas = calc_dt(ts, exp_step_factor, max_samples, grid_size, dt_scale)
    ts = torch.where(mask, ts, 0.0)
    deltas = torch.where(mask, deltas, 0.0)
    xyzs = torch.where(mask[..., None],
                       rays_o[:, None, :] + ts[..., None] * rays_d[:, None, :],
                       0.0)
    return ts, deltas, xyzs


def march_rays_train_plain(rays_o, rays_d, hits_t, density_bitfield,
                           cascades, scale, exp_step_factor, grid_size,
                           max_samples, noise, n_rungs, s_max, dt_scale=None,
                           rank_start=0, strata=None) -> MarchResults:
    """March rays over the whole ladder; return each ray's occupied samples
    ranked rank_start+1 .. rank_start+s_max (at most max_samples per ray):
    :func:`march_rays_train`'s plain version, every rung as (N, K) tensors.

    Args:
        hits_t: (N, 2) scene-AABB entry/exit (-1 if miss), t_near clamped.
        noise: (N,) start jitter in [0, 1) (zeros at test time).
        n_rungs: ladder length K; s_max: per-ray sample-buffer width S.
        strata: a :class:`Strata` budget, or None for every occupied rung.
    """
    if dt_scale is None:
        dt_scale = scale
    t1, t2 = hits_t[:, 0], hits_t[:, 1]
    valid_ray = t1 >= 0
    t_start = _jittered_start(hits_t, noise, exp_step_factor, max_samples,
                              grid_size, dt_scale)

    ks = torch.arange(n_rungs, device=rays_o.device)
    ts_all = t_ladder(t_start, ks, exp_step_factor, max_samples, grid_size,
                      dt_scale)                                   # (N, K)
    dt_all = calc_dt(ts_all, exp_step_factor, max_samples, grid_size,
                     dt_scale)
    xyz = rays_o[:, None, :] + ts_all[..., None] * rays_d[:, None, :]
    occ = _occupancy_at(xyz, dt_all, density_bitfield, cascades, scale,
                        grid_size)
    occ = occ & (ts_all < t2[:, None]) & valid_ray[:, None]
    if strata is not None:
        if strata.union:
            live = _live_union(rays_o, rays_d, t_start, t2, strata, scale,
                               exp_step_factor, max_samples, grid_size,
                               n_rungs, dt_scale)
        else:
            live = _live_twolevel(rays_o, rays_d, t_start, t2, strata, scale,
                                  max_samples, grid_size, n_rungs)
        live = _take_budget(live & valid_ray[:, None], strata.s_strata)
        occ = occ & live[:, ks // strata.stratum]

    csum = torch.cumsum(occ.to(torch.int32), dim=1)
    n_total = torch.clamp_max(csum[:, -1], max_samples)   # per-ray cap
    n_samples = torch.clamp(n_total - rank_start, 0, s_max).to(torch.int64)

    ranks = rank_start + torch.arange(1, s_max + 1, device=rays_o.device)
    k_idx = torch.clamp_max(
        _rung_of_rank(csum, ranks.expand(rays_o.shape[0], s_max)),
        n_rungs - 1)
    mask = torch.arange(1, s_max + 1, device=rays_o.device)[None, :] \
        <= n_samples[:, None]
    ts, deltas, xyzs = _samples_at(rays_o, rays_d, t_start, k_idx, mask,
                                   exp_step_factor, max_samples, grid_size,
                                   dt_scale)
    return MarchResults(xyzs=xyzs, deltas=deltas, ts=ts, mask=mask,
                        n_samples=n_samples, k_idx=k_idx,
                        rm_samples=n_samples.sum(), t_start=t_start)


def march_rays_window_plain(rays_o, rays_d, t_start, t2, cursor,
                            density_bitfield, cascades, scale,
                            exp_step_factor, grid_size, max_samples, n_window,
                            s_cap, dt_scale=None,
                            count=None) -> WindowMarchResults:
    """March ``n_window`` ladder rungs from each ray's ``cursor``, emitting
    at most ``s_cap`` occupied samples: :func:`march_rays_window`'s plain
    version, the window's rungs as (C, W) tensors.

    The resume point of the reference's ``raymarching_test`` (its in-place
    ``hits_t`` update) is the integer ``cursor`` on the ladder: it resumes
    right after the ``s_cap``-th occupied rung when the window holds more,
    else at the window's end.

    ``count``: None, or a (1,) int64 alive count: the rows at or past it
    march nothing and come back as an empty ray at cursor 0 would
    (:func:`_empty_rows`).
    """
    if dt_scale is None:
        dt_scale = scale
    if count is not None:
        k = _rows_before(count, rays_o.shape[0])
        mr = march_rays_window_plain(
            rays_o[:k], rays_d[:k], t_start[:k], t2[:k], cursor[:k],
            density_bitfield, cascades, scale, exp_step_factor, grid_size,
            max_samples, n_window, s_cap, dt_scale)
        return _empty_rows(mr, rays_o.shape[0], n_window)
    ladder = (exp_step_factor, max_samples, grid_size, dt_scale)
    xyz, dt_all, in_box = _window_rungs(rays_o, rays_d, t_start, t2, cursor,
                                        n_window, ladder)
    occ = _occupancy_at(xyz, dt_all, density_bitfield, cascades, scale,
                        grid_size) & in_box
    return _window_results(rays_o, rays_d, t_start, t2, cursor, occ, s_cap,
                           ladder)


def _rows_before(count, n):
    """The rows before an alive count (a (1,) tensor; a host read), at
    most n."""
    return max(0, min(int(count), n))


def _empty_rows(mr, n, n_window):
    """The window march's results of k rows followed by n - k rows past
    the alive count, each as an empty ray at cursor 0 marches: no samples,
    k_idx n_window - 1, new cursor n_window, exhausted."""
    pad = n - mr.mask.shape[0]

    def tail(t, value):
        return torch.cat([t, t.new_full((pad, *t.shape[1:]), value)])

    return WindowMarchResults(
        xyzs=tail(mr.xyzs, 0.0), deltas=tail(mr.deltas, 0.0),
        ts=tail(mr.ts, 0.0), mask=tail(mr.mask, False),
        n_samples=tail(mr.n_samples, 0), cursor=tail(mr.cursor, n_window),
        exhausted=tail(mr.exhausted, True),
        k_idx=tail(mr.k_idx, n_window - 1))


def _window_rungs(rays_o, rays_d, t_start, t2, cursor, n_window, ladder):
    """The window's rungs as (C, W) tensors: positions, steps, and whether
    each lies before the ray's exit."""
    ks = cursor[:, None] + torch.arange(n_window, device=cursor.device)
    ts_all = t_ladder(t_start, ks, *ladder)                       # (C, W)
    dt_all = calc_dt(ts_all, *ladder)
    xyz = rays_o[:, None, :] + ts_all[..., None] * rays_d[:, None, :]
    return xyz, dt_all, ts_all < t2[:, None]


def _window_results(rays_o, rays_d, t_start, t2, cursor, occ, s_cap,
                    ladder):
    """The window march's results from its (C, W) occupied rungs."""
    n_window = occ.shape[1]
    csum = torch.cumsum(occ.to(torch.int32), dim=1)
    n_found = csum[:, -1].to(torch.int64)
    n_samples = torch.clamp_max(n_found, s_cap)

    ranks = torch.arange(1, s_cap + 1, device=cursor.device)
    k_local = torch.clamp_max(
        _rung_of_rank(csum, ranks.expand(cursor.shape[0], s_cap)),
        n_window - 1)
    mask = ranks[None, :] <= n_samples[:, None]
    k_glob = cursor[:, None] + k_local
    ts, deltas, xyzs = _samples_at(rays_o, rays_d, t_start, k_glob, mask,
                                   *ladder)

    cursor_new = torch.where(n_found > s_cap, cursor + k_local[:, -1] + 1,
                             cursor + n_window)
    t_next = t_ladder(t_start, cursor_new[:, None], *ladder)[:, 0]
    return WindowMarchResults(xyzs=xyzs, deltas=deltas, ts=ts, mask=mask,
                              n_samples=n_samples, cursor=cursor_new,
                              exhausted=t_next >= t2, k_idx=k_glob)


def march_rays_window_skip_plain(rays_o, rays_d, t_start, t2, cursor,
                                 density_bitfield, cascades, scale,
                                 exp_step_factor, grid_size, max_samples,
                                 n_window, s_cap, dt_scale=None,
                                 skip=None) -> WindowMarchResults:
    """The window kernel's walk as (C, W) tensors: which rungs it tests and
    how it tests them. Each ray that :func:`window_params`' margins admit
    tests only the rungs of the strata (``skip.stratum`` rungs from its
    cursor) that pass the kernel's stage-A test, in the kernel's fp32
    arithmetic, and, where :func:`window_lanes` gives a ray 16 or 32
    lanes, the kernel's head of that many rungs from the cursor; every
    other ray, and every ray without ``skip``, tests every rung; a rung's
    cell is found as
    the kernel finds it (the cascade's half-width from its exponent bits, a
    product by the exact reciprocal of a power-of-two divisor). The untested
    rungs count as empty, so where the stage-A test is a superset of the
    rung test this equals :func:`march_rays_window_plain` bit for bit."""
    if dt_scale is None:
        dt_scale = scale
    ladder = (exp_step_factor, max_samples, grid_size, dt_scale)
    xyz, dt_all, in_box = _window_rungs(rays_o, rays_d, t_start, t2, cursor,
                                        n_window, ladder)
    occ = _occupancy_kernel(xyz, dt_all, density_bitfield, cascades, scale,
                            grid_size) & in_box
    p = window_params(scale, exp_step_factor, grid_size, cascades,
                      max_samples, dt_scale, n_window, s_cap, skip)
    if p.mode:
        lanes = window_lanes(rays_o.shape[0], n_window, p)
        live = _window_live(p, skip.stage_a, rays_o, rays_d, t_start, t2,
                            cursor)
        k = torch.arange(n_window, device=cursor.device)
        skips = _window_skips(p, rays_o, rays_d, t_start, cursor, ladder)
        head = k < (lanes if lanes >= 16 else 0)
        occ = occ & (live[:, k // p.stratum] | head | ~skips[:, None])
    return _window_results(rays_o, rays_d, t_start, t2, cursor, occ, s_cap,
                           ladder)


def _f32t(x, device):
    return torch.tensor(x, dtype=torch.float32, device=device)


def _div_exact(x, div):
    """``x / div`` as csrc/raymarch.cu's ``div_exact`` rounds it: a product
    by the exact reciprocal where ``div`` (float32, broadcast to ``x``) is a
    power of two with a normal reciprocal, else a true division."""
    bits = div.view(torch.int32)
    ex = (bits >> 23) & 0xFF
    pow2 = ((bits & (0x807FFFFF - (1 << 32))) == 0) & (ex >= 1) & (ex <= 253)
    recip = ((254 - ex).clamp(1, 254) << 23).view(torch.float32)
    return torch.where(pow2, x * recip, x / div)


def _cells_kernel(xyz, div, g):
    """clamp(0.5 * (x / div + 1) * g, 0, g - 1) truncated, as the kernel's
    ``cell_of``."""
    q = 0.5 * (_div_exact(xyz, div) + 1.0) * g
    return torch.clamp(q, 0.0, g - 1.0).to(torch.int32)


def _occupancy_kernel(xyz, dt, density_bitfield, cascades, scale,
                      grid_size):
    """:func:`_occupancy_at` in the kernel's arithmetic: the half-width
    2^(mip - 1) built from its exponent bits, the cell by ``_div_exact``."""
    mip = torch.maximum(mip_from_pos(xyz, cascades),
                        mip_from_dt(dt, grid_size, cascades))
    half = ((mip + 126) << 23).view(torch.float32)
    bound = torch.minimum(half, _f32t(scale, xyz.device))
    nxyz = _cells_kernel(xyz, bound[..., None], grid_size)
    idx = mip.to(torch.int64) * grid_size ** 3 + morton3d(nxyz)
    return bitfield_lookup(density_bitfield, idx)


def _window_skips(p, rays_o, rays_d, t_start, cursor, ladder):
    """(C,) bool: the rays the kernel's stage-A skip takes
    (``window_skips``): |d|^2 within ``p.d2_max`` and the bound on their
    positions' rounding error within ``p.slack_max``."""
    dev = rays_o.device
    n2 = (rays_d[:, 0] * rays_d[:, 0] + rays_d[:, 1] * rays_d[:, 1]) \
        + rays_d[:, 2] * rays_d[:, 2]
    n_strata = -(-p.n_rungs // p.stratum)
    t_end = t_ladder(t_start, (cursor + n_strata * p.stratum)[:, None],
                     *ladder)[:, 0]
    o1 = (rays_o[:, 0].abs() + rays_o[:, 1].abs()) + rays_o[:, 2].abs()
    d1 = (rays_d[:, 0].abs() + rays_d[:, 1].abs()) + rays_d[:, 2].abs()
    err = _f32t(POS_ERR, dev) * (o1 + (t_start.abs() + t_end.abs()) * d1)
    return (n2 <= _f32t(p.d2_max, dev)) & (err <= _f32t(p.slack_max, dev))


def _window_live(p, stage_a, rays_o, rays_d, t_start, t2, cursor):
    """(C, n_strata) bool: the window strata the kernel's stage A keeps (a
    stratum starting before the exit whose probes are occupied), in its
    arithmetic."""
    dev = rays_o.device
    a = _f32t(p.a, dev)
    first = (cursor[:, None] + torch.arange(
        -(-p.n_rungs // p.stratum), device=dev) * p.stratum).to(torch.float32)
    t_first = t_start[:, None] + first * a
    offs = _f32t(list(p.probe_off)[:p.n_probes], dev)
    t = t_start[:, None, None] + (first[..., None] + offs) * a
    xyz = rays_o[:, None, None, :] + t[..., None] * rays_d[:, None, None, :]
    c = _cells_kernel(xyz, _f32t(p.scale, dev), p.g_c).to(torch.int64)
    hit = stage_a[c[..., 2], c[..., 1], c[..., 0]].any(-1)
    return hit & (t_first < t2[:, None])


# ------------------------------------------------------------------ kernels
MAX_PROBES = 16        # csrc/raymarch.cu's limits
MAX_STRATA = 4096
MAX_CHOSEN = 512
# the window march's stage-A skip: the share of a stage-A cell that its
# proof keeps clear, and csrc/raymarch.cu's kPosErr
SKIP_MARGIN = 1.0 / 64
POS_ERR = 2.0 ** -20
# threads an H100 keeps resident (132 SMs of 2,048): the window kernel
# gives a ray more lanes while its rays leave them unfilled
RESIDENT_THREADS = 132 * 2048
# above this share of set stage-A cells the serving loop walks every rung:
# most strata along a ray are live there, and the stage-A pass costs more
# than it skips (tools/march_check.py --share-sweep along a bench training:
# the skip won at 0.41 and below, walking at 0.43 and above; PERF.md §6)
SKIP_MAX_SHARE = 0.42


class _MarchParams(ctypes.Structure):
    """csrc/raymarch.cu's MarchParams, passed by pointer."""
    _fields_ = [(name, ctypes.c_float) for name in (
        "a", "b", "e", "ta", "tb", "log1pe", "dt_min", "dt_max", "scale",
        "grid_f", "grid_m1", "gc_f", "gc_m1")] \
        + [("probe_off", ctypes.c_float * MAX_PROBES)] \
        + [(name, ctypes.c_int) for name in (
            "grid", "cascades", "n_rungs", "s_max", "max_samples",
            "rank_start", "mode", "stratum", "s_strata", "n_strata", "g_c",
            "n_probes", "expo")] \
        + [(name, ctypes.c_float) for name in ("d2_max", "slack_max")]


def _f32(x):
    """A Python float rounded once to float32, as torch rounds a scalar."""
    return float(np.float32(x))


def _f32_down(x):
    """The largest float32 at or below a Python float ``x`` >= 0."""
    f = np.float32(x)
    if float(f) > x:
        f = np.nextafter(f, np.float32(0.0))
    return float(f)


def _pow2(x):
    return x > 0 and math.frexp(x)[0] == 0.5


def march_params(scale, exp_step_factor, grid_size, cascades, max_samples,
                 dt_scale, n_rungs, s_max, rank_start=0, strata=None):
    """The kernels' constants, each computed in double as the plain version
    computes it (``stepping.calc_dt``, ``stepping.t_ladder``,
    ``_occupancy_at``, ``_live_twolevel``, ``_live_union``) and rounded once
    to float32."""
    a = SQRT3 / max_samples
    b = SQRT3 * 2.0 * dt_scale / grid_size
    e = exp_step_factor
    p = _MarchParams(
        a=_f32(a), b=_f32(b), e=_f32(e),
        ta=_f32(a / e) if e else 0.0, tb=_f32(b / e) if e else 0.0,
        log1pe=_f32(math.log1p(e)), dt_min=_f32(a), dt_max=_f32(b),
        scale=_f32(scale), grid_f=_f32(grid_size),
        grid_m1=_f32(grid_size - 1.0), grid=grid_size, cascades=cascades,
        n_rungs=n_rungs, s_max=s_max, max_samples=max_samples,
        rank_start=rank_start,
        mode=0 if strata is None else 2 if strata.union else 1,
        expo=int(e != 0.0))
    if strata is None:
        return p
    st = p.stratum = strata.stratum
    p.s_strata = strata.s_strata
    if strata.union:
        p.n_strata = -(-n_rungs // st)
        return p
    g_c = p.g_c = strata.stage_a.shape[0]
    p.gc_f, p.gc_m1 = _f32(g_c), _f32(g_c - 1.0)
    dt_min = SQRT3 / max_samples * strata.dir_norm
    cell = 2.0 * scale / g_c
    offs = stage_a_probes(st, dt_min, cell)
    if len(offs) > MAX_PROBES:
        raise ValueError(f"{len(offs)} stage-A probes a stratum; the kernel "
                         f"takes {MAX_PROBES}")
    p.n_probes = len(offs)
    for i, off in enumerate(offs):
        p.probe_off[i] = _f32(off)
    s_a = superstrata_len(st, dt_min, cell)
    n_cover = -(-n_rungs // st)                  # as _live_twolevel pads
    p.n_strata = -(-n_cover // s_a) * s_a
    return p


def window_params(scale, exp_step_factor, grid_size, cascades, max_samples,
                  dt_scale, n_window, s_cap, skip=None):
    """The window kernel's constants (:func:`march_params`) and, with
    ``skip``, its stage A, where the proof below holds (else mode 0: every
    ray walks every rung).

    Why the stage-A test is a superset of the rung test (one cascade,
    uniform steps). A rung is occupied when its position x's cell is set in
    cascade 0's grid, whose cells' half-width is ``scale`` (<= 0.5), so the
    fine coordinate is ``0.5 * v * G`` and the stage-A one ``0.5 * v * g``,
    from the same ``v = x / scale + 1`` rounded once; with G and g powers
    of two both products are exact, so the stage-A cell of x is its fine
    cell floor-divided by the pool, clamps included, with no rounding
    between them. The stage-A grid is the pooled grid dilated one cell, so
    a probe whose stage-A coordinate lies within one cell of x's finds that
    cell set. Probes sit at ``stage_a_probes`` of a stratum, spaced for
    steps of ``a * dir_norm / (1 - SKIP_MARGIN)``, so every rung lies within
    ``r`` rungs of one (r = (stratum - 1) / (2 p)) and, for |d| <= ``d_max``
    = cell (1 - SKIP_MARGIN) / (r a) (at least ``dir_norm``), within cell
    (1 - SKIP_MARGIN) of it on each axis.

    Rounding: the kernel computes every position with errors below
    ``POS_ERR`` (|o|_1 + (|t_start| + |t_end|) |d|_1), at least four times
    the bound the ladder's, the product's and the sum's roundings reach,
    and admits a ray only where that bound is below ``slack_max`` = a
    quarter of SKIP_MARGIN cells (two positions: half of it) and |d|^2 is
    below ``d2_max`` = min(d_max, dir_norm)^2 (1 - 2^-20) rounded down (a
    ray beyond the grids' ``dir_norm`` walks every rung, as does one beyond
    the proof's d_max; the fp32 sum of squares is within 2^-21 of |d|^2);
    the cell coordinates' own rounding (~1e-4 cells at G 1024) takes less
    than the half left. A stratum whose first rung is at or past the exit
    is empty, with every later one: the ladder rises by at least a step,
    far above an ulp, a rung.
    """
    p = march_params(scale, exp_step_factor, grid_size, cascades,
                     max_samples, dt_scale, n_window, s_cap)
    if skip is None:
        return p
    st = skip.stratum
    a = SQRT3 / max_samples
    g_c = skip.stage_a.shape[0]
    if not (cascades == 1 and exp_step_factor == 0.0 and scale <= 0.5
            and _pow2(grid_size) and _pow2(g_c) and g_c <= grid_size):
        return p
    cell = 2.0 * scale / g_c
    offs = stage_a_probes(st, a * skip.dir_norm / (1.0 - SKIP_MARGIN), cell)
    if len(offs) > MAX_PROBES:
        return p
    r = (st - 1) / (2.0 * len(offs))
    d_max = math.inf if r == 0 else cell * (1.0 - SKIP_MARGIN) / (r * a)
    p.mode, p.g_c, p.n_probes = 1, g_c, len(offs)
    p.gc_f, p.gc_m1 = _f32(g_c), _f32(g_c - 1.0)
    for i, off in enumerate(offs):
        p.probe_off[i] = _f32(off)
    p.stratum, p.s_strata = st, 1
    p.n_strata = -(-n_window // st)
    d_max = min(d_max, skip.dir_norm)
    p.d2_max = _f32_down(d_max * d_max * (1.0 - 2.0 ** -20))
    p.slack_max = _f32_down(cell * SKIP_MARGIN / 4.0)
    return p


def window_lanes(n, n_window, p):
    """Lanes a ray of the window kernel takes: the power of two at or above
    its window's strata (``p.stratum`` rungs, or 8 without a stage A), 4 to
    32; halved while n rays would ask for more than eight times
    RESIDENT_THREADS, down to 4 with a stage A and 8 without; doubled while
    they leave them unfilled. (On a trained bench frame's eleven rounds
    this was within 7% of the best count in each, PERF.md §6.)"""
    units = -(-n_window // (p.stratum if p.mode else 8))
    floor = 4 if p.mode else 8
    lanes = 4
    while lanes < min(units, 32):
        lanes *= 2
    while lanes > floor and n * lanes > 8 * RESIDENT_THREADS:
        lanes //= 2
    while lanes < 32 and n * lanes < RESIDENT_THREADS:
        lanes *= 2
    return lanes


@functools.cache
def _kernels():
    """The C entry points of csrc/raymarch.cu (built on first use)."""
    lib = build.load_library("raymarch")
    train, window = lib.march_train, lib.march_window
    train.argtypes = [ctypes.POINTER(_MarchParams), ctypes.c_longlong] \
        + [ctypes.c_void_p] * 14
    window.argtypes = [ctypes.POINTER(_MarchParams), ctypes.c_int,
                       ctypes.c_longlong] + [ctypes.c_void_p] * 18
    train.restype = window.restype = ctypes.c_int
    return train, window


def _stream(device):
    with torch.cuda.device(device):
        return torch.cuda.current_stream().cuda_stream


def _operand(t, name, dtype, shape, device):
    """``t`` contiguous, after checking its type, shape and device."""
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device:
        raise ValueError(f"{name} must be {shape} {dtype} on {device}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")
    return t.contiguous()


def _check_counts(p, n_rungs, s_max):
    if n_rungs < 1 or s_max < 1 or n_rungs >= 2 ** 24:
        raise ValueError(f"n_rungs {n_rungs} and s_max {s_max}: the kernels "
                         f"take 1 <= n_rungs < 2^24 and s_max >= 1")
    if p.mode and (p.n_strata > MAX_STRATA or p.s_strata > MAX_CHOSEN):
        raise ValueError(f"{p.n_strata} strata and s_strata {p.s_strata}: "
                         f"the kernel takes {MAX_STRATA} and {MAX_CHOSEN}")


def _launch_train(rays_o, rays_d, hits_t, density_bitfield, cascades, scale,
                  exp_step_factor, grid_size, max_samples, noise, n_rungs,
                  s_max, dt_scale, rank_start, strata):
    dev, n = rays_o.device, rays_o.shape[0]
    p = march_params(scale, exp_step_factor, grid_size, cascades,
                     max_samples, dt_scale, n_rungs, s_max, rank_start,
                     strata)
    _check_counts(p, n_rungs, s_max)
    f32 = torch.float32
    rays_o = _operand(rays_o, "rays_o", f32, (n, 3), dev)
    rays_d = _operand(rays_d, "rays_d", f32, (n, 3), dev)
    hits_t = _operand(hits_t, "hits_t", f32, (n, 2), dev)
    noise = _operand(noise, "noise", f32, (n,), dev)
    bits = _operand(density_bitfield, "density_bitfield", torch.uint8,
                    tuple(density_bitfield.shape), dev)
    stage_a = None
    if strata is not None:
        want = torch.uint8 if strata.union else torch.bool
        stage_a = _operand(strata.stage_a, "strata.stage_a", want,
                           tuple(strata.stage_a.shape), dev)
    xyzs = torch.empty((n, s_max, 3), dtype=f32, device=dev)
    deltas = torch.empty((n, s_max), dtype=f32, device=dev)
    ts = torch.empty((n, s_max), dtype=f32, device=dev)
    mask = torch.empty((n, s_max), dtype=torch.bool, device=dev)
    n_samples = torch.empty((n,), dtype=torch.int64, device=dev)
    k_idx = torch.empty((n, s_max), dtype=torch.int64, device=dev)
    t_start = torch.empty((n,), dtype=f32, device=dev)
    if n:
        rc = _kernels()[0](
            ctypes.byref(p), n, rays_o.data_ptr(), rays_d.data_ptr(),
            hits_t.data_ptr(), noise.data_ptr(), bits.data_ptr(),
            None if stage_a is None else stage_a.data_ptr(),
            xyzs.data_ptr(), deltas.data_ptr(), ts.data_ptr(),
            mask.data_ptr(), n_samples.data_ptr(), k_idx.data_ptr(),
            t_start.data_ptr(), _stream(dev))
        if rc != 0:
            raise RuntimeError(f"march_train launch failed: cudaError {rc}")
        march_rays_train.launches += 1
    return MarchResults(xyzs=xyzs, deltas=deltas, ts=ts, mask=mask,
                        n_samples=n_samples, k_idx=k_idx,
                        rm_samples=n_samples.sum(), t_start=t_start)


def _launch_window(rays_o, rays_d, t_start, t2, cursor, alive,
                   density_bitfield, cascades, scale, exp_step_factor,
                   grid_size, max_samples, n_window, s_cap, dt_scale, skip,
                   count=None, out=None):
    """The window kernel on the rows ``alive`` of the frame's arrays, their
    new cursors written into ``cursor`` in place; with ``count`` (a (1,)
    int64 on the device) only the rows before it; the results written into
    ``out`` where given."""
    dev, m, n = rays_o.device, rays_o.shape[0], alive.shape[0]
    p = window_params(scale, exp_step_factor, grid_size, cascades,
                      max_samples, dt_scale, n_window, s_cap, skip)
    _check_counts(p, n_window, s_cap)
    f32 = torch.float32
    rays_o = _operand(rays_o, "rays_o", f32, (m, 3), dev)
    rays_d = _operand(rays_d, "rays_d", f32, (m, 3), dev)
    t_start = _operand(t_start, "t_start", f32, (m,), dev)
    t2 = _operand(t2, "t2", f32, (m,), dev)
    alive = _operand(alive, "alive", torch.int64, (n,), dev)
    _operand(cursor, "cursor", torch.int64, (m,), dev)
    if not cursor.is_contiguous():
        raise ValueError("cursor must be contiguous: it is written in place")
    bits = _operand(density_bitfield, "density_bitfield", torch.uint8,
                    tuple(density_bitfield.shape), dev)
    if count is not None:
        count = _operand(count, "count", torch.int64, (1,), dev)
    stage_a = None
    if p.mode:
        stage_a = _operand(skip.stage_a, "skip.stage_a", torch.bool,
                           tuple(skip.stage_a.shape), dev)
    i64 = torch.int64
    shapes = dict(xyzs=((n, s_cap, 3), f32), deltas=((n, s_cap), f32),
                  ts=((n, s_cap), f32), mask=((n, s_cap), torch.bool),
                  n_samples=((n,), i64), cursor=((n,), i64),
                  exhausted=((n,), torch.bool), k_idx=((n, s_cap), i64))
    if out is None:
        out = WindowMarchResults(**{
            name: torch.empty(shape, dtype=dtype, device=dev)
            for name, (shape, dtype) in shapes.items()})
    for name, (shape, dtype) in shapes.items():
        t = getattr(out, name)
        _operand(t, f"out.{name}", dtype, shape, dev)
        if not t.is_contiguous():
            raise ValueError(f"out.{name} must be contiguous: it is written "
                             f"in place")
    xyzs, deltas, ts, mask, n_samples, cursor_new, exhausted, k_idx = out
    if n:
        rc = _kernels()[1](
            ctypes.byref(p), window_lanes(n, n_window, p), n,
            rays_o.data_ptr(), rays_d.data_ptr(), t_start.data_ptr(),
            t2.data_ptr(), cursor.data_ptr(), alive.data_ptr(),
            None if count is None else count.data_ptr(), bits.data_ptr(),
            None if stage_a is None else stage_a.data_ptr(),
            xyzs.data_ptr(), deltas.data_ptr(), ts.data_ptr(),
            mask.data_ptr(), n_samples.data_ptr(), cursor_new.data_ptr(),
            exhausted.data_ptr(), k_idx.data_ptr(), _stream(dev))
        if rc != 0:
            raise RuntimeError(f"march_window launch failed: cudaError {rc}")
        march_rays_window.launches += 1
    return out


def _needs_grad(*tensors):
    """Whether autograd records a function of ``tensors`` here."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _device_type(t):
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"the march runs on cpu or cuda, not {t.device}")
    return kind


def march_rays_train(rays_o, rays_d, hits_t, density_bitfield, cascades,
                     scale, exp_step_factor, grid_size, max_samples, noise,
                     n_rungs, s_max, dt_scale=None,
                     rank_start=0, strata=None) -> MarchResults:
    """March rays over the whole ladder; return each ray's occupied samples
    ranked rank_start+1 .. rank_start+s_max (at most max_samples per ray).

    Args:
        hits_t: (N, 2) scene-AABB entry/exit (-1 if miss), t_near clamped.
        noise: (N,) start jitter in [0, 1) (zeros at test time).
        n_rungs: ladder length K; s_max: per-ray sample-buffer width S.
        strata: a :class:`Strata` budget, or None for every occupied rung.

    CUDA tensors run csrc/raymarch.cu's ``march_train`` kernel, which walks
    only the rungs it needs and equals :func:`march_rays_train_plain` bit
    for bit, but for ``k_idx`` on masked slots: the kernel writes
    ``n_rungs - 1`` there, where the plain version keeps the rung of a rank
    between ``max_samples`` and the ray's total (nothing reads them). The
    kernel's samples carry no autograd graph: where autograd records a
    function of the rays, the hits or the jitter (pose refinement),
    ``t_start``, ``ts``, ``deltas`` and ``xyzs`` are recomputed from the
    kernel's rungs by the plain version's differentiable part
    (``_jittered_start``, ``_samples_at``), to the same values. CPU tensors
    run the plain version. ``march_rays_train.launches`` counts kernel
    launches.
    """
    if dt_scale is None:
        dt_scale = scale
    if _device_type(rays_o) == "cpu":
        return march_rays_train_plain(
            rays_o, rays_d, hits_t, density_bitfield, cascades, scale,
            exp_step_factor, grid_size, max_samples, noise, n_rungs, s_max,
            dt_scale, rank_start, strata)
    mr = _launch_train(rays_o, rays_d, hits_t, density_bitfield, cascades,
                       scale, exp_step_factor, grid_size, max_samples,
                       noise, n_rungs, s_max, dt_scale, rank_start, strata)
    if _needs_grad(rays_o, rays_d, hits_t, noise):
        ladder = (exp_step_factor, max_samples, grid_size, dt_scale)
        t_start = _jittered_start(hits_t, noise, *ladder)
        ts, deltas, xyzs = _samples_at(rays_o, rays_d, t_start, mr.k_idx,
                                       mr.mask, *ladder)
        mr = mr._replace(xyzs=xyzs, deltas=deltas, ts=ts, t_start=t_start)
    return mr


def march_rays_window(rays_o, rays_d, t_start, t2, cursor, density_bitfield,
                      cascades, scale, exp_step_factor, grid_size,
                      max_samples, n_window, s_cap, dt_scale=None
                      ) -> WindowMarchResults:
    """March ``n_window`` ladder rungs from each ray's ``cursor``, emitting
    at most ``s_cap`` occupied samples; the new cursor and whether the ray
    passed its exit there. ``cursor`` is left as it is.

    :func:`march_rays_window_into` over every row, on a copy of ``cursor``,
    with every rung tested: CUDA tensors run csrc/raymarch.cu's
    ``march_window`` kernel, bit for bit :func:`march_rays_window_plain`;
    CPU tensors run the plain version. ``march_rays_window.launches`` counts
    the kernel's launches (this function's and
    :func:`march_rays_window_into`'s).
    """
    if _device_type(rays_o) == "cpu":
        return march_rays_window_plain(
            rays_o, rays_d, t_start, t2, cursor, density_bitfield, cascades,
            scale, exp_step_factor, grid_size, max_samples, n_window, s_cap,
            dt_scale)
    rows = torch.arange(rays_o.shape[0], device=rays_o.device)
    return march_rays_window_into(
        rays_o, rays_d, t_start, t2, cursor.clone(), rows, density_bitfield,
        cascades, scale, exp_step_factor, grid_size, max_samples, n_window,
        s_cap, dt_scale)


def march_rays_window_into(rays_o, rays_d, t_start, t2, cursor, alive,
                           density_bitfield, cascades, scale,
                           exp_step_factor, grid_size, max_samples, n_window,
                           s_cap, dt_scale=None, skip=None, count=None,
                           out=None) -> WindowMarchResults:
    """:func:`march_rays_window` of the frame's rows ``alive`` (int64,
    distinct rows), in place: row r marches row ``alive[r]`` of ``rays_o``,
    ``rays_d``, ``t_start``, ``t2`` and ``cursor`` (the frame's arrays), and
    its new cursor is written into ``cursor[alive[r]]``. Returns the
    results of the rows (their new cursors in ``cursor`` too).

    ``count``: None, or a (1,) int64 alive count on the rays' device (the
    serving rounds' capacity buffers): only the rows before it march; the
    rows at or past it read nothing of the frame (their ``alive`` entries
    may be anything), leave its cursor alone and come back as an empty ray
    at cursor 0 would (:func:`march_rays_window_plain`'s ``count``).
    ``out``: a :class:`WindowMarchResults` of contiguous tensors of the
    results' shapes to write them into (static buffers), else new ones.

    CUDA tensors run csrc/raymarch.cu's ``march_window`` kernel, which
    reads and writes the frame's arrays through ``alive`` (no gather, no
    scatter), reads the count on the device and, with ``skip`` (a
    :class:`WindowSkip`), tests only the strata its stage-A grid cannot
    prove empty; bit for bit :func:`march_rays_window_plain` of the
    gathered rows with or without it (its samples recomputed
    differentiably where autograd records a function of the rays or
    ``t_start``, as in :func:`march_rays_train`). CPU tensors gather the
    rows before the count, run :func:`march_rays_window_plain` and scatter
    the cursor.
    """
    if dt_scale is None:
        dt_scale = scale
    if _device_type(rays_o) == "cpu":
        rows = alive
        if count is not None:
            rows = alive[:_rows_before(count, alive.shape[0])]
        mr = march_rays_window_plain(
            rays_o[rows], rays_d[rows], t_start[rows], t2[rows],
            cursor[rows], density_bitfield, cascades, scale,
            exp_step_factor, grid_size, max_samples, n_window, s_cap,
            dt_scale)
        cursor[rows] = mr.cursor
        if count is not None:
            mr = _empty_rows(mr, alive.shape[0], n_window)
        if out is not None:
            for t, v in zip(out, mr):
                t.copy_(v)
            mr = out
        return mr
    mr = _launch_window(rays_o, rays_d, t_start, t2, cursor, alive,
                        density_bitfield, cascades, scale, exp_step_factor,
                        grid_size, max_samples, n_window, s_cap, dt_scale,
                        skip, count, out)
    if _needs_grad(rays_o, rays_d, t_start):
        ts, deltas, xyzs = _samples_at(
            rays_o[alive], rays_d[alive], t_start[alive], mr.k_idx, mr.mask,
            exp_step_factor, max_samples, grid_size, dt_scale)
        mr = mr._replace(xyzs=xyzs, deltas=deltas, ts=ts)
    return mr


march_rays_train.launches = 0
march_rays_window.launches = 0
