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

The strata budget of the JAX two-level march
(``march_rays_train_twolevel``, which ``render_train`` runs on every
single-cascade synthetic scene): the ladder is cut into strata of
``stratum`` rungs; a stratum is live when a probe point of it lies in an
occupied cell of a coarse grid (the fine grid pooled by ``pool`` and
dilated by one cell, a superset test); a ray samples only ``s_strata`` of
its live strata, spread evenly along the ray when it has more, so early
training (most of the grid still occupied) does not spend every sample
near the camera. Under the budget the march equals the exact one. The
port applies the same budget to its exact march (``strata=``) without the
TPU's neighbourhood-row tables: the samples are the JAX march's, sample
for sample.
"""
import math
from typing import NamedTuple

import torch

from .morton import bitfield_lookup, morton3d
from .stepping import SQRT3, calc_dt, mip_from_dt, mip_from_pos, t_ladder

NBR_SPAN = 8   # the JAX march's neighbourhood-row width in cells
_RASTER_CODES = {}   # (grid_size, device) -> Morton code of each raster cell


class Strata(NamedTuple):
    """The two-level march's strata budget for :func:`march_rays_train`."""
    stage_a: torch.Tensor    # (g, g, g) bool [z, y, x]: :func:`stage_a_grid`
    stratum: int             # rungs a stratum (:func:`twolevel_stratum`)
    s_strata: int            # live strata a ray samples
    dir_norm: float          # bound on |rays_d| over every ray


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
    """Rungs a stratum, or 0 where the JAX package marches exactly (several
    cascades or exponential steps): the most rungs whose cells, at the
    worst spatial step (``dir_norm`` bounds |rays_d|), fit one
    ``NBR_SPAN``-cell window of the fine grid, at most 32."""
    if exp_step_factor != 0.0 or cascades != 1:
        return 0
    dt_eff = SQRT3 / max_samples * dir_norm
    cell_fine = 2.0 * min(0.5, scale) / grid_size
    stratum = min(int((NBR_SPAN - 1.0) * cell_fine / dt_eff) + 1, 32)
    return stratum if stratum >= 2 else 0


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
    g, dev = grid_size, density_bitfield.device
    codes = _RASTER_CODES.get((g, dev))
    if codes is None:
        r = torch.arange(g, device=dev)
        zyx = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1)
        codes = _RASTER_CODES[(g, dev)] = morton3d(zyx.flip(-1))
    fine = bitfield_lookup(density_bitfield, codes)
    gp = g // pool
    d = fine.reshape(gp, pool, gp, pool, gp, pool).any(5).any(3).any(1)
    for axis in range(3):
        d = d | torch.roll(d, 1, axis) | torch.roll(d, -1, axis)
    return d


def _live_strata(rays_o, rays_d, t_start, t2, valid_ray, strata, scale,
                 max_samples, grid_size, n_rungs):
    """(N, n_strata) bool: the strata each ray may sample. Stage A tests
    each stratum's probes on the stage-A grid; a ray with more live strata
    than the budget takes ``s_strata`` of them at even ranks."""
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
    nxyz = torch.clamp(0.5 * (xyz_c / scale + 1.0) * g_c, 0.0,
                       g_c - 1.0).to(torch.int64)
    live = strata.stage_a[nxyz[..., 2], nxyz[..., 1], nxyz[..., 0]]
    live = live.reshape(n, n_strata, -1).any(2)
    t_first = t_ladder(t_start, first, 0.0, max_samples, grid_size, scale)
    live = live & (t_first < t2[:, None]) & valid_ray[:, None]

    csum = torch.cumsum(live.to(torch.int32), dim=1)
    n_live = csum[:, -1:].to(torch.int64)
    jj = torch.arange(strata.s_strata, device=rays_o.device)[None, :]
    ranks = torch.where(n_live > strata.s_strata,
                        jj * n_live // strata.s_strata + 1, jj + 1)
    j_sel = torch.clamp_max(_rung_of_rank(csum, ranks), n_strata - 1)
    chosen = (jj + 1 <= torch.clamp_max(n_live, strata.s_strata))
    return torch.zeros_like(live, dtype=torch.int32).scatter_add_(
        1, j_sel, chosen.to(torch.int32)) > 0


def _rung_of_rank(csum, ranks):
    """Rung index of each 1-based occupied rank: #{k : csum[n, k] < rank}."""
    return torch.searchsorted(csum, ranks.to(csum.dtype).contiguous())


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
        strata: a :class:`Strata` budget (uniform steps, one cascade), or
            None for every occupied rung.
    """
    if dt_scale is None:
        dt_scale = scale
    t1, t2 = hits_t[:, 0], hits_t[:, 1]
    valid_ray = t1 >= 0

    dt0 = calc_dt(t1, exp_step_factor, max_samples, grid_size, dt_scale)
    t_start = torch.where(valid_ray, t1 + dt0 * noise, 0.0)

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
        live = _live_strata(rays_o, rays_d, t_start, t2, valid_ray, strata,
                            scale, max_samples, grid_size, n_rungs)
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


def march_rays_window(rays_o, rays_d, t_start, t2, cursor, density_bitfield,
                      cascades, scale, exp_step_factor, grid_size,
                      max_samples, n_window, s_cap, dt_scale=None
                      ) -> WindowMarchResults:
    """March ``n_window`` ladder rungs from each ray's ``cursor``, emitting
    at most ``s_cap`` occupied samples.

    The resume point of the reference's ``raymarching_test`` (its in-place
    ``hits_t`` update) is the integer ``cursor`` on the ladder: it resumes
    right after the ``s_cap``-th occupied rung when the window holds more,
    else at the window's end.
    """
    if dt_scale is None:
        dt_scale = scale
    ks = cursor[:, None] + torch.arange(n_window, device=cursor.device)
    ts_all = t_ladder(t_start, ks, exp_step_factor, max_samples, grid_size,
                      dt_scale)                                   # (C, W)
    dt_all = calc_dt(ts_all, exp_step_factor, max_samples, grid_size,
                     dt_scale)
    xyz = rays_o[:, None, :] + ts_all[..., None] * rays_d[:, None, :]
    occ = _occupancy_at(xyz, dt_all, density_bitfield, cascades, scale,
                        grid_size)
    occ = occ & (ts_all < t2[:, None])

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
                                   exp_step_factor, max_samples, grid_size,
                                   dt_scale)

    cursor_new = torch.where(n_found > s_cap, cursor + k_local[:, -1] + 1,
                             cursor + n_window)
    t_next = t_ladder(t_start, cursor_new[:, None], exp_step_factor,
                      max_samples, grid_size, dt_scale)[:, 0]
    return WindowMarchResults(xyzs=xyzs, deltas=deltas, ts=ts, mask=mask,
                              n_samples=n_samples, cursor=cursor_new,
                              exhausted=t_next >= t2, k_idx=k_glob)
