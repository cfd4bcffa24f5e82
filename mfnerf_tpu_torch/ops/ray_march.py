"""Occupancy-grid ray marching on the closed-form t-ladder.

Port of ``mfnerf_tpu/ops/ray_march.py``: ``_occupancy_at``,
``march_rays_train`` (used by the dense test oracle with zero noise and rank
windows) and ``march_rays_window`` (the cursor-window march of the alive-ray
renderer). A ray visits the rungs ``t_ladder(t_start, k)``; occupancy only
selects which rungs emit samples, so marching is: evaluate the rungs, look
up their cells in the bitfield, keep the first occupied ones.

Test-time bug parity: the reference test kernel passes ``cascades`` where
``calc_dt`` expects ``scale``; callers pass that as ``dt_scale``.
"""
from typing import NamedTuple

import torch

from .morton import bitfield_lookup, morton3d
from .stepping import calc_dt, mip_from_dt, mip_from_pos, t_ladder


class MarchResults(NamedTuple):
    xyzs: torch.Tensor       # (N, S, 3) sample positions
    deltas: torch.Tensor     # (N, S) integration steps
    ts: torch.Tensor         # (N, S) sample distances
    mask: torch.Tensor       # (N, S) bool sample validity
    n_samples: torch.Tensor  # (N,) int64 valid samples per ray (<= S)
    k_idx: torch.Tensor      # (N, S) int64 ladder rung of each sample


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
                     rank_start=0) -> MarchResults:
    """March rays over the whole ladder; return each ray's occupied samples
    ranked rank_start+1 .. rank_start+s_max (at most max_samples per ray).

    Args:
        hits_t: (N, 2) scene-AABB entry/exit (-1 if miss), t_near clamped.
        noise: (N,) start jitter in [0, 1) (zeros at test time).
        n_rungs: ladder length K; s_max: per-ray sample-buffer width S.
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
                        n_samples=n_samples, k_idx=k_idx)


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
