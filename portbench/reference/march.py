"""Rays, the scene box and the occupancy march, plain.

Frozen copies of the port's plain versions (``mfnerf_tpu_torch`` as of the
benchmark's first version):

* ``ops/stepping.py``: ``true_div``, ``calc_dt``, the mip selection,
  ``t_ladder``, ``max_ladder_steps``;
* ``ops/morton.py``: ``morton3d``, ``bitfield_lookup``,
  ``unpack_bits_morton``, ``morton_values_to_spatial``;
* ``ops/intersection.py::ray_aabb_intersect_single`` and
  ``models/rendering.py::_clamp_near`` / ``_scene_hits``;
* ``ops/ray_march.py``: ``_occupancy_at``, ``twolevel_stratum``,
  ``stage_a_probes``, ``superstrata_len``, ``stage_a_grid``,
  ``_live_twolevel``, ``_take_budget``, ``march_rays_train_plain``;
* ``models/rendering.py``: ``RenderConfig.n_rungs`` / ``_dt_scale``,
  ``flat_budget``'s cut (the first ``N * s_flat`` samples in ray order);
* ``datasets/ray_utils.py::get_rays`` (a pose a ray) and
  ``train.py::NeRFSystem.setup``'s strata sizing.

Only the single-cascade march with uniform steps (a synthetic scene at
scale 0.5) is kept: :func:`strata_of` refuses other scenes.
"""
import math
from typing import NamedTuple

import torch

SQRT3 = 1.7320508075688772
NEAR_DISTANCE = 0.01
NBR_SPAN = 8


def true_div(x, s):
    """``x / s`` as an IEEE division on every device (torch turns
    ``cuda_tensor / python_float`` into a multiply by the reciprocal)."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def calc_dt(t, exp_step_factor, max_samples, grid_size, scale):
    dt_min = SQRT3 / max_samples
    dt_max = SQRT3 * 2.0 * scale / grid_size
    return torch.clamp(t * exp_step_factor, dt_min, dt_max)


def _frexp_exponent(x):
    bits = x.abs().to(torch.float32).view(torch.int32)
    return ((bits >> 23) & 0xFF) - 126


def mip_from_pos(xyz, cascades):
    mx = xyz.abs().amax(dim=-1)
    return torch.clamp(_frexp_exponent(mx) + 1, 0, cascades - 1)


def mip_from_dt(dt, grid_size, cascades):
    return torch.clamp(_frexp_exponent(dt * grid_size), 0, cascades - 1)


def t_ladder(t0, ks, exp_step_factor, max_samples, grid_size, scale):
    """(N, K) t of rungs ``ks`` from the starts ``t0`` (N,): the closed form
    of t_{k+1} = t_k + calc_dt(t_k)."""
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
    ta, tb = a / e, b / e
    n1 = torch.ceil(true_div(torch.clamp_min(ta - t0, 0.0), a))
    t_g0 = t0 + n1 * a
    log1pe = math.log1p(e)
    m2 = torch.ceil(true_div(torch.clamp_min(torch.log(torch.clamp_min(
        torch.full_like(t_g0, tb) / t_g0, 1.0)), 0.0), log1pe))
    k1 = torch.minimum(ks, n1)
    kg = torch.minimum(torch.clamp(ks - n1, min=0.0), m2)
    kb = torch.clamp_min(ks - n1 - m2, 0.0)
    return (t0 + k1 * a) * torch.exp(kg * log1pe) + kb * b


def max_ladder_steps(t_start_min, t_end_max, exp_step_factor, max_samples,
                     grid_size, scale):
    a = SQRT3 / max_samples
    b = SQRT3 * 2.0 * scale / grid_size
    e = exp_step_factor
    if e == 0.0:
        return max(1, int(math.ceil((t_end_max - t_start_min) / a)) + 1)
    t, k = max(t_start_min, 0.0), 0
    while t < t_end_max:
        t += min(max(t * e, a), b)
        k += 1
        if k > 16 * max_samples:
            break
    return max(1, k + 1)


def n_rungs(scale, grid_size, max_samples, exp_step_factor, test=False):
    """The ladder's length over the scene box (``RenderConfig.n_rungs``)."""
    t_end = 2.0 * SQRT3 * scale + NEAR_DISTANCE
    k = max_ladder_steps(NEAR_DISTANCE, t_end, exp_step_factor, max_samples,
                         grid_size, dt_scale(scale, test))
    return min(k, 4 * max_samples)


def cascades_of(scale):
    return max(1 + int(math.ceil(math.log2(2 * scale))), 1)


def dt_scale(scale, test):
    """The step's scale: at test time the reference kernel's bug parity
    passes the cascade count where ``calc_dt`` expects the scale."""
    return cascades_of(scale) if test else scale


# ------------------------------------------------------------ Morton codes
def _expand_bits(v):
    v = v.to(torch.int64) & 0xFFFFFFFF
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3d(coords):
    """(..., 3) integer coords in [0, 1024) -> (...,) int64 codes."""
    return _expand_bits(coords[..., 0]) | (_expand_bits(coords[..., 1]) << 1) \
        | (_expand_bits(coords[..., 2]) << 2)


def bitfield_lookup(bitfield, idx):
    idx = idx.to(torch.int64)
    byte = bitfield[idx >> 3].to(torch.int64)
    return ((byte >> (idx & 7)) & 1).to(torch.bool)


def unpack_bits_morton(bitfield, n_cells):
    shifts = torch.arange(8, device=bitfield.device)
    bits = (bitfield.to(torch.int64)[:, None] >> shifts) & 1
    return bits.reshape(-1)[:n_cells].to(torch.bool)


def morton_values_to_spatial(v, g):
    """(g^3,) Morton-ordered values -> (g, g, g) raster [z, y, x]."""
    r = torch.arange(g, device=v.device)
    zyx = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1)
    return v[morton3d(zyx.flip(-1))]


# --------------------------------------------------------------- the rays
def get_rays(directions, c2w):
    """(rays_o, rays_d) of directions (N, 3) under poses (N, 3, 4), or one
    pose (3, 4); a pose a ray sums its three products elementwise."""
    if c2w.dim() == 2:
        rays_d = directions @ c2w[:, :3].T
        return c2w[:, 3].expand(rays_d.shape), rays_d
    rot = c2w[..., :3]
    rays_d = (directions[:, 0:1] * rot[..., 0] + directions[:, 1:2]
              * rot[..., 1] + directions[:, 2:3] * rot[..., 2])
    return c2w[..., 3], rays_d


def scene_hits(rays_o, rays_d, scale):
    """(N, 2) entry and exit of the box [-scale, scale]^3, -1 on a miss;
    the entry clamped to NEAR_DISTANCE."""
    rays_o = rays_o.to(torch.float32)
    inv_d = 1.0 / rays_d.to(torch.float32)
    dev = rays_o.device
    center = torch.zeros(3, device=dev)
    half = torch.full((3,), scale, device=dev)
    t_lo = (center - half - rays_o) * inv_d
    t_hi = (center + half - rays_o) * inv_d
    tmin = torch.minimum(t_lo, t_hi).amax(dim=-1)
    tmax = torch.maximum(t_lo, t_hi).amin(dim=-1)
    miss = tmin > tmax
    t1 = torch.where(miss, -1.0, tmin)
    t2 = torch.where(miss, -1.0, tmax)
    hit = t2 > 0
    t1 = torch.where(hit, torch.clamp_min(t1, 0.0), -1.0)
    t2 = torch.where(hit, t2, -1.0)
    t1 = torch.where((t1 >= 0) & (t1 < NEAR_DISTANCE), NEAR_DISTANCE, t1)
    return torch.stack([t1, t2], dim=1)


# -------------------------------------------------------------- the march
class Strata(NamedTuple):
    stage_a: torch.Tensor    # (g, g, g) bool [z, y, x]
    stratum: int
    s_strata: int
    dir_norm: float


class March(NamedTuple):
    xyzs: torch.Tensor       # (N, S, 3)
    deltas: torch.Tensor     # (N, S)
    ts: torch.Tensor         # (N, S)
    mask: torch.Tensor       # (N, S) bool
    n_samples: torch.Tensor  # (N,) int64


def _occupancy_at(xyz, dt, bitfield, cascades, scale, grid_size):
    mip = torch.maximum(mip_from_pos(xyz, cascades),
                        mip_from_dt(dt, grid_size, cascades))
    mip_bound = torch.clamp_max(torch.exp2(mip.to(torch.float32) - 1.0),
                                scale)
    nxyz = torch.clamp(
        0.5 * (xyz / mip_bound[..., None] + 1.0) * grid_size,
        0.0, grid_size - 1.0).to(torch.int32)
    idx = mip.to(torch.int64) * grid_size ** 3 + morton3d(nxyz)
    return bitfield_lookup(bitfield, idx)


def twolevel_stratum(exp_step_factor, max_samples, scale, grid_size,
                     cascades, dir_norm=1.0):
    if exp_step_factor != 0.0 or cascades != 1:
        return 0
    dt_eff = SQRT3 / max_samples * dir_norm
    cell_fine = 2.0 * min(0.5, scale) / grid_size
    stratum = min(int((NBR_SPAN - 1.0) * cell_fine / dt_eff) + 1, 32)
    return stratum if stratum >= 2 else 0


def stage_a_probes(stratum, dt_eff, cell):
    p = max(1, math.ceil(((stratum - 1) / 2.0) * dt_eff / cell))
    return [(stratum - 1) * (2 * i + 1) / (2.0 * p) for i in range(p)]


def superstrata_len(stratum, dt_min, cell):
    s = 1
    while s < 16 and ((s + 1) * stratum - 1) * dt_min \
            <= (NBR_SPAN - 1.0) * cell:
        s += 1
    return s


def stage_a_grid(bitfield, grid_size, pool):
    """Cascade 0's cells pooled ``pool`` to a side, dilated by one cell on
    each axis with wrap-around: (g, g, g) bool [z, y, x]."""
    g = grid_size
    fine = morton_values_to_spatial(
        unpack_bits_morton(bitfield[:g ** 3 // 8], g ** 3), g)
    gp = g // pool
    d = fine.reshape(gp, pool, gp, pool, gp, pool).any(5).any(3).any(1)
    for axis in range(3):
        d = d | torch.roll(d, 1, axis) | torch.roll(d, -1, axis)
    return d


def strata_of(hp, bitfield, dir_norm):
    """The training march's strata budget for the hyperparameters ``hp``
    (a dict) on ``bitfield``: ``NeRFSystem.setup``'s sizing and
    ``OccupancyState.refresh_coarse``'s stage-A grid."""
    scale, g = hp["scale"], hp["grid_size"]
    if cascades_of(scale) != 1:
        raise NotImplementedError("the reference marches one cascade")
    stratum = twolevel_stratum(0.0, hp["max_samples"], scale, g, 1, dir_norm)
    s_max = hp["s_max_train"]
    s_strata = max(4, -(-(9 * s_max // 4) // stratum)) if stratum \
        else max(4, s_max // 8)
    pool = hp.get("pool_a", 0)
    pool = pool if pool and g % pool == 0 else 2
    return Strata(stage_a_grid(bitfield, g, pool), stratum, s_strata,
                  dir_norm)


def _live_twolevel(rays_o, rays_d, t_start, t2, strata, scale, max_samples,
                   grid_size, n_rung):
    n = rays_o.shape[0]
    g_c = strata.stage_a.shape[0]
    dt_min = SQRT3 / max_samples * strata.dir_norm
    cell = 2.0 * scale / g_c
    st = strata.stratum
    s_a = superstrata_len(st, dt_min, cell)
    offs = torch.tensor(stage_a_probes(st, dt_min, cell),
                        device=rays_o.device)
    n_cover = -(-n_rung // st)
    n_strata = -(-n_cover // s_a) * s_a
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


def _rung_of_rank(csum, ranks):
    return torch.searchsorted(csum, ranks.to(csum.dtype).contiguous())


def _take_budget(live, s_strata):
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


def march(rays_o, rays_d, hits_t, bitfield, scale, grid_size, max_samples,
          noise, n_rung, s_max, test=False, rank_start=0, strata=None):
    """Each ray's occupied rungs ranked rank_start+1 .. rank_start+s_max
    (at most max_samples a ray) on the whole ladder, with the start jitter
    ``noise`` (N,) in [0, 1): ``march_rays_train_plain`` at one cascade
    and uniform steps."""
    cascades = cascades_of(scale)
    ds = dt_scale(scale, test)
    t1, t2 = hits_t[:, 0], hits_t[:, 1]
    valid_ray = t1 >= 0
    dt0 = calc_dt(t1, 0.0, max_samples, grid_size, ds)
    t_start = torch.where(valid_ray, t1 + dt0 * noise, 0.0)
    ks = torch.arange(n_rung, device=rays_o.device)
    ts_all = t_ladder(t_start, ks, 0.0, max_samples, grid_size, ds)
    dt_all = calc_dt(ts_all, 0.0, max_samples, grid_size, ds)
    xyz = rays_o[:, None, :] + ts_all[..., None] * rays_d[:, None, :]
    occ = _occupancy_at(xyz, dt_all, bitfield, cascades, scale, grid_size)
    occ = occ & (ts_all < t2[:, None]) & valid_ray[:, None]
    if strata is not None:
        live = _live_twolevel(rays_o, rays_d, t_start, t2, strata, scale,
                              max_samples, grid_size, n_rung)
        live = _take_budget(live & valid_ray[:, None], strata.s_strata)
        occ = occ & live[:, ks // strata.stratum]
    csum = torch.cumsum(occ.to(torch.int32), dim=1)
    n_total = torch.clamp_max(csum[:, -1], max_samples)
    n_samples = torch.clamp(n_total - rank_start, 0, s_max).to(torch.int64)
    ranks = rank_start + torch.arange(1, s_max + 1, device=rays_o.device)
    k_idx = torch.clamp_max(
        _rung_of_rank(csum, ranks.expand(rays_o.shape[0], s_max)),
        n_rung - 1)
    mask = torch.arange(1, s_max + 1, device=rays_o.device)[None, :] \
        <= n_samples[:, None]
    ts = t_ladder(t_start, k_idx, 0.0, max_samples, grid_size, ds)
    deltas = calc_dt(ts, 0.0, max_samples, grid_size, ds)
    ts = torch.where(mask, ts, 0.0)
    deltas = torch.where(mask, deltas, 0.0)
    xyzs = torch.where(mask[..., None],
                       rays_o[:, None, :] + ts[..., None] * rays_d[:, None, :],
                       0.0)
    return March(xyzs, deltas, ts, mask, n_samples)


def flat_cut(mr, s_flat):
    """The flat layout's budget: the batch's first ``N * s_flat`` samples
    in ray order kept, the rest masked out."""
    n, s = mr.mask.shape
    first = torch.cumsum(mr.n_samples, 0) - mr.n_samples
    rank = torch.arange(s, device=mr.mask.device)
    mask = mr.mask & (first[:, None] + rank < n * s_flat)
    return mr._replace(mask=mask, ts=torch.where(mask, mr.ts, 0.0),
                       deltas=torch.where(mask, mr.deltas, 0.0))
