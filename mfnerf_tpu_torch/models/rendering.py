"""Rendering: the differentiable training renderer, the alive-ray test
renderer and its dense oracle.

Port of ``mfnerf_tpu/models/rendering.py``.

* :func:`render_train` is the JAX ``render_train``: the march with the
  stratified jitter and the JAX package's choice of march
  (:func:`train_strata`): the two-level march's strata budget on
  single-cascade synthetic scenes, the cascade march's on multi-cascade
  ones, the exact march elsewhere (``ops/ray_march.py``; ``rcfg.s_strata``
  strata a ray, taken evenly along it when it crosses more), the field on
  the valid samples only, ``composite_train`` and the background. The
  field runs on a static buffer of slots (:func:`_eval_capacity`, the
  capacity layout): no host read, so a CUDA graph can capture the step.
  Without ``s_flat`` (the JAX padded branch) the buffer has a slot for
  each of the N * S padded entries; with ``s_flat`` the batch keeps its
  first ``N * s_flat`` samples in ray order, as the JAX flat layout's
  budget does, and the buffer has that many slots. The JAX
  neighbourhood-row tables, flat gathers and flat composite are TPU
  devices; the samples are the same.
* :func:`render_test_dense` is the plain oracle: every ray marches the whole
  ladder in rank windows of ``s_max_test`` samples, each window is field-
  evaluated and composited with resumed transmittance. Every renderer is
  held to its frames.
* :func:`render_test` is the serving entry. It follows the reference's
  alive-ray loop (``__render_rays_test``): alive rays are compacted with
  ``nonzero``; each round marches up to
  ``N_samples = max(min(N_rays // N_alive, 64), 1)`` occupied samples per
  alive ray from its ladder cursor, evaluates the field on the valid samples
  only, and composites from ``1 - opacity``. A ray dies when its
  transmittance falls to ``T_threshold``, when its ladder passes the box
  exit, or at ``max_samples`` samples. On the card each round marches the
  alive rows in place on the frame's arrays (``march_rays_window_into``)
  and, at one cascade, skips the strata that the occupancy's stage-A grid
  proves empty where that grid is sparse (:func:`serving_skip`); the
  samples are those of the rung-by-rung march.
  The JAX package's round schedules, wavefront pool and rasterised prepass
  are TPU throughput devices and are not ported.
* :func:`render_test_sharded` serves a frame with its rays split over the
  ranks of a process group (``parallel/dist.py``).
"""
import dataclasses
import math
from typing import NamedTuple

import torch

from ..ops.composite import (composite_test_step, composite_test_step_into,
                             composite_train)
from ..ops.intersection import ray_aabb_intersect_single
from ..ops.ray_march import (SKIP_MAX_SHARE, Strata, WindowSkip,
                             cascades_stratum, march_rays_train,
                             march_rays_window_into, twolevel_stratum)
from ..ops.stepping import max_ladder_steps
from .ngp import NEAR_DISTANCE

MAX_SAMPLES = 1024
SQRT3 = 1.7320508075688772
# ladder rungs tested per alive-ray round: bounds the march's transient
# (N_alive, window) tensors; the window grows as rays die
MARCH_BUDGET = 1 << 25


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """The fields of ``mfnerf_tpu``'s RenderConfig that the port uses."""
    exp_step_factor: float = 0.0   # 0 synthetic (white bg), 1/256 real
    T_threshold: float = 1e-4
    max_samples: int = MAX_SAMPLES
    s_max_train: int = 128         # padded per-ray sample budget (train)
    s_max_test: int = 256          # oracle rank-window width
    random_bg: bool = False        # real scenes: a random training background
    test_chunk: int = 16384        # oracle rays per chunk
    s_strata: int = 32             # strata budget: live strata a ray
    s_flat: int = 0                # flat layout: samples a ray on average

    def n_rungs(self, scale: float, grid_size: int = 128,
                test: bool = False) -> int:
        """Ladder length covering the whole scene AABB."""
        t_end = 2.0 * SQRT3 * scale + NEAR_DISTANCE
        k = max_ladder_steps(NEAR_DISTANCE, t_end, self.exp_step_factor,
                             self.max_samples, grid_size,
                             self._dt_scale(scale, test))
        return min(k, 4 * self.max_samples)

    def _dt_scale(self, scale, test):
        # bug parity: the reference test kernel passes `cascades` where
        # calc_dt expects `scale`
        if test:
            return max(1 + int(math.ceil(math.log2(2 * scale))), 1)
        return scale


def _clamp_near(hits_t):
    """Clamp t_near of hitting rays into [NEAR_DISTANCE, inf)."""
    t1 = hits_t[:, 0]
    t1 = torch.where((t1 >= 0) & (t1 < NEAR_DISTANCE), NEAR_DISTANCE, t1)
    return torch.stack([t1, hits_t[:, 1]], dim=1)


def _scene_hits(model, rays_o, rays_d):
    # the box made on the rays' device: no copy from the host (CUDA graphs)
    s, dev = model.cfg.scale, rays_o.device
    return _clamp_near(ray_aabb_intersect_single(
        rays_o, rays_d, torch.zeros(3, device=dev),
        torch.full((3,), s, device=dev)))


def _eval_valid(model, xyzs, rays_d, mask, grad_noise=None, exposure=None):
    """Field on the valid samples of a (N, S) block; zeros elsewhere (the
    serving loop's and the oracle's; a host read). The scatter is out of
    place, so autograd reaches the field. ``grad_noise``: the hash grids'
    per-sample uniforms for the valid samples in row-major order.
    ``exposure``: (N, 1) a ray, or (1, 1) for all (HDR heads)."""
    n, s = mask.shape
    flat = torch.nonzero(mask.reshape(-1)).squeeze(1)
    if exposure is not None and exposure.shape[0] > 1:
        exposure = exposure[flat // s]
    sig, col = model(xyzs.reshape(-1, 3)[flat], rays_d[flat // s],
                     exposure=exposure, grad_noise=grad_noise)
    sigmas = sig.new_zeros(n * s).index_put((flat,), sig)
    rgbs = col.new_zeros((n * s, 3)).index_put((flat,), col)
    return sigmas.reshape(n, s), rgbs.reshape(n, s, 3)


def _eval_capacity(model, xyzs, rays_d, mask, cap, grad_noise=None,
                   exposure=None, noise_start=None, by_entry=False):
    """Field on the valid samples of a (N, S) block through a static buffer
    of ``cap`` slots (the capacity layout of the JAX flat branch,
    ``mfnerf_tpu/models/rendering.py:247-299``, and with ``cap = N S`` of
    its padded branch, ``:310-325``), with no host read: the
    valid samples are compacted in row-major order on the device (slot k
    takes the entry where the inclusive cumsum of ``mask`` reaches k + 1,
    by ``searchsorted``), the slots past their count hold the scene's
    centre and a unit direction, the field runs on all ``cap`` slots with
    the count (the encoder kernels skip the rows past it), and the outputs
    are written back into the (N, S) rows, the padded slots' into a drop
    entry past them, so a padded slot gets exactly zero gradient. The
    write-back's gradient is a gather (no atomics: a scatter-add from the
    (N, S) rows into the slots would add every masked entry onto one
    slot). ``mask`` holds at most ``cap`` valid samples.

    ``grad_noise``: the hash grids' uniforms. Rows of the JAX flat draw
    (n_global * s_flat, m): valid sample j of this block takes row j, or
    under a shard row ``noise_start + j`` (``noise_start``, a 0-d tensor:
    the valid samples of the ranks before this one). With ``by_entry``, the
    JAX padded draw (N S, m): the sample at entry e of the (N, S) rows takes
    row e. ``exposure``: (N, 1) a ray, or (1, 1) for all. Returns (sigmas
    (N, S), rgbs (N, S, 3))."""
    n, s = mask.shape
    dev = mask.device
    csum = torch.cumsum(mask.reshape(-1), 0)         # inclusive: int64
    count = torch.clamp_max(csum[-1], cap).reshape(1)
    # slot -> its entry of the (N, S) rows; n * s (the drop entry) past
    # the count
    slot = torch.arange(cap, device=dev)
    src = torch.searchsorted(csum, slot + 1)
    live = src < n * s
    # a padded slot reads entry `slot` (cap <= N S), masked below: distinct
    # rows, so the gathers' backward (pose refinement's) adds its zeros
    # without piling every padded slot onto one row
    entry = torch.where(live, src, slot)
    ray = entry // s
    # made on the device, no copy from the host: (0, 0, 0) and (0, 0, 1)
    axis = torch.arange(3, device=dev)
    xyz_c = torch.where(live[:, None], xyzs.reshape(-1, 3)[entry], 0.0)
    dir_c = torch.where(live[:, None], rays_d[ray],
                        (axis == 2).to(rays_d.dtype))
    if exposure is not None and exposure.shape[0] > 1:
        exposure = torch.where(live[:, None], exposure[ray], 1.0)
    if grad_noise is not None:
        if by_entry:
            grad_noise = grad_noise[entry]
        elif noise_start is None:
            grad_noise = grad_noise[:cap]
        else:
            grad_noise = grad_noise[torch.clamp_max(
                noise_start + torch.arange(cap, device=dev),
                grad_noise.shape[0] - 1)]
    sig, col = model(xyz_c, dir_c, exposure=exposure, grad_noise=grad_noise,
                     count=count)
    sig = sig.new_zeros(n * s + 1).index_put((src,), sig)[:n * s]
    col = col.new_zeros((n * s + 1, 3)).index_put((src,), col)[:n * s]
    return sig.reshape(n, s), col.reshape(n, s, 3)


class FlatBudget(NamedTuple):
    """:func:`flat_budget`'s cut of a march."""
    mask: torch.Tensor          # (N, S) the kept samples
    ts: torch.Tensor            # (N, S), 0 off the mask
    deltas: torch.Tensor        # (N, S), 0 off the mask
    cap: int                    # the capacity buffer's slots
    noise_start: torch.Tensor   # under a shard: kept samples before it


def flat_budget(mr, rcfg, shard=None):
    """The flat layout's budget on a training march ``mr``: the batch's
    samples in ray order, the first ``n_global * s_flat`` of them (N and
    the order the global batch's, the samples of the ranks before this one
    from ``shard.prefix``), and the capacity buffer's ``min(N S, budget)``
    slots that hold them."""
    mask = mr.mask
    n, s = mask.shape
    first = torch.cumsum(mr.n_samples, 0) - mr.n_samples
    n_glob, before = n, None
    if shard is not None:
        before = shard.prefix(mr.n_samples.sum())[0]
        first = first + before
        n_glob = shard.n_global
    budget = n_glob * rcfg.s_flat
    rank = torch.arange(s, device=mask.device)
    mask = mask & (first[:, None] + rank < budget)
    return FlatBudget(
        mask=mask, ts=torch.where(mask, mr.ts, 0.0),
        deltas=torch.where(mask, mr.deltas, 0.0), cap=min(n * s, budget),
        noise_start=None if before is None
        else torch.clamp_max(before, budget))


def _check_fresh(occ):
    if occ.derived_from is not occ.density_bitfield:
        raise ValueError("the occupancy's stage-A grids are stale: call "
                         "refresh_coarse(cfg) after editing the bitfield")


def train_strata(cfg, occ, rcfg):
    """The strata budget of the JAX ``render_train``'s march, or None for
    the exact march: the two-level march's where ``twolevel_stratum`` gives
    a stratum (one cascade, uniform steps), else the cascade march's where
    ``cascades_stratum`` does (several cascades, exponential steps)."""
    _check_fresh(occ)
    stratum = twolevel_stratum(rcfg.exp_step_factor, rcfg.max_samples,
                               cfg.scale, cfg.grid_size, cfg.cascades,
                               cfg.dir_norm)
    if stratum:
        return Strata(occ.stage_a, stratum, rcfg.s_strata, cfg.dir_norm)
    stratum, _ = cascades_stratum(rcfg.exp_step_factor, cfg.scale,
                                  cfg.cascades, dir_norm=cfg.dir_norm)
    if stratum:
        return Strata(occ.union_bits, stratum, rcfg.s_strata, cfg.dir_norm,
                      union=True)
    return None


def window_skip(cfg, occ, rcfg):
    """The serving window march's stage-A skip (``ray_march.WindowSkip``)
    on the two-level march's grid, where ``twolevel_stratum`` gives a
    stratum (one cascade, uniform steps), else None (every rung tested).
    Raises on stale grids."""
    _check_fresh(occ)
    stratum = twolevel_stratum(rcfg.exp_step_factor, rcfg.max_samples,
                               cfg.scale, cfg.grid_size, cfg.cascades,
                               cfg.dir_norm)
    return WindowSkip(occ.stage_a, stratum, cfg.dir_norm) if stratum else None


def serving_skip(cfg, occ, rcfg):
    """The skip the serving loop marches with: :func:`window_skip`, unless
    more than ``SKIP_MAX_SHARE`` of its stage-A cells are set (a dense
    grid, as an untrained field's: nearly every stratum is live, and
    walking every rung is faster). The share is read from the device once
    a derivation of the grid and kept in ``occ.stage_a_share``."""
    skip = window_skip(cfg, occ, rcfg)
    if skip is None:
        return None
    if occ.stage_a_share is None:
        occ.stage_a_share = float(skip.stage_a.float().mean())
    return skip if occ.stage_a_share <= SKIP_MAX_SHARE else None


def render_train(model, occ, rays_o, rays_d, noise, rcfg: RenderConfig,
                 bg_rgb=None, grad_noise=None, exposure=None, shard=None):
    """Differentiable rendering of a training ray batch.

    Args:
        rays_o, rays_d: (N, 3) world rays.
        noise: (N,) start jitter in [0, 1) (``jax.random.uniform`` in the JAX
            package; a tensor here, so callers choose the generator).
        bg_rgb: (3,) background for ``rcfg.random_bg`` on real scenes
            (synthetic scenes composite onto white, real ones onto black).
        grad_noise: the hash grids' sampled-corner uniforms (the JAX
            ``hash_grad_noise``); None for the exact table gradient.
            Without ``s_flat``: the JAX padded branch's draw, (N * S,
            hash_grad_samples), whose row e the sample at entry e of the
            (N, S) rows takes (under a shard, this rank's rows of the
            global draw). With ``s_flat``: the JAX flat branch's draw,
            (n_global * s_flat, hash_grad_samples), whose row j the
            batch's valid sample j takes (under a shard, counted over the
            global batch).
        exposure: (N, 1) each ray's exposure, for an HDR head
            (``rgb_act="None"``); a Sigmoid head ignores it.
        shard: under data parallelism, this rank's
            :class:`parallel.dist.Shard` of the global batch, whose rays
            these are: the flat budget then keeps the global batch's first
            ``n_global * s_flat`` samples in global ray order, as the JAX
            step's cumsum over the whole sharded batch does (the samples of
            the ranks before this one come from ``shard.prefix``). None:
            the batch is whole.
    Returns:
        dict(rgb, opacity, depth, ws, deltas, ts, mask, rm_samples,
        vr_samples); the sample counters are 0-d tensors.
    """
    cfg = model.cfg
    mr = march_rays_train(
        rays_o, rays_d, _scene_hits(model, rays_o, rays_d),
        occ.density_bitfield, cfg.cascades, cfg.scale, rcfg.exp_step_factor,
        cfg.grid_size, rcfg.max_samples, noise,
        rcfg.n_rungs(cfg.scale, cfg.grid_size), rcfg.s_max_train,
        strata=train_strata(cfg, occ, rcfg))
    mask, ts, deltas = mr.mask, mr.ts, mr.deltas
    if rcfg.s_flat:
        flat = flat_budget(mr, rcfg, shard)
        mask, ts, deltas = flat.mask, flat.ts, flat.deltas
        sigmas, rgbs = _eval_capacity(model, mr.xyzs, rays_d, mask, flat.cap,
                                      grad_noise, exposure, flat.noise_start)
    else:
        sigmas, rgbs = _eval_capacity(model, mr.xyzs, rays_d, mask,
                                      mask.numel(), grad_noise, exposure,
                                      by_entry=True)
    comp = composite_train(sigmas, rgbs, deltas, ts, mask, rcfg.T_threshold)
    if rcfg.exp_step_factor == 0:       # synthetic scenes: white background
        bg = 1.0
    elif rcfg.random_bg:
        if bg_rgb is None:
            raise ValueError("random_bg needs bg_rgb")
        bg = bg_rgb
    else:
        bg = 0.0
    return {
        "rgb": comp.rgb + bg * (1.0 - comp.opacity)[:, None],
        "opacity": comp.opacity, "depth": comp.depth, "ws": comp.ws,
        "deltas": deltas, "ts": ts, "mask": mask,
        "rm_samples": mr.rm_samples, "vr_samples": comp.vr_samples,
    }


def _with_background(rcfg, rgb, opacity):
    bg = 1.0 if rcfg.exp_step_factor == 0 else 0.0   # white / black
    return rgb + bg * (1.0 - opacity)[:, None]


def _exposure(exposure, device):
    """A view's exposure (a scalar, or None) as the (1, 1) tensor the field
    takes."""
    if exposure is None:
        return None
    return torch.as_tensor(exposure, dtype=torch.float32,
                           device=device).reshape(1, 1)


def _render_test_chunk(model, occ, rays_o, rays_d, rcfg, exposure=None):
    """One oracle chunk: composite every ray's occupied samples in
    ceil(max_samples / s_max_test) rank windows."""
    cfg = model.cfg
    hits_t = _scene_hits(model, rays_o, rays_d)
    n = rays_o.shape[0]
    dev = rays_o.device
    noise = torch.zeros((n,), device=dev)   # test marching is unjittered
    opacity = torch.zeros((n,), device=dev)
    depth = torch.zeros((n,), device=dev)
    rgb = torch.zeros((n, 3), device=dev)
    alive = hits_t[:, 0] >= 0
    vr = 0
    for j in range(-(-rcfg.max_samples // rcfg.s_max_test)):
        mr = march_rays_train(
            rays_o, rays_d, hits_t, occ.density_bitfield, cfg.cascades,
            cfg.scale, rcfg.exp_step_factor, cfg.grid_size, rcfg.max_samples,
            noise, rcfg.n_rungs(cfg.scale, cfg.grid_size, test=True),
            rcfg.s_max_test, dt_scale=rcfg._dt_scale(cfg.scale, True),
            rank_start=j * rcfg.s_max_test)
        # samples of dead rays are masked out by the compositing anyway
        sigmas, rgbs = _eval_valid(model, mr.xyzs, rays_d,
                                   mr.mask & alive[:, None],
                                   exposure=exposure)
        vr += int(torch.where(alive, mr.n_samples, 0).sum())
        opacity, depth, rgb, alive = composite_test_step(
            sigmas, rgbs, mr.deltas, mr.ts, mr.mask, opacity, depth, rgb,
            alive, rcfg.T_threshold)
    return rgb, opacity, depth, vr


@torch.no_grad()
def render_test_dense(model, occ, rays_o, rays_d, rcfg: RenderConfig,
                      exposure=None):
    """Dense oracle frame: dict(rgb, opacity, depth, total_samples).
    ``exposure``: the view's exposure for an HDR head (a scalar)."""
    outs = []
    total_samples = 0
    exposure = _exposure(exposure, rays_o.device)
    for i in range(0, rays_o.shape[0], rcfg.test_chunk):
        rgb, opacity, depth, vr = _render_test_chunk(
            model, occ, rays_o[i:i + rcfg.test_chunk],
            rays_d[i:i + rcfg.test_chunk], rcfg, exposure)
        outs.append((rgb, opacity, depth))
        total_samples += vr
    rgb, opacity, depth = (torch.cat(o) for o in zip(*outs))
    return {"rgb": _with_background(rcfg, rgb, opacity), "opacity": opacity,
            "depth": depth, "total_samples": total_samples}


@torch.no_grad()
def render_test(model, occ, rays_o, rays_d, rcfg: RenderConfig,
                exposure=None):
    """Serve one frame with the alive-ray loop.

    ``exposure``: the view's exposure for an HDR head (a scalar), as the
    JAX ``render_test(exposure=)``; a Sigmoid head ignores it.
    Returns dict(rgb (N, 3), opacity (N,), depth (N,), total_samples,
    rounds): ``total_samples`` counts the samples the field evaluated,
    ``rounds`` the loop's iterations.
    """
    rgb, opacity, depth, total, rounds = _render_alive(
        model, occ, rays_o, rays_d, rcfg, exposure)
    return {"rgb": _with_background(rcfg, rgb, opacity), "opacity": opacity,
            "depth": depth, "total_samples": int(total), "rounds": rounds}


@torch.no_grad()
def render_test_sharded(model, occ, rays_o, rays_d, rcfg: RenderConfig,
                        exposure=None, group=None):
    """Serve one frame with its rays split over the ranks of the process
    group: the port of the JAX ``render_test_sharded``
    (``mfnerf_tpu/models/rendering.py:1305-1361``), data parallelism over
    rays. Every rank passes the whole frame's rays; they are padded to a
    multiple of the world size W, each rank drains its contiguous slice
    with the alive-ray loop (the field and occupancy replicated, no
    collective inside the loop), and rgb, opacity, depth and the sample
    total are gathered, the padding cut off and the background added.
    The padding rays start outside the scene's box and point away from
    it, so they march nothing (the JAX padding marches from the centre and
    its samples count). The JAX rasterised prepass is a TPU device and is
    not ported. Every rank returns the whole frame: dict(rgb, opacity,
    depth, total_samples, rounds (this rank's))."""
    from ..parallel import dist as pdist
    rank, size = pdist.world(group)
    n = rays_o.shape[0]
    pad = (-n) % size
    if pad:
        far = 4.0 * SQRT3 * model.cfg.scale + 1.0
        rays_o = torch.cat([rays_o, rays_o.new_tensor(
            [0.0, 0.0, far]).expand(pad, 3)])
        rays_d = torch.cat([rays_d, rays_d.new_tensor(
            [0.0, 0.0, 1.0]).expand(pad, 3)])
    per = (n + pad) // size
    lo = rank * per
    rgb, opacity, depth, total, rounds = _render_alive(
        model, occ, rays_o[lo:lo + per], rays_d[lo:lo + per], rcfg, exposure)
    rgb, opacity, depth = (pdist.gather_rows(x, n + pad, lo, group)[:n]
                           for x in (rgb, opacity, depth))
    total = pdist.all_sum(total.clone(), group)
    return {"rgb": _with_background(rcfg, rgb, opacity), "opacity": opacity,
            "depth": depth, "total_samples": int(total), "rounds": rounds}


def _render_alive(model, occ, rays_o, rays_d, rcfg, exposure=None):
    """The alive-ray loop of :func:`render_test` without the background:
    (rgb, opacity, depth, samples evaluated as a 0-d tensor, rounds)."""
    cfg = model.cfg
    n = rays_o.shape[0]
    dev = rays_o.device
    exposure = _exposure(exposure, dev)
    rays_o, rays_d = rays_o.contiguous(), rays_d.contiguous()
    hits_t = _scene_hits(model, rays_o, rays_d)
    t_start, t2 = hits_t[:, 0].contiguous(), hits_t[:, 1].contiguous()
    k_total = rcfg.n_rungs(cfg.scale, cfg.grid_size, test=True)
    dt_scale = rcfg._dt_scale(cfg.scale, True)
    # the plain march on the CPU tests every rung: it needs no stage A
    skip = serving_skip(cfg, occ, rcfg) if dev.type == "cuda" else None

    opacity = torch.zeros((n,), device=dev)
    depth = torch.zeros((n,), device=dev)
    rgb = torch.zeros((n, 3), device=dev)
    cursor = torch.zeros((n,), dtype=torch.int64, device=dev)
    taken = torch.zeros((n,), dtype=torch.int64, device=dev)
    total = torch.zeros((), dtype=torch.int64, device=dev)
    alive = torch.nonzero(t_start >= 0).squeeze(1)
    rounds = 0
    while alive.numel():
        n_alive = alive.numel()
        s_cap = max(min(n // n_alive, 64), 1)
        window = min(k_total, max(s_cap, MARCH_BUDGET // n_alive))
        # the alive rows' cursors advance in place
        mr = march_rays_window_into(
            rays_o, rays_d, t_start, t2, cursor, alive,
            occ.density_bitfield, cfg.cascades, cfg.scale,
            rcfg.exp_step_factor, cfg.grid_size, rcfg.max_samples, window,
            s_cap, dt_scale, skip=skip)
        rd = rays_d[alive]
        # per-ray cap: a ray composites at most max_samples samples
        taken_a = taken[alive]
        room = rcfg.max_samples - taken_a
        mask = mr.mask & (torch.arange(s_cap, device=dev)[None, :]
                          < room[:, None])
        sigmas, rgbs = _eval_valid(model, mr.xyzs, rd, mask,
                                   exposure=exposure)
        # the frame's accumulators of the alive rows, updated in place
        transparent = composite_test_step_into(
            sigmas, rgbs, mr.deltas, mr.ts, mask, alive, opacity, depth, rgb,
            rcfg.T_threshold)
        emitted = mask.sum(dim=1)
        taken_a = taken_a + emitted
        taken[alive] = taken_a
        total += emitted.sum()
        keep = transparent & ~mr.exhausted & (mr.cursor < k_total) \
            & (taken_a < rcfg.max_samples)
        alive = alive[torch.nonzero(keep).squeeze(1)]
        rounds += 1
    return rgb, opacity, depth, total, rounds
