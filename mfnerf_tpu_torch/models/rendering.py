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
  alive-ray loop (``__render_rays_test``) on static capacity buffers, as
  the JAX ``_render_test_alive`` runs it in one dispatch: the frame's
  alive rays are compacted in ray order on the device (a cumsum and a
  searchsorted); a round whose alive count is a runs at the smallest
  alive tier C >= a (capacities halving from the frame's N rays down to
  ``ALIVE_FLOOR``), the rows past the count marching nothing; it marches
  up to ``s_cap = max(min(N // C, 64), 1)`` occupied samples per alive ray
  from its ladder cursor, in place on the frame's arrays
  (``march_rays_window_into``, at one cascade skipping the strata that the
  occupancy's stage-A grid proves empty where that grid is sparse:
  :func:`serving_skip`), evaluates the field on the smallest field tier
  holding the round's valid samples (slots halving from N down to
  ``FIELD_FLOOR``, through :func:`_eval_capacity`), and composites from
  ``1 - opacity``. A ray dies when its transmittance falls to
  ``T_threshold``, when its ladder passes the box exit, or at
  ``max_samples`` samples: the samples are those of the rung-by-rung
  march, whatever the rounds' windows. Two host reads a round (the valid
  and the alive count, a few bytes each) and one a frame; on the card
  each round's three steps replay CUDA graphs (:class:`ServingRunner`).
  The JAX package's round schedules, wavefront pool and rasterised prepass
  are TPU throughput devices and are not ported.
* :func:`render_test_sharded` serves a frame with its rays split over the
  ranks of a process group (``parallel/dist.py``).
"""
import collections
import dataclasses
import functools
import math
import weakref
from typing import NamedTuple

import torch

from ..ops.composite import (composite_test_step, composite_test_step_into,
                             composite_train)
from ..ops.intersection import ray_aabb_intersect_single
from ..ops.ray_march import (SKIP_MAX_SHARE, Strata, WindowMarchResults,
                             WindowSkip, cascades_stratum, march_rays_train,
                             march_rays_window_into, twolevel_stratum)
from ..ops.stepping import max_ladder_steps
from .ngp import NEAR_DISTANCE

MAX_SAMPLES = 1024
SQRT3 = 1.7320508075688772
# ladder rungs tested per alive-ray round: bounds the march's transient
# (N_alive, window) tensors; the window grows as rays die
MARCH_BUDGET = 1 << 25
# the serving rounds' alive tiers: capacities halve (rounded up) from the
# frame's rays down to the first at or below this floor; a round runs at
# the smallest tier that holds its alive rays
ALIVE_FLOOR = 1 << 12
# the field's tiers in a serving round: slots halve from the frame's rays
# down to the first at or below this floor; the field runs at the smallest
# tier that holds the round's valid samples
FIELD_FLOOR = 1 << 14
# frame sizes whose buffers and graphs a ServingRunner keeps (the test
# views' and an orbit's)
FRAMES_KEPT = 2


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
    dense oracle's; a host read). The scatter is out of
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
                   exposure=None, noise_start=None, by_entry=False, out=None):
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
    row e. ``exposure``: (N, 1) a ray, or (1, 1) for all. ``out``: (sigmas
    (N S + 1,), rgbs (N S + 1, 3)) fp32 buffers to write the outputs into
    in place (the serving rounds'; no autograd), else new tensors. Returns
    (sigmas (N, S), rgbs (N, S, 3))."""
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
    if out is None:
        sig = sig.new_zeros(n * s + 1).index_put((src,), sig)
        col = col.new_zeros((n * s + 1, 3)).index_put((src,), col)
    else:
        sig = out[0].zero_().index_put_((src,), sig.to(out[0].dtype))
        col = out[1].zero_().index_put_((src,), col.to(out[1].dtype))
    return sig[:n * s].reshape(n, s), col[:n * s].reshape(n, s, 3)


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
    a derivation of the grid (a host read) and kept in
    ``occ.stage_a_share``."""
    skip = window_skip(cfg, occ, rcfg)
    if skip is None:
        return None
    if occ.stage_a_share is None:
        occ.stage_a_share = _read(skip.stage_a.float().mean())
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


# ------------------------------------------------------------- serving
def _tiers(n, floor):
    """Capacities halving (rounded up) from ``n`` down to the first at or
    below ``floor``."""
    tiers = [n]
    while tiers[-1] > max(floor, 1):
        tiers.append(-(-tiers[-1] // 2))
    return tiers


def _tier(tiers, a):
    """The smallest of ``tiers`` at or above ``a``."""
    return next(c for c in reversed(tiers) if c >= a)


def _read(t):
    """``t``'s values on the host: one of the serving loop's host reads,
    counted in ``render_test.host_reads``. This read alone passes
    ``torch.cuda.set_sync_debug_mode``, so a frame served under "error"
    raises at any other sync."""
    render_test.host_reads += 1
    if not t.is_cuda:
        return t.tolist()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        return t.tolist()
    finally:
        torch.cuda.set_sync_debug_mode(mode)


class _Frame:
    """A served frame's static buffers for ``n`` rays: every round reads
    and writes these (and temporaries of its own), so that the rounds'
    CUDA graphs replay on any frame of this size."""

    def __init__(self, n, dev):
        f32, i64 = torch.float32, torch.int64
        self.n = n
        # the rays, their ladder bounds and cursors; row n is a sentinel, a
        # ray that marches nothing (its exit at -inf), which the alive index
        # holds past the alive count
        self.rays_o = torch.zeros((n + 1, 3), device=dev)
        self.rays_d = torch.zeros((n + 1, 3), device=dev)
        self.rays_d[n, 2] = 1.0
        self.t_start = torch.zeros((n + 1,), device=dev)
        self.t2 = torch.full((n + 1,), -math.inf, device=dev)
        self.cursor = torch.zeros((n + 1,), dtype=i64, device=dev)
        self.opacity = torch.zeros((n,), device=dev)
        self.depth = torch.zeros((n,), device=dev)
        self.rgb = torch.zeros((n, 3), device=dev)
        # the alive rows in ray order, then the sentinel, and the samples
        # each has composited so far
        self.alive = torch.full((n,), n, dtype=i64, device=dev)
        self.taken = torch.zeros((n,), dtype=i64, device=dev)
        # [alive count, samples evaluated]; the kernels read the count
        self.status = torch.zeros((2,), dtype=i64, device=dev)
        self.count = self.status[:1]
        self.valid = torch.zeros((1,), dtype=i64, device=dev)
        # a round's (C, s_cap) sample block in the first C s_cap entries
        # (C s_cap <= n at every tier), with each entry's ray direction
        self.block = WindowMarchResults(
            xyzs=torch.zeros((n, 3), device=dev),
            deltas=torch.zeros((n,), device=dev),
            ts=torch.zeros((n,), device=dev),
            mask=torch.zeros((n,), dtype=torch.bool, device=dev),
            n_samples=torch.zeros((n,), dtype=i64, device=dev),
            cursor=torch.zeros((n,), dtype=i64, device=dev),
            exhausted=torch.zeros((n,), dtype=torch.bool, device=dev),
            k_idx=torch.zeros((n,), dtype=i64, device=dev))
        self.dirs = torch.zeros((n, 3), device=dev)
        # the field's outputs in block order, and a drop entry n
        self.sigmas = torch.zeros((n + 1,), dtype=f32, device=dev)
        self.rgbs = torch.zeros((n + 1, 3), dtype=f32, device=dev)
        self.exposure = torch.ones((1, 1), device=dev)
        self.graphs = {}


class _Rounds:
    """The serving rounds of one frame on a :class:`_Frame`'s buffers, in
    the three steps that :class:`ServingRunner` captures (each also runs
    eagerly, as on the CPU):

    * :meth:`march` at alive tier C: the window march of the frame's alive
      rows ``alive[:C]`` with the alive count (the rows past it march
      nothing), ``s_cap`` and the window of the eager loop's rule at C,
      into the sample block; the per-ray cap of ``max_samples``; each
      entry's direction; the valid count;
    * :meth:`field` at field tier F: the field on F slots through
      :func:`_eval_capacity` with the valid count (the encoder kernels skip
      the slots past it), its outputs written back into the block;
    * :meth:`composite` at alive tier C: the compositing round of the
      alive rows into the frame's accumulators with the alive count, the
      samples' total, and the next round's alive rows compacted in ray
      order (a cumsum and a searchsorted, as ``_eval_capacity`` does) with
      their count.
    """

    def __init__(self, model, occ, rcfg, frame, skip, exposure):
        cfg = model.cfg
        self.model, self.cfg, self.rcfg, self.f = model, cfg, rcfg, frame
        self.bits, self.skip = occ.density_bitfield, skip
        self.exposure = frame.exposure if exposure else None
        self.k_total = rcfg.n_rungs(cfg.scale, cfg.grid_size, test=True)
        self.dt_scale = rcfg._dt_scale(cfg.scale, True)
        self.alive_tiers = _tiers(frame.n, ALIVE_FLOOR)
        self.field_tiers = _tiers(frame.n, FIELD_FLOOR)

    def shape(self, c):
        """(s_cap, window) of a round at alive tier ``c``."""
        s_cap = max(min(self.f.n // c, 64), 1)
        return s_cap, min(self.k_total, max(s_cap, MARCH_BUDGET // c))

    def block(self, c):
        """The sample block of a round at alive tier ``c``, (C, s_cap)."""
        s_cap, _ = self.shape(c)
        m, b = c * s_cap, self.f.block
        return WindowMarchResults(
            xyzs=b.xyzs[:m].view(c, s_cap, 3),
            deltas=b.deltas[:m].view(c, s_cap), ts=b.ts[:m].view(c, s_cap),
            mask=b.mask[:m].view(c, s_cap), n_samples=b.n_samples[:c],
            cursor=b.cursor[:c], exhausted=b.exhausted[:c],
            k_idx=b.k_idx[:m].view(c, s_cap))

    def setup(self, rays_o, rays_d, exposure):
        """Load a frame: its rays, their box hits, zeroed cursors and
        accumulators, the rays that hit the box alive."""
        f, n = self.f, self.f.n
        f.rays_o[:n] = rays_o
        f.rays_d[:n] = rays_d
        hits_t = _scene_hits(self.model, rays_o, rays_d)
        f.t_start[:n] = hits_t[:, 0]
        f.t2[:n] = hits_t[:, 1]
        for t in (f.cursor, f.opacity, f.depth, f.rgb, f.taken, f.status):
            t.zero_()
        self._compact(hits_t[:, 0] >= 0,
                      torch.arange(n, device=rays_o.device), f.taken)
        if exposure is not None:
            if torch.is_tensor(exposure) and exposure.is_cuda:
                f.exposure.copy_(exposure.reshape(1, 1))
            else:
                f.exposure.fill_(float(torch.as_tensor(exposure).reshape(())))

    def _compact(self, keep, rows, taken):
        """The next alive rows: ``rows[j]`` where ``keep[j]``, in order,
        then the sentinel; their ``taken``; their count."""
        f, c = self.f, keep.shape[0]
        csum = torch.cumsum(keep, 0)
        src = torch.searchsorted(csum, torch.arange(1, c + 1,
                                                    device=keep.device))
        kept = src < c
        src = torch.clamp_max(src, c - 1)
        f.alive[:c] = torch.where(kept, rows[src], f.n)
        f.taken[:c] = torch.where(kept, taken[src], 0)
        f.count.copy_(csum[-1:])

    def march(self, c):
        f, cfg, rcfg = self.f, self.cfg, self.rcfg
        s_cap, window = self.shape(c)
        out = self.block(c)
        march_rays_window_into(
            f.rays_o, f.rays_d, f.t_start, f.t2, f.cursor, f.alive[:c],
            self.bits, cfg.cascades, cfg.scale, rcfg.exp_step_factor,
            cfg.grid_size, rcfg.max_samples, window, s_cap, self.dt_scale,
            skip=self.skip, count=f.count, out=out)
        # per-ray cap: a ray composites at most max_samples samples
        room = rcfg.max_samples - f.taken[:c]
        out.mask.logical_and_(torch.arange(s_cap, device=room.device)[None, :]
                              < room[:, None])
        m = c * s_cap
        f.block.mask[m:] = False
        f.dirs[:m].view(c, s_cap, 3).copy_(
            f.rays_d[f.alive[:c]][:, None, :].expand(c, s_cap, 3))
        f.valid.copy_(out.mask.sum().reshape(1))

    def field(self, slots):
        f, n = self.f, self.f.n
        _eval_capacity(self.model, f.block.xyzs.view(n, 1, 3), f.dirs,
                       f.block.mask.view(n, 1), slots,
                       exposure=self.exposure, out=(f.sigmas, f.rgbs))

    def composite(self, c):
        f, rcfg = self.f, self.rcfg
        s_cap, _ = self.shape(c)
        m, out = c * s_cap, self.block(c)
        transparent = composite_test_step_into(
            f.sigmas[:m].view(c, s_cap), f.rgbs[:m].view(c, s_cap, 3),
            out.deltas, out.ts, out.mask, f.alive[:c], f.opacity, f.depth,
            f.rgb, rcfg.T_threshold, count=f.count)
        emitted = out.mask.sum(dim=1)
        taken = f.taken[:c] + emitted
        f.status[1:] += emitted.sum()
        keep = transparent & ~out.exhausted & (out.cursor < self.k_total) \
            & (taken < rcfg.max_samples)
        self._compact(keep, f.alive[:c], taken)


def launch_counters():
    """The hand kernels' wrappers, each with its ``launches`` count."""
    from ..ops import composite, hashgrid, hatmul, linetable, ray_march
    return (hatmul.hat_prod, hatmul.hat_prod_bwd, hashgrid.hashgrid_encode,
            hashgrid.hashgrid_bwd, ray_march.march_rays_train,
            ray_march.march_rays_window, composite.composite_train,
            composite.composite_train_bwd, composite.composite_test_step,
            linetable.table_lerp, linetable.hat_basis_dw)


def capture_graph(fn, stream, generator=None):
    """(graph, ``fn``'s output inside it, the launches its capture
    recorded a wrapper): ``fn`` captured as a CUDA graph on ``stream`` (a
    memory pool of its own; ``generator`` registered with the graph, so
    that each replay draws from it anew). The recorded launches are taken
    off the wrappers' counts: :func:`replay_graph` adds them back a
    replay. A capture that fails, or meets a host sync, raises."""
    counters = launch_counters()
    before = [f.launches for f in counters]
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    with torch.cuda.graph(graph, stream=stream):
        out = fn()
    launches = {f: f.launches - n for f, n in zip(counters, before)
                if f.launches != n}
    for f, n in zip(counters, before):
        f.launches = n
    return graph, out, launches


def replay_graph(graph, launches):
    """Replay ``graph``, adding the launches its capture recorded to the
    wrappers' counts, as an eager run would."""
    graph.replay()
    for f, n in launches.items():
        f.launches += n


def side_stream_run(stream, fn, device):
    """``fn()`` eagerly on ``stream`` (a capture's warm-up), ordered after
    and before the current stream of ``device``."""
    cur = torch.cuda.current_stream(device)
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        out = fn()
    cur.wait_stream(stream)
    return out


class ServingRunner:
    """The JAX one-dispatch frame (``_render_test_alive``,
    ``mfnerf_tpu/models/rendering.py:528-557``) on the card:
    :func:`render_test`'s rounds on a frame's static capacity buffers
    (:class:`_Frame`), each step of :class:`_Rounds` captured once as a
    CUDA graph and replayed: the march of each alive tier (and skip or
    walk), the field of each field tier (with or without an exposure) and
    the composite of each alive tier, two host reads a round (the valid
    count, which picks the field tier, and the alive count, which picks
    the next alive tier and ends the loop) and one a frame.

    A graph is captured where its shape first runs, after that round's
    step has run eagerly on a side stream (PyTorch's warm-up); the eager
    run is the round's own. Each graph has a memory pool of its own. The
    buffers and graphs of the last two frame sizes are kept
    (``FRAMES_KEPT``); every graph is dropped when a tensor they read is
    replaced (the parameters, the bitfield, the stage-A grid), which
    :meth:`bind` checks a frame; the exposure is copied into its buffer.
    Replays add the launches their capture recorded to the wrappers'
    ``launches``. A capture that fails or meets a host sync raises: nothing
    falls back to the eager rounds."""

    def __init__(self, device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.frames = collections.OrderedDict()    # rays -> _Frame
        self.reads = None

    def bind(self, model, occ):
        """Drop every graph if a tensor they read was replaced."""
        reads = tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in (
            *model.parameters(), *model.buffers(), occ.density_bitfield,
            occ.stage_a) if t is not None)
        if reads != self.reads:
            while self.frames:
                self._drop(self.frames.popitem()[1])
            self.reads = reads

    @staticmethod
    def _drop(frame):
        for graph, _ in frame.graphs.values():
            graph.reset()
        frame.graphs.clear()

    def frame(self, n, device):
        """The buffers of a frame of ``n`` rays (the most recent size last;
        the oldest beyond FRAMES_KEPT dropped)."""
        frame = self.frames.pop(n, None)
        if frame is None:
            while len(self.frames) >= FRAMES_KEPT:
                self._drop(self.frames.popitem(last=False)[1])
            torch.cuda.empty_cache()
            frame = _Frame(n, device)
        self.frames[n] = frame
        return frame

    def run(self, frame, key, fn):
        """Replay ``frame``'s graph of ``key``, or run ``fn`` eagerly on the
        side stream and capture it."""
        entry = frame.graphs.get(key)
        if entry is None:
            side_stream_run(self.stream, fn, self.device)
            graph, _, launches = capture_graph(fn, self.stream)
            frame.graphs[key] = (graph, launches)
        else:
            replay_graph(*entry)


def serving_runner(model, device):
    """The :class:`ServingRunner` of ``model`` on the card (made on first
    use, kept while the model lives)."""
    runner = _RUNNERS.get(model)
    if runner is None:
        runner = _RUNNERS[model] = ServingRunner(device)
    return runner


_RUNNERS = weakref.WeakKeyDictionary()


def _runner_for(model, rays_o, graphs):
    """The model's :class:`ServingRunner` for a frame on the card with
    ``graphs``, else None (eager rounds)."""
    dev = rays_o.device
    return serving_runner(model, dev) if graphs and dev.type == "cuda" \
        else None


def _render_rounds(model, occ, rays_o, rays_d, rcfg, exposure, runner):
    """The serving rounds of a frame without the background: (rgb,
    opacity, depth, samples evaluated, rounds), the first three the
    frame buffers'. With a ``runner`` the steps replay its graphs; else
    they run eagerly."""
    n, dev = rays_o.shape[0], rays_o.device
    if n == 0:
        empty = torch.zeros((0,), device=dev)
        return torch.zeros((0, 3), device=dev), empty, empty, 0, 0
    if runner is None:
        frame = _Frame(n, dev)

        def run(key, fn):
            fn()
    else:
        runner.bind(model, occ)
        frame = runner.frame(n, dev)

        def run(key, fn):
            runner.run(frame, key, fn)
    # the plain march on the CPU tests every rung: it needs no stage A
    skip = serving_skip(model.cfg, occ, rcfg) if dev.type == "cuda" \
        else None
    rounds = _Rounds(model, occ, rcfg, frame, skip, exposure is not None)
    rounds.setup(rays_o.contiguous(), rays_d.contiguous(), exposure)
    alive, total = _read(frame.status)
    n_rounds = 0
    while alive:
        c = _tier(rounds.alive_tiers, alive)
        run(("march", rcfg, c, skip is not None),
            functools.partial(rounds.march, c))
        slots = _tier(rounds.field_tiers, _read(frame.valid)[0])
        run(("field", slots, exposure is not None),
            functools.partial(rounds.field, slots))
        run(("composite", rcfg, c), functools.partial(rounds.composite, c))
        alive, total = _read(frame.status)
        n_rounds += 1
    return frame.rgb, frame.opacity, frame.depth, total, n_rounds


@torch.no_grad()
def render_test(model, occ, rays_o, rays_d, rcfg: RenderConfig,
                exposure=None, graphs=True):
    """Serve one frame with the alive-ray rounds on capacity buffers.

    ``exposure``: the view's exposure for an HDR head (a scalar), as the
    JAX ``render_test(exposure=)``; a Sigmoid head ignores it. On the card
    the rounds replay the model's CUDA graphs (:class:`ServingRunner`);
    ``graphs=False`` runs the same rounds eagerly (a check's reference).
    Returns dict(rgb (N, 3), opacity (N,), depth (N,), total_samples,
    rounds): ``total_samples`` counts the samples the field evaluated,
    ``rounds`` the loop's iterations.
    """
    rgb, opacity, depth, total, rounds = _render_rounds(
        model, occ, rays_o, rays_d, rcfg, exposure,
        _runner_for(model, rays_o, graphs))
    return {"rgb": _with_background(rcfg, rgb, opacity),
            "opacity": opacity.clone(), "depth": depth.clone(),
            "total_samples": total, "rounds": rounds}


render_test.host_reads = 0


@torch.no_grad()
def render_test_sharded(model, occ, rays_o, rays_d, rcfg: RenderConfig,
                        exposure=None, group=None):
    """Serve one frame with its rays split over the ranks of the process
    group: the port of the JAX ``render_test_sharded``
    (``mfnerf_tpu/models/rendering.py:1305-1361``), data parallelism over
    rays. Every rank passes the whole frame's rays; they are padded to a
    multiple of the world size W, each rank serves its contiguous slice
    with :func:`render_test`'s rounds (the field and occupancy replicated,
    no collective inside the loop), and rgb, opacity, depth and the sample
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
    rgb, opacity, depth, total, rounds = _render_rounds(
        model, occ, rays_o[lo:lo + per], rays_d[lo:lo + per], rcfg, exposure,
        _runner_for(model, rays_o, True))
    rgb, opacity, depth = (pdist.gather_rows(x, n + pad, lo, group)[:n]
                           for x in (rgb, opacity, depth))
    total = pdist.all_sum(torch.tensor([total], device=rays_o.device), group)
    return {"rgb": _with_background(rcfg, rgb, opacity), "opacity": opacity,
            "depth": depth, "total_samples": int(total), "rounds": rounds}
