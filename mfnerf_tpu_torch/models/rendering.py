"""Rendering: the differentiable training renderer, the alive-ray test
renderer and its dense oracle.

Port of ``mfnerf_tpu/models/rendering.py``.

* :func:`render_train` is the JAX ``render_train``: the march with the
  stratified jitter and, on single-cascade synthetic scenes, the two-level
  march's strata budget (``ops/ray_march.py``; ``rcfg.s_strata`` strata a
  ray, taken evenly along it when it crosses more), the field on the valid
  samples only, ``composite_train`` and the background. With ``s_flat`` the
  batch keeps its first ``N * s_flat`` samples in ray order, as the JAX
  flat layout's budget does. The JAX neighbourhood-row tables and flat
  gathers are TPU devices; the samples are the same.
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
  exit, or at ``max_samples`` samples. The JAX package's round schedules,
  wavefront pool and rasterised prepass are TPU throughput devices and are
  not ported.
"""
import dataclasses
import math

import torch

from ..ops.composite import composite_test_step, composite_train
from ..ops.intersection import ray_aabb_intersect_single
from ..ops.ray_march import (Strata, march_rays_train, march_rays_window,
                             stage_a_grid, twolevel_stratum)
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
    s_strata: int = 32             # two-level march: live strata a ray
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
    s = model.cfg.scale
    return _clamp_near(ray_aabb_intersect_single(
        rays_o, rays_d, torch.zeros(3), torch.full((3,), s)))


def _eval_valid(model, xyzs, rays_d, mask, grad_noise=None):
    """Field on the valid samples of a (N, S) block; zeros elsewhere. The
    scatter is out of place, so autograd reaches the field in training.
    ``grad_noise``: the hash grids' per-sample uniforms for the valid
    samples in row-major order, or a function of their count that draws
    them."""
    n, s = mask.shape
    flat = torch.nonzero(mask.reshape(-1)).squeeze(1)
    if callable(grad_noise):
        grad_noise = grad_noise(flat.numel())
    sig, col = model(xyzs.reshape(-1, 3)[flat], rays_d[flat // s],
                     grad_noise=grad_noise)
    sigmas = sig.new_zeros(n * s).index_put((flat,), sig)
    rgbs = col.new_zeros((n * s, 3)).index_put((flat,), col)
    return sigmas.reshape(n, s), rgbs.reshape(n, s, 3)


def render_train(model, occ, rays_o, rays_d, noise, rcfg: RenderConfig,
                 bg_rgb=None, grad_noise=None):
    """Differentiable rendering of a training ray batch.

    Args:
        rays_o, rays_d: (N, 3) world rays.
        noise: (N,) start jitter in [0, 1) (``jax.random.uniform`` in the JAX
            package; a tensor here, so callers choose the generator).
        bg_rgb: (3,) background for ``rcfg.random_bg`` on real scenes
            (synthetic scenes composite onto white, real ones onto black).
        grad_noise: the hash grids' sampled-corner uniforms (the JAX
            ``hash_grad_noise``): (N_valid, hash_grad_samples) rows for the
            valid samples in row-major order of ``mask``, or a function of
            N_valid that draws them; None for the exact table gradient.
    Returns:
        dict(rgb, opacity, depth, ws, deltas, ts, mask, rm_samples,
        vr_samples); the sample counters are 0-d tensors.
    """
    cfg = model.cfg
    stratum = twolevel_stratum(rcfg.exp_step_factor, rcfg.max_samples,
                               cfg.scale, cfg.grid_size, cfg.cascades,
                               cfg.dir_norm)
    strata = None if not stratum else Strata(
        stage_a_grid(occ.density_bitfield, cfg.grid_size, cfg.pool_a or 2),
        stratum, rcfg.s_strata, cfg.dir_norm)
    mr = march_rays_train(
        rays_o, rays_d, _scene_hits(model, rays_o, rays_d),
        occ.density_bitfield, cfg.cascades, cfg.scale, rcfg.exp_step_factor,
        cfg.grid_size, rcfg.max_samples, noise,
        rcfg.n_rungs(cfg.scale, cfg.grid_size), rcfg.s_max_train,
        strata=strata)
    mask, ts, deltas = mr.mask, mr.ts, mr.deltas
    if rcfg.s_flat:
        # the flat layout's budget: the batch's samples in ray order, the
        # first N * s_flat of them
        n, s = mask.shape
        first = torch.cumsum(mr.n_samples, 0) - mr.n_samples
        rank = torch.arange(s, device=mask.device)
        mask = mask & (first[:, None] + rank < n * rcfg.s_flat)
        ts, deltas = torch.where(mask, ts, 0.0), torch.where(mask, deltas, 0.0)
    sigmas, rgbs = _eval_valid(model, mr.xyzs, rays_d, mask, grad_noise)
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


def _render_test_chunk(model, occ, rays_o, rays_d, rcfg):
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
                                   mr.mask & alive[:, None])
        vr += int(torch.where(alive, mr.n_samples, 0).sum())
        opacity, depth, rgb, alive = composite_test_step(
            sigmas, rgbs, mr.deltas, mr.ts, mr.mask, opacity, depth, rgb,
            alive, rcfg.T_threshold)
    return rgb, opacity, depth, vr


@torch.no_grad()
def render_test_dense(model, occ, rays_o, rays_d, rcfg: RenderConfig):
    """Dense oracle frame: dict(rgb, opacity, depth, total_samples)."""
    outs = []
    total_samples = 0
    for i in range(0, rays_o.shape[0], rcfg.test_chunk):
        rgb, opacity, depth, vr = _render_test_chunk(
            model, occ, rays_o[i:i + rcfg.test_chunk],
            rays_d[i:i + rcfg.test_chunk], rcfg)
        outs.append((rgb, opacity, depth))
        total_samples += vr
    rgb, opacity, depth = (torch.cat(o) for o in zip(*outs))
    return {"rgb": _with_background(rcfg, rgb, opacity), "opacity": opacity,
            "depth": depth, "total_samples": total_samples}


@torch.no_grad()
def render_test(model, occ, rays_o, rays_d, rcfg: RenderConfig):
    """Serve one frame with the alive-ray loop.

    Returns dict(rgb (N, 3), opacity (N,), depth (N,), total_samples,
    rounds): ``total_samples`` counts the samples the field evaluated,
    ``rounds`` the loop's iterations.
    """
    cfg = model.cfg
    n = rays_o.shape[0]
    dev = rays_o.device
    hits_t = _scene_hits(model, rays_o, rays_d)
    t_start, t2 = hits_t[:, 0], hits_t[:, 1]
    k_total = rcfg.n_rungs(cfg.scale, cfg.grid_size, test=True)
    dt_scale = rcfg._dt_scale(cfg.scale, True)

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
        rd = rays_d[alive]
        mr = march_rays_window(
            rays_o[alive], rd, t_start[alive], t2[alive], cursor[alive],
            occ.density_bitfield, cfg.cascades, cfg.scale,
            rcfg.exp_step_factor, cfg.grid_size, rcfg.max_samples, window,
            s_cap, dt_scale)
        # per-ray cap: a ray composites at most max_samples samples
        taken_a = taken[alive]
        room = rcfg.max_samples - taken_a
        mask = mr.mask & (torch.arange(s_cap, device=dev)[None, :]
                          < room[:, None])
        sigmas, rgbs = _eval_valid(model, mr.xyzs, rd, mask)
        op, de, co, transparent = composite_test_step(
            sigmas, rgbs, mr.deltas, mr.ts, mask, opacity[alive],
            depth[alive], rgb[alive], torch.ones_like(mask[:, 0]),
            rcfg.T_threshold)
        emitted = mask.sum(dim=1)
        opacity[alive], depth[alive], rgb[alive] = op, de, co
        cursor[alive] = mr.cursor
        taken_a = taken_a + emitted
        taken[alive] = taken_a
        total += emitted.sum()
        keep = transparent & ~mr.exhausted & (mr.cursor < k_total) \
            & (taken_a < rcfg.max_samples)
        alive = alive[torch.nonzero(keep).squeeze(1)]
        rounds += 1
    return {"rgb": _with_background(rcfg, rgb, opacity), "opacity": opacity,
            "depth": depth, "total_samples": int(total), "rounds": rounds}
