"""The port's training slice against the JAX package, on the CPU.

Each test draws its inputs with numpy from a seed and hands the same arrays
to the JAX function and to its port; the JAX side runs op by op
(``jax.disable_jit``) where a march is involved (see
tests/test_torch_render.py). Tolerances:

* hat-product backward (dW, du): rtol 1e-4 with atol 1e-4 of the largest
  value. Both sides round the same operands and g_d to bf16 and accumulate
  in fp32; only the summation order differs. du is exactly 0 on the knots.
* trunc_exp, compositing, distortion loss, learning rate, Adam: 1e-6
  relative (float32 elementwise ops and short sums).
* a whole training step (render_train + NeRFLoss, loss and every parameter
  gradient) with the unfused fp32 encoder: loss 1e-5 relative, gradients
  rtol 1e-4 with atol 1e-5 of the tensor's largest value (sums over
  thousands of samples in another order). With the fused bf16 encoder the
  step runs on the rays whose samples have the same bf16 hat bases on both
  sides (tests/test_torch_field.py's rotation-rounding exception), which
  must be nearly all of them, with the hat backward's atol (an ulp of the
  cotangent from the MLP backward can move a g_d across a bf16 step).
* render_train against the JAX render_train: rgb, opacity, depth 1e-5 on
  the rays whose sample counts agree.
* occupancy refresh: 1e-4, the bitfield bit for bit away from the threshold.
"""
import argparse
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mfnerf_tpu import losses as jlosses
from mfnerf_tpu import train as jtrain
from mfnerf_tpu.models import ngp as jngp
from mfnerf_tpu.models import rendering as jrendering
from mfnerf_tpu.ops import activations as jact
from mfnerf_tpu.ops import composite as jcomposite
from mfnerf_tpu.ops import hatmul as jhatmul
from mfnerf_tpu.ops import intersection as jinter
from mfnerf_tpu.ops import lowrank as jlowrank
from mfnerf_tpu.ops import ray_march as jmarch
from mfnerf_tpu.utils.procedural import make_scene as jmake_scene

from mfnerf_tpu_torch import losses as tlosses
from mfnerf_tpu_torch import train as ttrain
from mfnerf_tpu_torch.datasets.memory import MemoryDataset
from mfnerf_tpu_torch.models import ngp as tngp
from mfnerf_tpu_torch.models import rendering as trendering
from mfnerf_tpu_torch.ops import composite as tcomposite
from mfnerf_tpu_torch.ops import hatmul as thatmul
from mfnerf_tpu_torch.ops.activations import trunc_exp as t_trunc_exp
from mfnerf_tpu_torch.utils.ckpt import params_from_numpy
from mfnerf_tpu_torch.utils.procedural import make_scene

from test_torch_field import _same_bf16_basis

SMALL = dict(lr_levels=2, lr_rank=8, lr_k_max=64, grid_size=32,
             rgb_channels=16, rgb_layers=1)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread. The suite runs in several worker processes, and
    torch's default of one thread per core oversubscribes the CPU; the
    per-op thread barriers of these many small ops then stall."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))     # a writable, contiguous copy


def _close(got, want, rtol=1e-4, rel_atol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rel_atol * float(np.abs(want).max()))


# ------------------------------------------------------ hat-product backward
def _hat_operands(k, kp, r, n, seed=7):
    rng = np.random.default_rng(seed)
    u3 = rng.random((n, 3), dtype=np.float32)
    u3[:5] = 1.0          # the last knot
    u3[5:10] = 0.0
    u3[10:20] = np.float32(np.round(u3[10:20] * (k - 1)) / (k - 1))  # knots
    w = (1.0 + 0.3 * rng.normal(size=(3, kp, r))).astype(np.float32)
    w[:, k:, :] = 0.0     # rows past the knot count are zero padding
    g = rng.normal(size=(n, r)).astype(np.float32)
    pos = u3 * np.float32(k - 1)
    return u3, w, g, pos == np.floor(pos)


@pytest.mark.parametrize("ref", ["pallas_interpret", "xla_twin"])
@pytest.mark.parametrize("k,kp,r,n", [(65, 128, 16, jhatmul.TN + 37),
                                      (257, 384, 128, 600)])
def test_hat_prod_bwd_matches_jax(k, kp, r, n, ref):
    u3, w, g, knot = _hat_operands(k, kp, r, n)
    assert knot[:20].all() and not knot[20:].any()
    if ref == "pallas_interpret":
        _, vjp = jax.vjp(lambda u, w_: jhatmul.hat_prod(u, w_, k, True),
                         jnp.asarray(u3), jnp.asarray(w))
    else:
        _, vjp = jax.vjp(lambda u, w_: jlowrank._hat_cp_prod(
            u, w_, k, jnp.bfloat16), jnp.asarray(u3), jnp.asarray(w[:, :k]))
    du_j, dw_j = (np.asarray(x) for x in vjp(jnp.asarray(g)))
    assert (dw_j[:, k:] == 0).all()

    du_p, dw_p = thatmul.hat_prod_bwd_plain(_t(u3), _t(w[:, :k]), k, _t(g))
    uu = _t(u3).requires_grad_()
    ww = _t(w[:, :k]).requires_grad_()
    thatmul.hat_prod(uu, ww, k).backward(_t(g))
    for du, dw in ((du_p, dw_p), (uu.grad, ww.grad)):
        _close(dw.numpy(), dw_j[:, :k])
        _close(du.numpy(), du_j)
        assert (du.numpy()[knot] == 0).all() and (du_j[knot] == 0).all()
    assert thatmul.hat_prod.launches == thatmul.hat_prod_bwd.launches == 0


@pytest.mark.parametrize("u0", [0.5, 1.0, 0.375])
def test_hat_prod_gradient_is_zero_on_knots(u0):
    """d(out.sum())/du at a knot is the hat's subgradient 0, as in the JAX
    VJP; torch autograd through the dense basis gave 3.962 at u = 0.5 and
    -4.031 at u = 1 (K = 5)."""
    k = 5
    rng = np.random.default_rng(0)
    u3 = rng.random((1, 3), dtype=np.float32)
    u3[0, 0] = u0
    w = rng.normal(size=(3, k, 8)).astype(np.float32)
    _, vjp = jax.vjp(lambda u: jlowrank._hat_cp_prod(u, jnp.asarray(w), k,
                                                     jnp.bfloat16),
                     jnp.asarray(u3))
    want = float(np.asarray(vjp(jnp.ones((1, 8), jnp.float32))[0])[0, 0])
    uu = _t(u3).requires_grad_()
    thatmul.hat_prod(uu, _t(w), k).sum().backward()
    got = float(uu.grad[0, 0])
    if u0 in (0.5, 1.0):
        assert got == want == 0.0
    else:
        assert want != 0.0
        np.testing.assert_allclose(got, want, rtol=1e-4)


def test_trunc_exp_gradient_matches_jax():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.normal(scale=8, size=500),
                        [-100.0, -15.5, -15.0, 15.0, 15.5, 100.0]]
                       ).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    y_j, vjp = jax.vjp(jact.trunc_exp, jnp.asarray(x))
    xx = _t(x).requires_grad_()
    y = t_trunc_exp(xx)
    y.backward(_t(g))
    # exp(-100) is subnormal: one side may flush it to zero
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               rtol=1e-6, atol=1e-37)
    np.testing.assert_allclose(xx.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(g))[0]), rtol=1e-6)
    # the cotangent's factor is clamped at |x| = 15 where exp(x) is not
    factor = xx.grad.numpy()[-6:] / g[-6:]
    assert factor[0] == factor[1] == factor[2] and np.ptp(factor[3:]) == 0
    assert y[-1] == np.inf and np.isfinite(factor).all()


# ---------------------------------------------------- compositing and losses
def _rows(seed=4, n=64, s=24):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, s + 1, n)
    mask = np.arange(s)[None, :] < counts[:, None]
    sigmas = rng.exponential(8.0, (n, s)).astype(np.float32)
    sigmas[0, 3] = 1e4      # sigma * delta = 100: 1 - alpha == 0 exactly
    mask[0, :6] = True
    deltas = np.where(mask, rng.uniform(5e-3, 2e-2, (n, s)), 0
                      ).astype(np.float32)
    ts = np.where(mask, np.cumsum(deltas, axis=1) + 0.1, 0).astype(np.float32)
    rgbs = rng.random((n, s, 3), dtype=np.float32)
    return sigmas, rgbs, deltas, ts, mask, rng


def test_composite_train_and_distortion_match_jax():
    sigmas, rgbs, deltas, ts, mask, rng = _rows()
    assert sigmas[0, 3] * deltas[0, 3] > 90
    c_op, c_de = (rng.normal(size=64).astype(np.float32) for _ in range(2))
    c_rgb = rng.normal(size=(64, 3)).astype(np.float32)

    def objective(comp, dist, to):
        return ((comp.opacity * to(c_op)).sum()
                + (comp.depth * to(c_de)).sum()
                + (comp.rgb * to(c_rgb)).sum() + (dist * to(c_de)).sum())

    def jax_fn(sig, col):
        comp = jcomposite.composite_train(sig, col, deltas, ts, mask)
        dist = jlosses.distortion_loss(comp.ws, deltas, ts, mask)
        return objective(comp, dist, jnp.asarray), (comp, dist)

    (val_j, (comp_j, dist_j)), grads_j = jax.value_and_grad(
        jax_fn, argnums=(0, 1), has_aux=True)(jnp.asarray(sigmas),
                                              jnp.asarray(rgbs))
    sig = _t(sigmas).requires_grad_()
    col = _t(rgbs).requires_grad_()
    comp = tcomposite.composite_train(sig, col, _t(deltas), _t(ts),
                                      _t(mask))
    dist = tlosses.distortion_loss(comp.ws, _t(deltas), _t(ts), _t(mask))
    objective(comp, dist, _t).backward()
    for name in ("opacity", "depth", "rgb", "ws"):
        np.testing.assert_allclose(getattr(comp, name).detach().numpy(),
                                   np.asarray(getattr(comp_j, name)),
                                   rtol=1e-6, atol=1e-6)
    assert int(comp.vr_samples) == int(comp_j.vr_samples)
    np.testing.assert_allclose(dist.detach().numpy(), np.asarray(dist_j),
                               rtol=1e-5, atol=1e-7)
    for got, want in ((sig.grad, grads_j[0]), (col.grad, grads_j[1])):
        _close(got.numpy(), want, rtol=1e-5, rel_atol=1e-6)
    # the opaque sample ends its ray: nothing behind it weighs or learns
    assert comp.ws[0, 4:].abs().max() == 0
    assert sig.grad[0, 4:].abs().max() == 0 and np.isfinite(
        sig.grad.numpy()).all()


def test_nerf_loss_matches_jax():
    sigmas, rgbs, deltas, ts, mask, rng = _rows(seed=5)
    comp = jcomposite.composite_train(jnp.asarray(sigmas), jnp.asarray(rgbs),
                                      deltas, ts, mask)
    res_j = {"rgb": comp.rgb, "opacity": comp.opacity, "ws": comp.ws,
             "deltas": deltas, "ts": ts, "mask": mask}
    res_t = {k: _t(np.array(v)) for k, v in res_j.items()}
    target = rng.random((64, 3), dtype=np.float32)
    want = jlosses.NeRFLoss()(res_j, {"rgb": jnp.asarray(target)})
    got = tlosses.NeRFLoss()(res_t, {"rgb": _t(target)})
    assert set(got) == set(want) == {"rgb", "opacity", "distortion"}
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-9)


# ------------------------------------------------------ a whole training step
def _models(seed=0, **kw):
    cfg = dict(SMALL, **kw)
    jmodel = jngp.NGP(jngp.NGPConfig(grid="LowRank", **cfg))
    params = jmodel.init(jax.random.PRNGKey(seed))
    tmodel = tngp.NGP(tngp.NGPConfig(**cfg))
    tmodel.load_state_dict(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params)))
    return jmodel, params, tmodel


def _batch(n=128, seed=0, fill=0x33, grid=32):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 256, grid ** 3 // 8, dtype=np.uint8) \
        & np.uint8(fill)
    rays_o = np.tile(np.float32([[0.0, 0.0, -1.4]]), (n, 1))
    d = rng.normal(size=(n, 3)).astype(np.float32) \
        * np.float32([0.3, 0.3, 0.0]) + np.float32([0.0, 0.0, 1.0])
    rays_d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    rays_d[::17] = np.float32([0.0, 0.0, -1.0])          # a few misses
    noise = rng.random(n, dtype=np.float32)
    target = rng.random((n, 3), dtype=np.float32)
    return bits, rays_o, rays_d, noise, target


def _jax_step(jmodel, params, bits, rays_o, rays_d, noise, target, rcfg,
              loss_mod):
    """The padded branch of the JAX render_train, assembled from the JAX
    package's own functions, then NeRFLoss: (loss, grads, mask).

    The march runs op by op (see the module docstring). So does the fused
    encoder's step: under jit XLA fuses frame 1's rotation and rounds it
    otherwise, which moves many more bf16 hat weights than the exception
    (computed op by op) admits. The unfused fp32 step runs under jit."""
    cfg = jmodel.cfg
    ro, rd = jnp.asarray(rays_o), jnp.asarray(rays_d)
    with jax.disable_jit():
        hits = jrendering._clamp_near(jinter.ray_aabb_intersect_single(
            ro, rd, jnp.zeros(3), jnp.full(3, cfg.scale)))
        mr = jmarch.march_rays_train(
            ro, rd, hits, jnp.asarray(bits), cfg.cascades, cfg.scale,
            rcfg.exp_step_factor, cfg.grid_size, rcfg.max_samples,
            jnp.asarray(noise), rcfg.n_rungs(cfg.scale, cfg.grid_size),
            rcfg.s_max_train)
    n, s = mr.ts.shape

    def loss_fn(p):
        sig, col = jmodel(p, mr.xyzs.reshape(n * s, 3), jnp.broadcast_to(
            mr.dirs[:, None, :], (n, s, 3)).reshape(-1, 3))
        sig = jnp.where(mr.mask.reshape(-1), sig, 0.0).reshape(n, s)
        comp = jcomposite.composite_train(sig, col.reshape(n, s, 3),
                                          mr.deltas, mr.ts, mr.mask,
                                          rcfg.T_threshold)
        results = {"rgb": comp.rgb + (1.0 - comp.opacity)[:, None],
                   "opacity": comp.opacity, "ws": comp.ws,
                   "deltas": mr.deltas, "ts": mr.ts, "mask": mr.mask}
        return sum(v.mean() for v in loss_mod(
            results, {"rgb": jnp.asarray(target)}).values())

    step = jax.value_and_grad(loss_fn)
    if cfg.lr_fused:
        with jax.disable_jit():
            loss, grads = step(params)
    else:
        loss, grads = jax.jit(step)(params)
    return float(loss), grads, np.asarray(mr.mask)


def _torch_step(tmodel, bits, rays_o, rays_d, noise, target, rcfg, loss_mod):
    occ = tngp.OccupancyState.create(tmodel.cfg)
    occ.density_bitfield = _t(bits)
    tmodel.zero_grad(set_to_none=True)
    res = trendering.render_train(tmodel, occ, _t(rays_o), _t(rays_d),
                                  _t(noise), rcfg)
    loss = sum(v.mean() for v in loss_mod(
        res, {"rgb": _t(target)}).values())
    loss.backward()
    grads = {k: p.grad.numpy() for k, p in tmodel.named_parameters()}
    return float(loss.detach()), grads, res


@pytest.mark.parametrize("fused", [False, True])
def test_train_step_matches_jax(fused):
    jmodel, params, tmodel = _models(lr_fused=fused)
    bits, rays_o, rays_d, noise, target = _batch()
    rcfg_kw = dict(s_max_train=32, max_samples=256)
    rcfg_j = jrendering.RenderConfig(**rcfg_kw)
    rcfg_t = trendering.RenderConfig(**rcfg_kw)
    loss_j_mod = jlosses.NeRFLoss()
    loss_t_mod = tlosses.NeRFLoss()
    if fused:
        # keep the rays whose bf16 hat bases agree on both sides
        occ = tngp.OccupancyState.create(tmodel.cfg)
        occ.density_bitfield = _t(bits)
        with torch.no_grad():
            mr = trendering.march_rays_train(
                _t(rays_o), _t(rays_d),
                trendering._scene_hits(tmodel, _t(rays_o), _t(rays_d)),
                occ.density_bitfield, 1, 0.5, 0.0, 32, rcfg_t.max_samples,
                _t(noise), rcfg_t.n_rungs(0.5, 32), rcfg_t.s_max_train)
        mask = mr.mask.numpy()
        same = np.ones(mask.shape, bool)
        same[mask] = _same_bf16_basis(
            np.clip(mr.xyzs.numpy()[mask] + 0.5, 0, 1).astype(np.float32),
            tmodel.lowrank_cfg)
        keep = same.all(axis=1)
        assert keep.mean() > 0.9, keep.mean()
        rays_o, rays_d, noise, target = (x[keep] for x in
                                         (rays_o, rays_d, noise, target))
    loss_j, grads_j, mask_j = _jax_step(jmodel, params, bits, rays_o, rays_d,
                                        noise, target, rcfg_j, loss_j_mod)
    loss_t, grads_t, res = _torch_step(tmodel, bits, rays_o, rays_d, noise,
                                       target, rcfg_t, loss_t_mod)
    np.testing.assert_array_equal(res["mask"].numpy(), mask_j)
    assert 1000 < mask_j.sum() and int(res["rm_samples"]) == mask_j.sum()
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    want = params_from_numpy(jax.tree_util.tree_map(np.asarray, grads_j))
    assert set(want) == set(grads_t)
    for name, g in grads_t.items():
        assert np.abs(g).max() > 0, name
        # fused: an ulp of g from the MLP backward can move g_d across a
        # bf16 step, as in the hat-backward tests
        _close(g, want[name].numpy(), rtol=1e-4,
               rel_atol=1e-4 if fused else 1e-5)


@pytest.mark.parametrize("s_flat,fill", [(0, 0x33), (16, 0x01)])
def test_render_train_matches_jax_render_train(s_flat, fill):
    """The JAX package's own render_train marches synthetic scenes with the
    two-level (coarse-strata) tables, which drop a ray's samples only when
    its occupied strata overflow their budget
    (tests/test_twolevel_march.py:92-121); with ``s_flat`` it also
    evaluates the field on a flat ragged batch. On the rays whose sample
    counts agree with the port's exact march, which must be at least 95% of
    them, the frames agree. The JAX side runs under jit here: a sample that
    an ulp moved across a cell would change its ray's count."""
    cfg_kw = dict(SMALL, max_samples=256)
    jcfg = jngp.NGPConfig(grid="LowRank", **cfg_kw)
    jmodel = jngp.NGP(jcfg)
    params = jmodel.init(jax.random.PRNGKey(1))
    tmodel = tngp.NGP(tngp.NGPConfig(**SMALL))
    tmodel.load_state_dict(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params)))
    bits, rays_o, rays_d, _, _ = _batch(n=256, seed=2, fill=fill)
    occ_j = dataclasses.replace(jngp.OccupancyState.create(jcfg),
                                density_bitfield=jnp.asarray(bits)
                                ).refresh_coarse(jcfg)
    assert jmarch.twolevel_stratum(0.0, 256, 0.5, 32, 1, 1.0)[0] > 0
    rcfg_kw = dict(s_max_train=32, max_samples=256)
    key = jax.random.PRNGKey(3)
    render = jax.jit(jrendering.render_train, static_argnums=(0, 6))
    padded = render(jmodel, params, occ_j, jnp.asarray(rays_o),
                    jnp.asarray(rays_d), key,
                    jrendering.RenderConfig(**rcfg_kw))
    want = render(jmodel, params, occ_j, jnp.asarray(rays_o),
                  jnp.asarray(rays_d), key,
                  jrendering.RenderConfig(s_flat=s_flat, **rcfg_kw))
    noise = np.asarray(jax.random.uniform(jax.random.split(key, 3)[0],
                                          (256,)))
    occ_t = tngp.OccupancyState.create(tmodel.cfg)
    occ_t.density_bitfield = _t(bits)
    with torch.no_grad():
        got = trendering.render_train(tmodel, occ_t, _t(rays_o), _t(rays_d),
                                      _t(noise),
                                      trendering.RenderConfig(**rcfg_kw))
    counts_j = np.asarray(padded["mask"]).sum(axis=1)
    counts_t = got["mask"].numpy().sum(axis=1)
    agree = counts_j == counts_t
    assert agree.mean() >= 0.95, agree.mean()
    assert counts_t.sum() > 1000
    if s_flat:   # a batch the flat budget does not truncate
        assert counts_j.sum() <= 256 * s_flat
    for key_ in ("rgb", "opacity", "depth"):
        np.testing.assert_allclose(got[key_].numpy()[agree],
                                   np.asarray(want[key_])[agree], atol=1e-5)


# --------------------------------------------------------------- occupancy
def _occ_models(scale=0.5):
    kw = dict(SMALL, scale=scale)
    jmodel = jngp.NGP(jngp.NGPConfig(grid="LowRank", **kw))
    params = jmodel.init(jax.random.PRNGKey(6))
    tmodel = tngp.NGP(tngp.NGPConfig(**kw))
    tmodel.load_state_dict(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params)))
    return jmodel, params, tmodel


@pytest.mark.parametrize("scale", [0.5, 1.0])
def test_mark_invisible_cells_matches_jax(scale):
    jmodel, _, tmodel = _occ_models(scale)
    scene = jmake_scene(n_train=5, n_test=1, wh=24, seed=0)
    occ_j = jmodel.mark_invisible_cells(
        jngp.OccupancyState.create(jmodel.cfg), scene["K"], scene["poses"],
        scene["img_wh"])
    occ_t = tmodel.mark_invisible_cells(
        tngp.OccupancyState.create(tmodel.cfg), scene["K"],
        _t(scene["poses"]), scene["img_wh"], chunk=4096)
    np.testing.assert_array_equal(occ_t.density_grid.numpy(),
                                  np.asarray(occ_j.density_grid))
    np.testing.assert_array_equal(occ_t.count_grid.numpy(),
                                  np.asarray(occ_j.count_grid))
    grid, count = occ_t.density_grid.numpy(), occ_t.count_grid.numpy()
    assert set(np.unique(grid)) <= {-1.0, 0.0}
    assert 0.2 < count.mean() < 1.0
    if scale > 0.5:   # the outer cascade reaches past the cameras' views
        assert 0.05 < (grid[1] < 0).mean() < 0.95


@pytest.mark.parametrize("half", [0, 1])
def test_update_density_grid_half_erode_matches_jax(half):
    """Half-dense eroding refresh, with JAX's jitter: grids within 1e-4,
    bitfields bit for bit except at densities within 1e-5 (relative) of the
    threshold; the skipped half only decays."""
    jmodel, params, tmodel = _occ_models()
    cfg = jmodel.cfg
    thr = 0.01 * 1024 / np.sqrt(3)
    rng = np.random.default_rng(8 + half)
    grid0 = rng.uniform(-0.5, 3.0, (1, cfg.n_cells)).astype(np.float32)
    grid0[0, :100] = -1.0                  # invisible cells stay -1
    count = rng.random((1, cfg.n_cells), dtype=np.float32)
    count[0, 100:300] = 0.0                # seen by no camera
    occ_j = dataclasses.replace(jngp.OccupancyState.create(cfg),
                                density_grid=jnp.asarray(grid0),
                                count_grid=jnp.asarray(count))
    key = jax.random.PRNGKey(9)
    new_j = jmodel.update_density_grid(params, occ_j, key, thr, erode=True,
                                       half=half)
    _, sub = jax.random.split(key)          # JAX's jitter, as it draws it
    noise = np.array(jax.random.uniform(sub, (cfg.n_cells // 2, 3),
                                        minval=-1.0, maxval=1.0))[None]
    occ_t = tngp.OccupancyState(_t(grid0), torch.zeros(
        cfg.n_cells // 8, dtype=torch.uint8), _t(count))
    new_t = tmodel.update_density_grid(occ_t, thr, _t(noise), half=half,
                                       erode=True)
    grid_j = np.asarray(new_j.density_grid)
    grid_t = new_t.density_grid.numpy()
    np.testing.assert_allclose(grid_t, grid_j, rtol=1e-4, atol=1e-4)
    assert (grid_t[0, :100] == -1).all()
    skipped = np.arange(cfg.n_cells) % 2 != half
    assert (grid_t[0, skipped] <= np.maximum(grid0[0, skipped], 0)).all()
    assert new_t.count_grid is occ_t.count_grid
    bits_j = np.unpackbits(np.asarray(new_j.density_bitfield),
                           bitorder="little").astype(bool)
    bits_t = np.unpackbits(new_t.density_bitfield.numpy(),
                           bitorder="little").astype(bool)
    pos = grid_j > 0
    thr_j = min(grid_j[pos].sum() / pos.sum(), thr)
    near = np.abs(grid_j[0] - thr_j) <= 1e-5 * thr_j
    assert not ((bits_j != bits_t) & ~near).any()
    assert 0.05 < bits_t.mean() < 0.95


# ---------------------------------------------------------------- optimiser
@pytest.mark.parametrize("lr0,epochs,per_epoch", [(1e-2, 1, 1000),
                                                  (1e-2, 30, 1000),
                                                  (3e-3, 4, 250)])
def test_cosine_staircase_lr_matches_jax(lr0, epochs, per_epoch):
    want = jtrain.cosine_staircase_lr(lr0, epochs, per_epoch)
    got = ttrain.cosine_staircase_lr(lr0, epochs, per_epoch)
    for step in (0, 1, per_epoch - 1, per_epoch, 3 * per_epoch + 7,
                 epochs * per_epoch, 10 ** 6):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)


def test_adam_steps_match_optax():
    """torch.optim.Adam(eps=1e-15) on the cosine-staircase LambdaLR against
    optax.adam(schedule, eps=1e-15), three steps, to 1e-6."""
    rng = np.random.default_rng(10)
    p0 = {"a": rng.normal(size=(7, 5)).astype(np.float32),
          "b": rng.normal(size=(3,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * 10.0 ** rng.integers(-9, 2)
                  ).astype(np.float32) for k, v in p0.items()}
             for _ in range(3)]
    schedule = jtrain.cosine_staircase_lr(1e-2, 3, 2)
    tx = optax.adam(schedule, eps=1e-15)
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(pj)
    pt = {k: torch.nn.Parameter(_t(v.copy())) for k, v in p0.items()}
    opt = torch.optim.Adam(pt.values(), lr=1e-2, eps=1e-15)
    sched_t = ttrain.cosine_staircase_lr(1e-2, 3, 2)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: sched_t(step) / 1e-2)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, pj)
        pj = optax.apply_updates(pj, updates)
        for k, p in pt.items():
            p.grad = _t(g[k])
        opt.step()
        sched.step()
    for k in p0:
        np.testing.assert_allclose(pt[k].detach().numpy(), np.asarray(pj[k]),
                                   rtol=1e-6, atol=1e-7)
        assert not np.allclose(pt[k].detach().numpy(), p0[k])


# ------------------------------------------------------------ the trainer
def _hparams(**kw):
    d = dict(dataset_name="nsvf", scale=0.5, use_exposure=False,
             distortion_loss_w=0.0, batch_size=512, num_epochs=1, lr=1e-2,
             optimize_ext=False, random_bg=False, grid="LowRank", L=16, F=2,
             rgb_channels=16, rgb_layers=1, seed=1337, s_max_train=32,
             s_max_test=64, test_chunk=4096, steps_per_epoch=200,
             grid_size=32, max_samples=256, lr_levels=4, lr_rank=8,
             lr_frames=2, lr_k_max=64, lr_fused=True, refresh_half=True)
    d.update(kw)
    return argparse.Namespace(**d)


def test_fit_procedural_scene():
    """NeRFSystem.setup / configure / fit on a procedural scene, the test
    view's PSNR before (culled grid, one refresh) and after: +8 dB and above
    20 (the JAX package's bar, tests/test_e2e_train.py)."""
    scene = make_scene(n_train=8, n_test=1, wh=32, seed=0)
    system = ttrain.NeRFSystem(_hparams(), device="cpu")
    system.setup(MemoryDataset.from_scene(scene, "train"),
                 MemoryDataset.from_scene(scene, "test"))
    system.configure(0)
    ds = system.train_dataset
    system.occ = system.model.mark_invisible_cells(system.occ, ds.K,
                                                   system.poses, ds.img_wh)
    system.update_grid()
    before = system.validate()["test/psnr"]
    metrics = system.fit()
    after = system.validate()["test/psnr"]
    assert system.global_step == 200 and system.n_refresh == 1 + 13
    assert set(metrics) == {"loss", "psnr", "rm_s", "vr_s", "lr"}
    assert all(v.shape == (200,) for v in metrics.values())
    assert torch.isfinite(metrics["loss"]).all()
    assert metrics["loss"][-20:].mean() < metrics["loss"][:20].mean() / 4
    assert after > before + 8.0 and after > 20.0, (before, after)
