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
# the hash grids at a small size: 8 levels of 2 features, T 14, N_max 128
HASH = dict(L=8, log2_T=14, N_max=128)


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


@pytest.mark.parametrize("frame", [0, 1])
def test_hat_prod_bwd_reads_column_slice_of_feature_gradient(frame):
    """g as the fused encoder's backward hands it over: one frame's column
    slice of the (N, 2R) feature gradient. The slice gives the same (du, dW)
    as its contiguous copy and as the JAX VJP (Pallas, interpret mode), and
    the kernel's wrapper reads it in place: no copy, row stride 2R."""
    k, kp, r, n = 65, 128, 16, jhatmul.TN + 37
    u3, w, _, knot = _hat_operands(k, kp, r, n)
    feat_g = np.random.default_rng(11).normal(size=(n, 2 * r)) \
        .astype(np.float32)
    g = _t(feat_g)[:, frame * r:(frame + 1) * r]
    assert not g.is_contiguous() and g.stride() == (2 * r, 1)
    _, vjp = jax.vjp(lambda u, w_: jhatmul.hat_prod(u, w_, k, True),
                     jnp.asarray(u3), jnp.asarray(w))
    du_j, dw_j = (np.asarray(x) for x in vjp(jnp.asarray(
        feat_g[:, frame * r:(frame + 1) * r])))
    du_s, dw_s = thatmul.hat_prod_bwd(_t(u3), _t(w[:, :k]), k, g)
    du_c, dw_c = thatmul.hat_prod_bwd(_t(u3), _t(w[:, :k]), k,
                                      g.contiguous())
    assert torch.equal(du_s, du_c) and torch.equal(dw_s, dw_c)
    _close(dw_s.numpy(), dw_j[:, :k])
    _close(du_s.numpy(), du_j)
    assert (du_s.numpy()[knot] == 0).all()
    rows, ldg = thatmul._g_in_place(g)
    assert rows.data_ptr() == g.data_ptr() and ldg == 2 * r


@pytest.mark.parametrize("case", ["fp64", "unaligned_start",
                                  "unaligned_stride", "column_stride"])
def test_hat_prod_bwd_copies_g_only_when_it_must(case):
    """The wrapper copies g when the kernel cannot read it in place: not
    fp32, rows not 16-byte aligned, or columns not adjacent."""
    base = torch.randn(8, 40)
    g = {"fp64": base[:, :16].double(),
         "unaligned_start": base[:, 1:17],
         "unaligned_stride": torch.randn(8, 34)[:, :16],
         "column_stride": base[:, ::2][:, :16]}[case]
    rows, ldg = thatmul._g_in_place(g)
    assert rows.dtype == torch.float32 and rows.is_contiguous()
    assert rows.data_ptr() != g.data_ptr() and ldg == 16
    assert torch.equal(rows, g.float())


@pytest.mark.parametrize("n", [1, 15, 1023, 1025, 111_056, 1 << 19])
@pytest.mark.parametrize("r", [16, 128, 136])
def test_hat_prod_bwd_chunking(n, r):
    """Stage 1's chunks cover the N samples without an empty chunk, within
    about two blocks an SM of an H100; the chunking, and so the order of
    dW's sums, depends on N and R only."""
    chunk, chunks = thatmul.bwd_chunking(n, r)
    tiles = -(-r // thatmul.BWD_COLS)
    assert (chunks - 1) * chunk < n <= chunks * chunk
    assert chunks == 1 or chunk >= thatmul.BWD_MIN_CHUNK
    assert tiles * chunks <= max(thatmul.BWD_BLOCKS, tiles)
    assert thatmul.bwd_chunking(n, r) == (chunk, chunks)


def test_lowrank_backward_hands_hat_prod_a_strided_g(monkeypatch):
    """The fused encoder concatenates the frames' features, so the gradient
    of torch.cat reaches HatProd.backward as a column slice of the (N, 2R)
    feature gradient (row stride 2R); the kernel's wrapper reads it in
    place instead of copying it before every launch."""
    from mfnerf_tpu_torch.ops import lowrank as tlowrank
    cfg = tlowrank.LowRankConfig.create(n_levels=2, k_max=64, rank=8,
                                        n_frames=2, out_dim=16, fused=True)
    params = tlowrank.init_lowrank_params(cfg,
                                          torch.Generator().manual_seed(0))
    for m in params["lines"]:
        for level in m:
            for t in level:
                t.requires_grad_()
    seen, plain_bwd = [], thatmul.hat_prod_bwd

    def recorder(u3, w3, k_res, g, need_du=True):
        seen.append((g.shape, g.stride(), g.is_contiguous()))
        return plain_bwd(u3, w3, k_res, g, need_du)

    monkeypatch.setattr(thatmul, "hat_prod_bwd", recorder)
    x = torch.from_numpy(np.random.default_rng(12).random(
        (300, 3), dtype=np.float32))
    tlowrank.lowrank_encode(params, x, cfg).square().sum().backward()
    r = cfg.rank * len(cfg.levels)
    assert seen == [((300, r), (2 * r, 1), False)] * 2
    assert all(t.grad is not None for m in params["lines"] for level in m
               for t in level)


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
def _models(seed=0, grid="LowRank", **kw):
    cfg = dict(SMALL, grid=grid, **kw)
    if grid != "LowRank":
        cfg.update(HASH)
    jmodel = jngp.NGP(jngp.NGPConfig(**cfg))
    params = jmodel.init(jax.random.PRNGKey(seed))
    tmodel = tngp.NGP(tngp.NGPConfig(**cfg), device="cpu")
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
              loss_mod, grad_noise=None):
    """The padded branch of the JAX render_train, assembled from the JAX
    package's own functions, then NeRFLoss: (loss, grads, mask).
    ``grad_noise``: the hash grids' (N*S, m) uniforms for every padded slot,
    as the JAX padded branch draws them.

    The march runs op by op (see the module docstring). So does the fused
    encoder's step: under jit XLA fuses frame 1's rotation and rounds it
    otherwise, which moves many more bf16 hat weights than the exception
    (computed op by op) admits. So does a hash grid's step: under jit XLA
    may contract x * scale + 0.5 into a fused multiply-add, which can move a
    sample across a cell. The unfused fp32 LowRank step runs under jit."""
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
            mr.dirs[:, None, :], (n, s, 3)).reshape(-1, 3),
            grad_noise=None if grad_noise is None
            else jnp.asarray(grad_noise))
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
    if cfg.lr_fused or cfg.grid != "LowRank":
        with jax.disable_jit():
            loss, grads = step(params)
    else:
        loss, grads = jax.jit(step)(params)
    return float(loss), grads, np.asarray(mr.mask)


def _torch_step(tmodel, bits, rays_o, rays_d, noise, target, rcfg, loss_mod,
                grad_noise=None):
    occ = tngp.OccupancyState.create(tmodel.cfg, "cpu")
    occ.density_bitfield = _t(bits)
    tmodel.zero_grad(set_to_none=True)
    res = trendering.render_train(tmodel, occ, _t(rays_o), _t(rays_d),
                                  _t(noise), rcfg, grad_noise=grad_noise)
    loss = sum(v.mean() for v in loss_mod(
        res, {"rgb": _t(target)}).values())
    loss.backward()
    grads = {k: p.grad.numpy() for k, p in tmodel.named_parameters()}
    return float(loss.detach()), grads, res


@pytest.mark.parametrize("grid,fused,m", [
    pytest.param("LowRank", False, 8, id="False"),
    pytest.param("LowRank", True, 8, id="True"),
    pytest.param("Hash", False, 8, id="Hash"),
    pytest.param("MixedFeature", False, 8, id="MixedFeature"),
    pytest.param("MixedFeature", False, 1, id="MixedFeature-sampled")])
def test_train_step_matches_jax(grid, fused, m):
    """A whole step's loss and every parameter gradient, for the LowRank
    encoder (unfused fp32 and fused bf16) and the hash grids (MixedFeature
    with N_tables 2: salted shared tables), exact and with the sampled-corner
    table gradient. The JAX padded branch draws the sampled corners'
    uniforms for all N*S slots; the port is handed the valid samples' rows."""
    kw = dict(N_tables=2, hash_grad_samples=m) if grid == "MixedFeature" \
        else {}
    jmodel, params, tmodel = _models(grid=grid, lr_fused=fused, **kw)
    bits, rays_o, rays_d, noise, target = _batch()
    rcfg_kw = dict(s_max_train=32, max_samples=256)
    rcfg_j = jrendering.RenderConfig(**rcfg_kw)
    rcfg_t = trendering.RenderConfig(**rcfg_kw)
    loss_j_mod = jlosses.NeRFLoss()
    loss_t_mod = tlosses.NeRFLoss()
    if fused:
        # keep the rays whose bf16 hat bases agree on both sides
        occ = tngp.OccupancyState.create(tmodel.cfg, "cpu")
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
    grad_noise = None
    if m < 8:
        grad_noise = np.random.default_rng(1).random(
            (len(rays_o) * rcfg_kw["s_max_train"], m), dtype=np.float32)
    loss_j, grads_j, mask_j = _jax_step(jmodel, params, bits, rays_o, rays_d,
                                        noise, target, rcfg_j, loss_j_mod,
                                        grad_noise)
    loss_t, grads_t, res = _torch_step(
        tmodel, bits, rays_o, rays_d, noise, target, rcfg_t, loss_t_mod,
        None if grad_noise is None else _t(grad_noise[mask_j.reshape(-1)]))
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


@pytest.mark.parametrize("s_flat,s_strata,fill", [
    (0, 32, 0x33), (16, 32, 0x01), (4, 32, 0x33), (0, 4, 0xFF)])
def test_render_train_matches_jax_render_train(s_flat, s_strata, fill):
    """The JAX package's own render_train marches synthetic scenes with the
    two-level (coarse-strata) tables, which take a ray's strata at even
    ranks when they overflow the ``s_strata`` budget
    (tests/test_twolevel_march.py:92-121); with ``s_flat`` it also
    evaluates the field on a flat ragged batch cut at ``N * s_flat``
    samples. The port's render_train keeps the same samples (a full grid
    over a budget of 4 strata; a flat budget of 4 that cuts the batch): the
    sample counts agree on every ray, and so do the frames. The JAX side
    runs under jit here."""
    cfg_kw = dict(SMALL, max_samples=256)
    jcfg = jngp.NGPConfig(grid="LowRank", **cfg_kw)
    jmodel = jngp.NGP(jcfg)
    params = jmodel.init(jax.random.PRNGKey(1))
    tmodel = tngp.NGP(tngp.NGPConfig(**SMALL), device="cpu")
    tmodel.load_state_dict(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params)))
    bits, rays_o, rays_d, _, _ = _batch(n=256, seed=2, fill=fill)
    occ_j = dataclasses.replace(jngp.OccupancyState.create(jcfg),
                                density_bitfield=jnp.asarray(bits)
                                ).refresh_coarse(jcfg)
    assert jmarch.twolevel_stratum(0.0, 256, 0.5, 32, 1, 1.0)[0] > 0
    rcfg_kw = dict(s_max_train=32, max_samples=256, s_strata=s_strata,
                   s_flat=s_flat)
    key = jax.random.PRNGKey(3)
    render = jax.jit(jrendering.render_train, static_argnums=(0, 6))
    want = render(jmodel, params, occ_j, jnp.asarray(rays_o),
                  jnp.asarray(rays_d), key, jrendering.RenderConfig(**rcfg_kw))
    noise = np.asarray(jax.random.uniform(jax.random.split(key, 3)[0],
                                          (256,)))
    occ_t = tngp.OccupancyState.create(tmodel.cfg, "cpu")
    occ_t.density_bitfield = _t(bits)
    with torch.no_grad():
        got = trendering.render_train(tmodel, occ_t, _t(rays_o), _t(rays_d),
                                      _t(noise),
                                      trendering.RenderConfig(**rcfg_kw))
    counts_t = got["mask"].numpy().sum(axis=1)
    if s_flat:
        counts_j = np.bincount(np.asarray(want["ray_id_flat"])[
            :int(got["mask"].sum())], minlength=256)
    else:
        counts_j = np.asarray(want["mask"]).sum(axis=1)
    np.testing.assert_array_equal(counts_t, counts_j)
    assert counts_t.sum() > 1000
    assert int(got["rm_samples"]) == int(want["rm_samples"])
    if s_flat == 4:     # the flat budget cut the batch
        assert int(got["rm_samples"]) > counts_t.sum() == 256 * s_flat
    for key_ in ("rgb", "opacity", "depth"):
        np.testing.assert_allclose(got[key_].numpy(), np.asarray(want[key_]),
                                   atol=1e-5)


# --------------------------------------------------------------- occupancy
def _occ_models(scale=0.5):
    kw = dict(SMALL, scale=scale)
    jmodel = jngp.NGP(jngp.NGPConfig(grid="LowRank", **kw))
    params = jmodel.init(jax.random.PRNGKey(6))
    tmodel = tngp.NGP(tngp.NGPConfig(**kw), device="cpu")
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
        tngp.OccupancyState.create(tmodel.cfg, "cpu"), scene["K"],
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


def _sampling_system(**kw):
    """A CPU NeRFSystem on 8 small procedural views (configured, untrained)."""
    scene = make_scene(n_train=8, n_test=1, wh=8, seed=0)
    system = ttrain.NeRFSystem(_hparams(**kw), device="cpu")
    system.setup(MemoryDataset.from_scene(scene, "train"))
    system.configure(0)
    return system


def test_same_image_draws_one_image_a_batch():
    """ray_sampling_strategy="same_image" (mfnerf_tpu/train.py:353-358): one
    image a batch, uniform over the views (chi-square, 7 degrees of freedom,
    under its p = 0.001 point over 800 batches); pixels still a ray each."""
    system = _sampling_system(ray_sampling_strategy="same_image",
                              batch_size=64)
    draws = []
    for _ in range(800):
        img, pix = system.sample_batch()
        assert img.shape == pix.shape == (64,)
        assert bool((img == img[0]).all())
        draws.append(int(img[0]))
    counts = np.bincount(draws, minlength=8)
    assert ((counts - 100.0) ** 2 / 100.0).sum() < 24.32, counts
    assert len(set(pix.tolist())) > 32


def test_default_sampling_draws_an_image_a_ray():
    """Without the knob the trainer draws as before: an image and a pixel a
    ray, from the hparams seed's generator in that order."""
    system = _sampling_system()
    img, pix = system.sample_batch()
    gen = torch.Generator().manual_seed(1337)
    assert torch.equal(img, torch.randint(8, (512,), generator=gen))
    assert torch.equal(pix, torch.randint(64, (512,), generator=gen))
    assert len(set(img.tolist())) == 8


@pytest.mark.parametrize("knob,error", [
    (dict(eval_lpips=True), NotImplementedError),
    (dict(num_gpus=2), NotImplementedError),
    (dict(ray_sampling_strategy="one_ray"), ValueError),
    (dict(profile=True), NotImplementedError)])
def test_unported_trainer_knobs_raise(knob, error):
    with pytest.raises(error):
        ttrain.NeRFSystem(_hparams(**knob), device="cpu")
    ttrain.NeRFSystem(_hparams(weight_path=None, num_gpus=1), device="cpu")
