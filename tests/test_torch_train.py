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
* the trainer's step under ``--optimize_ext``, ``--use_exposure`` and
  ``--bf16`` against the JAX trainer's (``_check_trainer_step``): as the
  whole step above, dR/dT and the tonemappers included, with the unfused
  encoder on the rays whose every MLP ReLU gate lies farther from 0 than
  RELU_MARGIN of its scale (which must be over 90% of them); the fused
  encoder's gradients on 99.5% of their elements within its atol and all
  within 1e-3 of the largest value; under ``--bf16`` the loss 1e-4 and
  each gradient 2e-2 relative L2 (BF16_LOSS_RTOL, BF16_GRAD_RTOL).
* Rodrigues and its gradient: 1e-6 relative.
* render_train against the JAX render_train: rgb, opacity, depth 1e-5 on
  the rays whose sample counts agree.
* occupancy refresh: 1e-4, the bitfield bit for bit away from the threshold.
"""
import argparse
import contextlib
import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mfnerf_tpu import losses as jlosses
from mfnerf_tpu import train as jtrain
from mfnerf_tpu.datasets import ray_utils as jray
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
from mfnerf_tpu_torch.datasets.ray_utils import axisangle_to_R
from mfnerf_tpu_torch.models import ngp as tngp
from mfnerf_tpu_torch.models import rendering as trendering
from mfnerf_tpu_torch.ops import composite as tcomposite
from mfnerf_tpu_torch.ops import hatmul as thatmul
from mfnerf_tpu_torch.ops import morton as tmorton
from mfnerf_tpu_torch.ops.activations import trunc_exp as t_trunc_exp
from mfnerf_tpu_torch.utils import ckpt as tckpt
from mfnerf_tpu_torch.utils.ckpt import params_from_numpy
from mfnerf_tpu_torch.utils.procedural import make_scene

from test_torch_field import _same_bf16_basis

SMALL = dict(lr_levels=2, lr_rank=8, lr_k_max=64, grid_size=32,
             rgb_channels=16, rgb_layers=1)
# the hash grids at a small size: 8 levels of 2 features, T 14, N_max 128
HASH = dict(L=8, log2_T=14, N_max=128)
# the least relative distance from 0 of a ReLU pre-activation at which the
# trainer's step compares the compiled JAX field with the port
RELU_MARGIN = 1e-5


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


@pytest.mark.parametrize("k,r,n", [(65, 16, 637), (257, 128, 600)])
def test_hat_prod_bwd_fp32_matches_jax(k, r, n):
    """The fp32 mode's VJP (lr_matmul_dtype="float32": g_d, the basis and
    W in fp32) against the JAX _hat_cp_prod's with mm_dtype float32, the
    plain version and through autograd: rtol 1e-5 with atol 1e-5 of the
    largest value; du 0 on the knots."""
    u3, w, g, knot = _hat_operands(k, k, r, n)
    _, vjp = jax.vjp(lambda u, w_: jlowrank._hat_cp_prod(u, w_, k,
                                                         jnp.float32),
                     jnp.asarray(u3), jnp.asarray(w))
    du_j, dw_j = (np.asarray(x) for x in vjp(jnp.asarray(g)))
    du_p, dw_p = thatmul.hat_prod_bwd_plain(_t(u3), _t(w), k, _t(g),
                                            dtype="float32")
    uu, ww = _t(u3).requires_grad_(), _t(w).requires_grad_()
    thatmul.hat_prod(uu, ww, k, "float32").backward(_t(g))
    for du, dw in ((du_p, dw_p), (uu.grad, ww.grad)):
        _close(dw.numpy(), dw_j, rtol=1e-5, rel_atol=1e-5)
        _close(du.numpy(), du_j, rtol=1e-5, rel_atol=1e-5)
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

    def recorder(u3, w3, k_res, g, need_du=True, dtype="bfloat16"):
        seen.append((g.shape, g.stride(), g.is_contiguous()))
        return plain_bwd(u3, w3, k_res, g, need_du, dtype)

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


def _batch(n=128, seed=0, fill=0x33, grid=32, cascades=1):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 256, cascades * grid ** 3 // 8, dtype=np.uint8) \
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
    occ = dataclasses.replace(tngp.OccupancyState.create(tmodel.cfg, "cpu"),
                              density_bitfield=_t(bits)
                              ).refresh_coarse(tmodel.cfg)
    tmodel.zero_grad(set_to_none=True)
    res = trendering.render_train(tmodel, occ, _t(rays_o), _t(rays_d),
                                  _t(noise), rcfg, grad_noise=grad_noise)
    loss = sum(v.mean() for v in loss_mod(
        res, {"rgb": _t(target)}).values())
    loss.backward()
    grads = {k: p.grad.numpy() for k, p in tmodel.named_parameters()}
    return float(loss.detach()), grads, res


@pytest.mark.parametrize("grid,fused,m,flags", [
    pytest.param("LowRank", False, 8, "", id="False"),
    pytest.param("LowRank", True, 8, "", id="True"),
    pytest.param("Hash", False, 8, "", id="Hash"),
    pytest.param("MixedFeature", False, 8, "", id="MixedFeature"),
    pytest.param("MixedFeature", False, 1, "", id="MixedFeature-sampled"),
    pytest.param("LowRank", False, 8, "ext", id="ext-False"),
    pytest.param("LowRank", True, 8, "ext", id="ext-True"),
    pytest.param("MixedFeature", False, 8, "ext", id="ext-MixedFeature"),
    pytest.param("MixedFeature", False, 1, "ext",
                 id="ext-MixedFeature-sampled"),
    pytest.param("LowRank", False, 8, "ext-flat", id="ext-flat"),
    pytest.param("LowRank", False, 8, "exposure", id="exposure"),
    pytest.param("LowRank", True, 8, "exposure-ext", id="exposure-ext-True"),
    pytest.param("LowRank", False, 8, "bf16", id="bf16-False"),
    pytest.param("LowRank", True, 8, "bf16", id="bf16-True"),
    pytest.param("Hash", False, 8, "bf16", id="bf16-Hash"),
    pytest.param("LowRank", True, 8, "fp32", id="fp32-True")])
def test_train_step_matches_jax(grid, fused, m, flags):
    """A whole step's loss and every parameter gradient, for the LowRank
    encoder (unfused fp32 and fused bf16) and the hash grids (MixedFeature
    with N_tables 2: salted shared tables), exact and with the sampled-corner
    table gradient. The JAX padded branch draws the sampled corners'
    uniforms for all N*S slots; the port's (its capacity buffer of N*S
    slots) is handed the same draw.
    With ``flags`` the step is the trainer's (``NeRFSystem.step_loss``)
    under ``--optimize_ext`` (``dR`` and ``dT`` held too; "ext-flat" past
    ``FLAT_AFTER`` on the flat budget), ``--use_exposure`` or ``--bf16``,
    or ("fp32") with the fused encoder in its fp32 mode
    (``lr_matmul_dtype="float32"``: no bf16 step, held as the unfused
    encoder): :func:`_check_trainer_step`."""
    if flags:
        return _check_trainer_step(grid, fused, m, flags)
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
        None if grad_noise is None else _t(grad_noise))
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


# signed permutations as camera rotations: get_rays of these poses is exact
# in both packages (one nonzero a row), and so is R(0) @ P
ROTATIONS = np.float32([
    [[1, 0, 0], [0, 1, 0], [0, 0, 1]],          # from -z, looking +z
    [[1, 0, 0], [0, -1, 0], [0, 0, -1]],        # from +z, looking -z
    [[0, 0, -1], [0, 1, 0], [1, 0, 0]],         # from +x, looking -x
    [[1, 0, 0], [0, 0, 1], [0, -1, 0]]])        # from -y, looking +y
EXPOSURES = np.float32([0.5, 1.0, 2.0, 0.25])
# tolerances of the trainer step under --bf16: bf16 operands with fp32
# sums on both sides, but an ulp of an fp32 sum (summed in another order)
# can move a hidden activation or a gradient across a bf16 step (2^-8
# relative), which then reaches every parameter's gradient
BF16_LOSS_RTOL, BF16_GRAD_RTOL = 1e-4, 2e-2


def _trainer_batch(n=128, seed=0, n_pix=96, exposure=False):
    """Four cameras on the axes 1.4 from the centre (ROTATIONS), n_pix
    camera-space directions about the optical axis (every 17th facing
    backwards: a miss; no component exactly 0, where 1/d and so the pose
    gradient of either package is not finite), and n (image, pixel) draws;
    the images' colours, with each image's exposure as a 4th column with
    ``exposure``."""
    rng = np.random.default_rng(seed)
    centers = -1.4 * ROTATIONS[:, :, 2]
    poses = np.concatenate([ROTATIONS, centers[:, :, None]], axis=2)
    d = rng.normal(size=(n_pix, 3)).astype(np.float32) \
        * np.float32([0.3, 0.3, 0.0]) + np.float32([0.0, 0.0, 1.0])
    d[::17] = np.float32([0.02, -0.01, -1.0])
    dirs = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    images = rng.random((4, n_pix, 3), dtype=np.float32)
    if exposure:
        images = np.concatenate([images, np.broadcast_to(
            EXPOSURES[:, None, None], (4, n_pix, 1))], axis=2)
    bits = rng.integers(0, 256, 32 ** 3 // 8, dtype=np.uint8) & np.uint8(0x33)
    return (bits, poses.astype(np.float32), dirs, np.ascontiguousarray(
        images), rng.integers(0, 4, n), rng.integers(0, n_pix, n),
        rng.random(n, dtype=np.float32))


def _trainer_system(grid, fused, m, flags, params, train):
    """A CPU NeRFSystem of the test's small model with the JAX ``params``
    (``dR``/``dT`` into its pose group) on the ``train`` views, the strata
    budget at 32 (the exact march's samples on this batch)."""
    kw = dict(grid=grid, lr_fused=fused, lr_levels=SMALL["lr_levels"],
              lr_k_max=SMALL["lr_k_max"],
              lr_matmul_dtype="float32" if flags == "fp32" else "bfloat16",
              use_exposure="exposure" in flags, optimize_ext="ext" in flags,
              bf16=flags == "bf16", s_flat=4 if flags == "ext-flat" else 0,
              distortion_loss_w=1e-3)
    if grid != "LowRank":
        kw.update(L=HASH["L"], T=HASH["log2_T"], N_max=HASH["N_max"],
                  N_tables=2, hash_grad_samples=m)
    system = ttrain.NeRFSystem(_hparams(**kw), device="cpu")
    system.setup(train)
    system.configure(0)
    system.rcfg = dataclasses.replace(system.rcfg, s_strata=32)
    net = {k: v for k, v in params.items() if k not in ("dR", "dT")}
    system.model.load_state_dict(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, net)))
    with torch.no_grad():
        for name, p in system.ext.items():
            p.copy_(_t(params[name]))
    return system


class _JitField:
    """The JAX field with its forward, and so its VJP, compiled; the rest
    of a step around it runs op by op. The unfused fp32 encoder's
    gradients agree with the port to ~1e-6 compiled on the rays of
    :func:`_clear_relu_rays`; off them, where a ReLU gate lies within
    rounding of 0, either the compiled or the op-by-op field can round to
    the other side of the gate, depending on the host. The fused encoder
    and the hash grids run op by op (module docstring)."""

    def __init__(self, jmodel):
        self.cfg, self.is_lowrank = jmodel.cfg, jmodel.is_lowrank
        self.log_radiance_to_rgb = jmodel.log_radiance_to_rgb
        self._fwd = jax.jit(lambda p, x, d, e, g: jmodel(
            p, x, d, exposure=e, grad_noise=g))

    def __call__(self, p, x, d, exposure=None, grad_noise=None):
        return self._fwd(p, x, d, exposure, grad_noise)


def _clear_relu_rays(system, img, pix, noise):
    """(N,) bool: the rays of the step at whose every sample each hidden
    ReLU of the port's MLPs is decided by more than RELU_MARGIN of its
    scale, |h @ w| > RELU_MARGIN * (|h| @ |w|) for every unit. Nearer 0 a
    rounding difference between the packages can flip the gate, and the
    gradient then jumps by that unit's whole contribution: XLA sums the
    compiled field's encoder in another order (~4e-6 of its largest value
    apart from op by op), which flipped one of ~2,000 x 64 sigma-MLP gates
    (pre-activation 3.2e-7 op by op and in the port, -3.8e-8 compiled) and
    moved the lines, proj and sigma_mlp.0 gradients by up to 1.8e-2."""
    return _clear_relu_mask(lambda: system.step_loss(
        _t(img), _t(pix), _t(noise))[1])


def _clear_relu_mask(render):
    """:func:`_clear_relu_rays`' rule on the samples of ``render()``, a
    call of the port's ``render_train`` (its results)."""
    plain, margins = tngp._mlp_apply, []

    def recording(ws, x, sigmoid=False, dtype=torch.float32):
        h = x
        for w in ws[:-1]:
            z = h @ w
            margins.append((z.abs() / (h.abs() @ w.abs())).amin(dim=1))
            h = torch.relu(z)
        return plain(ws, x, sigmoid, dtype)

    with torch.no_grad(), mock.patch.object(tngp, "_mlp_apply", recording):
        res = render()
    mask = res["mask"].numpy()
    margin = np.full(mask.shape, np.inf, np.float32)
    # the capacity buffer's N*S rows, the valid samples first in row-major
    # order (not the unit exposure's one row)
    margin[mask] = torch.stack([m[:mask.sum()] for m in margins
                                if len(m) == mask.size]
                               ).amin(dim=0).numpy()
    return margin.min(axis=1) > RELU_MARGIN


class _GradCapture:
    """An optax transformation whose state after ``update`` is the
    gradient: the JAX trainer's step then hands back its gradients
    exactly."""

    def init(self, params):
        return params

    def update(self, grads, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, grads), grads


def _op_by_op(jmodel):
    """A context in which the JAX step runs op by op, unless ``jmodel`` is
    a :class:`_JitField`."""
    return contextlib.nullcontext() if isinstance(jmodel, _JitField) \
        else jax.disable_jit()


def _jax_trainer_grads(jmodel, params, occ, rcfg, batch, poses, dirs, key,
                       flags, unit_rgb):
    """The JAX trainer's own step (``NeRFSystem._make_train_step``: the
    pose refinement, ``render_train``, NeRFLoss and the unit-exposure
    term), compiled as the trainer compiles it (op by op, its flat
    layout's segmented scans alone compile ~1,400 programs, ~1 min):
    (loss, gradients)."""
    trainer = argparse.Namespace(tx=_GradCapture(),
                                 lr_schedule=lambda step: 0.0)
    step = jtrain.NeRFSystem._make_train_step(
        trainer, rcfg, jmodel, jlosses.NeRFLoss(), "exposure" in flags,
        "ext" in flags, unit_rgb)
    _, grads, metrics = jax.jit(step)(params, None, occ, jnp.asarray(poses),
                                      jnp.asarray(dirs), batch, key, 0)
    return float(metrics["loss"]), grads


def _jax_pose_step(jmodel, params, bits, poses, dirs, batch, noise, rcfg,
                   flags, unit_rgb):
    """The padded branch of the JAX trainer's step with the march jitter
    ``noise`` given: the trainer's pose refinement and get_rays
    (``mfnerf_tpu/train.py:273-283``), then as :func:`_jax_step` (the
    exact march, which keeps the strata budget's samples here), NeRFLoss
    and the unit-exposure term (``:286-294``). (loss, gradients, mask)."""
    cfg = jmodel.cfg
    img, pix = batch["img_idxs"], batch["pix_idxs"]
    exposure = batch.get("exposure")

    def loss_fn(p):
        pose = jnp.asarray(poses)[img]
        if "ext" in flags:
            dr = jray.axisangle_to_R(p["dR"][img])
            pose = pose.at[..., :3].set(dr @ pose[..., :3])
            pose = pose.at[..., 3].add(p["dT"][img])
        ro, rd = jray.get_rays(jnp.asarray(dirs)[pix], pose)
        hits = jrendering._clamp_near(jinter.ray_aabb_intersect_single(
            ro, rd, jnp.zeros(3), jnp.full(3, cfg.scale)))
        mr = jmarch.march_rays_train(
            ro, rd, hits, jnp.asarray(bits), cfg.cascades, cfg.scale,
            rcfg.exp_step_factor, cfg.grid_size, rcfg.max_samples,
            jnp.asarray(noise), rcfg.n_rungs(cfg.scale, cfg.grid_size),
            rcfg.s_max_train)
        n, s = mr.ts.shape
        exp_flat = None if exposure is None else jnp.broadcast_to(
            exposure[:, None, :], (n, s, 1)).reshape(-1, 1)
        sig, col = jmodel(p, mr.xyzs.reshape(n * s, 3), jnp.broadcast_to(
            mr.dirs[:, None, :], (n, s, 3)).reshape(-1, 3),
            exposure=exp_flat)
        sig = jnp.where(mr.mask.reshape(-1), sig, 0.0).reshape(n, s)
        comp = jcomposite.composite_train(sig, col.reshape(n, s, 3),
                                          mr.deltas, mr.ts, mr.mask,
                                          rcfg.T_threshold)
        results = {"rgb": comp.rgb + (1.0 - comp.opacity)[:, None],
                   "opacity": comp.opacity, "ws": comp.ws,
                   "deltas": mr.deltas, "ts": mr.ts, "mask": mr.mask}
        terms = jlosses.NeRFLoss()(results, batch)
        if "exposure" in flags:
            unit = jmodel.log_radiance_to_rgb(p, jnp.zeros((1, 3)),
                                              exposure=jnp.ones((1, 1)))
            terms["unit_exposure"] = 0.5 * (unit - unit_rgb) ** 2
        return sum(v.mean() for v in terms.values()), mr.mask

    with _op_by_op(jmodel):
        (loss, mask), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
    return float(loss), grads, np.asarray(mask)


def _check_trainer_step(grid, fused, m, flags):
    """One step of the port's trainer (``NeRFSystem.step_loss``) against
    the JAX trainer's, from the same weights, poses, pixels and jitter:
    the loss and every gradient, ``dR``/``dT`` and the tonemappers
    included. ``dR`` and ``dT`` are zero, as ``--optimize_ext`` starts, so
    both packages march the same rays bit for bit (signed-permutation
    cameras): off zero the rays differ by an ulp, and an ulp can move a
    sample across the transmittance cut-off or a hat knot, where the
    gradient jumps (``test_axisangle_to_R_matches_jax`` holds the rotation
    and its gradient off zero; ``chip_smoke.py`` the card's step there).
    The padded steps give the JAX side the jitter through
    :func:`_jax_pose_step`; "ext-flat" runs the JAX trainer's own step past
    ``FLAT_AFTER`` (:func:`_jax_trainer_grads`), its jitter drawn from its
    key as the JAX ``render_train`` draws it. Tolerances: as the module's
    (the fused encoder's: 99.5% of each gradient within its atol, all
    within 1e-3 of the largest value: each g_d that an ulp moves across a
    bf16 step moves a dW row by a step); under ``--bf16`` BF16_LOSS_RTOL
    and BF16_GRAD_RTOL."""
    hdr = "exposure" in flags
    bits, poses, dirs, images, img, pix, noise = _trainer_batch(
        exposure=hdr)
    fp32 = flags == "fp32"      # the fused encoder's fp32 mode
    cfg = dict(SMALL, grid=grid, lr_fused=fused, max_samples=256,
               lr_matmul_dtype="float32" if fp32 else "bfloat16",
               rgb_act="None" if hdr else "Sigmoid",
               compute_dtype="bfloat16" if flags == "bf16" else "float32")
    if grid != "LowRank":
        cfg.update(HASH, N_tables=2, hash_grad_samples=m)
    jmodel = jngp.NGP(jngp.NGPConfig(**cfg))
    params = jmodel.init(jax.random.PRNGKey(5))
    if grid == "LowRank" and not fused:
        jmodel = _JitField(jmodel)
    if "ext" in flags:      # zero, as --optimize_ext starts
        params["dR"], params["dT"] = jnp.zeros((4, 3)), jnp.zeros((4, 3))
    train = MemoryDataset(poses, images, np.eye(3), dirs, (len(dirs), 1))
    unit_rgb = 0.73 if hdr else None
    train.unit_exposure_rgb = unit_rgb
    system = _trainer_system(grid, fused, m, flags, params, train)
    rcfg_t = system.rcfg
    rcfg_j = jrendering.RenderConfig(**{
        f.name: getattr(rcfg_t, f.name)
        for f in dataclasses.fields(trendering.RenderConfig)})
    system.occ = dataclasses.replace(system.occ, density_bitfield=_t(bits)
                                     ).refresh_coarse(system.model_cfg)
    if isinstance(jmodel, _JitField) and flags not in ("ext-flat", "bf16"):
        keep = _clear_relu_rays(system, img, pix, noise)
        assert keep.mean() > 0.9, keep.mean()
        img, pix, noise = img[keep], pix[keep], noise[keep]
    if fused and not fp32:   # the rays whose bf16 hat bases agree
        ro, rd = (x.numpy() for x in ttrain.get_rays(
            _t(dirs)[_t(pix)], _t(poses)[_t(img)]))
        with torch.no_grad():
            mr = trendering.march_rays_train(
                _t(ro), _t(rd), trendering._scene_hits(system.model, _t(ro),
                                                       _t(rd)),
                _t(bits), 1, 0.5, 0.0, 32, 256, _t(noise),
                rcfg_t.n_rungs(0.5, 32), rcfg_t.s_max_train)
        mask = mr.mask.numpy()
        same = np.ones(mask.shape, bool)
        same[mask] = _same_bf16_basis(
            np.clip(mr.xyzs.numpy()[mask] + 0.5, 0, 1).astype(np.float32),
            system.model.lowrank_cfg)
        keep = same.all(axis=1)
        assert keep.mean() > 0.9, keep.mean()
        img, pix, noise = img[keep], pix[keep], noise[keep]
    batch = {"img_idxs": jnp.asarray(img), "pix_idxs": jnp.asarray(pix),
             "rgb": jnp.asarray(images[img, pix, :3])}
    if hdr:
        batch["exposure"] = jnp.asarray(images[img, pix, 3:4])
    grad_noise = None
    if flags == "ext-flat":
        occ_j = dataclasses.replace(jngp.OccupancyState.create(jmodel.cfg),
                                    density_bitfield=jnp.asarray(bits)
                                    ).refresh_coarse(jmodel.cfg)
        key = jax.random.PRNGKey(3)
        noise = np.asarray(jax.random.uniform(jax.random.split(key, 3)[0],
                                              (len(img),)))
        loss_j, grads_j = _jax_trainer_grads(
            jmodel, params, occ_j, rcfg_j, batch, poses, dirs, key, flags,
            unit_rgb)
        system.global_step = ttrain.FLAT_AFTER
    else:
        if m < 8:
            grad_noise = np.random.default_rng(1).random(
                (len(img) * rcfg_t.s_max_train, m), dtype=np.float32)
        jmodel_g = jmodel
        if grad_noise is not None:    # the padded branch's uniforms
            def jmodel_g(p, x, d, exposure=None):
                return jmodel(p, x, d, exposure=exposure,
                              grad_noise=jnp.asarray(grad_noise))
            jmodel_g.cfg = jmodel.cfg
            jmodel_g.log_radiance_to_rgb = jmodel.log_radiance_to_rgb
        loss_j, grads_j, mask_j = _jax_pose_step(
            jmodel_g, params, bits, poses, dirs, batch, noise, rcfg_j,
            flags, unit_rgb)
        if grad_noise is not None:     # the same draw, N*S rows
            grad_noise = _t(grad_noise)
    loss, res, _ = system.step_loss(_t(img), _t(pix), _t(noise),
                                    grad_noise=grad_noise)
    loss.backward()
    grads_t = {k: p.grad.numpy() for k, p in [
        *system.model.named_parameters(), *system.ext.items()]}
    if flags != "ext-flat":
        np.testing.assert_array_equal(res["mask"].numpy(), mask_j)
    else:   # the flat budget cut the batch
        assert int(res["rm_samples"]) > int(res["mask"].sum()) \
            == len(img) * rcfg_t.s_flat
    assert int(res["mask"].sum()) > 400
    bf16 = flags == "bf16"
    np.testing.assert_allclose(float(loss.detach()), loss_j,
                               rtol=BF16_LOSS_RTOL if bf16 else 1e-5)
    want = params_from_numpy(jax.tree_util.tree_map(np.asarray, grads_j))
    assert set(want) == set(grads_t)
    if "ext" in flags:
        assert {"dR", "dT"} <= set(grads_t)
    if hdr:
        assert "tonemappers.2.1" in grads_t
    for name, g in grads_t.items():
        assert np.abs(g).max() > 0 and np.isfinite(g).all(), name
        if bf16:
            err = np.linalg.norm(g - want[name].numpy())
            assert err <= BF16_GRAD_RTOL * np.linalg.norm(
                want[name].numpy()), (name, err)
        elif fused and not fp32:
            w = want[name].numpy()
            top = float(np.abs(w).max())
            within = np.abs(g - w) <= 1e-4 * np.abs(w) + 1e-4 * top
            assert within.mean() >= 0.995, (name, within.mean())
            _close(g, w, rtol=1e-4, rel_atol=1e-3)
        else:
            _close(g, want[name].numpy(), rtol=1e-4, rel_atol=1e-5)


@pytest.mark.parametrize("s_flat,s_strata,fill,scale", [
    pytest.param(0, 32, 0x33, 0.5, id="0-32-51"),
    pytest.param(16, 32, 0x01, 0.5, id="16-32-1"),
    pytest.param(4, 32, 0x33, 0.5, id="4-32-51"),
    pytest.param(0, 4, 0xFF, 0.5, id="0-4-255"),
    pytest.param(0, 8, 0x11, 1.0, id="cascades-scale1"),
    pytest.param(0, 8, 0x33, 4.0, id="cascades-scale4")])
def test_render_train_matches_jax_render_train(s_flat, s_strata, fill,
                                               scale):
    """The JAX package's own render_train marches synthetic scenes with the
    two-level (coarse-strata) tables, which take a ray's strata at even
    ranks when they overflow the ``s_strata`` budget
    (tests/test_twolevel_march.py:92-121); with ``s_flat`` it also
    evaluates the field on a flat ragged batch cut at ``N * s_flat``
    samples. Multi-cascade scenes (scale 1 and 4, exponential steps) it
    marches with the cascade march: union-grid strata under the same kind
    of budget. The port's render_train keeps the same samples (a full grid
    over a budget of 4 strata; a flat budget of 4 that cuts the batch;
    cascade strata over a budget of 8): the sample counts agree on every
    ray, and so do the frames. The JAX side runs under jit here."""
    cfg_kw = dict(SMALL, scale=scale)
    jcfg = jngp.NGPConfig(grid="LowRank", max_samples=256, **cfg_kw)
    jmodel = jngp.NGP(jcfg)
    params = jmodel.init(jax.random.PRNGKey(1))
    tcfg = tngp.NGPConfig(**cfg_kw)
    tmodel = tngp.NGP(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params)))
    bits, rays_o, rays_d, _, _ = _batch(n=256, seed=2, fill=fill,
                                        cascades=tcfg.cascades)
    rays_o = rays_o * np.float32(2 * scale)
    occ_j = dataclasses.replace(jngp.OccupancyState.create(jcfg),
                                density_bitfield=jnp.asarray(bits)
                                ).refresh_coarse(jcfg)
    e = 1 / 256 if scale > 0.5 else 0.0
    if scale > 0.5:
        assert jmarch.cascades_stratum(e, scale, tcfg.cascades)[0] > 0
    else:
        assert jmarch.twolevel_stratum(0.0, 256, 0.5, 32, 1, 1.0)[0] > 0
    rcfg_kw = dict(s_max_train=32, max_samples=256, s_strata=s_strata,
                   s_flat=s_flat, exp_step_factor=e)
    key = jax.random.PRNGKey(3)
    render = jax.jit(jrendering.render_train, static_argnums=(0, 6))
    want = render(jmodel, params, occ_j, jnp.asarray(rays_o),
                  jnp.asarray(rays_d), key, jrendering.RenderConfig(**rcfg_kw))
    noise = np.asarray(jax.random.uniform(jax.random.split(key, 3)[0],
                                          (256,)))
    occ_t = dataclasses.replace(tngp.OccupancyState.create(tcfg, "cpu"),
                                density_bitfield=_t(bits)
                                ).refresh_coarse(tcfg)
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
    if scale > 0.5:     # the budget cut rays that the exact march keeps
        rcfg = trendering.RenderConfig(**rcfg_kw)
        exact = trendering.march_rays_train(
            _t(rays_o), _t(rays_d),
            trendering._scene_hits(tmodel, _t(rays_o), _t(rays_d)),
            occ_t.density_bitfield, tcfg.cascades, scale, e, 32, 256,
            _t(noise), rcfg.n_rungs(scale, 32), 32)
        assert (exact.n_samples.numpy() > counts_t).mean() > 0.1
    for key_ in ("rgb", "opacity", "depth"):
        np.testing.assert_allclose(got[key_].numpy(), np.asarray(want[key_]),
                                   atol=1e-5)


# --------------------------------------------------------------- occupancy
def _occ_models(scale=0.5, **extra):
    kw = dict(SMALL, scale=scale)
    kw.update(extra)
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


@pytest.mark.parametrize("scale", [0.5, 1.0, 4.0])
def test_occupancy_march_grids_match_jax_refresh_coarse(scale, tmp_path):
    """The stage-A grids ``OccupancyState`` derives wherever the bitfield
    changes, after a refresh and after a checkpoint round trip: at several
    cascades the JAX ``refresh_coarse``'s ``union_bits`` bit for bit; at
    one, its dilated coarse bitfield (the pooled grid of the two-level
    march). Visible cells only in one corner block of each cascade (the
    first 1/64 of the Morton codes) keep the dilated union sparse; at scale
    1, whose union is dilated by 15 cells, on a grid of 64."""
    jmodel, _, tmodel = _occ_models(scale, grid_size=64 if scale == 1.0
                                    else 32)
    jcfg, tcfg = jmodel.cfg, tmodel.cfg
    rng = np.random.default_rng(11)
    visible = (rng.random((tcfg.cascades, tcfg.n_cells)) < 0.3) \
        & (np.arange(tcfg.n_cells) < tcfg.n_cells // 64)
    grid0 = np.where(visible, 0.0, -1.0).astype(np.float32)
    occ = dataclasses.replace(tngp.OccupancyState.create(tcfg, "cpu"),
                              density_grid=_t(grid0))
    noise = rng.uniform(-1, 1, (tcfg.cascades, tcfg.n_cells, 3))
    occ = tmodel.update_density_grid(occ, 0.01 * 1024 / np.sqrt(3),
                                     _t(noise.astype(np.float32)))
    path = str(tmp_path / "occ.ckpt.npz")
    tckpt.save_ckpt(path, tckpt.params_to_numpy(tmodel),
                    occ=tckpt.occupancy_to_numpy(occ))
    loaded = tckpt.occupancy_from_numpy(tckpt.load_ckpt(path)["occ"], tcfg,
                                        "cpu")
    bits = occ.density_bitfield.numpy()
    assert 0.001 < np.unpackbits(bits).mean() < 0.01
    want = dataclasses.replace(jngp.OccupancyState.create(jcfg),
                               density_bitfield=jnp.asarray(bits)
                               ).refresh_coarse(jcfg)
    for got in (occ, loaded):
        assert got.derived_from is got.density_bitfield
        if scale > 0.5:
            assert got.stage_a is None
            np.testing.assert_array_equal(got.union_bits.numpy(),
                                          np.asarray(want.union_bits))
            assert np.unpackbits(got.union_bits.numpy()).mean() < 0.9
        else:
            assert got.union_bits is None
            g2 = tcfg.grid_size // 2
            coarse = tmorton.spatial_to_morton_values(got.stage_a, g2)
            np.testing.assert_array_equal(
                np.packbits(coarse.numpy(), bitorder="little"),
                np.asarray(want.coarse_bitfield))


# ---------------------------------------------------------- pose refinement
@pytest.mark.parametrize("case", ["zero", "tiny", "random"])
def test_axisangle_to_R_matches_jax(case):
    """Rodrigues as the JAX package computes it: the rotation and the
    gradient of a weighted sum of its entries (jax.grad), at v = 0 (where
    --optimize_ext starts dR), under the 1e-14 clamp of the squared norm,
    and at random v; finite at zero; in float64 for a float64 v (the
    trainer's pose refinement). 1e-6 relative."""
    rng = np.random.default_rng(13)
    v = {"zero": np.zeros((3, 3), np.float32),
         "tiny": np.float32([[1e-8, -2e-8, 3e-8]] * 3),
         "random": rng.normal(scale=0.7, size=(16, 3)).astype(np.float32)
         }[case]
    w = rng.normal(size=(len(v), 3, 3)).astype(np.float32)

    def objective(r, to):
        return (r * to(w)).sum()

    r_j = jray.axisangle_to_R(jnp.asarray(v))
    g_j = np.asarray(jax.grad(lambda x: objective(
        jray.axisangle_to_R(x), jnp.asarray))(jnp.asarray(v)))
    vv = _t(v).requires_grad_()
    r_t = axisangle_to_R(vv)
    objective(r_t, _t).backward()
    np.testing.assert_allclose(r_t.detach().numpy(), np.asarray(r_j),
                               rtol=1e-6, atol=1e-6)
    assert np.isfinite(vv.grad.numpy()).all()
    _close(vv.grad.numpy(), g_j, rtol=1e-6, rel_atol=1e-6)
    np.testing.assert_allclose(axisangle_to_R(_t(v[0])).numpy(),
                               np.asarray(r_j)[0], rtol=1e-6, atol=1e-6)
    r64 = axisangle_to_R(_t(v).double())    # the trainer's refinement's
    assert r64.dtype == torch.float64
    np.testing.assert_allclose(r64.numpy(), np.asarray(r_j), rtol=1e-6,
                               atol=1e-6)
    if case == "zero":      # the identity, and the skew term's gradient
        np.testing.assert_array_equal(r_t.detach().numpy(),
                                      np.broadcast_to(np.eye(3), r_t.shape))
        assert np.abs(vv.grad.numpy()).max() > 0


def test_pose_group_keeps_its_rate():
    """--optimize_ext: dR and dT are an Adam group of their own at
    --pose_lr with optax's defaults (eps 1e-8), off the cosine staircase
    the network's group follows: over fit, after set_step (a resume), and
    step by step as optax.adam(pose_lr) moves the same parameters under the
    same gradients (test_adam_steps_match_optax's tolerance)."""
    scene = make_scene(n_train=4, n_test=1, wh=8, seed=0)
    system = ttrain.NeRFSystem(_hparams(
        optimize_ext=True, pose_lr=3e-3, num_epochs=4, steps_per_epoch=5,
        batch_size=64), device="cpu")
    system.setup(MemoryDataset.from_scene(scene, "train"))
    system.configure(0)
    net, pose = system.optimizer.param_groups
    assert [p.shape for p in pose["params"]] == [(4, 3), (4, 3)]
    assert pose["params"][0] is system.ext["dR"]
    assert pose["eps"] == 1e-8 and pose["betas"] == (0.9, 0.999)
    assert net["eps"] == 1e-15
    grads = []
    system.optimizer.register_step_pre_hook(lambda opt, args, kwargs: (
        grads.append([p.grad.clone() for p in opt.param_groups[1]["params"]])))
    m = system.fit(12)
    assert len(grads) == 12
    assert len(set(m["lr"].tolist())) == 3          # the staircase moved
    assert pose["lr"] == 3e-3
    tx = optax.adam(3e-3)
    p = {"dR": jnp.zeros((4, 3)), "dT": jnp.zeros((4, 3))}
    state = tx.init(p)
    for g_r, g_t in grads:
        upd, state = tx.update({"dR": jnp.asarray(g_r.numpy()),
                                "dT": jnp.asarray(g_t.numpy())}, state, p)
        p = optax.apply_updates(p, upd)
    for name in ("dR", "dT"):
        got = system.ext[name].detach().numpy()
        assert np.abs(got).max() > 0
        np.testing.assert_allclose(got, np.asarray(p[name]), rtol=1e-6,
                                   atol=1e-7)
    system.set_step(17)
    assert pose["lr"] == 3e-3 and net["lr"] == system.schedule(17)
    system.fit(2)
    assert pose["lr"] == 3e-3 and system.global_step == 19


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
    (dict(eval_lpips=True), "lpips_weights"),
    (dict(num_gpus=2), "process group of 2 ranks"),
    (dict(ray_sampling_strategy="one_ray"), "ray_sampling_strategy"),
    (dict(num_gpus=4), "process group of 4 ranks")])
def test_unported_trainer_knobs_raise(knob, error):
    """What the trainer cannot run raises ``ValueError`` when it is built:
    LPIPS without its weights (``--lpips_weights``), data parallelism on
    two or four ranks outside a process group of as many (``main`` or
    ``torchrun`` makes one; tests/test_torch_dp.py) and an unknown ray
    sampling; ``profile`` is ported (tests/test_torch_eval.py)."""
    with pytest.raises(ValueError, match=error):
        ttrain.NeRFSystem(_hparams(**knob), device="cpu")
    ttrain.NeRFSystem(_hparams(weight_path=None, num_gpus=1), device="cpu")
