"""The port's hash-grid encoder (Hash / Window / MixedFeature) against the JAX
package, on the CPU.

Inputs are drawn with numpy from a seed, with points on the box faces (where
the corner clamp acts), and go through the JAX functions op by op
(``jax.disable_jit``: under jit XLA may contract ``x * scale + 0.5`` into a
fused multiply-add, which can move a sample across a cell) and through the
port's plain versions. Tolerances:

* layout (``HashGridConfig.create``) and corner rows: exact;
* forward: 1e-6 relative (the same float32 operations in the same order);
* backward: d_params within 1e-5 of its largest value (scatter-adds in
  another order), d_x and d_window within 1e-5 relative, with an absolute
  floor of 1e-5 of the largest value (sums over levels and samples in
  another order); the same for the sampled-corner gradient given the same
  uniforms.
"""
import argparse
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfnerf_tpu.models import ngp as jngp
from mfnerf_tpu.ops import hashgrid as jhash

from mfnerf_tpu_torch import train as ttrain
from mfnerf_tpu_torch.datasets.memory import MemoryDataset
from mfnerf_tpu_torch.models import ngp as tngp
from mfnerf_tpu_torch.ops import hashgrid as thash
from mfnerf_tpu_torch.utils.ckpt import params_from_numpy
from mfnerf_tpu_torch.utils.procedural import make_scene

# small: L 8, T 14, N_max 128 (b = 4^(1/7)); a few thousand points
SMALL = dict(L=8, F=2, log2_T=14, N_min=16, N_max=128)
N = 3000


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread. The suite runs in several worker processes, and
    torch's default of one thread per core oversubscribes the CPU; the
    per-op thread barriers of these many small ops then stall."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(grid, n_tables=1, grad_corners=8, **kw):
    """The same configuration from both packages' NGPConfig."""
    cfg = dict(SMALL, grid=grid, N_tables=n_tables,
               hash_grad_samples=grad_corners, **kw)
    return jngp.NGPConfig(**cfg).hash_cfg, tngp.NGPConfig(**cfg).hash_cfg


def _points(n=N, seed=0):
    x = np.random.default_rng(seed).random((n, 3), dtype=np.float32)
    x[:40, 0] = 1.0           # on the box faces, where the clamp acts
    x[40:80, 1] = 1.0
    x[80:120, 2] = 1.0
    x[120:130] = 1.0
    x[130:140] = 0.0
    return x


def _operands(cfg, seed=1, n=N):
    rng = np.random.default_rng(seed)
    params = rng.normal(size=(cfg.n_params, cfg.F)).astype(np.float32)
    g = rng.normal(size=(n, cfg.out_dim)).astype(np.float32)
    return params, _points(n, seed), g


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rel,
                               atol=rel * float(np.abs(want).max()))


LAYOUTS = [("Hash", 1, SMALL), ("Window", 1, SMALL),
           ("MixedFeature", 1, SMALL), ("MixedFeature", 2, SMALL),
           ("MixedFeature", 4, SMALL), ("MixedFeature", 8, SMALL),
           # the two full-width configurations of chip_smoke.py
           ("Hash", 1, dict(L=16, F=2, log2_T=19, N_min=16, N_max=2048)),
           ("MixedFeature", 8, dict(L=16, F=2, log2_T=20, N_min=16,
                                    N_max=2048))]


@pytest.mark.parametrize("grid,n_tables,kw", LAYOUTS)
def test_config_matches_jax(grid, n_tables, kw):
    cfg = dict(kw, grid=grid, N_tables=n_tables)
    want = jngp.NGPConfig(**cfg).hash_cfg
    got = tngp.NGPConfig(**cfg).hash_cfg
    assert tngp.NGPConfig(**cfg).per_level_scale == \
        jngp.NGPConfig(**cfg).per_level_scale
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.n_params == want.n_params and got.levels == tuple(
        thash.LevelSpec(**dataclasses.asdict(m)) for m in want.levels)
    if kw["L"] == 16:
        assert got.n_params == 5_710_032
        assert sum(m.dense for m in got.levels) == 6
    if grid == "MixedFeature" and n_tables == 2:     # salted shared tables
        assert {m.salt for m in got.levels} == {
            0, 3674653429, (2 * 3674653429) & 0xFFFFFFFF,
            (3 * 3674653429) & 0xFFFFFFFF}
    if grid == "MixedFeature" and n_tables == 4:     # packed dense levels
        assert got.levels[0].dense and got.levels[1].dense
        assert got.levels[1].offset == got.levels[0].size


@pytest.mark.parametrize("grid,n_tables", [("Hash", 1), ("MixedFeature", 2),
                                           ("MixedFeature", 4)])
def test_corner_rows_match_jax(grid, n_tables):
    """Every corner row, hashed in uint32 by JAX and in int64 by the port,
    including corners past the last one (the clamp) and salted levels."""
    jcfg, tcfg = _cfgs(grid, n_tables)
    res = np.array([m.res for m in jcfg.levels])
    corner = (np.random.default_rng(2).random((jcfg.L, 500, 3))
              * (res + 1)[:, None, None]).astype(np.int32)
    want = np.asarray(jhash._corner_index(jnp.asarray(corner), *map(
        jnp.asarray, jhash._level_arrays(jcfg)[1:])))
    arrays = thash._level_arrays(tcfg, torch.device("cpu"))
    got = thash._corner_index(torch.from_numpy(corner).long(), *arrays[1:])
    np.testing.assert_array_equal(got.numpy(), want)
    assert (corner >= res[:, None, None]).any()


@pytest.mark.parametrize("grid,n_tables,alpha", [
    ("Hash", 1, None), ("Window", 1, 1.0), ("Window", 1, 0.6),
    ("MixedFeature", 2, None), ("MixedFeature", 4, None)])
def test_forward_matches_jax(grid, n_tables, alpha):
    jcfg, tcfg = _cfgs(grid, n_tables)
    params, x, _ = _operands(jcfg)
    win_j = None if alpha is None else jhash.window_weights(jcfg, alpha)
    win_t = None if alpha is None else thash.window_weights(tcfg, alpha)
    if alpha is not None:
        np.testing.assert_allclose(win_t.numpy(), np.asarray(win_j),
                                   rtol=1e-6, atol=1e-7)
    with jax.disable_jit():
        want = np.asarray(jhash._fwd_impl(jnp.asarray(params),
                                          jnp.asarray(x), jcfg, win_j))
    got = thash.hashgrid_encode_plain(torch.from_numpy(params),
                                      torch.from_numpy(x), tcfg, win_t)
    assert got.shape == (N, jcfg.L * jcfg.F) and got.dtype == torch.float32
    _close(got.numpy(), want, rel=1e-6)
    with torch.no_grad():
        again = thash.hashgrid_encode(torch.from_numpy(params),
                                      torch.from_numpy(x), tcfg, win_t)
    assert torch.equal(again, got)
    assert thash.hashgrid_encode.launches == 0


def _jax_vjp(jcfg, params, x, g, window=None, noise=None):
    p, xx = jnp.asarray(params), jnp.asarray(x)
    gn = None if noise is None else jnp.asarray(noise)
    with jax.disable_jit():
        if window is None:
            _, vjp = jax.vjp(lambda p_, x_: jhash.hashgrid_encode(
                p_, x_, jcfg, None, gn), p, xx)
            return (*vjp(jnp.asarray(g)), None)
        _, vjp = jax.vjp(lambda p_, x_, w_: jhash.hashgrid_encode(
            p_, x_, jcfg, w_, gn), p, xx, window)
        return vjp(jnp.asarray(g))


@pytest.mark.parametrize("grid,n_tables,alpha,m", [
    ("Hash", 1, None, 8), ("MixedFeature", 2, None, 8),
    ("MixedFeature", 4, None, 8), ("Window", 1, 0.6, 8),
    ("Hash", 1, None, 1), ("MixedFeature", 2, None, 2),
    ("Window", 1, 0.6, 1)])
def test_backward_matches_jax(grid, n_tables, alpha, m):
    """d_params, d_x and d_window of the JAX VJP, exact (m = 8) and with the
    sampled-corner table gradient given the same uniforms (m = 1, 2)."""
    jcfg, tcfg = _cfgs(grid, n_tables, grad_corners=m)
    params, x, g = _operands(jcfg)
    noise = None
    if m < 8:
        noise = np.random.default_rng(3).random((N, m), dtype=np.float32)
    win_j = None if alpha is None else jhash.window_weights(jcfg, alpha)
    dp_j, dx_j, dw_j = _jax_vjp(jcfg, params, x, g, win_j, noise)
    win_t = None if alpha is None else thash.window_weights(tcfg, alpha)
    t = torch.from_numpy
    dp, dx, dw = thash.hashgrid_bwd_plain(
        t(params), t(x), tcfg, t(g), win_t,
        None if noise is None else t(noise))
    assert dp.shape == params.shape and dx.shape == (N, 3)
    _close(dp.numpy(), dp_j)
    _close(dx.numpy(), dx_j)
    if alpha is None:
        assert dw is None
    else:
        assert dw.shape == (jcfg.L,)
        _close(dw.numpy(), dw_j)
    # every level's table got updates; the sampled gradient hits fewer rows
    assert (np.asarray(dp_j) != 0).any(axis=1).sum() > 1000
    if m < 8:
        exact = thash.hashgrid_bwd_plain(t(params), t(x), tcfg, t(g),
                                         win_t)[0]
        assert (dp != 0).any(dim=1).sum() < (exact != 0).any(dim=1).sum()


@pytest.mark.parametrize("need_dx", [True, False])
@pytest.mark.parametrize("alpha", [None, 0.6])
def test_autograd_runs_the_jax_vjp(need_dx, alpha):
    """HashGridEncode's backward is hashgrid_bwd_plain's VJP bit for bit
    (not torch autograd of the forward); d_x only when x needs it."""
    grid = "Hash" if alpha is None else "Window"
    _, tcfg = _cfgs(grid, grad_corners=2)
    params, x, g = (torch.from_numpy(a) for a in _operands(tcfg, seed=4))
    noise = torch.from_numpy(np.random.default_rng(5).random(
        (N, 2), dtype=np.float32))
    win = None if alpha is None else \
        thash.window_weights(tcfg, alpha).requires_grad_()
    p = params.clone().requires_grad_()
    xx = x.clone().requires_grad_(need_dx)
    thash.hashgrid_encode(p, xx, tcfg, win, noise).backward(g)
    dp, dx, dw = thash.hashgrid_bwd_plain(
        params, x, tcfg, g, None if win is None else win.detach(), noise,
        need_dx)
    assert torch.equal(p.grad, dp)
    if need_dx:
        assert torch.equal(xx.grad, dx)
    else:
        assert dx is None and xx.grad is None
    if alpha is not None:
        assert torch.equal(win.grad, dw)
    assert thash.hashgrid_bwd.launches == 0


def test_level_table_for_the_kernels():
    """The (L, 6) uint32 rows the kernels take: scale's fp32 bits, res,
    offset, size - 1 (the hash mask), salt, dense."""
    _, tcfg = _cfgs("MixedFeature", 4)
    table = thash.level_table(tcfg)
    assert table.dtype == np.uint32 and table.shape == (tcfg.L, 6)
    for row, m in zip(table, tcfg.levels):
        assert row[:1].view(np.float32)[0] == np.float32(m.scale)
        assert tuple(row[1:]) == (m.res, m.offset, m.size - 1, m.salt,
                                  int(m.dense))
    # the backward's block shape: a warp a 32 consecutive samples, which
    # walks the levels; the blocks (and so the d_window partials) depend on
    # N alone
    for n in (1, 15, 202_522, 1 << 19, 110_000, 10 ** 7):
        spb, blocks = thash.bwd_grid(n)
        assert spb % 32 == 0 and 32 <= spb <= 256
        assert 1 <= blocks <= thash.BWD_BLOCKS and (blocks - 1) * spb < n
        assert blocks == min(-(-n // spb), thash.BWD_BLOCKS)


def test_kernel_checks_refuse_what_the_kernels_do_not_take():
    """The wrappers' checks: the level table's 32 levels, the backward's
    16 features."""
    x = torch.zeros((4, 3))
    for kw in (dict(L=33, F=2), dict(L=4, F=17)):
        _, tcfg = _cfgs("Hash", **dict(SMALL, log2_T=10, **kw))
        params = torch.zeros((tcfg.n_params, tcfg.F))
        with pytest.raises(ValueError, match="the kernels take"):
            thash._check(params, x, tcfg, None)
    _, tcfg = _cfgs("Hash", **dict(SMALL, log2_T=10, L=32, F=16))
    thash._check(torch.zeros((tcfg.n_params, 16)), x, tcfg, None)


FIXED_CASES = [("Hash", 1, None, 8), ("Window", 1, 0.6, 8),
               ("MixedFeature", 2, None, 8), ("Hash", 1, None, 1),
               ("Window", 1, 0.6, 1), ("MixedFeature", 2, None, 1)]


def _fixed_operands(grid, n_tables, alpha, m, seed=6):
    jcfg, tcfg = _cfgs(grid, n_tables, grad_corners=m)
    params, x, g = _operands(jcfg, seed)
    noise = None if m == 8 else np.random.default_rng(seed + 1).random(
        (N, m), dtype=np.float32)
    return jcfg, tcfg, params, x, g, noise, alpha


@pytest.mark.parametrize("grid,n_tables,alpha,m", FIXED_CASES)
def test_fixed_point_model_matches_jax(grid, n_tables, alpha, m):
    """hashgrid_bwd_fixed_plain, the backward kernel's d_params in 64-bit
    fixed point, against the JAX VJP's d_params: within 1e-5 of the largest
    value (each update rounded by at most S 2^-62)."""
    jcfg, tcfg, params, x, g, noise, alpha = _fixed_operands(
        grid, n_tables, alpha, m)
    win_j = None if alpha is None else jhash.window_weights(jcfg, alpha)
    dp_j = _jax_vjp(jcfg, params, x, g, win_j, noise)[0]
    win_t = None if alpha is None else thash.window_weights(tcfg, alpha)
    t = torch.from_numpy
    dp = thash.hashgrid_bwd_fixed_plain(
        t(params), t(x), tcfg, t(g), win_t,
        None if noise is None else t(noise))
    assert dp.shape == params.shape and dp.dtype == torch.float32
    np.testing.assert_allclose(dp.numpy(), np.asarray(dp_j), rtol=0,
                               atol=1e-5 * float(np.abs(dp_j).max()))
    assert (dp != 0).any(dim=1).sum() > 1000


@pytest.mark.parametrize("grid,n_tables,alpha,m", FIXED_CASES[:3]
                         + FIXED_CASES[4:])
def test_fixed_point_model_ignores_sample_order(grid, n_tables, alpha, m):
    """The fixed-point d_params is bitwise the same for any order of the
    samples: integer sums do not depend on their order. The backward
    kernel's merge of a warp's equal rows relies on it."""
    _, tcfg, params, x, g, noise, alpha = _fixed_operands(
        grid, n_tables, alpha, m, seed=7)
    win = None if alpha is None else thash.window_weights(tcfg, alpha)
    t = torch.from_numpy
    perm = t(np.random.default_rng(8).permutation(N))
    args = [t(x), t(g), None if noise is None else t(noise)]
    want = thash.hashgrid_bwd_fixed_plain(t(params), args[0], tcfg, args[1],
                                          win, args[2])
    got = thash.hashgrid_bwd_fixed_plain(
        t(params), args[0][perm], tcfg, args[1][perm], win,
        None if noise is None else args[2][perm])
    assert torch.equal(got, want)
    # the float scatter of hashgrid_bwd_plain is only close
    plain = thash.hashgrid_bwd_plain(t(params), args[0], tcfg, args[1], win,
                                     args[2], need_dx=False)[0]
    assert float((plain - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


def test_fixed_point_scale():
    """2^k with S 2^k < 2^61 <= 2 S 2^k, for S = sum |g window| in fp64;
    1 for S = 0 and NaN for an S that is not finite."""
    _, tcfg = _cfgs("Window")
    n = 64
    win = thash.window_weights(tcfg, 0.6)
    g = torch.from_numpy(np.random.default_rng(9).normal(
        size=(n, tcfg.out_dim)).astype(np.float32))
    s = float((g.reshape(n, tcfg.L, tcfg.F) * win[None, :, None]).abs()
              .double().sum())
    scale = thash.fixed_point_scale(g, tcfg, win)
    assert math.log2(scale).is_integer()
    assert s * scale < 2.0 ** 61 <= 2 * s * scale
    assert thash.fixed_point_scale(g, tcfg) != scale     # window ignored
    # S exactly on a power of two: 2^k halves
    one = torch.zeros((1, tcfg.out_dim))
    one[0, 0] = 1.0
    assert thash.fixed_point_scale(one, tcfg) == 2.0 ** 60
    assert thash.fixed_point_scale(one * 0.75, tcfg) == 2.0 ** 61
    assert thash.fixed_point_scale(torch.zeros_like(g), tcfg) == 1.0
    one[0, 1] = math.inf
    assert math.isnan(thash.fixed_point_scale(one, tcfg))
    assert torch.isnan(thash.hashgrid_bwd_fixed_plain(
        torch.zeros((tcfg.n_params, tcfg.F)), torch.zeros((1, 3)), tcfg,
        one)).all()


@pytest.mark.parametrize("grid,n_tables", [("Hash", 1), ("MixedFeature", 8)])
def test_ngp_field_matches_jax(grid, n_tables):
    """The NGP field with a hash grid, its weights carried over from the JAX
    pytree by params_from_numpy (``hash_table`` unchanged)."""
    kw = dict(SMALL, grid=grid, N_tables=n_tables, rgb_channels=32)
    jmodel = jngp.NGP(jngp.NGPConfig(**kw))
    params = jmodel.init(jax.random.PRNGKey(0))
    params["hash_table"] = params["hash_table"] * 1e4   # features O(1)
    state = params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    tmodel = tngp.NGP(tngp.NGPConfig(**kw), device="cpu")
    fresh = {k: tuple(v.shape) for k, v in tmodel.state_dict().items()}
    assert fresh == {k: tuple(v.shape) for k, v in state.items()}
    assert "hash_table" in fresh and not any("lowrank" in k for k in fresh)
    table = tmodel.hash_table.detach()
    assert float(table.abs().max()) <= 1e-4 and float(table.std()) > 5e-5
    tmodel.load_state_dict(state)
    rng = np.random.default_rng(1)
    x = rng.uniform(-0.5, 0.5, (N, 3)).astype(np.float32)
    x[:20] = 0.5                                       # the box face
    d = rng.normal(size=(N, 3)).astype(np.float32)
    with jax.disable_jit():
        sig_j, rgb_j = jmodel.forward(params, jnp.asarray(x), jnp.asarray(d))
    with torch.no_grad():
        sig_t, rgb_t = tmodel(torch.from_numpy(x), torch.from_numpy(d))
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=1e-4,
                               atol=1e-6)
    assert float(sig_t.std()) > 0


def test_fit_procedural_scene_hash():
    """NeRFSystem trains a Hash field on a procedural scene: the test view's
    PSNR before (culled grid, one refresh) and after 200 steps, +8 dB and
    above 20 (the JAX package's bar, tests/test_e2e_train.py, which trains
    the same grid)."""
    hp = argparse.Namespace(
        dataset_name="nsvf", scale=0.5, use_exposure=False,
        distortion_loss_w=0.0, batch_size=512, num_epochs=1, lr=1e-2,
        optimize_ext=False, random_bg=False, grid="Hash", L=8, F=2, T=14,
        N_min=16, N_max=128, N_tables=1, rgb_channels=32, rgb_layers=2,
        seed=1337, s_max_train=32, s_max_test=64, test_chunk=4096,
        steps_per_epoch=200, grid_size=32, max_samples=256,
        refresh_half=True)
    scene = make_scene(n_train=8, n_test=1, wh=32, seed=0)
    system = ttrain.NeRFSystem(hp, device="cpu")
    system.setup(MemoryDataset.from_scene(scene, "train"),
                 MemoryDataset.from_scene(scene, "test"))
    system.configure(0)
    assert system.model.hash_cfg.grid_type == "Hash"
    ds = system.train_dataset
    system.occ = system.model.mark_invisible_cells(system.occ, ds.K,
                                                   system.poses, ds.img_wh)
    system.update_grid()
    before = system.validate()["test/psnr"]
    metrics = system.fit()
    after = system.validate()["test/psnr"]
    assert system.global_step == 200 and torch.isfinite(metrics["loss"]).all()
    assert metrics["loss"][-20:].mean() < metrics["loss"][:20].mean() / 4
    assert after > before + 8.0 and after > 20.0, (before, after)
    assert thash.hashgrid_encode.launches == thash.hashgrid_bwd.launches == 0
