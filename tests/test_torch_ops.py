"""Parity of the PyTorch port's ops with the JAX package, on the CPU.

Each test draws its inputs with numpy from a seed and feeds the same arrays
to the JAX function and to its port. Tolerances:

* Morton codes, packbits, bitfield lookups, the march's rung indices, sample
  counts and masks, the procedural cameras: bit-exact. The JAX side runs op
  by op (not under ``jit``), where XLA evaluates ``o + t * d`` without a
  fused multiply-add, exactly as torch does.
* t_ladder, calc_dt, ray/AABB, SH, compositing: atol 1e-6 (float32 ops
  whose library implementations may differ by an ulp).
* hat product: atol/rtol 1e-4. Both sides round the same operands to bf16
  and accumulate in fp32; only the summation order differs.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mfnerf_tpu.ops import composite as jcomposite
from mfnerf_tpu.ops import hatmul as jhatmul
from mfnerf_tpu.ops import intersection as jinter
from mfnerf_tpu.ops import lowrank as jlowrank
from mfnerf_tpu.ops import morton as jmorton
from mfnerf_tpu.ops import ray_march as jmarch
from mfnerf_tpu.ops import sh as jsh
from mfnerf_tpu.ops import stepping as jstep
from mfnerf_tpu.models import rendering as jrendering

from mfnerf_tpu_torch.ops import composite as tcomposite
from mfnerf_tpu_torch.ops import hatmul as thatmul
from mfnerf_tpu_torch.ops import intersection as tinter
from mfnerf_tpu_torch.ops import morton as tmorton
from mfnerf_tpu_torch.ops import ray_march as tmarch
from mfnerf_tpu_torch.ops import sh as tsh
from mfnerf_tpu_torch.ops import stepping as tstep
from mfnerf_tpu_torch.ops.activations import trunc_exp as t_trunc_exp
from mfnerf_tpu_torch.models import rendering as trendering


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread. The suite runs in several worker processes, and
    torch's default of one thread per core oversubscribes the CPU; the
    per-op thread barriers of these many small ops then stall."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x)


# ------------------------------------------------------------ morton & bits
def test_morton_roundtrip_bit_exact():
    rng = np.random.default_rng(0)
    coords = rng.integers(0, 1024, (4096, 3), dtype=np.int32)
    want = _np(jmorton.morton3d(jnp.asarray(coords))).astype(np.int64)
    got = tmorton.morton3d(_t(coords)).numpy()
    np.testing.assert_array_equal(got, want)

    codes = rng.integers(0, 1 << 30, 4096, dtype=np.int64)
    want_inv = _np(jmorton.morton3d_invert(jnp.asarray(codes, jnp.uint32)))
    got_inv = tmorton.morton3d_invert(_t(codes)).numpy()
    np.testing.assert_array_equal(got_inv, want_inv)
    np.testing.assert_array_equal(tmorton.morton3d(_t(got_inv)).numpy(),
                                  codes)


def test_packbits_and_lookup_bit_exact():
    rng = np.random.default_rng(1)
    grid = rng.normal(size=(2, 16 ** 3)).astype(np.float32)
    want = _np(jmorton.packbits(jnp.asarray(grid), 0.3))
    got = tmorton.packbits(_t(grid), 0.3).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.uint8

    idx = rng.integers(0, grid.size, 5000, dtype=np.int32)
    want_b = _np(jmorton.bitfield_lookup(jnp.asarray(want),
                                         jnp.asarray(idx)))
    got_b = tmorton.bitfield_lookup(_t(got), _t(idx)).numpy()
    np.testing.assert_array_equal(got_b, want_b)
    np.testing.assert_array_equal(got_b, grid.reshape(-1)[idx] > 0.3)


# ---------------------------------------------------------------- stepping
@pytest.mark.parametrize("e", [0.0, 1.0 / 256])
def test_ladder_and_dt_match(e):
    rng = np.random.default_rng(2)
    t0 = rng.uniform(0.01, 2.0, 300).astype(np.float32)
    ks = np.arange(700, dtype=np.int32)
    args = (e, 1024, 128, 0.5 if e == 0 else 4.0)
    want = _np(jstep.t_ladder(jnp.asarray(t0), jnp.asarray(ks), *args))
    got = tstep.t_ladder(_t(t0), _t(ks), *args).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        tstep.calc_dt(_t(want), *args).numpy(),
        _np(jstep.calc_dt(jnp.asarray(want), *args)), atol=1e-6)
    assert tstep.max_ladder_steps(0.01, 3.0, *args) == \
        jstep.max_ladder_steps(0.01, 3.0, *args)


def test_mip_selection_bit_exact():
    rng = np.random.default_rng(3)
    xyz = (rng.normal(size=(4000, 3)) * 3).astype(np.float32)
    dt = rng.uniform(0, 0.2, 4000).astype(np.float32)
    dt[:10] = 0.0
    np.testing.assert_array_equal(
        tstep.mip_from_pos(_t(xyz), 5).numpy(),
        _np(jstep.mip_from_pos(jnp.asarray(xyz), 5)))
    np.testing.assert_array_equal(
        tstep.mip_from_dt(_t(dt), 128, 5).numpy(),
        _np(jstep.mip_from_dt(jnp.asarray(dt), 128, 5)))
    np.testing.assert_array_equal(
        tstep._frexp_exponent(_t(xyz)).numpy(),
        _np(jstep._frexp_exponent(jnp.asarray(xyz))))


# ------------------------------------------------------- geometry, SH, exp
def _rays(n, seed, miss_every=0):
    rng = np.random.default_rng(seed)
    rays_o = np.tile(np.float32([[0.0, 0.0, -1.4]]), (n, 1))
    d = rng.normal(size=(n, 3)).astype(np.float32) \
        * np.float32([0.3, 0.3, 0]) + np.float32([0, 0, 1])
    rays_d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    if miss_every:
        rays_d[::miss_every] = np.float32([0.0, 0.0, -1.0])
    return rays_o, rays_d


def test_aabb_and_clamp_near():
    rays_o, rays_d = _rays(1000, 4, miss_every=7)
    rays_o = rays_o + np.random.default_rng(5).normal(
        scale=0.4, size=rays_o.shape).astype(np.float32)
    rays_o[:50] = 0.0   # origin inside the box: t_near clamps to >= 0
    want = _np(jrendering._clamp_near(jinter.ray_aabb_intersect_single(
        jnp.asarray(rays_o), jnp.asarray(rays_d), jnp.zeros(3),
        jnp.full(3, 0.5))))
    got = trendering._clamp_near(tinter.ray_aabb_intersect_single(
        _t(rays_o), _t(rays_d), torch.zeros(3), torch.full((3,), 0.5)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert (want[:, 0] == -1).sum() > 100 and (want[:50, 0] == 0.01).all()


def test_sh_and_trunc_exp():
    rng = np.random.default_rng(6)
    d = rng.normal(size=(2000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    for degree in (1, 2, 3, 4):
        np.testing.assert_allclose(
            tsh.sh_encode(_t((d + 1) / 2), degree).numpy(),
            _np(jsh.sh_encode(jnp.asarray((d + 1) / 2), degree)), atol=1e-6)
    x = rng.normal(scale=4, size=1000).astype(np.float32)
    from mfnerf_tpu.ops.activations import trunc_exp
    np.testing.assert_allclose(t_trunc_exp(_t(x)).numpy(),
                               _np(trunc_exp(jnp.asarray(x))), rtol=1e-6)


# ------------------------------------------------------------- hat product
@pytest.mark.parametrize("ref", ["pallas_interpret", "xla_twin"])
@pytest.mark.parametrize("k,kp,r,n", [(65, 128, 16, jhatmul.TN + 37),
                                      (257, 384, 128, 600)])
def test_hat_prod_plain_matches_jax(k, kp, r, n, ref):
    rng = np.random.default_rng(7)
    u3 = rng.random((n, 3), dtype=np.float32)
    u3[:5] = 1.0          # the last knot: basis e_{K-1}
    u3[5:10] = 0.0
    u3[10:20] = np.float32(np.round(u3[10:20] * (k - 1)) / (k - 1))  # knots
    w = (1.0 + 0.3 * rng.normal(size=(3, kp, r))).astype(np.float32)
    w[:, k:, :] = 0.0     # rows past the knot count are zero padding
    if ref == "pallas_interpret":
        want = jhatmul.hat_prod(jnp.asarray(u3), jnp.asarray(w), k,
                                interpret=True)
    else:
        want = jlowrank._hat_cp_prod(jnp.asarray(u3), jnp.asarray(w[:, :k]),
                                     k, jnp.bfloat16)
    got = thatmul.hat_prod(_t(u3), _t(w[:, :k]), k)   # CPU -> plain
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4, rtol=1e-4)
    assert thatmul.hat_prod.launches == 0


def test_hat_prod_rejects_other_devices():
    u3 = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError):
        thatmul.hat_prod(u3, torch.zeros((3, 5, 8), device="meta"), 5)


# ---------------------------------------------------------------- marching
def _bitfield(g, seed, fill):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, g ** 3 // 8, dtype=np.uint8) & np.uint8(fill)


@pytest.mark.parametrize("rank_start", [0, 32])
def test_march_rays_train_bit_exact(rank_start):
    g, max_samples, s_max = 32, 128, 32
    rays_o, rays_d = _rays(256, 8, miss_every=9)
    bits = _bitfield(g, 9, 0x77)
    rcfg = jrendering.RenderConfig(max_samples=max_samples)
    n_rungs = rcfg.n_rungs(0.5, g, test=True)
    hits = _np(jrendering._clamp_near(jinter.ray_aabb_intersect_single(
        jnp.asarray(rays_o), jnp.asarray(rays_d), jnp.zeros(3),
        jnp.full(3, 0.5))))
    noise = np.zeros(256, np.float32)
    args = (1, 0.5, 0.0, g, max_samples)
    want = jmarch.march_rays_train(
        jnp.asarray(rays_o), jnp.asarray(rays_d), jnp.asarray(hits),
        jnp.asarray(bits), *args, jnp.asarray(noise), n_rungs, s_max,
        dt_scale=1, rank_start=rank_start)
    got = tmarch.march_rays_train(
        _t(rays_o), _t(rays_d), _t(hits), _t(bits), *args, _t(noise),
        n_rungs, s_max, dt_scale=1, rank_start=rank_start)
    np.testing.assert_array_equal(got.mask.numpy(), _np(want.mask))
    np.testing.assert_array_equal(got.n_samples.numpy(),
                                  _np(want.n_samples))
    np.testing.assert_array_equal(got.k_idx.numpy(), _np(want.k_idx))
    np.testing.assert_allclose(got.ts.numpy(), _np(want.ts), atol=1e-6)
    np.testing.assert_allclose(got.deltas.numpy(), _np(want.deltas),
                               atol=1e-6)
    np.testing.assert_allclose(got.xyzs.numpy(), _np(want.xyzs), atol=1e-6)
    assert got.n_samples.sum() > 0


@pytest.mark.parametrize("g,max_samples,pool_a", [(32, 256, 0), (64, 512, 0),
                                                   (64, 512, 4)])
@pytest.mark.parametrize("s_strata,fill", [(4, 0xFF), (4, 0x11),
                                           (32, 0x33)])
def test_march_rays_train_strata_bit_exact(g, max_samples, pool_a, s_strata,
                                           fill):
    """The exact march under the strata budget against the JAX two-level
    march, sample for sample on every ray: rays over the budget (a full
    grid) take their strata at even ranks, rays under it march exactly.
    Camera-like rays with |d| up to 1.25, the training jitter."""
    scale, dir_norm, n = 0.5, 1.25, 384
    rays_o, rays_d = _rays(n, 11, miss_every=13)
    rays_d = rays_d * np.random.default_rng(12).uniform(
        1.0, dir_norm, (n, 1)).astype(np.float32)
    bits = _bitfield(g, 13, fill)
    rcfg = jrendering.RenderConfig(max_samples=max_samples)
    n_rungs = rcfg.n_rungs(scale, g)
    stratum, _ = jmarch.twolevel_stratum(0.0, max_samples, scale, g, 1,
                                         dir_norm)
    assert stratum == tmarch.twolevel_stratum(0.0, max_samples, scale, g, 1,
                                              dir_norm) > 1
    hits = _np(jrendering._clamp_near(jinter.ray_aabb_intersect_single(
        jnp.asarray(rays_o), jnp.asarray(rays_d), jnp.zeros(3),
        jnp.full(3, scale))))
    noise = np.random.default_rng(14).random(n, dtype=np.float32)
    tables = jmorton.occupancy_nbr_tables(jnp.asarray(bits), g,
                                          pool_a=pool_a)
    pool_kw = dict(nbr_a=tables[2], g_a=g // pool_a) if pool_a else {}
    want = jmarch.march_rays_train_twolevel(
        jnp.asarray(rays_o), jnp.asarray(rays_d), jnp.asarray(hits),
        tables[1], tables[0], scale, 0.0, g, max_samples,
        jnp.asarray(noise), n_rungs, 64, stratum, s_strata=s_strata,
        dir_norm=dir_norm, **pool_kw)
    strata = tmarch.Strata(tmarch.stage_a_grid(_t(bits), g, pool_a or 2),
                           stratum, s_strata, dir_norm)
    got = tmarch.march_rays_train(
        _t(rays_o), _t(rays_d), _t(hits), _t(bits), 1, scale, 0.0, g,
        max_samples, _t(noise), n_rungs, 64, strata=strata)
    np.testing.assert_array_equal(got.n_samples.numpy(),
                                  _np(want.n_samples))
    np.testing.assert_array_equal(got.mask.numpy(), _np(want.mask))
    np.testing.assert_array_equal(got.k_idx.numpy()[got.mask.numpy()],
                                  _np(want.k_idx)[_np(want.mask)])
    np.testing.assert_allclose(got.xyzs.numpy(), _np(want.xyzs), atol=1e-6)
    exact = tmarch.march_rays_train(
        _t(rays_o), _t(rays_d), _t(hits), _t(bits), 1, scale, 0.0, g,
        max_samples, _t(noise), n_rungs, 64)
    cut = (exact.n_samples != got.n_samples).numpy()
    # a full grid puts every hitting ray over a budget of 4 strata
    assert cut.any() == (s_strata == 4), cut.sum()
    assert got.n_samples.sum() > 0


def test_march_rays_window_bit_exact():
    g, max_samples = 32, 1024
    rays_o, rays_d = _rays(300, 10)
    bits = _bitfield(g, 11, 0x33)
    hits = _np(jrendering._clamp_near(jinter.ray_aabb_intersect_single(
        jnp.asarray(rays_o), jnp.asarray(rays_d), jnp.zeros(3),
        jnp.full(3, 0.5))))
    cursor = np.random.default_rng(12).integers(0, 600, 300).astype(np.int32)
    args = (1, 0.5, 0.0, g, max_samples, 96, 8)
    want = jmarch.march_rays_window(
        jnp.asarray(rays_o), jnp.asarray(rays_d), jnp.asarray(hits[:, 0]),
        jnp.asarray(hits[:, 1]), jnp.asarray(cursor), jnp.asarray(bits),
        *args, dt_scale=1)
    got = tmarch.march_rays_window(
        _t(rays_o), _t(rays_d), _t(hits[:, 0]), _t(hits[:, 1]),
        _t(cursor.astype(np.int64)), _t(bits), *args, dt_scale=1)
    for name in ("mask", "n_samples", "cursor", "exhausted", "k_idx"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      _np(getattr(want, name)), err_msg=name)
    np.testing.assert_allclose(got.ts.numpy(), _np(want.ts), atol=1e-6)
    np.testing.assert_allclose(got.xyzs.numpy(), _np(want.xyzs), atol=1e-6)
    assert got.exhausted.any() and not got.exhausted.all()


# ------------------------------------------------------------- compositing
def test_composite_test_step():
    rng = np.random.default_rng(13)
    n, s = 400, 48
    sig = rng.exponential(20.0, (n, s)).astype(np.float32)
    rgbs = rng.random((n, s, 3), dtype=np.float32)
    deltas = np.full((n, s), 1.7320508 / 128, np.float32)
    ts = np.cumsum(deltas, 1).astype(np.float32)
    mask = rng.random((n, s)) < 0.8
    opacity = rng.uniform(0, 0.9, n).astype(np.float32)
    depth = rng.random(n, dtype=np.float32)
    rgb = rng.random((n, 3), dtype=np.float32)
    alive = rng.random(n) < 0.9
    for thr in (1e-4, 1e-2):
        want = jcomposite.composite_test_step(
            *(jnp.asarray(a) for a in (sig, rgbs, deltas, ts, mask, opacity,
                                       depth, rgb, alive)), thr)
        got = tcomposite.composite_test_step(
            *(_t(a) for a in (sig, rgbs, deltas, ts, mask, opacity, depth,
                              rgb, alive)), thr)
        for w, g_ in zip(want[:3], got[:3]):
            np.testing.assert_allclose(g_.numpy(), _np(w), atol=1e-6)
        np.testing.assert_array_equal(got[3].numpy(), _np(want[3]))
