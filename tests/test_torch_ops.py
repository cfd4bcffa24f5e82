"""Parity of the PyTorch port's ops with the JAX package, on the CPU.

Each test draws its inputs with numpy from a seed and feeds the same arrays
to the JAX function and to its port. Tolerances:

* Morton codes, packbits, bitfield lookups, the union grid, the march's
  rung indices, sample counts and masks, the procedural cameras:
  bit-exact. The JAX side runs op
  by op (not under ``jit``), where XLA evaluates ``o + t * d`` without a
  fused multiply-add, exactly as torch does.
* t_ladder, calc_dt, ray/AABB, SH, compositing: atol 1e-6 (float32 ops
  whose library implementations may differ by an ulp); the cascade
  march's ts, deltas and xyzs 1e-6 relative (t reaches 14 at scale 4,
  where an ulp is 9.5e-7).
* hat product: atol/rtol 1e-4. Both sides round the same operands to bf16
  and accumulate in fp32; only the summation order differs.
"""
import math

import numpy as np
import pytest
import torch

import jax
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

import test_cascades_march as jcasc


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


@pytest.mark.parametrize("dilate", [1, 2, 3])
@pytest.mark.parametrize("cascades", [2, 3, 4])
def test_union_bitfield_bit_exact(cascades, dilate):
    """The dilated world-space union of every cascade, bit for bit, on a
    random bitfield; the Morton <-> raster helpers it rests on too."""
    g = 32
    occupied = np.random.default_rng(10 * cascades + dilate).random(
        cascades * g ** 3) < 0.002
    bits = np.packbits(occupied, bitorder="little")
    want = _np(jmorton.union_bitfield(jnp.asarray(bits), g, cascades,
                                      dilate))
    got = tmorton.union_bitfield(_t(bits), g, cascades, dilate).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < np.unpackbits(got).mean() < 1
    cells = _np(jmorton._unpack_bits_morton(jnp.asarray(bits), g ** 3))
    np.testing.assert_array_equal(
        tmorton.unpack_bits_morton(_t(bits), g ** 3).numpy(), cells)
    spatial = tmorton.morton_values_to_spatial(_t(cells), g)
    np.testing.assert_array_equal(
        spatial.numpy(),
        _np(jmorton.morton_values_to_spatial(jnp.asarray(cells), g)))
    np.testing.assert_array_equal(
        tmorton.spatial_to_morton_values(spatial, g).numpy(), cells)


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


def _boxes_and_rays(seed):
    """Rays from around the unit box through a few boxes, one box twice
    (equal t_near on two indices: the stable sort's order), rays that miss
    everything and rays starting inside a box."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-0.6, 0.6, (6, 3)).astype(np.float32)
    centers[5] = centers[2]
    half = rng.uniform(0.05, 0.3, (6, 3)).astype(np.float32)
    half[5] = half[2]
    rays_o = rng.normal(size=(512, 3)).astype(np.float32)
    rays_o *= 2.5 / np.linalg.norm(rays_o, axis=1, keepdims=True)
    target = rng.uniform(-0.5, 0.5, (512, 3)).astype(np.float32)
    rays_d = target - rays_o
    rays_d /= np.linalg.norm(rays_d, axis=1, keepdims=True)
    rays_d[:40] = -rays_d[:40]              # pointing away: misses
    rays_o[40:60] = centers[0]              # inside box 0
    return rays_o, rays_d, centers, half


@pytest.mark.parametrize("max_hits", [1, 3, 8])
def test_ray_aabb_intersect_matches_jax(max_hits):
    """Several boxes, the nearest ``max_hits`` (below, near and above the
    hit counts, and above the box count: padded) sorted near to far; t
    1e-6, counts and indices exact."""
    rays_o, rays_d, centers, half = _boxes_and_rays(11)
    want = jinter.ray_aabb_intersect(jnp.asarray(rays_o), jnp.asarray(rays_d),
                                     jnp.asarray(centers), jnp.asarray(half),
                                     max_hits)
    got = tinter.ray_aabb_intersect(_t(rays_o), _t(rays_d), _t(centers),
                                    _t(half), max_hits)
    cnt, hits_t, idx = (_np(w) for w in want)
    np.testing.assert_array_equal(got[0].numpy(), cnt)
    np.testing.assert_allclose(got[1].numpy(), hits_t, atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), idx)
    assert got[0].dtype == got[2].dtype == torch.int32
    assert (cnt[:40] == 0).all() and (hits_t[:40] == -1).all()
    assert (hits_t[40:60, 0, 0] == 0).all()     # inside: t_near clamped
    assert cnt.max() > max_hits or max_hits == 8
    assert ((cnt > 0) & (cnt < max_hits)).any() or max_hits == 1
    # the twin boxes tie: the lower index first, as jnp.argsort keeps them
    twins = (idx == 2).any(1) & (idx == 5).any(1)
    assert twins.any() or max_hits == 1
    assert (np.argmax(idx == 2, 1) < np.argmax(idx == 5, 1))[twins].all()


@pytest.mark.parametrize("max_hits", [1, 2, 6])
def test_ray_sphere_intersect_matches_jax(max_hits):
    """Several spheres as the boxes above, and a ray tangent to a sphere
    (discriminant exactly 0: a miss in both); t 1e-5 (sums of three
    products and a square root), counts and indices exact."""
    rays_o, rays_d, centers, _ = _boxes_and_rays(12)
    radii = np.random.default_rng(13).uniform(0.1, 0.35, 6).astype(
        np.float32)
    radii[5] = radii[2]
    centers[4], radii[4] = 0.0, 1.0
    rays_o[60], rays_d[60] = [-2.0, 1.0, 0.0], [1.0, 0.0, 0.0]   # tangent
    want = jinter.ray_sphere_intersect(jnp.asarray(rays_o),
                                       jnp.asarray(rays_d),
                                       jnp.asarray(centers),
                                       jnp.asarray(radii), max_hits)
    got = tinter.ray_sphere_intersect(_t(rays_o), _t(rays_d), _t(centers),
                                      _t(radii), max_hits)
    cnt, hits_t, idx = (_np(w) for w in want)
    np.testing.assert_array_equal(got[0].numpy(), cnt)
    np.testing.assert_allclose(got[1].numpy(), hits_t, atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), idx)
    assert cnt[60] == 0 and (idx[60] == -1).all()
    assert (cnt[:40] == 0).all() and (cnt > min(max_hits, 3)).any()


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


@pytest.mark.parametrize("k,r,n", [(65, 16, 637), (257, 128, 600)])
def test_hat_prod_plain_fp32_matches_jax(k, r, n):
    """The fp32 mode (lr_matmul_dtype="float32"): the plain version in fp32
    end to end against the JAX _hat_cp_prod with mm_dtype float32, rtol
    1e-5 with atol 1e-5 of the largest value (the dense sums in another
    order); through hat_prod on the CPU too."""
    rng = np.random.default_rng(8)
    u3 = rng.random((n, 3), dtype=np.float32)
    u3[:5] = 1.0
    u3[5:10] = np.float32(np.round(u3[5:10] * (k - 1)) / (k - 1))
    w = (1.0 + 0.3 * rng.normal(size=(3, k, r))).astype(np.float32)
    want = _np(jlowrank._hat_cp_prod(jnp.asarray(u3), jnp.asarray(w), k,
                                     jnp.float32))
    for got in (thatmul.hat_prod_plain(_t(u3), _t(w), k, "float32"),
                thatmul.hat_prod(_t(u3), _t(w), k, "float32")):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    bf16 = thatmul.hat_prod_plain(_t(u3), _t(w), k).numpy()
    assert np.abs(bf16 - want).max() > 1e-3 * np.abs(want).max()
    with pytest.raises(ValueError, match="dtype"):
        thatmul.hat_prod(_t(u3), _t(w), k, "float16")
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


@pytest.mark.parametrize("dir_norm", [1.0, 1.25])
@pytest.mark.parametrize("scale", [0.5, 1.0, 1.5, 4.0, 16.0])
def test_cascades_stratum_matches_jax(scale, dir_norm):
    cascades = max(1 + int(np.ceil(np.log2(2 * scale))), 1)
    for e in (0.0, 1.0 / 256):
        want = jmarch.cascades_stratum(e, scale, cascades, dir_norm=dir_norm)
        assert tmarch.cascades_stratum(e, scale, cascades,
                                       dir_norm=dir_norm) == want
        assert (want[0] > 0) == (e > 0 and scale in (1.0, 4.0, 16.0))


@pytest.mark.parametrize("s_strata", [4, 8])
@pytest.mark.parametrize("occupancy", [0.004, 0.02, 0.06])
def test_march_rays_train_cascades_bit_exact(occupancy, s_strata):
    """The exact march under the cascade strata budget against the JAX
    cascade march (``march_rays_train_cascades``), sample for sample, on
    tests/test_cascades_march.py's scene (scale 4, 4 cascades, grid 32):
    k_idx, ts, deltas, xyzs, mask and n_samples. The budget cuts rays at
    every occupancy (over it) and leaves the rest exact (under it)."""
    fine, union, stratum, ro, rd, hits, noise = jcasc._setup(occupancy,
                                                             n=512)
    args = (jcasc.CASCADES, jcasc.SCALE, jcasc.E, jcasc.GRID,
            jcasc.MAX_SAMPLES)
    n_rungs = jstep.max_ladder_steps(0.01, 2 * 1.7320508 * jcasc.SCALE
                                     + 0.01, jcasc.E, jcasc.MAX_SAMPLES,
                                     jcasc.GRID, jcasc.SCALE)
    with jax.disable_jit():
        want = jmarch.march_rays_train_cascades(
            ro, rd, hits, fine, union, *args, noise, n_rungs, 64, stratum,
            s_strata=s_strata)
    rays = (_t(ro), _t(rd), _t(hits), _t(fine))
    got = tmarch.march_rays_train(
        *rays, *args, _t(noise), n_rungs, 64,
        strata=tmarch.Strata(_t(union), stratum, s_strata, 1.0, union=True))
    mask = _np(want.mask)
    np.testing.assert_array_equal(got.n_samples.numpy(),
                                  _np(want.n_samples))
    np.testing.assert_array_equal(got.mask.numpy(), mask)
    np.testing.assert_array_equal(got.k_idx.numpy()[mask],
                                  _np(want.k_idx)[mask])
    for name in ("ts", "deltas", "xyzs"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   _np(getattr(want, name)), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    exact = tmarch.march_rays_train(*rays, *args, _t(noise), n_rungs, 64)
    cut = (exact.n_samples != got.n_samples).numpy()
    assert (got.n_samples <= exact.n_samples).all()
    assert 0.1 < cut.mean() < 0.95, cut.mean()
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


def _twolevel_pair(g, max_samples, fill, s_strata, s_max, n=256, seed=21):
    """The JAX two-level march and the port's budgeted march on the same
    camera-like rays (|d| up to 1.25, the training jitter) and bitfield."""
    scale, dir_norm = 0.5, 1.25
    rays_o, rays_d = _rays(n, seed, miss_every=11)
    rays_d = rays_d * np.random.default_rng(seed + 1).uniform(
        1.0, dir_norm, (n, 1)).astype(np.float32)
    bits = _bitfield(g, seed + 2, fill)
    n_rungs = jrendering.RenderConfig(max_samples=max_samples).n_rungs(
        scale, g)
    stratum = tmarch.twolevel_stratum(0.0, max_samples, scale, g, 1,
                                      dir_norm)
    hits = _np(jrendering._clamp_near(jinter.ray_aabb_intersect_single(
        jnp.asarray(rays_o), jnp.asarray(rays_d), jnp.zeros(3),
        jnp.full(3, scale))))
    noise = np.random.default_rng(seed + 3).random(n, dtype=np.float32)
    tables = jmorton.occupancy_nbr_tables(jnp.asarray(bits), g)
    want = jmarch.march_rays_train_twolevel(
        jnp.asarray(rays_o), jnp.asarray(rays_d), jnp.asarray(hits),
        tables[1], tables[0], scale, 0.0, g, max_samples,
        jnp.asarray(noise), n_rungs, s_max, stratum, s_strata=s_strata,
        dir_norm=dir_norm)
    strata = tmarch.Strata(tmarch.stage_a_grid(_t(bits), g, 2), stratum,
                           s_strata, dir_norm)
    args = (_t(rays_o), _t(rays_d), _t(hits), _t(bits), 1, scale, 0.0, g,
            max_samples, _t(noise), n_rungs, s_max)
    return want, tmarch.march_rays_train(*args, strata=strata), args, strata


def _assert_march_equal(got, want):
    """Sample for sample: n_samples, mask, k_idx on the valid slots, ts,
    deltas and xyzs."""
    mask = _np(want.mask)
    np.testing.assert_array_equal(got.n_samples.numpy(), _np(want.n_samples))
    np.testing.assert_array_equal(got.mask.numpy(), mask)
    np.testing.assert_array_equal(got.k_idx.numpy()[mask],
                                  _np(want.k_idx)[mask])
    for name in ("ts", "deltas", "xyzs"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   _np(getattr(want, name)), atol=1e-6,
                                   err_msg=name)


def test_march_chosen_strata_beyond_s_max():
    """A full grid and a buffer of 4 slots: a hitting ray's first chosen
    stratum fills the buffer, so the rest of its chosen strata lie beyond
    s_max (the kernel stops walking there); JAX's two-level march keeps
    the same 4 samples."""
    want, got, args, strata = _twolevel_pair(32, 256, 0xFF, 4, 4)
    _assert_march_equal(got, want)
    hit = args[2][:, 0] >= 0
    assert strata.stratum > 4
    assert float((got.n_samples[hit] == 4).float().mean()) > 0.95


def test_march_more_live_strata_than_s_strata():
    """Half the cells occupied and s_strata 3: rays with more live strata
    than the budget take 3 of them at even ranks, as the JAX march does."""
    want, got, args, strata = _twolevel_pair(32, 256, 0x55, 3, 64)
    _assert_march_equal(got, want)
    ro, rd, hits, bits = args[:4]
    dt0 = tstep.calc_dt(hits[:, 0], 0.0, 256, 32, 0.5)
    t_start = torch.where(hits[:, 0] >= 0, hits[:, 0] + dt0 * args[9], 0.0)
    live = tmarch._live_twolevel(ro, rd, t_start, hits[:, 1], strata, 0.5,
                                 256, 32, args[10]) & (hits[:, :1] >= 0)
    assert int((live.sum(1) > 3).sum()) > 50
    exact = tmarch.march_rays_train(*args)
    assert bool((exact.n_samples > got.n_samples).any())


@pytest.mark.parametrize("rank_start", [40, 128, 200])
def test_march_rank_start_past_ray_totals(rank_start):
    """Rank windows that start past some or all rays' totals (the dense
    oracle's late windows): those rays keep no sample, as in JAX."""
    g, max_samples, s_max = 32, 128, 32
    rays_o, rays_d = _rays(256, 8, miss_every=9)
    bits = _bitfield(g, 9, 0x77)
    n_rungs = jrendering.RenderConfig(max_samples=max_samples).n_rungs(
        0.5, g, test=True)
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
    _assert_march_equal(got, want)
    total = tmarch.march_rays_train(
        _t(rays_o), _t(rays_d), _t(hits), _t(bits), *args, _t(noise),
        n_rungs, max_samples, dt_scale=1).n_samples
    past = total <= rank_start
    assert bool(past.any()) and not bool(got.mask[past].any())
    assert (rank_start < int(total.max())) == bool(got.mask.any())


def test_march_window_s_cap_th_rung_is_its_last():
    """Windows whose s_cap-th occupied rung is the window's last rung: the
    ray emits s_cap samples, the last at cursor + n_window - 1, and resumes
    at cursor + n_window, as in JAX."""
    g, max_samples, n_window, s_cap = 32, 1024, 40, 3
    rays_o, rays_d = _rays(300, 10)
    bits = _bitfield(g, 11, 0x33)
    hits = _np(jrendering._clamp_near(jinter.ray_aabb_intersect_single(
        jnp.asarray(rays_o), jnp.asarray(rays_d), jnp.zeros(3),
        jnp.full(3, 0.5))))
    keep = hits[:, 0] >= 0
    rays_o, rays_d, hits = rays_o[keep], rays_d[keep], hits[keep]
    n_all = 1200
    every = tmarch.march_rays_window(
        _t(rays_o), _t(rays_d), _t(hits[:, 0]), _t(hits[:, 1]),
        torch.zeros(len(hits), dtype=torch.int64), _t(bits), 1, 0.5, 0.0, g,
        max_samples, n_all, n_all, dt_scale=1)
    cursor, rows = [], []
    for i in range(len(hits)):   # a cursor putting the s_cap-th at the end
        occ = every.k_idx[i][every.mask[i]].numpy()
        for j in range(s_cap - 1, len(occ)):
            c = occ[j] - (n_window - 1)
            if c >= 0 and occ[j - s_cap + 1] >= c \
                    and (j < s_cap or occ[j - s_cap] < c):
                cursor.append(c)
                rows.append(i)
                break
    assert len(rows) > 100
    rows = np.asarray(rows)
    cursor = np.asarray(cursor, np.int64)
    args = (1, 0.5, 0.0, g, max_samples, n_window, s_cap)
    want = jmarch.march_rays_window(
        jnp.asarray(rays_o[rows]), jnp.asarray(rays_d[rows]),
        jnp.asarray(hits[rows, 0]), jnp.asarray(hits[rows, 1]),
        jnp.asarray(cursor.astype(np.int32)), jnp.asarray(bits), *args,
        dt_scale=1)
    got = tmarch.march_rays_window(
        _t(rays_o[rows]), _t(rays_d[rows]), _t(hits[rows, 0]),
        _t(hits[rows, 1]), _t(cursor), _t(bits), *args, dt_scale=1)
    for name in ("mask", "n_samples", "cursor", "exhausted", "k_idx"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      _np(getattr(want, name)), err_msg=name)
    np.testing.assert_allclose(got.xyzs.numpy(), _np(want.xyzs), atol=1e-6)
    assert bool((got.n_samples == s_cap).all())
    np.testing.assert_array_equal(got.k_idx[:, -1].numpy(),
                                  cursor + n_window - 1)
    np.testing.assert_array_equal(got.cursor.numpy(), cursor + n_window)


def test_march_params_are_the_plain_versions_constants():
    """The kernels' constants (``march_params``) are the plain march's: the
    strata count of each stage A, the probes' float32 offsets, and the
    ladder's and calc_dt's scalars rounded once from double."""
    want, got, args, strata = _twolevel_pair(32, 256, 0x55, 3, 64, n=16)
    ro, rd, hits, bits = args[:4]
    p = tmarch.march_params(0.5, 0.0, 32, 1, 256, 0.5, args[10], 64,
                            strata=strata)
    live = tmarch._live_twolevel(ro, rd, hits[:, 0], hits[:, 1], strata,
                                 0.5, 256, 32, args[10])
    assert (p.mode, p.expo, p.n_strata) == (1, 0, live.shape[1])
    dt_min = tstep.SQRT3 / 256 * strata.dir_norm
    offs = torch.tensor(tmarch.stage_a_probes(strata.stratum, dt_min,
                                              2.0 * 0.5 / p.g_c))
    assert list(p.probe_off)[:p.n_probes] == offs.tolist()
    union = tmarch.Strata(_t(_bitfield(32, 5, 0x11)), 8, 4, 1.0, union=True)
    e = 1 / 256
    p = tmarch.march_params(4.0, e, 32, 4, 256, 4.0, 900, 64, strata=union)
    live = tmarch._live_union(ro, rd, hits[:, 0], hits[:, 1], union, 4.0, e,
                              256, 32, 900, 4.0)
    assert (p.mode, p.expo, p.n_strata) == (2, 1, live.shape[1])
    a, b = tstep.SQRT3 / 256, tstep.SQRT3 * 2.0 * 4.0 / 32
    for got_, want_ in ((p.a, a), (p.b, b), (p.ta, a / e), (p.tb, b / e),
                        (p.log1pe, math.log1p(e)), (p.dt_min, a),
                        (p.dt_max, b), (p.e, e)):
        assert got_ == float(np.float32(want_))


def test_march_dispatch():
    """CPU tensors run the plain marches (the kernels' launch counts stay
    0); a tensor on another device raises."""
    tmarch.march_rays_train.launches = tmarch.march_rays_window.launches = 0
    g = 32
    rays_o, rays_d = _t(_rays(64, 3)[0]), _t(_rays(64, 3)[1])
    hits = trendering._clamp_near(tinter.ray_aabb_intersect_single(
        rays_o, rays_d, torch.zeros(3), torch.full((3,), 0.5)))
    bits = _t(_bitfield(g, 4, 0x77))
    args = (rays_o, rays_d, hits, bits, 1, 0.5, 0.0, g, 128,
            torch.zeros(64), 300, 16)
    for got, want in (
            (tmarch.march_rays_train(*args),
             tmarch.march_rays_train_plain(*args)),
            (tmarch.march_rays_window(
                rays_o, rays_d, hits[:, 0], hits[:, 1],
                torch.zeros(64, dtype=torch.int64), bits, 1, 0.5, 0.0, g,
                128, 48, 8),
             tmarch.march_rays_window_plain(
                 rays_o, rays_d, hits[:, 0], hits[:, 1],
                 torch.zeros(64, dtype=torch.int64), bits, 1, 0.5, 0.0, g,
                 128, 48, 8))):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert tmarch.march_rays_train.launches == 0
    assert tmarch.march_rays_window.launches == 0
    meta = [a.to("meta") if torch.is_tensor(a) else a for a in args]
    with pytest.raises(ValueError, match="cpu or cuda"):
        tmarch.march_rays_train(*meta)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tmarch.march_rays_window(*meta[:4], meta[4], *meta[3:8], 128, 48, 8)


def test_true_div_matches_jax_where_the_reciprocal_does_not():
    """``stepping.true_div`` divides as JAX does, at values where the
    multiply by the float reciprocal (torch's ``tensor / python_float`` on
    CUDA) rounds to another float: the ladder's ``/ a`` and ``/ log1p(e)``
    and a cell's ``/ scale``."""
    x = np.random.default_rng(31).uniform(0.0, 4.0, 1 << 16).astype(
        np.float32)
    for s in (1.7320508075688772 / 1024, math.log1p(1 / 256), 1.5):
        want = _np(jnp.asarray(x) / s)
        np.testing.assert_array_equal(tstep.true_div(_t(x), s).numpy(),
                                      want)
        recip = x * np.float32(1.0 / np.float32(s))
        assert (recip != want).sum() > 100


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
