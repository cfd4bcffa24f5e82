"""Parity of the port's LowRank field and occupancy refresh with the JAX
package, on the CPU, at the bench model's full width (K=257, rank 16,
2 frames, 256 encoder columns, 32->64->16 sigma MLP, 32->64->64->3 rgb MLP).

Parameters are drawn by the JAX package and carried over through the
weights bridge (``utils.ckpt.params_from_numpy``).

Tolerance 1e-4, with one stated exception for the fused (bf16) encoder: the
hat weights are rounded to bf16, a step function of the position. Frame 1
rotates positions with a 3x3 matmul, which XLA and torch round differently
in the last bit, and a one-ulp move of a coordinate moves a hat weight
across a bf16 rounding step for a fraction of a percent of the samples. The
fused comparisons hold the samples whose bf16 hat bases agree on both sides
to 1e-4, and require the others to be rare.

The HDR head (``rgb_act="None"``: log radiance, the tonemappers at an
exposure) is held to 1e-4 like the rest. Under ``compute_dtype="bfloat16"``
both packages round the MLPs' inputs and hidden activations to bf16 and sum
in fp32; an fp32 sum one ulp apart can round a hidden activation to the
neighbouring bf16 value (2^-8 relative), so the bf16 field is held to
BF16_TOL of each output's largest value on 99% of the samples and to 8x
that on all.

The sampled occupancy refresh (``sparse``) is held to the JAX one with
JAX's own draws of cells, uniforms and jitter.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfnerf_tpu.models import ngp as jngp
from mfnerf_tpu.ops import lowrank as jlowrank

from mfnerf_tpu_torch.models import ngp as tngp
from mfnerf_tpu_torch.ops import lowrank as tlowrank
from mfnerf_tpu_torch.utils.ckpt import params_from_numpy

N = 4096
BENCH = dict(lr_k_max=256, lr_fused=True)
BF16_TOL = 1e-2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread. The suite runs in several worker processes, and
    torch's default of one thread per core oversubscribes the CPU; the
    per-op thread barriers of these many small ops then stall."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(**kw):
    jmodel = jngp.NGP(jngp.NGPConfig(grid="LowRank", **kw))
    params = jmodel.init(jax.random.PRNGKey(0))
    tmodel = tngp.NGP(tngp.NGPConfig(**kw), device="cpu")
    tmodel.load_state_dict(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params)))
    return jmodel, params, tmodel


def _bf16_basis(u3, k):
    pos = u3[..., None].astype(np.float32) * np.float32(k - 1)
    b = np.maximum(0, 1 - np.abs(pos - np.arange(k, dtype=np.float32)))
    return np.asarray(jnp.asarray(b.astype(np.float32)).astype(jnp.bfloat16)
                      .astype(jnp.float32))


def _same_bf16_basis(xn, cfg):
    """(N,) bool: the samples whose bf16 hat bases agree between JAX's and
    the port's frame coordinates (evaluated op by op, as the JAX encoder
    evaluates them outside jit)."""
    rots = jlowrank._frame_rotations(cfg.n_frames)
    k = cfg.levels[-1]
    same = np.ones(xn.shape[0], bool)
    for m in range(1, cfg.n_frames):
        uj = np.asarray(jnp.clip((jnp.asarray(xn) - 0.5)
                                 @ jnp.asarray(rots[m]).T / 1.7320508 + 0.5,
                                 0.0, 1.0))
        ut = tlowrank._frame_coords(torch.from_numpy(xn),
                                    torch.from_numpy(rots), m).numpy()
        same &= (_bf16_basis(uj, k) == _bf16_basis(ut, k)).all(axis=(1, 2))
    return same


def _check(got, want, same, atol=1e-4):
    np.testing.assert_allclose(got[same], want[same], atol=atol, rtol=1e-4)
    assert same.mean() > 0.98, same.mean()
    # where a hat weight took the other bf16 step, by about one step
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("fused", [True, False])
def test_lowrank_encode_matches(fused):
    jmodel, params, tmodel = _models(lr_k_max=256, lr_fused=fused)
    xn = np.random.default_rng(0).random((N, 3), dtype=np.float32)
    want = np.asarray(jlowrank.lowrank_encode(
        params["lowrank"], jnp.asarray(xn), jmodel.lowrank_cfg))
    with torch.no_grad():
        got = tlowrank.lowrank_encode(
            {"lines": tmodel.lowrank.lines, "proj": tmodel.lowrank.proj},
            torch.from_numpy(xn), tmodel.lowrank_cfg).numpy()
    assert got.shape == (N, 32)
    same = (_same_bf16_basis(xn, tmodel.lowrank_cfg) if fused
            else np.ones(N, bool))
    _check(got, want, same)


@pytest.mark.parametrize("part", ["encode", "field"])
def test_fp32_fused_encoder_matches_jax(part):
    """The fused encoder in its fp32 mode (``lr_matmul_dtype="float32"``,
    the JAX ``matmul_dtype="float32"`` of tests/test_lowrank.py:77,109):
    no bf16 step, so every sample is held to 1e-4, the encoding and the
    whole field (density and colour) alike."""
    jmodel, params, tmodel = _models(lr_k_max=256, lr_fused=True,
                                     lr_matmul_dtype="float32")
    assert tmodel.lowrank_cfg.matmul_dtype == "float32"
    rng = np.random.default_rng(2)
    everywhere = np.ones(N, bool)
    if part == "encode":
        xn = rng.random((N, 3), dtype=np.float32)
        want = np.asarray(jlowrank.lowrank_encode(
            params["lowrank"], jnp.asarray(xn), jmodel.lowrank_cfg))
        with torch.no_grad():
            got = tlowrank.lowrank_encode(
                {"lines": tmodel.lowrank.lines, "proj": tmodel.lowrank.proj},
                torch.from_numpy(xn), tmodel.lowrank_cfg).numpy()
        _check(got, want, everywhere)
        return
    x = rng.uniform(-0.5, 0.5, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    sig_j, rgb_j = jmodel.forward(params, jnp.asarray(x), jnp.asarray(d))
    with torch.no_grad():
        sig_t, rgb_t = tmodel(torch.from_numpy(x), torch.from_numpy(d))
    _check(sig_t.numpy(), np.asarray(sig_j), everywhere)
    _check(rgb_t.numpy(), np.asarray(rgb_j), everywhere)


@pytest.mark.parametrize("fused", [True, False])
def test_density_and_forward_match(fused):
    jmodel, params, tmodel = _models(lr_k_max=256, lr_fused=fused)
    rng = np.random.default_rng(1)
    x = rng.uniform(-0.5, 0.5, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    sig_j, rgb_j = jmodel.forward(params, jnp.asarray(x), jnp.asarray(d))
    with torch.no_grad():
        sig_t, rgb_t = tmodel(torch.from_numpy(x), torch.from_numpy(d))
        dens_t = tmodel.density(torch.from_numpy(x))
    xn = np.clip((x + 0.5) / 1.0, 0.0, 1.0).astype(np.float32)
    same = (_same_bf16_basis(xn, tmodel.lowrank_cfg) if fused
            else np.ones(N, bool))
    _check(sig_t.numpy(), np.asarray(sig_j), same)
    _check(rgb_t.numpy(), np.asarray(rgb_j), same)
    np.testing.assert_array_equal(dens_t.numpy(), sig_t.numpy())
    assert rgb_t.shape == (N, 3) and ((rgb_t >= 0) & (rgb_t <= 1)).all()


def test_lowrank_config_and_init_law():
    for kw in (dict(k_max=256, fused=True), dict(k_max=512, fused=False),
               dict(n_levels=1, k_max=64)):
        j = jlowrank.LowRankConfig.create(**kw)
        t = tlowrank.LowRankConfig.create(**kw)
        assert t.levels == j.levels and t.n_components == j.n_components
    assert tlowrank.LowRankConfig.create(k_max=256, fused=True).levels == \
        (3, 5, 9, 17, 33, 65, 129, 257)
    np.testing.assert_array_equal(tlowrank._frame_rotations(3),
                                  jlowrank._frame_rotations(3))
    for kf, kc in ((257, 3), (257, 129), (65, 65)):
        np.testing.assert_array_equal(tlowrank._prolongation(kf, kc),
                                      jlowrank._prolongation(kf, kc))
    # same shapes as the JAX tree, drawn from a torch.Generator
    jmodel, params, tmodel = _models(**BENCH)
    state = params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    fresh = tngp.NGP(tngp.NGPConfig(**BENCH),
                     torch.Generator().manual_seed(3), device="cpu")
    assert {k: tuple(v.shape) for k, v in fresh.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in state.items()}
    lines0 = fresh.lowrank.lines[0][7][0].detach()
    assert abs(float(lines0.mean()) - 1.0) < 0.05
    assert abs(float(lines0.std()) - 0.3) < 0.05
    bound = np.sqrt(6.0 / 256)
    assert float(fresh.lowrank.proj.detach().abs().max()) <= bound


@pytest.mark.parametrize("fused", [True, False])
def test_update_density_grid_dense(fused):
    """Dense refresh at grid_size 32 with JAX's own jitter: the bitfield
    agrees bit for bit except at cells whose densities lie within 1e-5
    (relative) of the threshold."""
    kw = dict(lr_k_max=256, lr_fused=fused, grid_size=32)
    jmodel, params, tmodel = _models(**kw)
    cfg = jmodel.cfg
    thr = 0.01 * 1024 / np.sqrt(3)
    rng = np.random.default_rng(4)
    grid0 = rng.uniform(-0.5, 3.0, (1, cfg.n_cells)).astype(np.float32)
    grid0[0, :100] = -1.0                  # invisible cells stay -1
    occ_j = dataclasses.replace(jngp.OccupancyState.create(cfg),
                                density_grid=jnp.asarray(grid0))
    key = jax.random.PRNGKey(5)
    new_j = jmodel.update_density_grid(params, occ_j, key, thr, warmup=True)
    # JAX's jitter, as update_density_grid draws it
    _, sub = jax.random.split(key)
    noise = np.array(jax.random.uniform(sub, (cfg.n_cells, 3), minval=-1.0,
                                        maxval=1.0))[None]
    occ_t = tngp.OccupancyState(density_grid=torch.from_numpy(grid0),
                                density_bitfield=torch.zeros(
                                    cfg.n_cells // 8, dtype=torch.uint8))
    new_t = tmodel.update_density_grid(occ_t, thr, torch.from_numpy(noise))

    grid_j = np.asarray(new_j.density_grid)
    grid_t = new_t.density_grid.numpy()
    assert (grid_t[0, :100] == -1).all()
    if fused:
        xyz = np.asarray(jmodel._cell_world_coords(
            jmodel.all_cell_coords(), 0)) + noise[0] * (0.5 / 32)
        ok = _same_bf16_basis(np.clip((xyz + 0.5) / 1.0, 0, 1)
                              .astype(np.float32), tmodel.lowrank_cfg)
    else:
        ok = np.ones(cfg.n_cells, bool)
    np.testing.assert_allclose(grid_t[0, ok], grid_j[0, ok], rtol=1e-4,
                               atol=1e-4)

    bits_j = np.unpackbits(np.asarray(new_j.density_bitfield),
                           bitorder="little").astype(bool)
    bits_t = np.unpackbits(new_t.density_bitfield.numpy(),
                           bitorder="little").astype(bool)
    pos = grid_j > 0
    thr_j = min(grid_j[pos].sum() / pos.sum(), thr)
    near = np.abs(grid_j[0] - thr_j) <= 1e-5 * thr_j
    differ = bits_j != bits_t
    assert not (differ & ok & ~near).any()
    assert 0.05 < bits_t.mean() < 0.95


@pytest.mark.parametrize("fused", [True, False])
def test_bf16_field_matches_jax(fused):
    """``compute_dtype="bfloat16"``: the encoder (the projection, and the
    unfused basis matmuls, on bf16 operands), log sigma and rgb against the
    JAX ones at the bench width."""
    jmodel, params, tmodel = _models(lr_k_max=256, lr_fused=fused,
                                     compute_dtype="bfloat16")
    assert tmodel.dtype == torch.bfloat16
    rng = np.random.default_rng(2)
    x = rng.uniform(-0.5, 0.5, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    xn = np.clip(x + 0.5, 0.0, 1.0).astype(np.float32)
    enc_j = np.asarray(jlowrank.lowrank_encode(
        params["lowrank"], jnp.asarray(xn), jmodel.lowrank_cfg,
        dtype=jnp.bfloat16))
    sig_j, rgb_j = jmodel.forward(params, jnp.asarray(x), jnp.asarray(d))
    with torch.no_grad():
        enc_t = tlowrank.lowrank_encode(
            {"lines": tmodel.lowrank.lines, "proj": tmodel.lowrank.proj},
            torch.from_numpy(xn), tmodel.lowrank_cfg,
            dtype=torch.bfloat16)
        sig_t, rgb_t = tmodel(torch.from_numpy(x), torch.from_numpy(d))
    assert enc_t.dtype == sig_t.dtype == rgb_t.dtype == torch.float32
    same = (_same_bf16_basis(xn, tmodel.lowrank_cfg) if fused
            else np.ones(N, bool))
    for got, want in ((enc_t.numpy(), enc_j),
                      (np.log(sig_t.numpy()), np.log(np.asarray(sig_j))),
                      (rgb_t.numpy(), np.asarray(rgb_j))):
        err = np.abs(got - want).reshape(N, -1).max(axis=1)[same]
        top = float(np.abs(want).max())
        assert (err <= BF16_TOL * top).mean() >= 0.99, err.max()
        assert err.max() <= 8 * BF16_TOL * top, err.max()
    # the field is not the fp32 one: the bf16 rounding shows
    _, rgb_f = _models(lr_k_max=256, lr_fused=fused)[2](
        torch.from_numpy(x), torch.from_numpy(d))
    assert float((rgb_f.detach() - rgb_t).abs().max()) > 1e-4


@pytest.mark.parametrize("exposure", [None, 0.25, "rays"])
def test_hdr_head_matches_jax(exposure):
    """``rgb_act="None"``: the tonemappers' parameters (under the JAX
    names), rgb at no exposure, at one exposure (1, 1) for all samples, at
    an exposure a sample (N, 1), and the radiance (``output_radiance``)."""
    jmodel, params, tmodel = _models(lr_k_max=64, rgb_act="None")
    assert {k for k in tmodel.state_dict() if k.startswith("tonemappers")} \
        == {f"tonemappers.{c}.{i}" for c in range(3) for i in range(2)}
    rng = np.random.default_rng(3)
    x = rng.uniform(-0.5, 0.5, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    e = {None: None, 0.25: np.float32([[0.25]]),
         "rays": rng.choice(np.float32([0.125, 0.5, 2.0]), (N, 1))}[exposure]
    sig_j, rgb_j = jmodel.forward(params, jnp.asarray(x), jnp.asarray(d),
                                  exposure=None if e is None
                                  else jnp.asarray(e))
    _, rad_j = jmodel.forward(params, jnp.asarray(x), jnp.asarray(d),
                              output_radiance=True)
    with torch.no_grad():
        sig_t, rgb_t = tmodel(torch.from_numpy(x), torch.from_numpy(d),
                              exposure=None if e is None
                              else torch.from_numpy(e))
        _, rad_t = tmodel(torch.from_numpy(x), torch.from_numpy(d),
                          output_radiance=True)
    same = np.ones(N, bool)
    _check(sig_t.numpy(), np.asarray(sig_j), same)
    _check(rgb_t.numpy(), np.asarray(rgb_j), same)
    _check(rad_t.numpy(), np.asarray(rad_j), same)
    assert float(rgb_t.std()) > 1e-3


@pytest.mark.parametrize("occupied", [True, False])
def test_update_density_grid_sparse_matches_jax(occupied):
    """The sampled refresh (the JAX ``sparse=True``): G^3/4 uniform cells
    and as many occupied ones by inverse CDF, the largest density of a
    cell's draws, with JAX's draws; without an occupied cell the uniform
    set twice. Grids within 1e-4, the bitfield bit for bit away from the
    threshold, and cells neither drawn only decay."""
    kw = dict(lr_k_max=64, grid_size=32)
    jmodel, params, tmodel = _models(**kw)
    cfg = jmodel.cfg
    n, m = cfg.n_cells, cfg.n_cells // 4
    thr = 0.01 * 1024 / np.sqrt(3)
    rng = np.random.default_rng(6)
    grid0 = rng.uniform(-0.5, 3.0, (1, n)).astype(np.float32)
    if occupied:        # 500 visible cells above the threshold
        hot = rng.choice(np.arange(100, n), 500, replace=False)
        grid0[0, hot] = rng.uniform(thr, 2 * thr, 500)
    grid0[0, :100] = -1.0
    occ_j = dataclasses.replace(jngp.OccupancyState.create(cfg),
                                density_grid=jnp.asarray(grid0))
    key = jax.random.PRNGKey(7)
    new_j = jmodel.update_density_grid(params, occ_j, key, thr, sparse=True)
    # JAX's draws, as update_density_grid makes them for cascade 0
    _, k1, k2, k3, _ = jax.random.split(key, 5)
    idx_uniform = np.asarray(jax.random.randint(k1, (m,), 0, n))
    u = np.asarray(jax.random.uniform(k2, (m,)))
    noise = np.asarray(jax.random.uniform(k3, (2 * m, 3), minval=-1.0,
                                          maxval=1.0))
    occ_t = tngp.OccupancyState(density_grid=torch.from_numpy(grid0),
                                density_bitfield=torch.zeros(
                                    n // 8, dtype=torch.uint8))
    new_t = tmodel.update_density_grid(
        occ_t, thr, torch.from_numpy(noise)[None],
        sparse=(torch.from_numpy(idx_uniform).long()[None],
                torch.from_numpy(u)[None]))
    grid_j = np.asarray(new_j.density_grid)
    grid_t = new_t.density_grid.numpy()
    np.testing.assert_allclose(grid_t, grid_j, rtol=1e-4, atol=1e-4)
    draws = tmodel._sampled_cells(torch.from_numpy(grid0[0]), thr,
                                  torch.from_numpy(idx_uniform).long(),
                                  torch.from_numpy(u)).numpy()
    if occupied:    # m draws among the occupied cells, all of them drawn
        assert (grid0[0, draws[m:]] > thr).all()
        assert len(np.unique(draws[m:])) == 500
    else:
        np.testing.assert_array_equal(draws[m:], idx_uniform)
    drawn = np.zeros(n, bool)
    drawn[draws] = True
    decayed = np.where(grid0[0] < 0, grid0[0],
                       np.maximum(grid0[0] * np.float32(0.95), 0))
    np.testing.assert_array_equal(grid_t[0, ~drawn], decayed[~drawn])
    bits_j = np.unpackbits(np.asarray(new_j.density_bitfield),
                           bitorder="little").astype(bool)
    bits_t = np.unpackbits(new_t.density_bitfield.numpy(),
                           bitorder="little").astype(bool)
    pos = grid_j > 0
    thr_j = min(grid_j[pos].sum() / pos.sum(), thr)
    near = np.abs(grid_j[0] - thr_j) <= 1e-5 * thr_j
    assert not ((bits_j != bits_t) & ~near).any()
