"""The port's renderers against the JAX dense oracle, on the CPU.

Both of the port's renderers — the dense oracle ``render_test_dense`` and the
alive-ray serving loop ``render_test`` — are held to the JAX package's
``render_test_dense`` frame, with the tolerances the JAX package holds its
own renderers to (tests/test_alive_renderer.py): rgb and opacity atol 2e-4,
depth 2e-3.

The JAX oracle runs op by op (``jax.disable_jit``). Under ``jit`` XLA
computes sample positions ``o + t * d`` with fused multiply-adds, one ulp
off torch's, and now and then that ulp crosses a cell boundary and adds or
drops a sample; op by op the two sample sets agree bit for bit
(tests/test_torch_ops.py). The field is a small unfused LowRank model (fp32
hat matmuls): the fused encoder's bf16 hat weights are a step function of
the position, and its parity is tested in tests/test_torch_field.py. An
HDR head (``rgb_act="None"``) is rendered at a view's exposure.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfnerf_tpu.models import ngp as jngp
from mfnerf_tpu.models import rendering as jrendering

from mfnerf_tpu_torch.models import ngp as tngp
from mfnerf_tpu_torch.models import rendering as trendering
from mfnerf_tpu_torch.ops.stepping import t_ladder
from mfnerf_tpu_torch.utils.ckpt import params_from_numpy

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


def _setup(fill=0x33, n=512, miss_every=0, seed=0, scale=0.5, **kw):
    jcfg = jngp.NGPConfig(grid="LowRank", scale=scale, **SMALL, **kw)
    jmodel = jngp.NGP(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed))
    tmodel = tngp.NGP(tngp.NGPConfig(scale=scale, **SMALL, **kw),
                      device="cpu")
    tmodel.load_state_dict(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params)))

    rng = np.random.default_rng(seed)
    # random bytes masked by ``fill``; None occupies every cell
    n_bytes = jcfg.cascades * jcfg.n_cells // 8
    bits = (np.full(n_bytes, 255, np.uint8) if fill is None else
            rng.integers(0, 256, n_bytes, dtype=np.uint8) & np.uint8(fill))
    occ_j = dataclasses.replace(jngp.OccupancyState.create(jcfg),
                                density_bitfield=jnp.asarray(bits))
    occ_t = tngp.OccupancyState.create(tmodel.cfg, "cpu")
    occ_t.density_bitfield = torch.from_numpy(bits)

    rays_o = np.tile(np.float32([[0.0, 0.0, -2.8 * scale]]), (n, 1))
    d = rng.normal(size=(n, 3)).astype(np.float32) \
        * np.float32([0.3, 0.3, 0.0]) + np.float32([0.0, 0.0, 1.0])
    rays_d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    if miss_every:
        rays_d[::miss_every] = np.float32([0.0, 0.0, -1.0])
    return (jmodel, params, occ_j), (tmodel, occ_t), rays_o, rays_d


def _render_both(setup, rcfg_kw, exposure=None):
    """The JAX oracle's frame and the port's two; ``exposure``: the view's
    (HDR heads), as the JAX ``render_test`` reshapes it to (1, 1)."""
    (jmodel, params, occ_j), (tmodel, occ_t), rays_o, rays_d = setup
    with jax.disable_jit():
        want = jrendering.render_test_dense(
            jmodel, params, occ_j, jnp.asarray(rays_o), jnp.asarray(rays_d),
            jrendering.RenderConfig(**rcfg_kw),
            exposure=None if exposure is None
            else jnp.full((1, 1), exposure, jnp.float32))
    want = {k: np.asarray(want[k]) for k in ("rgb", "opacity", "depth")}
    rcfg = trendering.RenderConfig(**rcfg_kw)
    ro, rd = torch.from_numpy(rays_o), torch.from_numpy(rays_d)
    dense = trendering.render_test_dense(tmodel, occ_t, ro, rd, rcfg,
                                         exposure=exposure)
    alive = trendering.render_test(tmodel, occ_t, ro, rd, rcfg,
                                   exposure=exposure)
    return want, dense, alive


def _assert_frame(got, want):
    np.testing.assert_allclose(got["rgb"].numpy(), want["rgb"], atol=2e-4)
    np.testing.assert_allclose(got["opacity"].numpy(), want["opacity"],
                               atol=2e-4)
    np.testing.assert_allclose(got["depth"].numpy(), want["depth"],
                               atol=2e-3)


@pytest.mark.parametrize("T_threshold", [1e-4, 1e-2])
def test_renderers_match_jax_oracle(T_threshold):
    want, dense, alive = _render_both(
        _setup(), dict(T_threshold=T_threshold, test_chunk=256))
    _assert_frame(dense, want)
    _assert_frame(alive, want)
    assert alive["total_samples"] > 0 and alive["rounds"] > 1
    assert (want["opacity"] > 0.05).mean() > 0.5   # content, not background


@pytest.mark.parametrize("exposure", [0.25, 2.0])
def test_renderers_match_jax_oracle_at_an_exposure(exposure):
    """An HDR head (``rgb_act="None"``) renders a view at its exposure, as
    the JAX renderers take it (``exposure=``, a (1, 1) array); the frame
    differs from the one at exposure 1."""
    setup = _setup(seed=3, rgb_act="None")
    rcfg_kw = dict(T_threshold=1e-4, test_chunk=256)
    want, dense, alive = _render_both(setup, rcfg_kw, exposure)
    _assert_frame(dense, want)
    _assert_frame(alive, want)
    _, (tmodel, occ_t), rays_o, rays_d = setup
    unit = trendering.render_test(tmodel, occ_t, torch.from_numpy(rays_o),
                                  torch.from_numpy(rays_d),
                                  trendering.RenderConfig(**rcfg_kw))
    assert float((unit["rgb"] - alive["rgb"]).abs().max()) > 1e-2


def test_missed_rays_get_white_background():
    want, dense, alive = _render_both(
        _setup(miss_every=2, seed=1), dict(T_threshold=1e-2, test_chunk=256))
    _assert_frame(dense, want)
    _assert_frame(alive, want)
    np.testing.assert_allclose(alive["rgb"].numpy()[::2], 1.0, atol=1e-6)
    assert alive["opacity"].numpy()[::2].max() == 0.0


def test_per_ray_sample_cap():
    """Two cascades (scale 1), every cell occupied: a ray crosses more
    occupied rungs than max_samples, so the alive loop's per-ray cap must
    stop it exactly where the oracle's does (the oracle resumes past
    s_max_test in rank windows). A negative T_threshold stops no ray
    early."""
    setup = _setup(fill=None, seed=2, scale=1.0)
    want, dense, alive = _render_both(
        setup,
        dict(T_threshold=-1.0, max_samples=128, s_max_test=32,
             test_chunk=512))
    _assert_frame(dense, want)
    _assert_frame(alive, want)
    # every in-box rung is occupied: a ray's samples are its in-box rungs,
    # capped at max_samples
    _, (tmodel, _), rays_o, rays_d = setup
    hits = trendering._scene_hits(tmodel, torch.from_numpy(rays_o),
                                  torch.from_numpy(rays_d))
    rcfg = trendering.RenderConfig(max_samples=128)
    ts = t_ladder(hits[:, 0], torch.arange(rcfg.n_rungs(1.0, 32, True)),
                  0.0, 128, 32, 2)
    in_box = ((ts < hits[:, 1:]) & (hits[:, :1] >= 0)).sum(dim=1)
    assert (in_box > 128).sum() > 50
    assert alive["total_samples"] == dense["total_samples"] \
        == int(in_box.clamp_max(128).sum())
