"""The port's host-side utilities against the JAX package, on the CPU:
checkpoint reading and the weights bridge (identical tensors), the
procedural scene and camera rays (bit-exact numpy; get_rays atol 1e-6),
PSNR."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfnerf_tpu.datasets import ray_utils as jrays
from mfnerf_tpu.models import ngp as jngp
from mfnerf_tpu.utils import ckpt as jckpt
from mfnerf_tpu.utils import metrics as jmetrics
from mfnerf_tpu.utils import procedural as jproc

from mfnerf_tpu_torch.datasets import ray_utils as trays
from mfnerf_tpu_torch.models import ngp as tngp
from mfnerf_tpu_torch.utils import ckpt as tckpt
from mfnerf_tpu_torch.utils import metrics as tmetrics
from mfnerf_tpu_torch.utils import procedural as tproc

BENCH = dict(lr_k_max=256, lr_fused=True, grid_size=32)


def test_jax_checkpoint_reads_into_identical_tensors(tmp_path):
    jcfg = jngp.NGPConfig(grid="LowRank", **BENCH)
    jmodel = jngp.NGP(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    occ = dataclasses.replace(
        jngp.OccupancyState.create(jcfg),
        density_grid=jnp.asarray(rng.random((1, jcfg.n_cells), np.float32)),
        density_bitfield=jnp.asarray(rng.integers(
            0, 256, jcfg.n_cells // 8, dtype=np.uint8)))
    path = str(tmp_path / "model.npz")
    jckpt.save_ckpt(path, params, occ=occ, step=7)
    jckpt.slim_ckpt(path, str(tmp_path / "slim.npz"))

    ck = tckpt.load_ckpt(path)
    assert ck["step"] == 7
    assert "lowrank/lines/1/7/2" in ck["params"]
    state = tckpt.params_from_numpy(ck["params"])
    # the bridge gives the same tensors from the in-memory tree
    from_tree = tckpt.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params))
    assert state.keys() == from_tree.keys()
    for k in state:
        torch.testing.assert_close(state[k], from_tree[k], rtol=0, atol=0)

    model = tngp.NGP(tngp.NGPConfig(**BENCH), device="cpu")
    model.load_state_dict(state)      # strict: every name present
    np.testing.assert_array_equal(
        model.lowrank.lines[1][7][2].detach().numpy(),
        np.asarray(params["lowrank"]["lines"][1][7][2]))
    np.testing.assert_array_equal(model.rgb_mlp[2].detach().numpy(),
                                  np.asarray(params["rgb_mlp"][2]))

    for name in ("model.npz", "slim.npz"):
        occ_t = tckpt.occupancy_from_numpy(
            tckpt.load_ckpt(str(tmp_path / name))["occ"], model.cfg, "cpu")
        np.testing.assert_array_equal(occ_t.density_bitfield.numpy(),
                                      np.asarray(occ.density_bitfield))
        assert occ_t.density_grid.shape == (1, 32 ** 3)
    np.testing.assert_array_equal(
        tckpt.occupancy_from_numpy(ck["occ"], model.cfg,
                                   "cpu").density_grid.numpy(),
        np.asarray(occ.density_grid))


@pytest.mark.parametrize("kw", [dict(n_test=8), dict(n_test=2, spread=6.0),
                                dict(n_test=2, thin=True)])
def test_procedural_scene_bit_exact(kw):
    want = jproc.make_scene(n_train=2, wh=48, seed=0, **kw)
    got = tproc.make_scene(n_train=2, wh=48, seed=0, **kw)
    for k in ("poses", "test_poses", "K", "directions", "images",
              "test_images"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["img_wh"] == want["img_wh"]
    assert len({p.tobytes() for p in got["test_poses"]}) == kw["n_test"]


def test_get_rays_matches():
    scene = tproc.make_scene(n_train=1, n_test=2, wh=40, seed=1)
    d = scene["directions"]
    np.testing.assert_array_equal(
        d, jrays.get_ray_directions(40, 40, scene["K"]))
    for pose in (scene["test_poses"][0],
                 np.stack([scene["test_poses"][1]] * d.shape[0])):
        ro_j, rd_j = jrays.get_rays(jnp.asarray(d), jnp.asarray(pose))
        ro_t, rd_t = trays.get_rays(torch.from_numpy(d),
                                    torch.from_numpy(np.array(pose)))
        np.testing.assert_allclose(ro_t.numpy(), np.asarray(ro_j), atol=1e-6)
        np.testing.assert_allclose(rd_t.numpy(), np.asarray(rd_j), atol=1e-6)


def test_psnr():
    rng = np.random.default_rng(0)
    a = rng.random((32, 32, 3), dtype=np.float32)
    b = np.clip(a + rng.normal(scale=0.05, size=a.shape), 0, 1) \
        .astype(np.float32)
    np.testing.assert_allclose(
        float(tmetrics.psnr(torch.from_numpy(a), torch.from_numpy(b))),
        float(jmetrics.psnr(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5)
