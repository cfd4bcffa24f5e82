"""The port's NSVF and Blender loaders against the JAX package's, on the CPU.

The scenes are procedural (``make_scene``) at the loaders' 800x800: the
NSVF one written by the JAX package's ``write_nsvf_scene`` (imageio), the
Blender one by the port's ``write_blender_scene`` plus the test's own
``transforms_val.json``. Both loaders read the same files; the port
decodes with ``png.py``.

Tolerances: K, directions and poses 1e-6 (the same float32 arithmetic);
rays 1e-6 at the files' size and 2e-3 resized (``downsample`` 0.5: a
bilinear torch resize against cv2's, tests/test_torch_io.py).
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from mfnerf_tpu.datasets.nerf import NeRFDataset as JNeRF
from mfnerf_tpu.datasets.nsvf import NSVFDataset as JNSVF
from mfnerf_tpu.utils.procedural import write_nsvf_scene as jwrite_nsvf

from mfnerf_tpu_torch.datasets import dataset_dict
from mfnerf_tpu_torch.datasets.nerf import NeRFDataset as TNeRF
from mfnerf_tpu_torch.datasets.nsvf import NSVFDataset as TNSVF
from mfnerf_tpu_torch.utils.procedural import (make_scene,
                                               write_blender_scene,
                                               write_nsvf_scene)

RESIZE_TOL = 2e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """{"scene", "Spheres", "Lego", "blender", "port_nsvf"}: a 2+1-view
    800x800 scene and its directories (the Lego root gets NSVF_BOUND_FIX)."""
    base = tmp_path_factory.mktemp("scenes")
    scene = make_scene(n_train=2, n_test=1, wh=800, seed=3)
    spheres = str(base / "Synthetic_NeRF_proc" / "Spheres")
    jwrite_nsvf(spheres, scene)
    lego = str(base / "Synthetic_NeRF_proc" / "Lego")
    shutil.copytree(spheres, lego)
    blender = str(base / "blender_proc")
    write_blender_scene(blender, scene)
    with open(os.path.join(blender, "transforms_test.json")) as f:
        meta = json.load(f)
    with open(os.path.join(blender, "transforms_val.json"), "w") as f:
        json.dump(meta, f)
    port_nsvf = str(base / "port" / "Synthetic_NeRF_proc" / "Spheres")
    write_nsvf_scene(port_nsvf, scene)
    return {"scene": scene, "Spheres": spheres, "Lego": lego,
            "blender": blender, "port_nsvf": port_nsvf}


def _same(got, want, tol):
    assert got.img_wh == want.img_wh
    assert len(got) == len(want.poses)     # JAX's train split counts steps
    for name in ("K", "directions", "poses"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == np.float32 and a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=name)
    assert got.rays.shape == want.rays.shape
    assert got.rays.dtype == np.float32
    np.testing.assert_allclose(got.rays, want.rays, rtol=0, atol=tol)
    item = got[len(got) - 1]
    assert set(item) == {"pose", "rgb", "img_idxs"}
    np.testing.assert_array_equal(item["rgb"], got.rays[-1])
    np.testing.assert_array_equal(item["pose"], got.poses[-1])
    assert item["img_idxs"] == len(got) - 1


@pytest.mark.parametrize("split", ["train", "trainval", "test"])
@pytest.mark.parametrize("downsample,tol", [(1.0, 1e-6), (0.5, RESIZE_TOL)])
@pytest.mark.parametrize("root", ["Spheres", "Lego"])
def test_nsvf_loader_matches_jax(scenes, split, downsample, tol, root):
    got = TNSVF(scenes[root], split=split, downsample=downsample)
    want = JNSVF(scenes[root], split=split, downsample=downsample)
    _same(got, want, tol)
    assert got.scale == pytest.approx(want.scale, rel=1e-12)
    assert (got.scale > 0.55) == (root == "Lego")       # the bound fix


@pytest.mark.parametrize("split", ["train", "trainval", "test"])
@pytest.mark.parametrize("downsample,tol", [(1.0, 1e-6), (0.5, RESIZE_TOL)])
def test_blender_loader_matches_jax(scenes, split, downsample, tol):
    got = TNeRF(scenes["blender"], split=split, downsample=downsample)
    want = JNeRF(scenes["blender"], split=split, downsample=downsample)
    _same(got, want, tol)
    assert len(got) == {"train": 2, "trainval": 3, "test": 1}[split]


def test_blender_writer_gives_back_the_scene(scenes):
    """write_blender_scene's files load back to the scene's cameras (the
    loader's radius normalisation keeps the ring of radius 1.5) and
    pixels (uint8 truncation)."""
    scene = scenes["scene"]
    ds = TNeRF(scenes["blender"], split="train")
    np.testing.assert_allclose(ds.poses, scene["poses"], atol=1e-5)
    np.testing.assert_allclose(ds.K, scene["K"], rtol=1e-5)
    err = np.abs(ds.rays - scene["images"])
    assert err.max() <= 1 / 255 + 1e-6


def test_jax_loader_reads_the_port_nsvf_writer(scenes):
    """The JAX loader reads the port's write_nsvf_scene (png.py, Sub rows)
    to exactly what it reads from the JAX writer's (imageio) files."""
    for split in ("train", "test"):
        got = JNSVF(scenes["port_nsvf"], split=split)
        want = JNSVF(scenes["Spheres"], split=split)
        np.testing.assert_array_equal(got.rays, want.rays)
        np.testing.assert_array_equal(got.poses, want.poses)
        np.testing.assert_array_equal(got.K, want.K)


@pytest.mark.parametrize("name", ["colmap", "nerfpp", "rtmv"])
def test_unported_loaders_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dataset_dict[name](root_dir="nowhere", split="train")
