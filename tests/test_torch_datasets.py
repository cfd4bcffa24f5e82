"""The port's loaders against the JAX package's, on the CPU.

The scenes are procedural (``make_scene``): at the synthetic loaders'
800x800, the NSVF one written by the JAX package's ``write_nsvf_scene``
(imageio), the Blender one by the port's ``write_blender_scene`` plus the
test's own ``transforms_val.json``; for the real-scene loaders a spread
scene (``spread=5``, on black) at 40x40, in the COLMAP layout by the port's
``write_colmap_scene`` (the JAX package has no COLMAP writer; its own
test writes ``sparse/0`` the same way, tests/test_colmap_dataset.py) and in
the NeRF++ and RTMV layouts by the JAX package's writers. Both loaders
read the same files; the port decodes with ``png.py`` and ``jpeg.py``, and
refuses OpenEXR files, and JPEG variants it does not read, by name.

HDR-NeRF's synthetic layout comes from the port's ``write_hdr_scene``:
both loaders hand out the same rgb and exposure a view and a training ray,
and the trainer steps and validates on it without ``--use_exposure``.

Tolerances: K, directions and poses 1e-6 (the same float32 arithmetic);
rays 1e-6 at the files' size and 2e-3 resized (``downsample`` 0.5: a
bilinear torch resize against cv2's, tests/test_torch_io.py).
"""
import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from mfnerf_tpu.datasets import colmap_utils as jcolmap_utils
from mfnerf_tpu.datasets.colmap import ColmapDataset as JColmap
from mfnerf_tpu.datasets.nerf import NeRFDataset as JNeRF
from mfnerf_tpu.datasets.nerfpp import NeRFPPDataset as JNeRFPP
from mfnerf_tpu.datasets.nsvf import NSVFDataset as JNSVF
from mfnerf_tpu.datasets.rtmv import RTMVDataset as JRTMV
from mfnerf_tpu.utils.procedural import write_nerfpp_scene as jwrite_nerfpp
from mfnerf_tpu.utils.procedural import write_nsvf_scene as jwrite_nsvf
from mfnerf_tpu.utils.procedural import write_rtmv_scene as jwrite_rtmv

from mfnerf_tpu_torch.datasets import colmap_utils as tcolmap_utils
from mfnerf_tpu_torch.datasets import png as tpng
from mfnerf_tpu_torch.datasets import dataset_dict
from mfnerf_tpu_torch.datasets.color_utils import read_image
from mfnerf_tpu_torch.datasets.colmap import ColmapDataset as TColmap
from mfnerf_tpu_torch.datasets.nerf import NeRFDataset as TNeRF
from mfnerf_tpu_torch.datasets.nerfpp import NeRFPPDataset as TNeRFPP
from mfnerf_tpu_torch.datasets.nsvf import NSVFDataset as TNSVF
from mfnerf_tpu_torch.datasets.rtmv import RTMVDataset as TRTMV
from mfnerf_tpu_torch import train as ttrain
from mfnerf_tpu_torch.opt import get_opts
from mfnerf_tpu_torch.utils.procedural import (HDR_TEST, HDR_TRAIN,
                                               make_scene,
                                               write_blender_scene,
                                               write_colmap_scene,
                                               write_hdr_scene,
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
    """The real-scene loaders are ported: ``dataset_dict`` names them, and
    a root that holds no such scene raises where the JAX loader does."""
    loader = {"colmap": TColmap, "nerfpp": TNeRFPP, "rtmv": TRTMV}[name]
    assert dataset_dict[name] is loader
    with pytest.raises((FileNotFoundError, IndexError)):
        dataset_dict[name](root_dir="nowhere", split="train")


# -------------------------------------------------------- real-scene loaders
@pytest.fixture(scope="module")
def real_scenes(tmp_path_factory):
    """{"scene", "colmap", "colmap360", "nerfpp", "rtmv"}: a 14+2-view 40x40
    spread scene in each layout; "colmap360" is the COLMAP one under a
    ``360_v2`` root whose images sit only in ``images_2``."""
    base = tmp_path_factory.mktemp("real")
    scene = make_scene(n_train=14, n_test=2, wh=40, seed=3, spread=5.0)
    roots = {"scene": scene}
    for name in ("colmap", "nerfpp", "rtmv"):
        roots[name] = str(base / name)
    write_colmap_scene(roots["colmap"], scene, spread=5.0)
    roots["colmap360"] = str(base / "360_v2" / "garden")
    shutil.copytree(roots["colmap"], roots["colmap360"])
    os.rename(os.path.join(roots["colmap360"], "images"),
              os.path.join(roots["colmap360"], "images_2"))
    jwrite_nerfpp(roots["nerfpp"], scene)
    jwrite_rtmv(roots["rtmv"], scene)
    return roots


def _same_cameras(got, want):
    assert got.img_wh == want.img_wh
    for name in ("K", "directions", "poses"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == np.float32 and a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("root,split,downsample,tol", [
    ("colmap", "train", 1.0, 1e-6), ("colmap", "test", 1.0, 1e-6),
    ("colmap", "trainval", 1.0, 1e-6), ("colmap", "test_traj", 1.0, 0),
    ("colmap", "train", 0.5, RESIZE_TOL),
    ("colmap360", "test", 0.5, RESIZE_TOL),
    ("nerfpp", "train", 1.0, 1e-6), ("nerfpp", "test", 1.0, 1e-6),
    ("nerfpp", "trainval", 1.0, 1e-6), ("nerfpp", "test_traj", 1.0, 0),
    ("rtmv", "train", 1.0, 1e-6), ("rtmv", "test", 1.0, 1e-6),
    ("rtmv", "trainval", 0.5, RESIZE_TOL)])
def test_real_scene_loader_matches_jax(real_scenes, root, split, downsample,
                                       tol):
    """Poses, directions, K and rays of the COLMAP (LLFF, mip-NeRF 360's
    images_<n> folder), NeRF++ and RTMV loaders against the JAX ones."""
    name = "colmap" if root.startswith("colmap") else root
    loaders = {"colmap": (TColmap, JColmap), "nerfpp": (TNeRFPP, JNeRFPP),
               "rtmv": (TRTMV, JRTMV)}[name]
    got, want = (cls(real_scenes[root], split=split, downsample=downsample)
                 for cls in loaders)
    _same_cameras(got, want)
    assert got.rays.shape == want.rays.shape
    np.testing.assert_allclose(got.rays, want.rays, rtol=0, atol=tol)
    if split == "test_traj":
        assert got.rays.size == 0 and len(got) > 0
        return
    n = {"colmap": {"train": 14, "test": 2, "trainval": 16},
         "nerfpp": {"train": 14, "test": 2, "trainval": 14},
         "rtmv": {"train": 100, "test": 5, "trainval": 105}}[name][split]
    assert len(got) == n and got.rays.dtype == np.float32
    if name == "colmap":
        np.testing.assert_allclose(got.pts3d, want.pts3d, rtol=0, atol=1e-6)
        dist = np.linalg.norm(got.poses[..., 3], axis=-1)
        assert dist.min() >= 1 - 1e-6     # the nearest camera of all at 1


def test_colmap_writer_gives_back_the_scene(real_scenes):
    """write_colmap_scene's views load back in the scene's order: the test
    views at every 8th index, the pixels to uint8 truncation."""
    scene = real_scenes["scene"]
    for split, key in (("train", "images"), ("test", "test_images")):
        ds = TColmap(real_scenes["colmap"], split=split)
        assert np.abs(ds.rays - scene[key]).max() <= 1 / 255 + 1e-6
    np.testing.assert_allclose(ds.K, scene["K"], rtol=1e-6)


def test_colmap_binary_readers_match_jax(real_scenes):
    sparse = os.path.join(real_scenes["colmap"], "sparse/0")
    for kind in ("cameras", "images", "points3d"):
        path = os.path.join(sparse, ("points3D" if kind == "points3d"
                                     else kind) + ".bin")
        got = getattr(tcolmap_utils, f"read_{kind}_binary")(path)
        want = getattr(jcolmap_utils, f"read_{kind}_binary")(path)
        assert list(got) == list(want) and len(got) > 0
        for k in got:
            for field in got[k]._fields:
                np.testing.assert_array_equal(
                    np.asarray(getattr(got[k], field)),
                    np.asarray(getattr(want[k], field)), err_msg=field)
    q = np.random.default_rng(0).normal(size=4)
    q /= np.linalg.norm(q)
    np.testing.assert_array_equal(tcolmap_utils.qvec2rotmat(q),
                                  jcolmap_utils.qvec2rotmat(q))


@pytest.mark.parametrize("kind", ["syndata", "real"])
def test_colmap_hdr_split_matches_jax(tmp_path, kind):
    """HDR-NeRF's splits: the image paths, the repeated poses and the unit
    exposure, and the loaded rays with the exposure column: the synthetic
    layout ships PNG, the real one JPEG (written here by PIL)."""
    scene = make_scene(n_train=30, n_test=5, wh=8, seed=4, spread=5.0)
    root = str(tmp_path / "HDR-NeRF" / kind / "bathroom")
    write_colmap_scene(root, scene, spread=5.0)
    n_poses = 35
    if kind == "syndata":
        files = [f"train/{i:03d}_{e}.png" for i in range(18)
                 for e in (0, 2, 4)] + [f"test/{i:03d}_{e}.png"
                                        for i in range(17) for e in (1, 3)]
    else:
        files = [f"input_images/{i:03d}_{e}.jpg" for i in range(n_poses)
                 for e in range(5)]
    img = (scene["images"][0].reshape(8, 8, 3) * 255).astype(np.uint8)
    for name in files:
        os.makedirs(os.path.dirname(os.path.join(root, name)), exist_ok=True)
        if name.endswith(".png"):
            tpng.write_png(os.path.join(root, name), img)
        else:
            Image.fromarray(img).save(os.path.join(root, name), "JPEG",
                                      quality=90)
    for split in ("train", "test"):
        got, want = (cls(root, split=split, read_meta=False)
                     for cls in (TColmap, JColmap))
        poses = np.random.default_rng(5).random((n_poses, 3, 4))
        got.poses, want.poses = poses, poses
        assert got._hdr_split(split) == want._hdr_split(split)
        np.testing.assert_array_equal(got.poses, want.poses)
        assert got.unit_exposure_rgb == want.unit_exposure_rgb
        assert len(got.poses) == {"syndata": {"train": 54, "test": 34},
                                  "real": {"train": 54, "test": 34}}[
                                      kind][split]
        got, want = TColmap(root, split=split), JColmap(root, split=split)
        _same_cameras(got, want)
        assert got.rays.shape == (len(got.poses), 64, 4)
        np.testing.assert_allclose(got.rays, want.rays, rtol=0, atol=1e-6)


@pytest.mark.parametrize("magic,fmt", [(b"\xff\xd8\xff\xc9", "JPEG"),
                                       (b"v/1\x01", "OpenEXR")])
def test_read_image_names_a_format_it_cannot_read(tmp_path, magic, fmt):
    """OpenEXR by name; of JPEG, the variants the decoder does not read (an
    arithmetic-coded frame here; tests/test_torch_jpeg.py has the rest)."""
    path = str(tmp_path / ("view.jpg" if fmt == "JPEG" else "view.exr"))
    with open(path, "wb") as f:
        f.write(magic + bytes(60))
    match = {"JPEG": r"view\.jpg: JPEG not decoded: arithmetic coding",
             "OpenEXR": r"view\.exr: an OpenEXR file"}[fmt]
    with pytest.raises(ValueError, match=match):
        read_image(path, (4, 4))


@pytest.fixture(scope="module")
def hdr_root(tmp_path_factory):
    """A 12x12 spread scene in HDR-NeRF's synthetic layout (luckycat's
    exposures: train 2, 0.5, 0.125; test 1, 0.25)."""
    root = str(tmp_path_factory.mktemp("hdr") / "HDR-NeRF" / "syndata"
               / "luckycat")
    write_hdr_scene(root, make_scene(n_train=HDR_TRAIN[0],
                                     n_test=HDR_TEST[0], wh=12, seed=0,
                                     spread=5.0), spread=5.0)
    return root


def test_hdr_test_views_match_jax(hdr_root):
    """The test split's views: rgb (H*W, 3) and the view's exposure, as the
    JAX base returns them (``mfnerf_tpu/datasets/base.py:50-60``); the
    rays keep the exposure column."""
    got, want = TColmap(hdr_root, split="test"), JColmap(hdr_root,
                                                         split="test")
    assert got.rays.shape == want.rays.shape == (34, 144, 4)
    assert got.unit_exposure_rgb == want.unit_exposure_rgb == 0.73
    for i in range(len(got)):
        a, b = got[i], want[i]
        assert set(a) == set(b) == {"pose", "img_idxs", "rgb", "exposure"}
        assert a["rgb"].shape == (144, 3)
        np.testing.assert_allclose(a["rgb"], b["rgb"], rtol=0, atol=1e-6)
        assert a["exposure"] == b["exposure"] == (1.0, 0.25)[i % 2]


def test_hdr_scene_trains_without_use_exposure(hdr_root, monkeypatch):
    """Without ``--use_exposure`` ``fit`` takes its steps on the HDR scene
    (the Sigmoid head ignores the exposure); a step's target is the rgb and
    its exposure the 4th column of the JAX base's training sample for the
    same (image, pixel) draws; ``validate`` scores every test view."""
    want = JColmap(hdr_root, split="train")
    want.batch_size = 64
    want.seed(4)
    sample = want[0]
    hp = get_opts(["--root_dir", hdr_root, "--dataset_name", "colmap",
                   "--scale", "4", "--lr_levels", "2", "--lr_rank", "8",
                   "--lr_k_max", "32", "--grid_size", "16", "--max_samples",
                   "128", "--s_max_train", "16", "--s_max_test", "32",
                   "--rgb_channels", "16", "--rgb_layers", "1",
                   "--batch_size", "64", "--num_epochs", "1",
                   "--steps_per_epoch", "4"])
    system = ttrain.NeRFSystem(hp, device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        system.setup()
    system.configure(0)
    m = system.fit()
    assert system.global_step == 4 and torch.isfinite(m["loss"]).all()
    seen = {}
    render_train = ttrain.render_train

    def spy(*args, **kwargs):
        seen["exposure"] = args[8]
        return render_train(*args, **kwargs)

    monkeypatch.setattr(ttrain, "render_train", spy)
    img = torch.from_numpy(sample["img_idxs"])
    pix = torch.from_numpy(sample["pix_idxs"])
    _, res, target = system.step_loss(img, pix, torch.rand(64))
    np.testing.assert_array_equal(target["rgb"].numpy(), sample["rgb"])
    np.testing.assert_array_equal(seen["exposure"].numpy(),
                                  sample["exposure"])
    assert res["rgb"].shape == (64, 3)
    with contextlib.redirect_stdout(io.StringIO()) as log:
        metrics = system.validate()
    assert np.isfinite(metrics["test/psnr"])
    assert log.getvalue().count("val image") == 34
