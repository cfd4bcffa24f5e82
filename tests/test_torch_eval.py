"""The port's offline entry points against the JAX package's, on the CPU:
``eval`` (the root ``eval.py`` run with ``JAX_PLATFORMS=cpu`` on the same
checkpoint: per-view PSNR within 0.05 dB, the printed value's resolution
being 0.01), the mesh export (the JAX fallback's vertex set, but for
voxels next to one whose σ lies within 1e-3 relative of the threshold,
where the two σ grids' last bits decide), the viewer's orbit camera (the
JAX one's pose within 1e-6) and orbit render, ``main --profile`` and
``read_pfm``."""
import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from mfnerf_tpu.datasets import depth_utils as jdepth
from mfnerf_tpu.models import ngp as jngp
from mfnerf_tpu.utils import mesh as jmesh

from mfnerf_tpu_torch import eval as teval
from mfnerf_tpu_torch import opt as topt
from mfnerf_tpu_torch import show_gui as tgui
from mfnerf_tpu_torch import train as ttrain
from mfnerf_tpu_torch.datasets import depth_utils as tdepth
from mfnerf_tpu_torch.models import ngp as tngp
from mfnerf_tpu_torch.utils import mesh as tmesh
from mfnerf_tpu_torch.utils.ckpt import params_from_numpy
from mfnerf_tpu_torch.utils.procedural import make_scene, write_nsvf_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE_DIR = os.path.join("Synthetic_NeRF_proc", "Spheres")
# a small LowRank model on a 32x32 NSVF scene (read at 800 x 0.04)
FLAGS = ["--root_dir", SCENE_DIR, "--exp_name", "e", "--grid", "LowRank",
         "--lr_levels", "2", "--lr_rank", "8", "--lr_k_max", "32",
         "--grid_size", "16", "--max_samples", "128", "--s_max_train", "16",
         "--s_max_test", "32", "--rgb_channels", "16", "--rgb_layers", "1",
         "--batch_size", "256", "--downsample", "0.04"]
CKPT = os.path.join("ckpts", "nsvf", "e", "epoch=0.ckpt.npz")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A directory holding the scene and a checkpoint of 30 steps."""
    root = tmp_path_factory.mktemp("eval")
    scene = make_scene(n_train=4, n_test=2, wh=32, seed=0)
    write_nsvf_scene(str(root / SCENE_DIR),
                     dict(scene, K=scene["K"] * np.float32([[25], [25],
                                                            [1]])))
    cwd, n = os.getcwd(), torch.get_num_threads()
    os.chdir(root)
    torch.set_num_threads(1)
    try:
        ttrain.main(topt.get_opts(FLAGS + [
            "--num_epochs", "1", "--steps_per_epoch", "30",
            "--no_save_test"]), device="cpu")
    finally:
        os.chdir(cwd)
        torch.set_num_threads(n)
    return root


def _jax_eval(root, *extra):
    """The root eval.py's stdout, on the JAX package on the CPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "eval.py"), *FLAGS,
         "--ckpt_path", CKPT, "--no_save_test", *extra],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_eval_matches_the_root_eval_script(trained, monkeypatch, capsys):
    monkeypatch.chdir(trained)
    got = teval.main(FLAGS + ["--ckpt_path", CKPT], device="cpu")
    out = capsys.readouterr().out
    want = [float(p) for p in re.findall(r"^image \d+: \d+ ms, psnr "
                                         r"([0-9.]+)$",
                                         _jax_eval(trained), re.M)]
    assert len(want) == len(got["psnr"]) == 2
    np.testing.assert_allclose(got["psnr"], want, rtol=0, atol=0.05)
    assert re.search(r"^image 1: \d+ ms, psnr [0-9.]+$", out, re.M)
    assert re.search(r"^mean PSNR: [0-9.]+ dB$", out, re.M)
    assert re.search(r"^mean FPS: [0-9.]+$", out, re.M)
    assert sorted(os.listdir(os.path.join("results", "nsvf", "e", "eval"))) \
        == ["000.png", "000_d.png", "001.png", "001_d.png"]


def test_eval_at_training_threshold_is_val_only(trained, monkeypatch):
    """At T 1e-4 eval renders as validation does: the same PSNR."""
    monkeypatch.chdir(trained)
    got = teval.main(FLAGS + ["--ckpt_path", CKPT, "--t_threshold", "1e-4",
                              "--no_save_test"], device="cpu")
    val = ttrain.main(topt.get_opts(FLAGS + [
        "--val_only", "--ckpt_path", CKPT, "--no_save_test"]), device="cpu")
    assert got["mean_psnr"] == pytest.approx(val["test/psnr"], abs=1e-6)


@pytest.mark.parametrize("flag", [["--guided"], ["--wavefront", "4,2,8,64"]])
def test_eval_refuses_the_unported_renderers(trained, monkeypatch, flag):
    monkeypatch.chdir(trained)
    with pytest.raises(NotImplementedError, match=flag[0]):
        teval.main(FLAGS + ["--ckpt_path", CKPT, *flag], device="cpu")


def test_eval_exports_a_mesh(trained, monkeypatch, capsys):
    monkeypatch.chdir(trained)
    monkeypatch.setitem(sys.modules, "mcubes", None)   # the fallback
    got = teval.main(FLAGS + ["--ckpt_path", CKPT, "--no_save_test",
                              "--mesh", "m.obj", "--mesh_resolution", "16",
                              "--sigma_threshold", "0.5"], device="cpu")
    with open("m.obj") as f:
        lines = f.read().splitlines()
    assert len(lines) == got["mesh_vertices"] > 0
    assert all(line.startswith("v ") for line in lines)
    assert f"mesh: {got['mesh_vertices']} vertices -> m.obj" in \
        capsys.readouterr().out


# ------------------------------------------------------------------ mesh
@pytest.mark.parametrize("grid", ["LowRank", "Hash"])
def test_extract_mesh_matches_the_jax_fallback(tmp_path, monkeypatch, grid):
    monkeypatch.setitem(sys.modules, "mcubes", None)
    cfg = dict(lr_levels=2, lr_rank=8, lr_k_max=32, grid_size=16,
               rgb_channels=16, rgb_layers=1, grid=grid, L=4, log2_T=12,
               N_max=64)
    jmodel = jngp.NGP(jngp.NGPConfig(**cfg))
    params = jmodel.init(jax.random.PRNGKey(2))
    tmodel = tngp.NGP(tngp.NGPConfig(**cfg), device="cpu")
    tmodel.load_state_dict(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params)))
    res = 32
    sigma_j = jmesh.density_on_grid(jmodel, params, res)
    sigma_t = tmesh.density_on_grid(tmodel, res)
    np.testing.assert_allclose(sigma_t, sigma_j, rtol=1e-4,
                               atol=1e-5 * np.abs(sigma_j).max())
    thr = float(np.quantile(sigma_j, 0.7))
    verts_j, _ = jmesh.extract_mesh(jmodel, params, res, thr,
                                    out_path=str(tmp_path / "j.obj"))
    verts_t, tris = tmesh.extract_mesh(tmodel, res, thr,
                                       out_path=str(tmp_path / "t.obj"))
    assert tris is None and len(verts_j) > 500
    scale = 2 * 0.5 / (res - 1)
    key = lambda v: {tuple(i) for i in np.rint((v + 0.5) / scale).astype(
        int)}
    differ = key(verts_j) ^ key(verts_t)
    near = np.abs(sigma_j - thr) <= 1e-3 * thr
    for i, j, k in differ:      # a voxel at or next to a near-threshold one
        nb = near[max(i - 1, 0):i + 2, max(j - 1, 0):j + 2,
                  max(k - 1, 0):k + 2]
        assert nb.any(), (i, j, k)
    assert len(differ) <= 0.01 * len(verts_j), len(differ)
    with open(tmp_path / "t.obj") as f:
        assert len(f.read().splitlines()) == len(verts_t)


# ------------------------------------------------------------ the viewer
def _jax_show_gui():
    spec = importlib.util.spec_from_file_location(
        "jax_show_gui", os.path.join(REPO, "show_gui.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_orbit_camera_matches_jax():
    jgui = _jax_show_gui()
    k = np.float32([[40, 0, 16], [0, 40, 16], [0, 0, 1]])
    cams = [m.OrbitCamera(k, (32, 32), 2.5) for m in (jgui, tgui)]
    for cam in cams:
        for step in range(5):
            cam.orbit(600, 37 * step - 50)
            cam.scale(0.5 - step / 4)
            cam.pan(120 * step, -80, 15)
    np.testing.assert_allclose(cams[1].pose, cams[0].pose, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tgui._rotvec_to_mat(np.float64([0.3, -1, 2])),
                               jgui._rotvec_to_mat(np.float64([0.3, -1, 2])),
                               rtol=0, atol=1e-12)


def test_render_orbit_writes_its_frames(trained, monkeypatch, capsys):
    monkeypatch.chdir(trained)
    ms = tgui.main(FLAGS + ["--ckpt_path", CKPT], device="cpu", n_frames=3)
    out = capsys.readouterr().out
    assert len(ms) == 3 and all(t > 0 for t in ms)
    frames = sorted(os.listdir(os.path.join("results", "nsvf", "e", "gui")))
    assert frames == ["orbit_000.png", "orbit_001.png", "orbit_002.png"]
    assert len(re.findall(r"^frame \d: \d+ ms, [0-9.]+ samples/ray$", out,
                          re.M)) == 3
    assert "mp4 skipped" in out


# --------------------------------------------------------------- profile
def test_profile_writes_a_trace_and_resets_the_step(trained, monkeypatch):
    """``--profile``: 48 traced steps, then, as the JAX ``main``, the step
    counter back at 0 and the epoch settings restored, then the run."""
    monkeypatch.chdir(trained)
    calls = []
    fit = ttrain.NeRFSystem.fit

    def spy(self, n_steps=None):
        start = self.global_step
        out = fit(self, n_steps)
        calls.append((start, self.global_step, self.steps_per_epoch))
        return out

    monkeypatch.setattr(ttrain.NeRFSystem, "fit", spy)
    ttrain.main(topt.get_opts(FLAGS + [
        "--exp_name", "p", "--num_epochs", "1", "--steps_per_epoch", "4",
        "--no_save_test", "--profile"]), device="cpu")
    assert calls == [(0, 48, 48), (0, 4, 4)]
    path = os.path.join("logs", "nsvf", "p", "profile", "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::mm") for e in events)


# ------------------------------------------------------------------ PFM
@pytest.mark.parametrize("color,scale", [(True, -1.0), (False, 2.5)])
def test_read_pfm_matches_jax(tmp_path, color, scale):
    rng = np.random.default_rng(0)
    data = rng.random((5, 7, 3) if color else (5, 7), dtype=np.float32)
    path = str(tmp_path / "d.pfm")
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(b"7 5\n" + f"{scale}\n".encode())
        f.write(data.astype("<f4" if scale < 0 else ">f4").tobytes())
    got, want = tdepth.read_pfm(path), jdepth.read_pfm(path)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == abs(scale)
    np.testing.assert_array_equal(got[0], np.flipud(data))
