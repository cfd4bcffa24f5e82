"""The port runs where JAX is absent: in a subprocess where ``jax``,
``mfnerf_tpu``, ``imageio``, ``PIL``, ``cv2`` and ``tqdm`` cannot be
imported, import every module of ``mfnerf_tpu_torch``, serve a 64-ray frame,
take two training steps of a LowRank and of a MixedFeature field, and run
the command line's ``main`` on a small scene written to disk, on the CPU."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
BLOCKED = ("jax", "mfnerf_tpu", "imageio", "PIL", "cv2", "tqdm")
for blocked in BLOCKED:              # any import of them raises ImportError
    sys.modules[blocked] = None
import torch
import mfnerf_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mfnerf_tpu_torch.__path__,
                                               "mfnerf_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from mfnerf_tpu_torch.datasets.ray_utils import get_rays
from mfnerf_tpu_torch.models.ngp import NGP, NGPConfig, OccupancyState
from mfnerf_tpu_torch.models.rendering import RenderConfig, render_test
from mfnerf_tpu_torch.utils.procedural import make_scene
g = torch.Generator().manual_seed(0)
cfg = NGPConfig(lr_k_max=256, lr_fused=True, grid_size=16)
model = NGP(cfg, g, device="cpu")
occ = model.update_density_grid(
    OccupancyState.create(cfg, "cpu"), 5.77,
    torch.rand((1, cfg.n_cells, 3), generator=g) * 2 - 1)
scene = make_scene(n_train=1, n_test=1, wh=8, seed=0)
ro, rd = get_rays(torch.from_numpy(scene["directions"]),
                  torch.from_numpy(scene["test_poses"][0]))
out = render_test(model, occ, ro, rd, RenderConfig(T_threshold=1e-2))
assert out["rgb"].shape == (64, 3) and torch.isfinite(out["rgb"]).all()
assert out["total_samples"] > 0
import argparse
from mfnerf_tpu_torch.datasets.memory import MemoryDataset
from mfnerf_tpu_torch.train import NeRFSystem
hp = argparse.Namespace(
    dataset_name="nsvf", scale=0.5, use_exposure=False, distortion_loss_w=1e-3,
    batch_size=64, num_epochs=1, lr=1e-2, optimize_ext=False, random_bg=False,
    grid="LowRank", L=16, F=2, rgb_channels=16, rgb_layers=1, seed=1,
    s_max_train=16, s_max_test=32, test_chunk=1024, grid_size=16,
    max_samples=128, lr_levels=2, lr_rank=8, lr_k_max=32, lr_fused=True,
    refresh_half=True)
system = NeRFSystem(hp, device="cpu")
system.setup(MemoryDataset.from_scene(scene, "train"))
system.configure(0)
before = system.model.lowrank.lines[0][1][0].detach().clone()
metrics = system.fit(2)
assert system.global_step == 2 and torch.isfinite(metrics["loss"]).all()
assert not torch.equal(before, system.model.lowrank.lines[0][1][0])
hp.grid, hp.L, hp.T, hp.N_max, hp.hash_grad_samples = "MixedFeature", 4, 12, 64, 1
system = NeRFSystem(hp, device="cpu")
system.setup(MemoryDataset.from_scene(scene, "train"))
system.configure(0)
before = system.model.hash_table.detach().clone()
metrics = system.fit(2)
assert torch.isfinite(metrics["loss"]).all()
assert not torch.equal(before, system.model.hash_table)
import os, tempfile
import numpy as np
from mfnerf_tpu_torch.opt import get_opts
from mfnerf_tpu_torch.train import main
from mfnerf_tpu_torch.utils.procedural import write_nsvf_scene
scene = make_scene(n_train=2, n_test=1, wh=16, seed=0)
scene["K"] = scene["K"] * np.float32([[50], [50], [1]])   # read at 800 x 0.02
with tempfile.TemporaryDirectory() as tmp:
    os.chdir(tmp)
    write_nsvf_scene("Synthetic_NeRF_proc/Spheres", scene)
    metrics = main(get_opts([
        "--root_dir", "Synthetic_NeRF_proc/Spheres", "--grid", "LowRank",
        "--downsample", "0.02", "--num_epochs", "1", "--steps_per_epoch", "2",
        "--batch_size", "64", "--grid_size", "16", "--lr_levels", "2",
        "--lr_rank", "8", "--lr_k_max", "32", "--max_samples", "128",
        "--s_max_train", "16", "--s_max_test", "32", "--rgb_channels", "16",
        "--rgb_layers", "1"]), device="cpu")
    assert os.path.exists("ckpts/nsvf/exp/epoch=0_slim.ckpt.npz")
    assert os.path.exists("results/nsvf/exp/000_d.png")
    os.chdir("/")
assert np.isfinite(metrics["test/psnr"]) and np.isfinite(metrics["test/ssim"])
assert not any(m.split(".")[0] in BLOCKED
               for m in sys.modules if sys.modules[m] is not None)
print("ok", len(names))
"""


def test_port_imports_and_serves_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # one intra-op thread: the suite runs in several worker processes
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    last = proc.stdout.splitlines()[-1]
    assert last.startswith("ok ")
    assert int(last.split()[1]) >= 15   # every module was imported
