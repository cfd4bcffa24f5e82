"""The port runs where JAX is absent: in a subprocess where ``jax`` and
``mfnerf_tpu`` cannot be imported, import every module of
``mfnerf_tpu_torch``, serve a 64-ray frame and take two training steps on
the CPU."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None            # any import of them raises ImportError
sys.modules["mfnerf_tpu"] = None
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
model = NGP(cfg, g)
occ = model.update_density_grid(
    OccupancyState.create(cfg), 5.77,
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
assert not any(m == "jax" or m.startswith(("jax.", "mfnerf_tpu."))
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
    assert proc.stdout.startswith("ok ")
    assert int(proc.stdout.split()[1]) >= 15   # every module was imported
