"""The port runs where JAX is absent: in a subprocess where ``jax`` and
``mfnerf_tpu`` cannot be imported, import every module of
``mfnerf_tpu_torch`` and serve a 64-ray frame on the CPU."""
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
