"""Viewer on a trained checkpoint: port of the root ``show_gui.py``'s
orbit camera and offline orbit render.

    python -m mfnerf_tpu_torch.show_gui --root_dir <dir> \
        --dataset_name <name> --ckpt_path <ckpt.npz> ...

:class:`OrbitCamera` is the JAX script's (``show_gui.py:23-65``). Frames
are served by the port's ``render_test`` (the alive-ray loop) at
``T_threshold`` 1e-2, ``max_samples`` 100 and ``s_max_test`` 64, with the
exponential steps of unbounded scenes for ``colmap`` and ``nerfpp`` and
exposure 0.2 for an HDR-NeRF head. The JAX viewer's depth-guided pass and
its dearpygui window (with its depth view) are not ported: the script
always renders offline
(:meth:`NGPGUI.render_orbit`, 30 frames at ~30 degrees a frame into
``results/<dataset>/<exp>/gui/orbit_NNN.png``, a line a frame with its ms
and samples a ray) and skips the mp4. Runs on the card;
:class:`NGPGUI` takes ``device="cpu"`` for tests.
"""
import os
import time

import numpy as np
import torch

from .datasets import dataset_dict
from .datasets.png import write_png
from .datasets.ray_utils import get_ray_directions, get_rays
from .device import no_tf32
from .models.rendering import RenderConfig, render_test
from .opt import get_opts
from .train import NeRFSystem


def _rotvec_to_mat(v):
    angle = np.linalg.norm(v)
    if angle < 1e-12:
        return np.eye(3)
    axis = v / angle
    k = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)


class OrbitCamera:
    """A camera on a sphere of ``radius`` about ``center`` (float64)."""

    def __init__(self, K, img_wh, r):
        self.K = K
        self.W, self.H = img_wh
        self.radius = r
        self.center = np.zeros(3)
        self.rot = np.eye(3)

    @property
    def pose(self):
        res = np.eye(4)
        res[2, 3] -= self.radius
        rot = np.eye(4)
        rot[:3, :3] = self.rot
        res = rot @ res
        res[:3, 3] -= self.center
        return res

    def orbit(self, dx, dy):
        rotvec_x = self.rot[:, 1] * np.radians(0.05 * dx)
        rotvec_y = self.rot[:, 0] * np.radians(-0.05 * dy)
        self.rot = _rotvec_to_mat(rotvec_y) @ _rotvec_to_mat(rotvec_x) @ \
            self.rot

    def scale(self, delta):
        self.radius *= 1.1 ** (-delta)

    def pan(self, dx, dy, dz=0):
        self.center += 1e-4 * self.rot @ np.array([dx, dy, dz])


class NGPGUI:
    """Render a trained field from an orbit camera, offline."""

    def __init__(self, hparams, K, img_wh, radius=2.5, device=None):
        self.hparams = hparams
        system = NeRFSystem(hparams, device=device)
        system.init_model(0)
        system.restore(hparams.ckpt_path, with_optimizer=False)
        self.system = system
        self.rcfg = RenderConfig(
            exp_step_factor=(1 / 256 if hparams.dataset_name
                             in ("colmap", "nerfpp") else 0.0),
            T_threshold=1e-2, max_samples=100, s_max_test=64,
            test_chunk=min(hparams.test_chunk, img_wh[0] * img_wh[1]))
        self.cam = OrbitCamera(K, img_wh, r=radius)
        self.W, self.H = img_wh
        self.dt = 0.0
        self.mean_samples = 0.0
        self.exposure = 0.2 if hparams.use_exposure else None

    def render_cam(self, cam):
        """The frame at ``cam``: (H, W, 3) float32 rgb in [0, 1]; sets
        ``dt`` (host clock, synchronised) and ``mean_samples`` (samples a
        ray)."""
        system = self.system
        dev = system.device
        directions = torch.from_numpy(
            get_ray_directions(cam.H, cam.W, cam.K)).to(dev)
        pose = torch.from_numpy(cam.pose[:3].astype(np.float32)).to(dev)
        system.synchronize()
        t = time.perf_counter()
        results = render_test(system.model, system.occ,
                              *get_rays(directions, pose), self.rcfg,
                              exposure=self.exposure)
        system.synchronize()
        self.dt = time.perf_counter() - t
        self.mean_samples = float(results["total_samples"]) \
            / (self.W * self.H)
        return results["rgb"].reshape(self.H, self.W, 3).cpu().numpy()

    def render_orbit(self, out_dir, n_frames=30):
        """``n_frames`` frames, the camera orbited 600 (~30 degrees) before
        each, as ``orbit_NNN.png`` under ``out_dir``. Returns each frame's
        ms."""
        os.makedirs(out_dir, exist_ok=True)
        ms = []
        for i in range(n_frames):
            self.cam.orbit(600, 0)
            img = (np.clip(self.render_cam(self.cam), 0, 1)
                   * 255).astype(np.uint8)
            write_png(os.path.join(out_dir, f"orbit_{i:03d}.png"), img)
            ms.append(self.dt * 1e3)
            print(f"frame {i}: {self.dt * 1e3:.0f} ms, "
                  f"{self.mean_samples:.1f} samples/ray", flush=True)
        print("mp4 skipped: the port writes no mp4", flush=True)
        return ms


def main(argv=None, device=None, n_frames=30):
    """The script: the dataset's intrinsics, then the offline orbit."""
    hparams = get_opts(argv)
    if not hparams.ckpt_path:
        raise ValueError("--ckpt_path is required for the viewer")
    no_tf32()
    dataset = dataset_dict[hparams.dataset_name](
        root_dir=hparams.root_dir, downsample=hparams.downsample,
        read_meta=False)
    gui = NGPGUI(hparams, dataset.K, dataset.img_wh, device=device)
    print("the port has no dearpygui window -> offline orbit render")
    return gui.render_orbit(f"results/{hparams.dataset_name}/"
                            f"{hparams.exp_name}/gui", n_frames)


if __name__ == "__main__":
    main()
