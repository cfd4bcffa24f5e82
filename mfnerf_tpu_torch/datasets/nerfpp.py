"""NeRF++ loader: ``{split}/{intrinsics,rgb,pose}`` and the
``camera_path/pose`` test trajectory.

Port of ``mfnerf_tpu/datasets/nerfpp.py``. The image size comes from the
first training image's PNG header (``png.png_size``; the JAX loader asks
PIL, which the card's machine lacks). ``trainval`` reads ``train`` and
``val``.
"""
import glob
import os

import numpy as np

from .base import BaseDataset
from .color_utils import read_image
from .png import png_size
from .ray_utils import get_ray_directions


class NeRFPPDataset(BaseDataset):
    def __init__(self, root_dir, split="train", downsample=1.0, **kwargs):
        super().__init__(root_dir, split, downsample)
        self.read_intrinsics()
        if kwargs.get("read_meta", True):
            self.read_meta(split)

    def read_intrinsics(self):
        K = np.loadtxt(
            glob.glob(os.path.join(self.root_dir,
                                   "train/intrinsics/*.txt"))[0],
            dtype=np.float32).reshape(4, 4)[:3, :3]
        K[:2] *= self.downsample
        w, h = png_size(
            glob.glob(os.path.join(self.root_dir, "train/rgb/*"))[0])
        w, h = int(w * self.downsample), int(h * self.downsample)
        self.K = np.asarray(K, np.float32)
        self.directions = get_ray_directions(h, w, self.K)
        self.img_wh = (w, h)

    def _files(self, split, sub, pattern):
        splits = ["train", "val"] if split == "trainval" else [split]
        return sum((sorted(glob.glob(os.path.join(self.root_dir, name, sub,
                                                  pattern)))
                    for name in splits), [])

    def read_meta(self, split):
        if split == "test_traj":
            pose_files = sorted(glob.glob(
                os.path.join(self.root_dir, "camera_path/pose/*.txt")))
            self.poses = np.stack([np.loadtxt(p).reshape(4, 4)[:3]
                                   for p in pose_files]).astype(np.float32)
            return
        img_paths = self._files(split, "rgb", "*")
        pose_files = self._files(split, "pose", "*.txt")
        print(f"Loading {len(img_paths)} {split} images ...", flush=True)
        rays, poses = [], []
        for img_path, pose in zip(img_paths, pose_files):
            poses.append(np.loadtxt(pose).reshape(4, 4)[:3])
            rays.append(read_image(img_path, self.img_wh))
        self.rays = np.stack(rays)
        self.poses = np.stack(poses).astype(np.float32)
