"""NSVF-format loader (Synthetic-NeRF/NSVF, BlendedMVS, TanksAndTemples).

Port of ``mfnerf_tpu/datasets/nsvf.py`` on the tables of
``conventions.py``: family intrinsics and resolution (``NSVF_FAMILIES``),
filename-prefix splits (``NSVF_SPLIT_PREFIX``), the bbox shift and scale
with the scene-bound fixes (``NSVF_BOUND_FIX``), the ``test_traj`` axis
flip and the black-to-white background scenes (``NSVF_BLACK_TO_WHITE``).
Progress is printed, one line a split.
"""
import glob
import os

import numpy as np

from .base import BaseDataset
from .color_utils import read_image
from .conventions import (NSVF_BBOX_ENLARGE, NSVF_BLACK_TO_WHITE,
                          NSVF_BOUND_FIX, NSVF_FAMILIES, NSVF_SPLIT_PREFIX,
                          bound_into_unit_box, match_family, to_rdf)
from .ray_utils import get_ray_directions


class NSVFDataset(BaseDataset):
    def __init__(self, root_dir, split="train", downsample=1.0, **kwargs):
        super().__init__(root_dir, split, downsample)
        self.read_intrinsics()
        if kwargs.get("read_meta", True):
            xyz_min, xyz_max = np.loadtxt(
                os.path.join(root_dir, "bbox.txt"))[:6].reshape(2, 3)
            self.shift = (xyz_max + xyz_min) / 2
            self.scale = (xyz_max - xyz_min).max() / 2 * NSVF_BBOX_ENLARGE
            for marker, fix in NSVF_BOUND_FIX.items():
                if marker in self.root_dir:
                    self.scale *= fix
            self.read_meta(split)

    def read_intrinsics(self):
        fam = match_family(self.root_dir, NSVF_FAMILIES)
        w, h = (int(v * self.downsample) for v in fam["wh"])
        path = os.path.join(self.root_dir, "intrinsics.txt")
        if fam["fx_from_first_float"]:
            with open(path) as f:
                fx = fy = float(f.readline().split()[0]) * self.downsample
            K = np.float32([[fx, 0, w / 2], [0, fy, h / 2], [0, 0, 1]])
        else:
            K = np.loadtxt(path, dtype=np.float32)[:3, :3]
            K[:2] *= self.downsample
        self.K = np.asarray(K, np.float32)
        self.directions = get_ray_directions(h, w, self.K)
        self.img_wh = (w, h)

    def _split_prefix(self, split):
        if split in NSVF_SPLIT_PREFIX:
            return NSVF_SPLIT_PREFIX[split]
        if split == "test":
            synthetic = "Synthetic" in self.root_dir
            return NSVF_SPLIT_PREFIX[("test", synthetic)]
        raise ValueError(f"{split} split not recognized!")

    def _bound(self, c2w):
        return bound_into_unit_box(c2w, self.shift, 2 * self.scale)

    def read_meta(self, split):
        rays, poses = [], []

        if split == "test_traj":  # BlendedMVS and TanksAndTemples
            if "Ignatius" in self.root_dir:
                traj = [np.loadtxt(p) for p in sorted(glob.glob(
                    os.path.join(self.root_dir, "test_pose/*.txt")))]
            else:
                traj = np.loadtxt(os.path.join(
                    self.root_dir, "test_traj.txt")).reshape(-1, 4, 4)
            poses = [self._bound(to_rdf(pose, "ldf")).astype(np.float32)
                     for pose in traj]
        else:
            prefix = self._split_prefix(split)
            img_paths = sorted(glob.glob(
                os.path.join(self.root_dir, "rgb", prefix + "*.png")))
            pose_files = sorted(glob.glob(
                os.path.join(self.root_dir, "pose", prefix + "*.txt")))

            to_white = any(s in self.root_dir for s in NSVF_BLACK_TO_WHITE)
            print(f"Loading {len(img_paths)} {split} images ...", flush=True)
            for img_path, pose in zip(img_paths, pose_files):
                c2w = self._bound(to_rdf(np.loadtxt(pose), "rdf"))
                poses.append(c2w.astype(np.float32))

                img = read_image(img_path, self.img_wh)
                if to_white:  # black-background scenes -> white
                    img[np.all(img <= 0.1, axis=-1)] = 1.0
                rays.append(img)
            if rays:
                self.rays = np.stack(rays)
        self.poses = np.stack(poses).astype(np.float32)
