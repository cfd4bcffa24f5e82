"""NeRF (Blender) synthetic dataset loader.

Port of ``mfnerf_tpu/datasets/nerf.py`` on the tables of
``conventions.py``: ``transforms_{split}.json`` frames (``trainval`` reads
train and val), fx from ``camera_angle_x`` at ``BLENDER_WH``, pose axes
``rub`` (Blender) or ``luf`` (Jrender), the camera radius normalised to
``BLENDER_POSE_RADIUS`` or the Jrender scene's ``JRENDER_RADIUS``, then
the ``JRENDER_SHIFT`` corrections. Progress is printed, one line a split.
"""
import json
import os

import numpy as np

from .base import BaseDataset
from .color_utils import read_image
from .conventions import (BLENDER_POSE_RADIUS, BLENDER_WH, JRENDER_RADIUS,
                          JRENDER_SHIFT, scene_name, to_rdf)
from .ray_utils import get_ray_directions


def _load_frames(root_dir, split):
    names = ["train", "val"] if split == "trainval" else [split]
    frames = []
    for name in names:
        with open(os.path.join(root_dir, f"transforms_{name}.json")) as f:
            frames += json.load(f)["frames"]
    return frames


class NeRFDataset(BaseDataset):
    def __init__(self, root_dir, split="train", downsample=1.0, **kwargs):
        super().__init__(root_dir, split, downsample)
        self.read_intrinsics()
        if kwargs.get("read_meta", True):
            self.read_meta(split)

    def read_intrinsics(self):
        with open(os.path.join(self.root_dir, "transforms_train.json")) as f:
            meta = json.load(f)
        w, h = (int(v * self.downsample) for v in BLENDER_WH)
        fx = fy = 0.5 * BLENDER_WH[0] / np.tan(
            0.5 * meta["camera_angle_x"]) * self.downsample
        self.K = np.float32([[fx, 0, w / 2], [0, fy, h / 2], [0, 0, 1]])
        self.directions = get_ray_directions(h, w, self.K)
        self.img_wh = (w, h)

    def read_meta(self, split):
        frames = _load_frames(self.root_dir, split)
        jrender = "Jrender_Dataset" in self.root_dir
        scene = scene_name(self.root_dir)
        radius = (JRENDER_RADIUS.get(scene, BLENDER_POSE_RADIUS) if jrender
                  else BLENDER_POSE_RADIUS)

        rays, poses = [], []
        print(f"Loading {len(frames)} {split} images ...", flush=True)
        for frame in frames:
            c2w = to_rdf(np.array(frame["transform_matrix"]),
                         "luf" if jrender else "rub")
            c2w[:, 3] /= np.linalg.norm(c2w[:, 3]) / radius
            if jrender and scene in JRENDER_SHIFT:
                row, delta = JRENDER_SHIFT[scene]
                c2w[row, 3] += delta
            poses.append(c2w.astype(np.float32))

            img_path = os.path.join(self.root_dir,
                                    f"{frame['file_path']}.png")
            if os.path.exists(img_path):
                rays.append(read_image(img_path, self.img_wh))

        if rays:
            self.rays = np.stack(rays)
        self.poses = np.stack(poses).astype(np.float32)
