"""RTMV loader: a ``camera_data`` json a frame and ``images/``.

Port of ``mfnerf_tpu/datasets/rtmv.py`` on the tables of
``conventions.py``: intrinsics and the scene box from ``00000.json``,
index-range splits (``RTMV_SPLITS``), ``cam2world`` stored transposed in
``rub`` axes, and the box normalisation of the ``RTMV_BOUND_SCENES``.
RTMV ships OpenEXR frames, which ``color_utils.read_image`` refuses by
name: ``python -m mfnerf_tpu_torch.misc.prepare_rtmv <root_dir>`` writes
them to ``images/`` as the PNGs this loader reads, as the JAX package's
``misc/prepare_rtmv.py`` does.
"""
import glob
import json
import os

import numpy as np

from .base import BaseDataset
from .color_utils import read_image
from .conventions import (RTMV_BBOX_ENLARGE, RTMV_BOUND_SCENES, RTMV_SPLITS,
                          bound_into_unit_box, to_rdf)
from .ray_utils import get_ray_directions


class RTMVDataset(BaseDataset):
    def __init__(self, root_dir, split="train", downsample=1.0, **kwargs):
        super().__init__(root_dir, split, downsample)
        self.read_intrinsics()
        if kwargs.get("read_meta", True):
            self.read_meta(split)

    def read_intrinsics(self):
        with open(os.path.join(self.root_dir, "00000.json")) as f:
            meta = json.load(f)["camera_data"]
        self.shift = np.array(meta["scene_center_3d_box"])
        self.scale = (np.array(meta["scene_max_3d_box"])
                      - np.array(meta["scene_min_3d_box"])).max() / 2 \
            * RTMV_BBOX_ENLARGE
        intr = meta["intrinsics"]
        fx, fy, cx, cy = (intr[k] * self.downsample
                          for k in ("fx", "fy", "cx", "cy"))
        w = int(meta["width"] * self.downsample)
        h = int(meta["height"] * self.downsample)
        self.K = np.float32([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
        self.directions = get_ray_directions(h, w, self.K)
        self.img_wh = (w, h)

    def read_meta(self, split):
        start, end = RTMV_SPLITS.get(split, RTMV_SPLITS[None])
        img_paths = sorted(glob.glob(
            os.path.join(self.root_dir, "images/*")))[start:end]
        pose_files = sorted(glob.glob(
            os.path.join(self.root_dir, "*.json")))[start:end]
        bound = any(s in self.root_dir for s in RTMV_BOUND_SCENES)
        print(f"Loading {len(img_paths)} {split} images ...", flush=True)
        rays, poses = [], []
        for img_path, pose in zip(img_paths, pose_files):
            with open(pose) as f:
                p = json.load(f)["camera_data"]
            c2w = to_rdf(np.array(p["cam2world"]).T, "rub")
            if bound:
                c2w = bound_into_unit_box(c2w, self.shift, 2 * self.scale)
            poses.append(c2w)
            rays.append(read_image(img_path, self.img_wh))
        self.rays = np.stack(rays)
        self.poses = np.stack(poses).astype(np.float32)
