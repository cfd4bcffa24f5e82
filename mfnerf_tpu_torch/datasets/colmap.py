"""COLMAP-reconstruction loader (LLFF, mip-NeRF 360, HDR-NeRF scenes).

Port of ``mfnerf_tpu/datasets/colmap.py`` on the tables of
``conventions.py``: intrinsics from ``sparse/0/cameras.bin`` scaled by
``downsample``; poses from ``sparse/0/images.bin`` in filename order,
centred about the average pose with the ``points3D.bin`` cloud and scaled
so the nearest camera sits at distance 1; mip-NeRF 360's
``images_<1/downsample>`` folders; every ``COLMAP_TEST_EVERY``-th image a
test view; the ``test_traj`` spheric trajectory; HDR-NeRF's splits and
its exposure column (``HDR_EXPOSURES``). The readers are
``colmap_utils.py``'s (the JAX package's C++ parser is not ported; it reads
the same files). Images decode through ``color_utils.read_image``: PNG
and JPEG, as the scenes ship them.
"""
import glob
import os

import numpy as np

from .base import BaseDataset
from .color_utils import read_image
from .colmap_utils import (qvec2rotmat, read_cameras_binary,
                           read_images_binary, read_points3d_binary)
from .conventions import (COLMAP_TEST_EVERY, HDR_EXPOSURES,
                          HDR_UNIT_EXPOSURE_RGB, MIPNERF360_MARKER,
                          scene_name)
from .ray_utils import center_poses, create_spheric_poses, get_ray_directions


def poses_from_colmap(qvecs, tvecs, perm):
    """World-to-camera quaternion/translation pairs -> (N, 3, 4) c2w poses in
    ``perm`` (filename-sorted) order."""
    bottom = np.array([[0, 0, 0, 1.0]])
    w2c_mats = [np.concatenate(
        [np.concatenate([qvec2rotmat(q), t.reshape(3, 1)], 1), bottom], 0)
        for q, t in zip(qvecs, tvecs)]
    return np.linalg.inv(np.stack(w2c_mats, 0))[perm, :3]


def normalize_colmap_poses(poses, pts3d):
    """Centre poses about the point-cloud-informed average pose, then scale
    so the nearest camera sits at distance 1."""
    poses, pts3d = center_poses(poses, pts3d)
    scale = np.linalg.norm(poses[..., 3], axis=-1).min()
    poses[..., 3] /= scale
    return poses, pts3d / scale


class ColmapDataset(BaseDataset):
    def __init__(self, root_dir, split="train", downsample=1.0, **kwargs):
        super().__init__(root_dir, split, downsample)
        self.read_intrinsics()
        if kwargs.get("read_meta", True):
            self.read_meta(split)

    def read_intrinsics(self):
        cam = read_cameras_binary(
            os.path.join(self.root_dir, "sparse/0/cameras.bin"))[1]
        h = int(cam.height * self.downsample)
        w = int(cam.width * self.downsample)
        self.img_wh = (w, h)
        if cam.model == "SIMPLE_RADIAL":
            fx = fy = cam.params[0] * self.downsample
            cx, cy = (p * self.downsample for p in cam.params[1:3])
        elif cam.model in ["PINHOLE", "OPENCV"]:
            fx, fy, cx, cy = (p * self.downsample for p in cam.params[:4])
        else:
            raise ValueError(
                f"Please parse the intrinsics for camera model {cam.model}!")
        self.K = np.float32([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
        self.directions = get_ray_directions(h, w, self.K)

    def _hdr_split(self, split):
        """HDR-NeRF image paths and poses: synthetic scenes shoot 3
        exposures a train pose and 2 a test pose; real ones alternate
        even-train / odd-test."""
        if "syndata" in self.root_dir:   # 17 test + 18 train poses
            self.unit_exposure_rgb = HDR_UNIT_EXPOSURE_RGB["syndata"]
            if split == "train":
                paths = sorted(glob.glob(os.path.join(
                    self.root_dir, "train/*[024].png")))
                poses = np.repeat(self.poses[-18:], 3, 0)
            elif split == "test":
                paths = sorted(glob.glob(os.path.join(
                    self.root_dir, "test/*[13].png")))
                poses = np.repeat(self.poses[:17], 2, 0)
            else:
                raise ValueError(f"split {split} is invalid for HDR-NeRF!")
        else:
            self.unit_exposure_rgb = HDR_UNIT_EXPOSURE_RGB["real"]
            if split == "train":
                paths = sum((sorted(glob.glob(os.path.join(
                    self.root_dir, f"input_images/*{e}.jpg")))[::2]
                    for e in (0, 2, 4)), [])
                poses = np.tile(self.poses[::2], (3, 1, 1))
            elif split == "test":
                paths = sum((sorted(glob.glob(os.path.join(
                    self.root_dir, f"input_images/*{e}.jpg")))[1::2]
                    for e in (1, 3)), [])
                poses = np.tile(self.poses[1::2], (2, 1, 1))
            else:
                raise ValueError(f"split {split} is invalid for HDR-NeRF!")
        self.poses = poses
        return paths

    def read_meta(self, split):
        sparse = os.path.join(self.root_dir, "sparse/0")
        imdata = read_images_binary(os.path.join(sparse, "images.bin"))
        img_names = [imdata[k].name for k in imdata]
        if MIPNERF360_MARKER in self.root_dir and self.downsample < 1:
            folder = f"images_{int(1 / self.downsample)}"
        else:
            folder = "images"
        img_paths = [os.path.join(self.root_dir, folder, name)
                     for name in sorted(img_names)]
        poses = poses_from_colmap([imdata[k].qvec for k in imdata],
                                  [imdata[k].tvec for k in imdata],
                                  np.argsort(img_names))
        pts3d = read_points3d_binary(os.path.join(sparse, "points3D.bin"))
        self.poses, self.pts3d = normalize_colmap_poses(
            poses, np.array([pts3d[k].xyz for k in pts3d]))

        if split == "test_traj":   # spheric test poses, no images
            self.poses = create_spheric_poses(
                1.2, self.poses[:, 1, 3].mean()).astype(np.float32)
            return

        hdr = "HDR-NeRF" in self.root_dir
        if hdr:
            img_paths = self._hdr_split(split)
        else:   # every COLMAP_TEST_EVERY-th image is a test view
            if split == "train":
                keep = [i for i in range(len(img_paths))
                        if i % COLMAP_TEST_EVERY != 0]
            elif split == "test":
                keep = [i for i in range(len(img_paths))
                        if i % COLMAP_TEST_EVERY == 0]
            else:
                keep = list(range(len(img_paths)))
            img_paths = [img_paths[i] for i in keep]
            self.poses = self.poses[keep]

        scene = scene_name(self.root_dir)
        rays = []
        print(f"Loading {len(img_paths)} {split} images ...", flush=True)
        for img_path in img_paths:
            buf = [read_image(img_path, self.img_wh, blend_a=False)]
            if hdr:   # the exposure index is the file stem's last digit
                e = int(os.path.splitext(img_path)[0][-1])
                buf.append(HDR_EXPOSURES[scene][e]
                           * np.ones_like(buf[0][:, :1]))
            rays.append(np.concatenate(buf, 1))
        self.rays = np.stack(rays)
        self.poses = self.poses.astype(np.float32)
