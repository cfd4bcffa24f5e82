"""Minimal COLMAP sparse-reconstruction reader (binary + text), numpy and
``struct`` only.

A copy of ``mfnerf_tpu/datasets/colmap_utils.py`` for the port, which
imports nothing of the JAX package: the public COLMAP output format
(https://colmap.github.io/format.html), covering what the loaders need:
cameras.bin / images.bin / points3D.bin and their .txt fallbacks. The
eleven camera models and field layouts follow the published spec.
``rotmat2qvec`` serves the scene writer (``utils/procedural.py``).
"""
from __future__ import annotations

import collections
import struct

import numpy as np

CameraModel = collections.namedtuple(
    "CameraModel", ["model_id", "model_name", "num_params"])
Camera = collections.namedtuple(
    "Camera", ["id", "model", "width", "height", "params"])
BaseImage = collections.namedtuple(
    "Image", ["id", "qvec", "tvec", "camera_id", "name", "xys",
              "point3D_ids"])
Point3D = collections.namedtuple(
    "Point3D", ["id", "xyz", "rgb", "error", "image_ids", "point2D_idxs"])

_MODELS = [
    CameraModel(0, "SIMPLE_PINHOLE", 3),
    CameraModel(1, "PINHOLE", 4),
    CameraModel(2, "SIMPLE_RADIAL", 4),
    CameraModel(3, "RADIAL", 5),
    CameraModel(4, "OPENCV", 8),
    CameraModel(5, "OPENCV_FISHEYE", 8),
    CameraModel(6, "FULL_OPENCV", 12),
    CameraModel(7, "FOV", 5),
    CameraModel(8, "SIMPLE_RADIAL_FISHEYE", 4),
    CameraModel(9, "RADIAL_FISHEYE", 5),
    CameraModel(10, "THIN_PRISM_FISHEYE", 12),
]
CAMERA_MODEL_IDS = {m.model_id: m for m in _MODELS}
CAMERA_MODEL_NAMES = {m.model_name: m for m in _MODELS}


def qvec2rotmat(qvec):
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w,
         2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z,
         2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w,
         1 - 2 * x * x - 2 * y * y]])


def rotmat2qvec(R):
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz]]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


class Image(BaseImage):
    def qvec2rotmat(self):
        return qvec2rotmat(self.qvec)


def _read(fid, n_bytes, fmt):
    return struct.unpack("<" + fmt, fid.read(n_bytes))


def read_cameras_binary(path):
    cameras = {}
    with open(path, "rb") as fid:
        (n,) = _read(fid, 8, "Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(fid, 24, "iiQQ")
            model = CAMERA_MODEL_IDS[model_id]
            params = np.array(_read(fid, 8 * model.num_params,
                                    "d" * model.num_params))
            cameras[cam_id] = Camera(cam_id, model.model_name, width, height,
                                     params)
    return cameras


def read_images_binary(path):
    images = {}
    with open(path, "rb") as fid:
        (n,) = _read(fid, 8, "Q")
        for _ in range(n):
            img_id = _read(fid, 4, "i")[0]
            qvec = np.array(_read(fid, 32, "dddd"))
            tvec = np.array(_read(fid, 24, "ddd"))
            (cam_id,) = _read(fid, 4, "i")
            name = b""
            ch = fid.read(1)
            while ch != b"\x00":
                name += ch
                ch = fid.read(1)
            (n_pts,) = _read(fid, 8, "Q")
            data = _read(fid, 24 * n_pts, "ddq" * n_pts)
            xys = np.column_stack([data[0::3], data[1::3]])
            ids = np.array(data[2::3], dtype=np.int64)
            images[img_id] = Image(img_id, qvec, tvec, cam_id,
                                   name.decode("utf-8"), xys, ids)
    return images


def read_points3d_binary(path):
    points = {}
    with open(path, "rb") as fid:
        (n,) = _read(fid, 8, "Q")
        for _ in range(n):
            pid = _read(fid, 8, "q")[0]
            xyz = np.array(_read(fid, 24, "ddd"))
            rgb = np.array(_read(fid, 3, "BBB"))
            (err,) = _read(fid, 8, "d")
            (track_len,) = _read(fid, 8, "Q")
            data = _read(fid, 8 * track_len, "ii" * track_len)
            image_ids = np.array(data[0::2], dtype=np.int32)
            p2d = np.array(data[1::2], dtype=np.int32)
            points[pid] = Point3D(pid, xyz, rgb, err, image_ids, p2d)
    return points


def read_cameras_text(path):
    cameras = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id = int(parts[0])
            cameras[cam_id] = Camera(
                cam_id, parts[1], int(parts[2]), int(parts[3]),
                np.array([float(p) for p in parts[4:]]))
    return cameras


def read_images_text(path):
    images = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f
                 if ln.strip() and not ln.startswith("#")]
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        img_id = int(parts[0])
        qvec = np.array([float(p) for p in parts[1:5]])
        tvec = np.array([float(p) for p in parts[5:8]])
        cam_id = int(parts[8])
        name = parts[9]
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.array([[float(pts[j]), float(pts[j + 1])]
                        for j in range(0, len(pts), 3)])
        ids = np.array([int(pts[j + 2]) for j in range(0, len(pts), 3)],
                       dtype=np.int64)
        images[img_id] = Image(img_id, qvec, tvec, cam_id, name, xys, ids)
    return images


def read_points3d_text(path):
    points = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            pid = int(parts[0])
            xyz = np.array([float(p) for p in parts[1:4]])
            rgb = np.array([int(p) for p in parts[4:7]])
            err = float(parts[7])
            track = parts[8:]
            image_ids = np.array(track[0::2], dtype=np.int32)
            p2d = np.array(track[1::2], dtype=np.int32)
            points[pid] = Point3D(pid, xyz, rgb, err, image_ids, p2d)
    return points
