"""Procedural multi-view scene for tests and the chip smoke run (numpy).

Port of ``mfnerf_tpu/utils/procedural.py`` (``make_scene`` and its pose and
ground-truth render helpers), bit-identical to it: the same seed gives the
same poses, intrinsics, directions and images, so the port renders the same
cameras as the JAX package's ``bench.py``. Scenes are checker-textured
shaded spheres on a white background, seen from cameras on a ring of radius
1.5 around [-0.5, 0.5]^3, with the Blender/NSVF camera conventions
([right down front]).

``write_nsvf_scene``, ``write_blender_scene``, ``write_nerfpp_scene``,
``write_rtmv_scene``, ``write_colmap_scene`` and ``write_hdr_scene``
(HDR-NeRF's synthetic layout) put a scene on disk in the layouts of the
loaders (``datasets/``), with ``datasets/png.py`` as the PNG writer:
pixels are ``(img * 255).astype(uint8)``, as the JAX package writes them.
:func:`write_jpeg` is a numpy baseline JPEG encoder (Annex K tables) for
scenes in JPEG, as LLFF and mip-NeRF 360 ship them, and
:func:`encode_exr` a numpy OpenEXR encoder (NONE, RLE, ZIPS, ZIP and PIZ;
HALF and FLOAT) for RTMV's frames.
The JAX package has no Blender, COLMAP or HDR-NeRF writer.
:func:`perturb_poses` shifts training poses for the pose refinement
(``--optimize_ext``) to recover.
"""
import heapq
import json
import os
import struct
import zlib

import numpy as np

import torch

from ..datasets.color_utils import srgb_to_linear
from ..datasets.colmap_utils import rotmat2qvec
from ..datasets.conventions import (COLMAP_TEST_EVERY, HDR_EXPOSURES,
                                    scene_name)
from ..datasets.png import write_png
from ..datasets.ray_utils import axisangle_to_R, get_ray_directions


def _look_at_pose(position):
    """c2w with camera at `position` looking at the origin, [right down front]."""
    forward = -position / np.linalg.norm(position)          # +z: front
    up_world = np.array([0.0, 0.0, 1.0])
    if abs(forward @ up_world) > 0.99:
        up_world = np.array([0.0, 1.0, 0.0])
    right = np.cross(-up_world, forward)
    right /= np.linalg.norm(right)
    down = np.cross(forward, right)
    c2w = np.stack([right, down, forward, position], axis=1)
    return c2w.astype(np.float32)


# a small fixed multi-sphere arrangement: one big textured sphere + satellites
_SPHERES = [
    ((0.0, 0.0, 0.0), 0.30, 0),
    ((0.28, 0.18, -0.10), 0.12, 1),
    ((-0.25, -0.05, 0.22), 0.10, 2),
    ((0.05, -0.30, -0.18), 0.08, 3),
    ((-0.12, 0.28, 0.05), 0.07, 4),
]

# thin-structure variant (``thin=True``): finite rods of radius ~0.01 — at
# scene scale 0.5 that is ~1.3 occupancy cells / ~2.6 fine-feature cells at a
# 512-per-axis finest level. Sub-voxel geometry like this (Lego rails/grille)
# is exactly the content multiresolution hash grids were designed for, so it
# is the quality-discriminating fixture for LowRank-vs-Hash head-to-heads.
_RODS = [
    # (p0, p1, radius, mat): a tilted tripod + two crossbars around the
    # central sphere, all inside [-0.45, 0.45]^3
    ((-0.42, -0.40, -0.35), (0.40, 0.42, 0.38), 0.012, 1),
    ((0.42, -0.38, -0.30), (-0.38, 0.40, 0.35), 0.010, 2),
    ((-0.40, 0.42, -0.32), (0.38, -0.36, 0.40), 0.011, 3),
    ((-0.44, 0.05, 0.38), (0.44, -0.02, 0.34), 0.009, 4),
    ((0.02, -0.44, 0.36), (-0.05, 0.44, 0.32), 0.009, 0),
]


def _ray_rod_hits(rays_o, d, p0, p1, rad):
    """Finite-cylinder intersection: (hit mask, t, unit normal at hit)."""
    p0 = np.asarray(p0, np.float32)
    axis = np.asarray(p1, np.float32) - p0
    length = np.linalg.norm(axis)
    a = axis / length
    m = rays_o - p0
    dp = d - (d @ a)[:, None] * a
    mp = m - (m @ a)[:, None] * a
    A = (dp * dp).sum(-1)
    b = (dp * mp).sum(-1)
    c = (mp * mp).sum(-1) - rad ** 2
    disc = b * b - A * c
    ok = (disc > 0) & (A > 1e-12)
    t = (-b - np.sqrt(np.maximum(disc, 0.0))) / np.maximum(A, 1e-12)
    s = ((m + t[:, None] * d) @ a)
    ok &= (t > 0) & (s > 0) & (s < length)
    p = rays_o + t[:, None] * d
    n = p - (p0 + s[:, None] * a)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
    return ok, t, n, s / length


def _render_gt(rays_o, rays_d, radius=None, center=None, spread=1.0,
               bg=1.0, thin=False):
    """Analytic render: checker-textured shaded spheres on ``bg`` background.

    Deliberately non-trivial (multiple objects, occlusion, high-frequency
    texture) so reconstruction PSNR discriminates encoder quality.
    """
    d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    n_rays = rays_o.shape[0]
    best_t = np.full(n_rays, np.inf, np.float32)
    img = np.full_like(rays_o, bg)
    if radius is not None:  # legacy single-sphere mode
        spheres = [(tuple(center or (0.0, 0.0, 0.0)), radius, 0)]
    else:
        spheres = _SPHERES
    if spread != 1.0:
        spheres = [(tuple(spread * x for x in ctr), spread * rad, mat)
                   for ctr, rad, mat in spheres]
    for ctr, rad, mat in spheres:
        ctr = np.asarray(ctr, np.float32)
        co = rays_o - ctr
        b = (d * co).sum(-1)
        c = (co * co).sum(-1) - rad ** 2
        disc = b * b - c
        hit = disc > 0
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        hit &= (t > 0) & (t < best_t)
        p = rays_o[hit] + t[hit, None] * d[hit]
        n = (p - ctr) / rad
        shade = np.clip(n @ np.array([0.3, -0.5, 0.8]), 0.05, 1.0)[:, None]
        # checker texture in spherical coords (high-frequency detail)
        theta = np.arctan2(n[:, 1], n[:, 0])
        phi = np.arccos(np.clip(n[:, 2], -1, 1))
        checker = ((np.floor(theta * (8 + 4 * mat) / np.pi)
                    + np.floor(phi * (8 + 4 * mat) / np.pi)) % 2)[:, None]
        base = np.asarray([
            [0.9, 0.3, 0.2], [0.2, 0.7, 0.9], [0.9, 0.8, 0.2],
            [0.4, 0.9, 0.3], [0.8, 0.4, 0.9]], np.float32)[mat]
        color = (0.35 + 0.65 * checker) * base * (0.4 + 0.6 * shade)
        img[hit] = np.clip(color, 0, 1)
        best_t[hit] = t[hit]
    if thin:
        base_colors = np.asarray([
            [0.9, 0.3, 0.2], [0.2, 0.7, 0.9], [0.9, 0.8, 0.2],
            [0.4, 0.9, 0.3], [0.8, 0.4, 0.9]], np.float32)
        rods = _RODS
        if spread != 1.0:
            rods = [(tuple(spread * x for x in p0),
                     tuple(spread * x for x in p1), spread * rad, mat)
                    for p0, p1, rad, mat in rods]
        for p0, p1, rad, mat in rods:
            ok, t, n, frac = _ray_rod_hits(rays_o, d, p0, p1, rad)
            ok &= t < best_t
            shade = np.clip(n[ok] @ np.array([0.3, -0.5, 0.8]),
                            0.05, 1.0)[:, None]
            # fine stripes along the rod (high-frequency on a thin body)
            stripe = (np.floor(frac[ok] * 40.0) % 2)[:, None]
            color = (0.35 + 0.65 * stripe) * base_colors[mat] \
                * (0.4 + 0.6 * shade)
            img[ok] = np.clip(color, 0, 1)
            best_t[ok] = t[ok]
    return img.astype(np.float32)


def make_scene(n_train=20, n_test=2, wh=64, cam_radius=1.5, fov_scale=1.0,
               sphere_radius=0.35, seed=0, spread=1.0, thin=False):
    """Build an in-memory dataset dict for training/eval.

    ``spread`` scales the sphere arrangement and camera ring uniformly —
    spread > 1 produces content outside [-0.5, 0.5]^3 for exercising the
    multi-cascade (scale > 0.5, exponential-dt) marching paths the real
    large-scale datasets (TaT / mip-NeRF-360 / NeRF++) need. Spread scenes
    render on a BLACK background to match the real-scene rendering
    convention (exp_step_factor != 0 composites onto black,
    models/rendering.py) — a white background would force the field to
    fabricate a luminous far shell the real datasets don't have.

    ``thin=True`` adds striped rods of radius ~0.01 (sub-voxel thin
    structure, the hash-grid-favorable content class) to the multi-sphere
    arrangement — the LowRank-vs-Hash quality fixture.

    Returns dict(poses, test_poses, K, directions, images (N, wh*wh, 3),
    test_images, img_wh).
    """
    rng = np.random.default_rng(seed)
    if spread != 1.0:
        cam_radius = cam_radius * spread
        sphere_radius = None  # multi-sphere arrangement, scaled by spread
    if thin:
        sphere_radius = None  # rods join the multi-sphere arrangement
    f = wh * fov_scale  # ~53 deg fov
    K = np.float32([[f, 0, wh / 2], [0, f, wh / 2], [0, 0, 1]])
    directions = get_ray_directions(wh, wh, K)

    def sample_poses(n, offset=0.0):
        poses = []
        for i in range(n):
            theta = 2 * np.pi * (i + offset) / n
            phi = np.deg2rad(25 + 25 * rng.random())
            pos = cam_radius * np.array([
                np.cos(theta) * np.cos(phi),
                np.sin(theta) * np.cos(phi),
                np.sin(phi)], dtype=np.float32)
            poses.append(_look_at_pose(pos))
        return np.stack(poses)

    poses = sample_poses(n_train)
    test_poses = sample_poses(n_test, offset=0.37)

    def render_all(pose_set):
        imgs = []
        for c2w in pose_set:
            rays_d = directions @ c2w[:, :3].T
            rays_o = np.broadcast_to(c2w[:, 3], rays_d.shape)
            imgs.append(_render_gt(rays_o, rays_d, sphere_radius,
                                   spread=spread,
                                   bg=0.0 if spread != 1.0 else 1.0,
                                   thin=thin))
        return np.stack(imgs)

    return {
        "poses": poses, "test_poses": test_poses, "K": K,
        "directions": directions, "images": render_all(poses),
        "test_images": render_all(test_poses), "img_wh": (wh, wh),
    }



def _to_uint8(img, wh):
    w, h = wh
    return (img.reshape(h, w, 3) * 255).astype(np.uint8)


def write_nsvf_scene(root, scene=None, **kwargs):
    """Write a procedural scene (``make_scene(**kwargs)`` unless given) in
    the NSVF layout: bbox.txt, intrinsics.txt, rgb/{0_,2_}NNNN.png and
    pose/{0_,2_}NNNN.txt, as ``mfnerf_tpu.utils.procedural.write_nsvf_scene``
    writes it. Returns the scene."""
    scene = scene or make_scene(**kwargs)
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "pose"), exist_ok=True)
    w, h = scene["img_wh"]
    # the scene fits inside the sphere bbox; NSVF shifts/scales it to
    # [-.5,.5]
    np.savetxt(os.path.join(root, "bbox.txt"),
               np.array([[-0.5, -0.5, -0.5, 0.5, 0.5, 0.5, 0.01]]))
    with open(os.path.join(root, "intrinsics.txt"), "w") as f:
        fx = scene["K"][0, 0]
        f.write(f"{fx} 0 {w / 2} 0\n0 {fx} {h / 2} 0\n0 0 1 0\n0 0 0 1\n")
    for prefix, poses, images in (("0_", scene["poses"], scene["images"]),
                                  ("2_", scene["test_poses"],
                                   scene["test_images"])):
        for i, (pose, img) in enumerate(zip(poses, images)):
            write_png(os.path.join(root, "rgb", f"{prefix}{i:04d}.png"),
                      _to_uint8(img, (w, h)))
            mat = np.eye(4)
            mat[:3] = pose
            np.savetxt(os.path.join(root, "pose", f"{prefix}{i:04d}.txt"),
                       mat)
    return scene


def write_blender_scene(root, scene=None, **kwargs):
    """Write a procedural scene (``make_scene(**kwargs)`` unless given) in
    the Blender layout: transforms_{train,test}.json with {train,test}/
    rNNN.png. Poses are stored [right up back] as 4x4 ``transform_matrix``;
    ``camera_angle_x`` is the scene's field of view, so the loader's
    ``downsample`` = W / 800 gives back the scene's intrinsics. Returns the
    scene."""
    scene = scene or make_scene(**kwargs)
    w, h = scene["img_wh"]
    angle_x = 2 * np.arctan(0.5 * w / float(scene["K"][0, 0]))
    for split, poses, images in (("train", scene["poses"], scene["images"]),
                                 ("test", scene["test_poses"],
                                  scene["test_images"])):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for i, (pose, img) in enumerate(zip(poses, images)):
            write_png(os.path.join(root, split, f"r_{i:03d}.png"),
                      _to_uint8(img, (w, h)))
            mat = np.eye(4)
            mat[:3] = pose
            mat[:3, 1:3] *= -1                    # rdf -> rub
            frames.append({"file_path": f"./{split}/r_{i:03d}",
                           "transform_matrix": mat.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": float(angle_x), "frames": frames},
                      f)
    return scene


COLMAP_POINTS = 256     # write_colmap_scene's sparse point cloud


def _pose44(pose):
    mat = np.eye(4)
    mat[:3] = pose
    return mat


def write_nerfpp_scene(root, scene=None, **kwargs):
    """Write a procedural scene in the NeRF++ layout:
    {train,test}/{intrinsics,rgb,pose}/NNNNN.txt|png and the test poses as
    the camera_path/pose/ trajectory, as
    ``mfnerf_tpu.utils.procedural.write_nerfpp_scene`` writes it. Returns
    the scene."""
    scene = scene or make_scene(**kwargs)
    k44 = np.eye(4)
    k44[:3, :3] = scene["K"]
    for split, poses, images in (("train", scene["poses"], scene["images"]),
                                 ("test", scene["test_poses"],
                                  scene["test_images"])):
        for sub in ("intrinsics", "rgb", "pose"):
            os.makedirs(os.path.join(root, split, sub), exist_ok=True)
        for i, (pose, img) in enumerate(zip(poses, images)):
            np.savetxt(os.path.join(root, split, "intrinsics",
                                    f"{i:05d}.txt"), k44.reshape(-1))
            np.savetxt(os.path.join(root, split, "pose", f"{i:05d}.txt"),
                       _pose44(pose).reshape(-1))
            write_png(os.path.join(root, split, "rgb", f"{i:05d}.png"),
                      _to_uint8(img, scene["img_wh"]))
    os.makedirs(os.path.join(root, "camera_path", "pose"), exist_ok=True)
    for i, pose in enumerate(scene["test_poses"]):
        np.savetxt(os.path.join(root, "camera_path", "pose", f"{i:05d}.txt"),
                   _pose44(pose).reshape(-1))
    return scene


def write_rtmv_scene(root, scene=None, n_frames=110, image_format="png",
                     compression="zip", **kwargs):
    """Write a procedural scene in the RTMV layout: images/NNNNN.png and a
    NNNNN.json a frame whose camera_data holds the intrinsics, a unit scene
    box and ``cam2world`` transposed in [right up back] axes, as
    ``mfnerf_tpu.utils.procedural.write_rtmv_scene`` writes it. RTMV splits
    are index ranges (train 0-100, test 105-150), so ``n_frames`` frames
    cycle through the scene's training views. With ``image_format="exr"``
    the frames are NNNNN.exr beside the jsons, as RTMV publishes them:
    linear light (``srgb_to_linear`` of the PNG's pixels) in HALF RGBA with
    alpha 1, under ``compression`` (:func:`encode_exr`); the RTMV
    preparation (``misc/prepare_rtmv.py``) turns them into images/.
    Returns the scene."""
    if image_format not in ("png", "exr"):
        raise ValueError(f"image_format {image_format!r}: png or exr")
    scene = scene or make_scene(**kwargs)
    os.makedirs(os.path.join(root, "images") if image_format == "png"
                else root, exist_ok=True)
    w, h = scene["img_wh"]
    k = scene["K"]
    n_cycle = len(scene["poses"])
    for i in range(n_frames):
        rub = np.asarray(scene["poses"][i % n_cycle], np.float64).copy()
        rub[:, 1:3] *= -1.0
        meta = {"camera_data": {
            "width": w, "height": h,
            "intrinsics": {"fx": float(k[0, 0]), "fy": float(k[1, 1]),
                           "cx": float(k[0, 2]), "cy": float(k[1, 2])},
            "scene_center_3d_box": [0.0, 0.0, 0.0],
            "scene_min_3d_box": [-0.5, -0.5, -0.5],
            "scene_max_3d_box": [0.5, 0.5, 0.5],
            "cam2world": _pose44(rub).T.tolist(),
        }}
        with open(os.path.join(root, f"{i:05d}.json"), "w") as f:
            json.dump(meta, f)
        pixels = _to_uint8(scene["images"][i % n_cycle], (w, h))
        if image_format == "png":
            write_png(os.path.join(root, "images", f"{i:05d}.png"), pixels)
            continue
        linear = srgb_to_linear(pixels.astype(np.float32) / 255)
        rgba = np.concatenate([linear, np.ones((h, w, 1), np.float32)], -1)
        write_exr(os.path.join(root, f"{i:05d}.exr"), rgba, compression)
    return scene


def write_colmap_scene(root, scene=None, spread=1.0, image_format="png",
                       **kwargs):
    """Write a procedural scene (``make_scene(spread=spread, **kwargs)``
    unless given) as a COLMAP reconstruction: sparse/0/cameras.bin (one
    PINHOLE camera), images.bin (each view's world-to-camera quaternion and
    translation, no 2D points) and points3D.bin (COLMAP_POINTS seeded
    points on the sphere arrangement scaled by ``spread``, which the loader
    centres the poses on), with the views as images/im_NNN.png, or with
    ``image_format="jpg"`` as images/im_NNN.jpg (:func:`write_jpeg`,
    quality 95, 4:2:0, as real scenes ship). The test
    views take every ``COLMAP_TEST_EVERY``-th index, where the loader's
    test split reads them, so the scene needs ceil((n_train + n_test) / 8)
    test views.
    Returns the scene."""
    scene = scene or make_scene(spread=spread, **kwargs)
    n_train, n_test = len(scene["poses"]), len(scene["test_poses"])
    n = n_train + n_test
    if n_test != -(-n // COLMAP_TEST_EVERY):
        raise ValueError(f"{n_train} train and {n_test} test views: the "
                         f"COLMAP split reads every {COLMAP_TEST_EVERY}th "
                         f"of {n} views as a test view")
    train, test = iter(range(n_train)), iter(range(n_test))
    views = [("test_", next(test)) if i % COLMAP_TEST_EVERY == 0
             else ("", next(train)) for i in range(n)]
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    writer = {"png": write_png, "jpg": write_jpeg}[image_format]
    for i, (split, j) in enumerate(views):
        writer(os.path.join(root, "images", f"im_{i:03d}.{image_format}"),
               _to_uint8(scene[split + "images"][j], scene["img_wh"]))
    _write_colmap_model(root, scene, [scene[split + "poses"][j]
                                      for split, j in views], spread,
                        image_format)
    return scene


def _write_colmap_model(root, scene, poses, spread, image_format="png"):
    """sparse/0 of a COLMAP reconstruction: one PINHOLE camera (the scene's
    intrinsics), an image a pose named im_NNN.<image_format> in that order,
    and COLMAP_POINTS points on the sphere arrangement scaled by
    ``spread``."""
    w, h = scene["img_wh"]
    k = scene["K"]
    os.makedirs(os.path.join(root, "sparse/0"), exist_ok=True)
    with open(os.path.join(root, "sparse/0/cameras.bin"), "wb") as f:
        f.write(struct.pack("<QiiQQ", 1, 1, 1, w, h))        # PINHOLE
        f.write(struct.pack("<dddd", k[0, 0], k[1, 1], k[0, 2], k[1, 2]))
    with open(os.path.join(root, "sparse/0/images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(poses)))
        for i, pose in enumerate(poses):
            c2w = np.asarray(pose, np.float64)
            r_w2c = c2w[:, :3].T
            f.write(struct.pack("<i", i + 1))
            f.write(struct.pack("<dddd", *rotmat2qvec(r_w2c)))
            f.write(struct.pack("<ddd", *(-r_w2c @ c2w[:, 3])))
            name = f"im_{i:03d}.{image_format}"
            f.write(struct.pack("<i", 1) + name.encode() + b"\x00")
            f.write(struct.pack("<Q", 0))
    rng = np.random.default_rng(0)
    idx = rng.integers(0, len(_SPHERES), COLMAP_POINTS)
    normal = rng.normal(size=(COLMAP_POINTS, 3))
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    centers = np.float64([_SPHERES[i][0] for i in idx])
    radii = np.float64([_SPHERES[i][1] for i in idx])[:, None]
    pts = spread * (centers + radii * normal)
    with open(os.path.join(root, "sparse/0/points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", COLMAP_POINTS))
        for i, p in enumerate(pts):
            f.write(struct.pack("<q", i) + struct.pack("<ddd", *p))
            f.write(struct.pack("<BBBdQ", 128, 128, 128, 0.5, 0))


# HDR-NeRF's synthetic scenes: 18 train poses shot at exposures 0, 2 and 4
# of the scene's table, 17 test poses at 1 and 3
# (mfnerf_tpu/datasets/colmap.py's HDR split)
HDR_TRAIN, HDR_TEST = (18, (0, 2, 4)), (17, (1, 3))


def write_hdr_scene(root, scene=None, spread=1.0, **kwargs):
    """Write a procedural scene (``make_scene(n_train=18, n_test=17,
    spread=spread, **kwargs)`` unless given) in HDR-NeRF's synthetic layout,
    which the COLMAP loader reads from a ``HDR-NeRF/syndata/<scene>`` root:
    sparse/0 (as :func:`write_colmap_scene`; the 17 test poses first, then
    the 18 train poses, by image name) and each pose's views observed at
    exposure e as ``clip(e * image, 0, 1)``: train/NNN_E.png at the
    exposures 0, 2, 4 of ``HDR_EXPOSURES[<scene>]`` and test/NNN_E.png at 1
    and 3. ``luckycat`` trains at 2, 0.5 and 0.125 and tests at 1 and
    0.25. Returns the scene."""
    parts = os.path.normpath(root).split(os.sep)
    if "HDR-NeRF" not in parts or "syndata" not in parts:
        raise ValueError(f"{root}: the loader reads HDR-NeRF's synthetic "
                         f"layout under HDR-NeRF/syndata/<scene>")
    table = HDR_EXPOSURES[scene_name(root)]
    scene = scene or make_scene(n_train=HDR_TRAIN[0], n_test=HDR_TEST[0],
                                spread=spread, **kwargs)
    if (len(scene["poses"]), len(scene["test_poses"])) != (HDR_TRAIN[0],
                                                           HDR_TEST[0]):
        raise ValueError("HDR-NeRF's synthetic scenes have 18 train and 17 "
                         "test poses")
    for split, (_, exps), images in (
            ("train", HDR_TRAIN, scene["images"]),
            ("test", HDR_TEST, scene["test_images"])):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        for i, img in enumerate(images):
            for e in exps:
                write_png(os.path.join(root, split, f"{i:03d}_{e}.png"),
                          _to_uint8(np.clip(np.float32(table[e]) * img, 0, 1),
                                    scene["img_wh"]))
    _write_colmap_model(root, scene, [*scene["test_poses"], *scene["poses"]],
                        spread)
    return scene


def perturb_poses(poses, sigma=0.03, seed=0):
    """Training poses shifted as the JAX package's pose-refinement test
    shifts them: per pose an axis-angle dr and a translation dt, each
    N(0, sigma^2) a component (one numpy generator of ``seed``, dr first),
    applied as ``R(dr) @ pose[:, :3]`` and ``pose[:, 3] + dt``. Returns
    (perturbed poses, dr, dt)."""
    rng = np.random.default_rng(seed)
    dr = (sigma * rng.normal(size=(len(poses), 3))).astype(np.float32)
    dt = (sigma * rng.normal(size=(len(poses), 3))).astype(np.float32)
    out = np.array(poses, np.float32)
    out[..., :3] = axisangle_to_R(torch.from_numpy(dr)).numpy() @ out[..., :3]
    out[..., 3] += dt
    return out, dr, dt


def gauge_center_error(centers, true_centers):
    """The mean distance of camera centres (N, 3) from the true ones after
    the mean offset is removed: a global translation of every camera (with
    the scene) is not observable under a NeRF loss."""
    d = np.asarray(centers, np.float64) - np.asarray(true_centers,
                                                     np.float64)
    return float(np.linalg.norm(d - d.mean(axis=0), axis=1).mean())


# ---------------------------------------------------------------- JPEG writer
# A baseline encoder for test scenes: the machine that runs the port has no
# PIL. ITU-T T.81 Annex K's quantization tables (natural order, scaled by
# quality as libjpeg's jpeg_quality_scaling) and Huffman tables.
JPEG_LUMA_Q = np.int64([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
JPEG_CHROMA_Q = np.int64([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32)
_AC_SYMBOLS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a92"
    "939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8"
    "c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")
_AC_CHROMA_SYMBOLS = bytes.fromhex(
    "00010203110405213106124151076171132232810814429"
    "1a1b1c109233352f0156272d10a162434e125f11718191a262728292a35363738"
    "393a434445464748494a535455565758595a636465666768696a737475767778"
    "797a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4"
    "b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9"
    "eaf2f3f4f5f6f7f8f9fa")
# (counts of codes of length 1..16, symbols): DC and AC, luma and chroma
JPEG_HUFFMAN = {
    ("dc", 0): ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
                bytes(range(12))),
    ("dc", 1): ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
                bytes(range(12))),
    ("ac", 0): ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D),
                _AC_SYMBOLS),
    ("ac", 1): ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77),
                _AC_CHROMA_SYMBOLS),
}
# zigzag index -> natural index
JPEG_ZIGZAG = np.int64([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])


def jpeg_quant_tables(quality):
    """The Annex K tables scaled to ``quality`` (1-100) as libjpeg scales
    them, clamped to [1, 255]: (luma, chroma), natural order."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return tuple(np.clip((q * scale + 50) // 100, 1, 255)
                 for q in (JPEG_LUMA_Q, JPEG_CHROMA_Q))


def _huffman_codes(counts, symbols):
    """(code, length) a symbol (256 entries each) of a canonical table."""
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            code_of[symbols[k]], len_of[symbols[k]] = code, length
            code, k = code + 1, k + 1
        code <<= 1
    return code_of, len_of


def _magnitude(v):
    """(category, bits) of JPEG's magnitude coding of integers ``v``."""
    a = np.abs(v)
    cat = (a[..., None] >= (1 << np.arange(16))).sum(-1)
    return cat, np.where(v < 0, v + (1 << cat) - 1, v)


def _dct_matrix():
    x = np.arange(8)
    c = np.cos((2 * x[None, :] + 1) * x[:, None] * np.pi / 16)
    c[0] *= np.sqrt(0.5)
    return c * 0.5      # orthonormal: JPEG's 1/4 C(u) C(v) in 2-D


def _jpeg_blocks(plane, q):
    """(by, bx) blocks of a (8 by, 8 bx) float plane: level-shifted,
    transformed and quantized, as (by * bx, 64) zigzag-ordered ints."""
    hb, wb = plane.shape[0] // 8, plane.shape[1] // 8
    b = (plane - 128.0).reshape(hb, 8, wb, 8).transpose(0, 2, 1, 3)
    c = _dct_matrix()
    f = c @ b @ c.T
    out = np.rint(f.reshape(hb, wb, 64) / q).astype(np.int64)
    return out[..., JPEG_ZIGZAG]


def _entropy_code(coefs, table, comp):
    """Baseline Huffman data of ``coefs`` (N, 64) zigzag ints in scan
    order, with Huffman tables ``table`` (0 luma, 1 chroma) and DC chain
    ``comp`` a block: the packed, byte-stuffed bytes."""
    n = len(coefs)
    dc = coefs[:, 0].copy()
    pred = np.zeros(n, np.int64)
    for c in np.unique(comp):       # each component's own DC chain
        idx = np.flatnonzero(comp == c)
        pred[idx[1:]] = dc[idx[:-1]]
    keys, vals, lens = [], [], []
    codes = {k: _huffman_codes(*v) for k, v in JPEG_HUFFMAN.items()}

    def huff(kind, sym, tab):
        code = np.where(tab == 0, codes[(kind, 0)][0][sym],
                        codes[(kind, 1)][0][sym])
        length = np.where(tab == 0, codes[(kind, 0)][1][sym],
                          codes[(kind, 1)][1][sym])
        return code, length

    cat, bits = _magnitude(dc - pred)
    code, length = huff("dc", cat, table)
    keys.append(np.arange(n) * 65 * 17)
    vals.append((code << cat) | bits)
    lens.append(length + cat)
    blk, pos = np.nonzero(coefs[:, 1:])
    pos = pos + 1
    prev = np.zeros_like(pos)       # the block's previous nonzero
    prev[1:] = np.where(blk[1:] == blk[:-1], pos[:-1], 0)
    run = pos - prev - 1
    zrl = run // 16
    tab = table[blk]
    zcode, zlen = huff("ac", np.full(len(blk), 0xF0), tab)
    for j in range(int(zrl.max()) if len(zrl) else 0):
        m = zrl > j
        keys.append(blk[m] * 65 * 17 + pos[m] * 17 + j)
        vals.append(zcode[m])
        lens.append(zlen[m])
    cat, bits = _magnitude(coefs[blk, pos])
    code, length = huff("ac", ((run % 16) << 4) | cat, tab)
    keys.append(blk * 65 * 17 + pos * 17 + 16)
    vals.append((code << cat) | bits)
    lens.append(length + cat)
    last = np.zeros(n, np.int64)
    last[blk] = pos
    eob = np.flatnonzero(last < 63)
    code, length = huff("ac", np.zeros(len(eob), np.int64), table[eob])
    keys.append(eob * 65 * 17 + 64 * 17)
    vals.append(code)
    lens.append(length)
    order = np.argsort(np.concatenate(keys), kind="stable")
    vals = np.concatenate(vals)[order]
    lens = np.concatenate(lens)[order]
    total = int(lens.sum())
    starts = np.cumsum(lens) - lens
    item = np.repeat(np.arange(len(lens)), lens)
    shift = lens[item] - 1 - (np.arange(total) - starts[item])
    stream = ((vals[item] >> shift) & 1).astype(np.uint8)
    stream = np.concatenate([stream, np.ones(-total % 8, np.uint8)])
    data = np.packbits(stream)
    ff = np.flatnonzero(data == 0xFF)
    return np.insert(data, ff + 1, 0).tobytes()


def _segment(marker, payload):
    return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) \
        + payload


def encode_jpeg(img, quality=95, sampling=(2, 2)):
    """Baseline JPEG bytes of uint8 ``img`` (H, W, 3) or (H, W): JFIF,
    YCbCr with the luma sampled ``sampling`` = (h, v) times the chroma
    ((2, 2) 4:2:0, (2, 1) 4:2:2, (1, 2) 4:4:0, (1, 1) 4:4:4), the Annex K
    tables at ``quality``. Edges are replicated to whole MCUs and the chroma
    is the mean of each h x v cell."""
    img = np.asarray(img, np.uint8)
    gray = img.ndim == 2
    h_img, w_img = img.shape[:2]
    hs, vs = (1, 1) if gray else sampling
    mw, mh = -(-w_img // (8 * hs)), -(-h_img // (8 * vs))
    x = np.pad(img.astype(np.float64),
               [(0, mh * 8 * vs - h_img), (0, mw * 8 * hs - w_img)]
               + [(0, 0)] * (img.ndim - 2), mode="edge")
    q_luma, q_chroma = jpeg_quant_tables(quality)
    if gray:
        coefs = _jpeg_blocks(x, q_luma).reshape(-1, 64)
        blocks = (coefs, np.zeros(len(coefs), np.int64),
                  np.zeros(len(coefs), np.int64))
    else:
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        y = 0.299 * r + 0.587 * g + 0.114 * b
        cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128
        cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128
        cb, cr = (p.reshape(mh * 8, vs, mw * 8, hs).mean(axis=(1, 3))
                  for p in (cb, cr))
        # MCU order: luma's vs x hs blocks, then one Cb and one Cr block
        yb = _jpeg_blocks(y, q_luma).reshape(mh, vs, mw, hs, 64
                                             ).transpose(0, 2, 1, 3, 4
                                                         ).reshape(mh, mw, -1,
                                                                   64)
        cbb = _jpeg_blocks(cb, q_chroma)[:, :, None]
        crb = _jpeg_blocks(cr, q_chroma)[:, :, None]
        coefs = np.concatenate([yb, cbb, crb], axis=2).reshape(-1, 64)
        per_mcu = np.int64([0] * (hs * vs) + [1, 2])
        comp = np.tile(per_mcu, mh * mw)
        blocks = (coefs, np.minimum(comp, 1), comp)
    out = [b"\xff\xd8", _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00"
                                 b"\x01\x00\x00")]
    tables = [q_luma] if gray else [q_luma, q_chroma]
    out.append(_segment(0xDB, b"".join(
        bytes([i]) + bytes(q[JPEG_ZIGZAG].astype(np.uint8))
        for i, q in enumerate(tables))))
    comps = [(1, 1, 1, 0)] if gray else [(1, hs, vs, 0), (2, 1, 1, 1),
                                         (3, 1, 1, 1)]
    out.append(_segment(0xC0, struct.pack(">BHHB", 8, h_img, w_img,
                                          len(comps)) + b"".join(
        bytes([cid, (h << 4) | v, t]) for cid, h, v, t in comps)))
    for (kind, i), (counts, symbols) in JPEG_HUFFMAN.items():
        if gray and i:
            continue
        out.append(_segment(0xC4, bytes([(kind == "ac") << 4 | i])
                            + bytes(counts) + symbols))
    out.append(_segment(0xDA, bytes([len(comps)]) + b"".join(
        bytes([cid, (t << 4) | t]) for cid, _, _, t in comps)
        + b"\x00\x3f\x00"))
    out.append(_entropy_code(*blocks))
    out.append(b"\xff\xd9")
    return b"".join(out)


def write_jpeg(path, img, quality=95, sampling=(2, 2)):
    """Write :func:`encode_jpeg` of ``img`` to ``path``."""
    with open(path, "wb") as f:
        f.write(encode_jpeg(img, quality, sampling))


# ------------------------------------------------------------------ OpenEXR
# The OpenEXR File Layout document's header, offset table and chunks, and
# the codecs as the OpenEXR library's ImfRle, ImfZip, ImfPizCompressor,
# ImfHuf and ImfWav write them (test tooling: datasets/exr.py reads them).
EXR_COMPRESSION = {"none": 0, "rle": 1, "zips": 2, "zip": 3, "piz": 4}
EXR_LINES = {"none": 1, "rle": 1, "zips": 1, "zip": 16, "piz": 32}
EXR_PIXEL_TYPE = {"half": (1, "<f2"), "float": (2, "<f4")}
EXR_LINE_ORDER = {"increasing": 0, "decreasing": 1}
EXR_ZIP_LEVEL = 4           # the OpenEXR library's default zlib level


def _exr_attr(name, kind, value):
    return (name.encode() + b"\0" + kind.encode() + b"\0"
            + struct.pack("<i", len(value)) + value)


def _exr_header(width, height, channels, compression, line_order=0):
    """Magic, version 2 and a scanline header: ``channels`` [(name, pixel
    type)] sorted by name, the data and display windows (0, 0) - (width -
    1, height - 1), ``compression`` and ``line_order`` as the format's
    numbers."""
    chlist = b"".join(name.encode() + b"\0" + struct.pack("<iB3xii", kind, 0,
                                                          1, 1)
                      for name, kind in channels) + b"\0"
    box = struct.pack("<4i", 0, 0, width - 1, height - 1)
    return b"".join([
        b"v/1\x01", struct.pack("<I", 2),
        _exr_attr("channels", "chlist", chlist),
        _exr_attr("compression", "compression", bytes([compression])),
        _exr_attr("dataWindow", "box2i", box),
        _exr_attr("displayWindow", "box2i", box),
        _exr_attr("lineOrder", "lineOrder", bytes([line_order])),
        _exr_attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
        _exr_attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0)),
        _exr_attr("screenWindowWidth", "float", struct.pack("<f", 1.0)),
        b"\0"])


def _exr_predict(raw):
    """ImfZip / ImfRleCompressor: the even bytes then the odd ones, each
    byte minus its predecessor plus 128."""
    b = np.frombuffer(raw, np.uint8)
    t = np.concatenate([b[0::2], b[1::2]])
    d = t.copy()
    d[1:] = t[1:] - t[:-1] + 128
    return d


def _exr_rle(data):
    """Runs of three or more equal bytes as (count - 1, byte), up to 128;
    the bytes between them as (-count, bytes), up to 127."""
    out = bytearray()
    n = len(data)
    starts = np.flatnonzero(np.concatenate([[True], data[1:] != data[:-1]]))
    lengths = np.diff(np.append(starts, n))

    def literal(a, b):
        for i in range(a, b, 127):
            k = min(127, b - i)
            out.append(256 - k)
            out.extend(data[i:i + k].tobytes())

    pos = 0
    for start, length in zip(starts[lengths >= 3], lengths[lengths >= 3]):
        literal(pos, start)
        for k in range(length, 0, -128):
            out.extend((min(k, 128) - 1, int(data[start])))
        pos = start + length
    literal(pos, n)
    return bytes(out)


def _msb_bits(values, nbits):
    """The fields ``values`` of ``nbits`` bits each, most significant bit
    first, packed into bytes (the last one padded with zeros): (bytes,
    bit count)."""
    values = np.asarray(values, np.uint64)
    nbits = np.asarray(nbits, np.int64)
    total = int(nbits.sum())
    field = np.repeat(np.arange(len(values)), nbits)
    pos = np.arange(total) - np.repeat(np.cumsum(nbits) - nbits, nbits)
    shift = (nbits[field] - 1 - pos).astype(np.uint64)
    bits = (values[field] >> shift) & np.uint64(1)
    return np.packbits(bits.astype(np.uint8)).tobytes(), total


def _huf_lengths(freq):
    """Huffman code lengths of the symbols with a non-zero ``freq``."""
    syms = np.flatnonzero(freq)
    heap = [(int(freq[s]), i) for i, s in enumerate(syms)]
    heapq.heapify(heap)
    parent = list(range(len(syms)))
    while len(heap) > 1:
        (f1, a), (f2, b) = heapq.heappop(heap), heapq.heappop(heap)
        node = len(parent)
        parent.append(node)
        parent[a] = parent[b] = node
        heapq.heappush(heap, (f1 + f2, node))
    depth = [0] * len(parent)
    for node in range(len(parent) - 2, -1, -1):
        depth[node] = depth[parent[node]] + 1
    lengths = np.zeros(len(freq), np.int64)
    lengths[syms] = depth[:len(syms)]
    if lengths.max() > 58:
        raise ValueError("a Huffman code longer than 58 bits")
    return lengths


def _huf_codes(lengths):
    """ImfHuf's canonical codes: longer codes numerically lower, codes of
    one length increasing with the symbol."""
    count = np.bincount(lengths, minlength=59)
    first, c = np.zeros(59, np.uint64), 0
    for length in range(58, 0, -1):
        first[length], c = c, (c + int(count[length])) >> 1
    syms = np.flatnonzero(lengths)
    order = syms[np.lexsort((syms, lengths[syms]))]
    ls = lengths[order]
    rank = np.arange(len(order)) - np.searchsorted(ls, ls)
    codes = np.zeros(len(lengths), np.uint64)
    codes[order] = first[ls] + rank.astype(np.uint64)
    return codes


def _huf_table(lengths, im, i_max):
    """ImfHuf's code-length table: 6 bits a symbol from ``im`` to ``i_max``;
    zero runs as 59-62 (2-5 zeros) or 63 and 8 bits (6-261 zeros)."""
    fields = []
    prev = im
    for s in np.flatnonzero(lengths[im:i_max + 1]) + im:
        gap = int(s - prev)
        while gap:
            run = min(gap, 261)
            if run == 1:
                fields.append((0, 6))
            elif run < 6:
                fields.append((59 + run - 2, 6))
            else:
                fields += [(63, 6), (run - 6, 8)]
            gap -= run
        fields.append((int(lengths[s]), 6))
        prev = s + 1
    values, nbits = zip(*fields)
    return _msb_bits(values, nbits)[0]


def _huf_compress(data):
    """ImfHuf's hufCompress of uint16 ``data``: the 20-byte header (min and
    max symbol, table bytes, data bits, 0), the code-length table and the
    codes; the pseudo symbol after the largest codes runs of up to 255
    repeats of the previous value where that is shorter."""
    freq = np.bincount(data, minlength=(1 << 16) + 1).astype(np.int64)
    nz = np.flatnonzero(freq)
    im, rlc = int(nz[0]), int(nz[-1]) + 1
    freq[rlc] = 1
    lengths = _huf_lengths(freq)
    codes = _huf_codes(lengths)
    table = _huf_table(lengths, im, rlc)
    starts = np.flatnonzero(np.concatenate([[True], data[1:] != data[:-1]]))
    run = np.diff(np.append(starts, len(data)))
    pieces = -(-run // 256)
    sym = np.repeat(data[starts], pieces).astype(np.int64)
    size = np.full(int(pieces.sum()), 256)
    size[np.cumsum(pieces) - 1] = run - 256 * (pieces - 1)
    cs = size - 1
    ls = lengths[sym]
    use_run = ls + lengths[rlc] + 8 < ls * cs
    k = np.where(use_run, 3, cs + 1)
    piece = np.repeat(np.arange(len(sym)), k)
    j = np.arange(int(k.sum())) - np.repeat(np.cumsum(k) - k, k)
    ur = use_run[piece]
    values = np.where(ur & (j == 1), codes[rlc],
                      np.where(ur & (j == 2), cs[piece].astype(np.uint64),
                               codes[sym[piece]]))
    nbits = np.where(ur & (j == 1), lengths[rlc],
                     np.where(ur & (j == 2), 8, ls[piece]))
    body, total = _msb_bits(values, nbits)
    return struct.pack("<5I", im, rlc, len(table), total, 0) + table + body


def _wenc(a, b, w14):
    """ImfWav's wenc14 / wenc16 on uint16 arrays: (l, h)."""
    if w14:
        a = a.astype(np.int16).astype(np.int32)
        b = b.astype(np.int16).astype(np.int32)
        return ((a + b) >> 1).astype(np.uint16), (a - b).astype(np.uint16)
    a, b = a.astype(np.int32), b.astype(np.int32)
    ao = (a + (1 << 15)) & 0xFFFF
    m = (ao + b) >> 1
    d = ao - b
    m = np.where(d < 0, (m + (1 << 15)) & 0xFFFF, m)
    return m.astype(np.uint16), (d & 0xFFFF).astype(np.uint16)


def _wav2_encode(a, max_value):
    """ImfWav's wav2Encode of the 2D uint16 view ``a`` in place."""
    w14 = max_value < (1 << 14)
    ny, nx = a.shape
    n = min(nx, ny)
    p, p2 = 1, 2
    while p2 <= n:
        ny_b, nx_b = ny // p2 * p2, nx // p2 * p2
        y0, y1 = slice(0, ny_b, p2), slice(p, ny_b, p2)
        x0, x1 = slice(0, nx_b, p2), slice(p, nx_b, p2)
        i00, i01 = _wenc(a[y0, x0], a[y0, x1], w14)
        i10, i11 = _wenc(a[y1, x0], a[y1, x1], w14)
        a[y0, x0], a[y1, x0] = _wenc(i00, i10, w14)
        a[y0, x1], a[y1, x1] = _wenc(i01, i11, w14)
        if nx & p:      # the odd column
            a[y0, nx_b], a[y1, nx_b] = _wenc(a[y0, nx_b], a[y1, nx_b], w14)
        if ny & p:      # the odd line
            a[ny_b, x0], a[ny_b, x1] = _wenc(a[ny_b, x0], a[ny_b, x1], w14)
        p, p2 = p2, p2 << 1


def _exr_piz(raw, lines, width, size):
    """ImfPizCompressor of one chunk: ``lines`` lines of channels of
    ``width`` pixels, ``size`` 16-bit words a pixel (1 HALF, 2 FLOAT)."""
    u = np.frombuffer(raw, "<u2").reshape(lines, -1, width * size)
    tmp = np.ascontiguousarray(u.transpose(1, 0, 2)).reshape(-1)
    present = np.zeros(1 << 16, bool)
    present[tmp] = True
    present[0] = False
    bitmap = np.packbits(present, bitorder="little")
    nz = np.flatnonzero(bitmap)
    lo, hi = (int(nz[0]), int(nz[-1])) if len(nz) else (len(bitmap) - 1, 0)
    present[0] = True
    lut = (np.cumsum(present) - 1).astype(np.uint16)
    tmp = lut[tmp]
    max_value = int(present.sum()) - 1
    for plane in tmp.reshape(-1, lines, width * size):
        for j in range(size):
            _wav2_encode(plane[:, j::size], max_value)
    huf = _huf_compress(tmp)
    return (struct.pack("<HH", lo, hi)
            + (bitmap[lo:hi + 1].tobytes() if lo <= hi else b"")
            + struct.pack("<i", len(huf)) + huf)


def encode_exr(img, compression="zip", pixel_type="half",
               line_order="increasing"):
    """OpenEXR bytes of ``img`` (H, W, 3) or (H, W, 4) as R, G, B[, A]: a
    single-part scanline file, ``pixel_type`` "half" (a float16 ``img``
    keeps its bits) or "float", ``compression`` one of EXR_COMPRESSION,
    chunks in ``line_order`` "increasing" or "decreasing" y. A chunk that
    does not shrink is stored raw, as the OpenEXR library stores it."""
    img = np.asarray(img)
    h, w, c = img.shape
    names = "RGBA"[:c]
    order = sorted(range(c), key=lambda i: names[i])
    kind, dtype = EXR_PIXEL_TYPE[pixel_type]
    size = np.dtype(dtype).itemsize // 2
    lines = np.ascontiguousarray(
        img.astype(dtype)[..., order].transpose(0, 2, 1))   # (H, C, W)
    header = _exr_header(w, h, [(names[i], kind) for i in order],
                        EXR_COMPRESSION[compression],
                        EXR_LINE_ORDER[line_order])
    n_lines = EXR_LINES[compression]
    chunks = []
    for y in range(0, h, n_lines):
        raw = lines[y:y + n_lines].tobytes()
        if compression in ("zip", "zips"):
            packed = zlib.compress(_exr_predict(raw).tobytes(), EXR_ZIP_LEVEL)
        elif compression == "rle":
            packed = _exr_rle(_exr_predict(raw))
        elif compression == "piz":
            packed = _exr_piz(raw, min(n_lines, h - y), w, size)
        else:
            packed = raw
        if len(packed) >= len(raw):
            packed = raw
        chunks.append(struct.pack("<ii", y, len(packed)) + packed)
    seq = list(range(len(chunks)))
    if line_order == "decreasing":
        seq.reverse()
    offsets, at = [0] * len(chunks), len(header) + 8 * len(chunks)
    for i in seq:
        offsets[i] = at
        at += len(chunks[i])
    return b"".join([header, struct.pack(f"<{len(chunks)}Q", *offsets),
                     *(chunks[i] for i in seq)])


def write_exr(path, img, compression="zip", pixel_type="half",
              line_order="increasing"):
    """Write :func:`encode_exr` of ``img`` to ``path``."""
    with open(path, "wb") as f:
        f.write(encode_exr(img, compression, pixel_type, line_order))
