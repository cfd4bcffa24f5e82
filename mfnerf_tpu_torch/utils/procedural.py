"""Procedural multi-view scene for tests and the chip smoke run (numpy).

Port of ``mfnerf_tpu/utils/procedural.py`` (``make_scene`` and its pose and
ground-truth render helpers), bit-identical to it: the same seed gives the
same poses, intrinsics, directions and images, so the port renders the same
cameras as the JAX package's ``bench.py``. Scenes are checker-textured
shaded spheres on a white background, seen from cameras on a ring of radius
1.5 around [-0.5, 0.5]^3, with the Blender/NSVF camera conventions
([right down front]).
"""
import numpy as np

from ..datasets.ray_utils import get_ray_directions


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

