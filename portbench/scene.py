"""The benchmark's scene, made on the device in every run.

Synthetic-NeRF's layout (100 training views and 200 test poses at
800x800, a camera ring of radius 1.5 around [-0.5, 0.5]^3, the
Blender/NSVF camera convention [right down front], the focal length of
``mfnerf_tpu_torch/utils/procedural.py::make_scene``, ~53 degrees) on that
module's multi-sphere arrangement: five checker-textured, shaded spheres
on a white background, rendered analytically in torch. The port's own
procedural module is not used: the scene is the yardstick's input.

The scene is data, as a Synthetic-NeRF scene is: the same in every run.
The training cameras sit at even angles on the ring, at elevations of
25-50 degrees spread by the golden section; the test poses are an orbit
at 30 degrees. The seed draws what a run does with them (the field's
weights, the batches, the viewer's order).
"""
import math

import numpy as np
import torch

# (centre, radius, material) and the materials' base colours
SPHERES = (
    ((0.0, 0.0, 0.0), 0.30, 0),
    ((0.28, 0.18, -0.10), 0.12, 1),
    ((-0.25, -0.05, 0.22), 0.10, 2),
    ((0.05, -0.30, -0.18), 0.08, 3),
    ((-0.12, 0.28, 0.05), 0.07, 4),
)
BASE = ((0.9, 0.3, 0.2), (0.2, 0.7, 0.9), (0.9, 0.8, 0.2), (0.4, 0.9, 0.3),
        (0.8, 0.4, 0.9))
LIGHT = (0.3, -0.5, 0.8)
CAM_RADIUS = 1.5
TEST_ELEVATION = 30.0      # degrees
GOLDEN = (math.sqrt(5) - 1) / 2
VIEWS_A_CALL = 10          # training views rendered together


def intrinsics(wh):
    f = float(wh)
    return np.float32([[f, 0, wh / 2], [0, f, wh / 2], [0, 0, 1]])


def directions(wh, device):
    """(wh*wh, 3) float32 camera directions through the pixel centres."""
    r = torch.arange(wh, dtype=torch.float32, device=device)
    v, u = torch.meshgrid(r, r, indexing="ij")
    c = wh / 2
    return torch.stack([(u - c + 0.5) / wh, (v - c + 0.5) / wh,
                        torch.ones_like(u)], -1).reshape(-1, 3)


def look_at(position):
    """c2w (3, 4) float32 of a camera at ``position`` looking at the
    origin, [right down front]."""
    forward = -position / np.linalg.norm(position)
    up = np.array([0.0, 0.0, 1.0])
    right = np.cross(-up, forward)
    right /= np.linalg.norm(right)
    down = np.cross(forward, right)
    return np.stack([right, down, forward, position], axis=1).astype(
        np.float32)


def ring_pose(theta, elevation_deg):
    phi = math.radians(elevation_deg)
    return look_at(CAM_RADIUS * np.array([
        math.cos(theta) * math.cos(phi), math.sin(theta) * math.cos(phi),
        math.sin(phi)]))


def train_poses(n):
    return np.stack([ring_pose(2 * math.pi * i / n,
                               25 + 25 * ((i * GOLDEN) % 1.0))
                     for i in range(n)])


def test_poses(n):
    return np.stack([ring_pose(2 * math.pi * (i + 0.37) / n, TEST_ELEVATION)
                     for i in range(n)])


def render(rays_o, rays_d):
    """(N, 3) colours of rays (N, 3) against the spheres, white behind."""
    d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    n_rays, dev = rays_o.shape[0], rays_o.device
    best_t = torch.full((n_rays,), math.inf, device=dev)
    img = torch.ones((n_rays, 3), device=dev)
    light = torch.tensor(LIGHT, device=dev)
    for ctr, rad, mat in SPHERES:
        co = rays_o - torch.tensor(ctr, device=dev)
        b = (d * co).sum(-1)
        disc = b * b - ((co * co).sum(-1) - rad ** 2)
        t = -b - torch.sqrt(torch.clamp_min(disc, 0.0))
        hit = (disc > 0) & (t > 0) & (t < best_t)
        nrm = (co + t[:, None] * d) / rad
        shade = torch.clamp(nrm @ light, 0.05, 1.0)[:, None]
        k = (8 + 4 * mat) / math.pi
        theta = torch.atan2(nrm[:, 1], nrm[:, 0])
        phi = torch.arccos(torch.clamp(nrm[:, 2], -1, 1))
        checker = torch.remainder(torch.floor(theta * k)
                                  + torch.floor(phi * k), 2)[:, None]
        color = (0.35 + 0.65 * checker) * torch.tensor(BASE[mat], device=dev) \
            * (0.4 + 0.6 * shade)
        img = torch.where(hit[:, None], torch.clamp(color, 0, 1), img)
        best_t = torch.where(hit, t, best_t)
    return img


def make(n_train, n_test, wh, device):
    """dict(images (n_train, wh*wh, 3) float32 on ``device``, poses,
    test_poses (n, 3, 4) float32 numpy, K (3, 3), directions (wh*wh, 3)
    on ``device``, img_wh)."""
    poses = train_poses(n_train)
    dirs = directions(wh, device)
    images = torch.empty((n_train, wh * wh, 3), device=device)
    rot = torch.from_numpy(poses).to(device)
    for i in range(0, n_train, VIEWS_A_CALL):
        r = rot[i:i + VIEWS_A_CALL]                        # (V, 3, 4)
        rays_d = torch.einsum("pj,vij->vpi", dirs, r[:, :, :3])
        rays_o = r[:, None, :, 3].expand_as(rays_d)
        images[i:i + r.shape[0]] = render(
            rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)).reshape(
                r.shape[0], -1, 3)
    return {"images": images, "poses": poses, "test_poses": test_poses(n_test),
            "K": intrinsics(wh), "directions": dirs, "img_wh": (wh, wh)}
