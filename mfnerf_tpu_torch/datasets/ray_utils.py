"""Camera rays: pixel directions (numpy) and world rays (torch).

Port of ``mfnerf_tpu/datasets/ray_utils.py``. Camera coords are
[right down front]; directions pass through pixel centres (u + 0.5) and are
NOT normalised: marching distances are measured in units of |d|.
:func:`axisangle_to_R` is the pose refinement's rotation (torch, with a
finite gradient at the zero rotation). The COLMAP loader's pose helpers
(``average_poses``, ``center_poses``, ``create_spheric_poses``) are numpy,
in float64 as the JAX package's.
"""
import numpy as np
import torch


def get_ray_directions(H, W, K):
    """(H*W, 3) float32 directions through the pixel centres, in camera
    coordinates (numpy). The JAX version's random-offset and uv outputs are
    for training and are not ported yet."""
    u, v = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")
    K = np.asarray(K, np.float32)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    directions = np.stack(
        [(u - cx + 0.5) / fx, (v - cy + 0.5) / fy, np.ones_like(u)], -1)
    return directions.reshape(-1, 3).astype(np.float32)


def get_rays(directions, c2w):
    """Camera-space directions + c2w pose(s) -> world rays.

    Args:
        directions: (N, 3) float32 tensor.
        c2w: (3, 4) or (N, 3, 4) float32 tensor on the same device.
    Returns:
        rays_o, rays_d: (N, 3) world origins and (unnormalised) directions.

    With a pose a ray, each direction is three products summed in a fixed
    order, elementwise: a batched matmul's kernel, and so the last bit of a
    ray, would depend on N on the card, and under data parallelism a rank's
    rays must be the same as the whole batch's.
    """
    if c2w.dim() == 2:
        rays_d = directions @ c2w[:, :3].T
        rays_o = c2w[:, 3].expand(rays_d.shape)
    else:
        rot = c2w[..., :3]
        rays_d = (directions[:, 0:1] * rot[..., 0]
                  + directions[:, 1:2] * rot[..., 1]
                  + directions[:, 2:3] * rot[..., 2])
        rays_o = c2w[..., 3]
    return rays_o, rays_d


def axisangle_to_R(v):
    """Axis-angle (N, 3) or (3,) -> rotation (N, 3, 3) or (3, 3), Rodrigues
    as the JAX package computes it: the squared norm is clamped at 1e-14 and
    below that the constant branches (sinc 1, (1 - cos) / theta^2 1/2) are
    taken, so the gradient at v = 0, where ``--optimize_ext`` starts, is
    finite (first order through the skew term). In float32, or in float64
    for a float64 ``v``."""
    v = torch.as_tensor(v)
    if v.dtype != torch.float64:
        v = v.to(torch.float32)
    squeeze = v.dim() == 1
    if squeeze:
        v = v[None]
    zero = torch.zeros_like(v[:, :1])
    skew = torch.stack([
        torch.cat([zero, -v[:, 2:3], v[:, 1:2]], 1),
        torch.cat([v[:, 2:3], zero, -v[:, 0:1]], 1),
        torch.cat([-v[:, 1:2], v[:, 0:1], zero], 1)], dim=1)
    sq = (v * v).sum(dim=1)[:, None, None]
    sq_safe = torch.clamp_min(sq, 1e-14)
    norm_v = torch.sqrt(sq_safe)
    small = sq < 1e-14
    sinc = torch.where(small, 1.0, torch.sin(norm_v) / norm_v)
    cosc = torch.where(small, 0.5, (1 - torch.cos(norm_v)) / sq_safe)
    r = torch.eye(3, dtype=v.dtype, device=v.device) + sinc * skew \
        + cosc * (skew @ skew)
    return r[0] if squeeze else r


def normalize(v):
    return v / np.linalg.norm(v)


def average_poses(poses, pts3d=None):
    """(3, 4) average pose: centred on the points (else the cameras), z the
    mean viewing axis, y the mean up axis made orthogonal to it."""
    center = pts3d.mean(0) if pts3d is not None else poses[..., 3].mean(0)
    z = normalize(poses[..., 2].mean(0))
    y_ = poses[..., 1].mean(0)
    x = normalize(np.cross(y_, z))
    y = np.cross(z, x)
    return np.stack([x, y, z, center], 1)


def center_poses(poses, pts3d=None):
    """Poses (and points) in the frame of :func:`average_poses`."""
    pose_avg_homo = np.eye(4)
    pose_avg_homo[:3] = average_poses(poses, pts3d)
    pose_avg_inv = np.linalg.inv(pose_avg_homo)
    last_row = np.tile(np.array([0, 0, 0, 1.0]), (len(poses), 1, 1))
    poses_homo = np.concatenate([poses, last_row], 1)
    poses_centered = (pose_avg_inv @ poses_homo)[:, :3]
    if pts3d is not None:
        pts3d_centered = pts3d @ pose_avg_inv[:3, :3].T + pose_avg_inv[:3, 3]
        return poses_centered, pts3d_centered
    return poses_centered


def create_spheric_poses(radius, mean_h, n_poses=120):
    """(n_poses, 3, 4) test-trajectory poses on a circle of ``radius`` at
    height ``2 * mean_h``, tilted 15 degrees down."""
    def spheric_pose(theta, phi):
        trans_t = np.array([[1, 0, 0, 0], [0, 1, 0, 2 * mean_h],
                            [0, 0, 1, -radius]], dtype=np.float64)
        rot_phi = np.array([[1, 0, 0], [0, np.cos(phi), -np.sin(phi)],
                            [0, np.sin(phi), np.cos(phi)]])
        rot_theta = np.array([[np.cos(theta), 0, -np.sin(theta)],
                              [0, 1, 0],
                              [np.sin(theta), 0, np.cos(theta)]])
        c2w = rot_theta @ rot_phi @ trans_t
        return np.array([[-1, 0, 0], [0, 0, 1], [0, 1, 0.]]) @ c2w

    return np.stack([spheric_pose(th, -np.pi / 12)
                     for th in np.linspace(0, 2 * np.pi, n_poses + 1)[:-1]])
