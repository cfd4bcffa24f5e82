"""Camera rays: pixel directions (numpy) and world rays (torch).

Port of ``mfnerf_tpu/datasets/ray_utils.py``. Camera coords are
[right down front]; directions pass through pixel centres (u + 0.5) and are
NOT normalised: marching distances are measured in units of |d|.
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
    """
    if c2w.dim() == 2:
        rays_d = directions @ c2w[:, :3].T
        rays_o = c2w[:, 3].expand(rays_d.shape)
    else:
        rays_d = torch.einsum("nc,nbc->nb", directions, c2w[..., :3])
        rays_o = c2w[..., 3]
    return rays_o, rays_d
