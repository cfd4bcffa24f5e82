"""Ray / scene-AABB intersection (slab method).

Port of ``mfnerf_tpu/ops/intersection.py::ray_aabb_intersect_single``: the
main path intersects each ray with exactly one box, the scene AABB.
"""
import torch


def ray_aabb_intersect_single(rays_o, rays_d, center, half_size):
    """(N, 2) (t_near, t_far) of each ray against one box; (-1, -1) where the
    ray misses it or the box lies behind it. t_near is clamped to >= 0."""
    rays_o = rays_o.to(torch.float32)
    inv_d = 1.0 / rays_d.to(torch.float32)
    center = torch.as_tensor(center, dtype=torch.float32,
                             device=rays_o.device).reshape(3)
    half_size = torch.as_tensor(half_size, dtype=torch.float32,
                                device=rays_o.device).reshape(3)
    t_lo = (center - half_size - rays_o) * inv_d
    t_hi = (center + half_size - rays_o) * inv_d
    tmin = torch.minimum(t_lo, t_hi).amax(dim=-1)
    tmax = torch.maximum(t_lo, t_hi).amin(dim=-1)
    miss = tmin > tmax
    t1 = torch.where(miss, -1.0, tmin)
    t2 = torch.where(miss, -1.0, tmax)
    hit = t2 > 0
    t1 = torch.where(hit, torch.clamp_min(t1, 0.0), -1.0)
    t2 = torch.where(hit, t2, -1.0)
    return torch.stack([t1, t2], dim=-1)
