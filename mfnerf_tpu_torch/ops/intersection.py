"""Ray / box and ray / sphere intersection (slab and quadratic methods).

Port of ``mfnerf_tpu/ops/intersection.py``: the main path intersects each
ray with exactly one box, the scene AABB (:func:`ray_aabb_intersect_single`).
:func:`ray_aabb_intersect` and :func:`ray_sphere_intersect` are the public
API of the JAX package's ``ops`` (the reference's ``intersection.cu``): the
hits of every ray against every box or sphere, the nearest ``max_hits``
sorted near to far. The JAX functions are jnp, so these are plain torch.
"""
import torch


def _nearest(hit, t1, t2, max_hits):
    """Hit counts, the nearest ``max_hits`` (t_near, t_far) and indices of
    (N_rays, N) hits, sorted near to far as the JAX package sorts them (a
    stable argsort, misses last); -1 where there is no hit."""
    hits_cnt = hit.sum(dim=-1).to(torch.int32)
    t1 = torch.where(hit, torch.clamp_min(t1, 0.0), -1.0)
    t2 = torch.where(hit, t2, -1.0)
    k = min(max_hits, hit.shape[1])
    key = torch.where(hit, t1, torch.inf)
    order = torch.argsort(key, dim=-1, stable=True)[:, :k]
    hits_t = torch.stack([torch.gather(t1, 1, order),
                          torch.gather(t2, 1, order)], dim=-1)
    hits_idx = torch.where(torch.gather(hit, 1, order), order,
                           -1).to(torch.int32)
    if k < max_hits:        # pad to the static max_hits width
        pad = max_hits - k
        hits_t = torch.nn.functional.pad(hits_t, (0, 0, 0, pad), value=-1.0)
        hits_idx = torch.nn.functional.pad(hits_idx, (0, pad), value=-1)
    return hits_cnt, hits_t, hits_idx


def ray_aabb_intersect(rays_o, rays_d, centers, half_sizes, max_hits=1):
    """Rays (N_rays, 3) against axis-aligned boxes (N, 3) centres and half
    sizes: (hits_cnt (N_rays,) int32 boxes hit, t_far > 0; hits_t
    (N_rays, max_hits, 2) (t_near, t_far) of the nearest hits, t_near
    clamped to >= 0; hits_voxel_idx (N_rays, max_hits) int32); -1 where
    there is no hit."""
    rays_o = rays_o.to(torch.float32)[:, None, :]
    inv_d = 1.0 / rays_d.to(torch.float32)[:, None, :]
    centers = centers.to(torch.float32)[None]
    half_sizes = half_sizes.to(torch.float32)[None]
    t_lo = (centers - half_sizes - rays_o) * inv_d
    t_hi = (centers + half_sizes - rays_o) * inv_d
    tmin = torch.minimum(t_lo, t_hi).amax(dim=-1)
    tmax = torch.maximum(t_lo, t_hi).amin(dim=-1)
    miss = tmin > tmax
    t1 = torch.where(miss, -1.0, tmin)
    t2 = torch.where(miss, -1.0, tmax)
    return _nearest(t2 > 0, t1, t2, max_hits)


def ray_sphere_intersect(rays_o, rays_d, centers, radii, max_hits=1):
    """Rays against spheres (N, 3) centres and (N,) radii, as
    :func:`ray_aabb_intersect`; a ray tangent to a sphere (discriminant 0)
    misses it."""
    rays_o = rays_o.to(torch.float32)
    rays_d = rays_d.to(torch.float32)
    co = rays_o[:, None, :] - centers.to(torch.float32)[None]
    a = (rays_d * rays_d).sum(-1)[:, None]
    half_b = (rays_d[:, None, :] * co).sum(-1)
    radii = torch.as_tensor(radii, dtype=torch.float32,
                            device=rays_o.device)
    c = (co * co).sum(-1) - (radii * radii).reshape(1, -1)
    disc = half_b * half_b - a * c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t1 = (-half_b - sq) / a
    t2 = (-half_b + sq) / a
    return _nearest((disc > 0) & (t2 > 0), t1, t2, max_hits)


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
