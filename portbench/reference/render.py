"""A served frame's pixels, plain.

What ``mfnerf_tpu_torch/models/rendering.py::render_test`` serves, as its
dense oracle ``render_test_dense`` computes it (as of the benchmark's
first version): each ray marches the whole test ladder (no jitter, the
test step's bug parity) in windows of ``s_max_test`` occupied samples,
each window's samples go through the field and are composited from the
transmittance left, a ray stops contributing once its transmittance falls
to ``T_threshold`` or after ``max_samples`` samples, and the white
background fills what is left. The trained parameters and the occupancy
bitfield are the program's state; the rest is this file's.
"""
import torch

from . import composite, field, march
from .train_step import matmul_tf32


@torch.no_grad()
def render_rays(hp, params, bits, rays_o, rays_d, T_threshold, chunk=1 << 14,
                tf32=False):
    """dict(rgb (N, 3), opacity (N,), depth (N,)) of the rays."""
    fld = field.Field(hp, params)
    scale, g, ms = hp["scale"], hp["grid_size"], hp["max_samples"]
    s_max = hp["s_max_test"]
    k = march.n_rungs(scale, g, ms, 0.0, test=True)
    outs = []
    with matmul_tf32(tf32):
        for i in range(0, rays_o.shape[0], chunk):
            ro, rd = rays_o[i:i + chunk], rays_d[i:i + chunk]
            n = ro.shape[0]
            hits = march.scene_hits(ro, rd, scale)
            opacity = torch.zeros((n,), device=ro.device)
            depth = torch.zeros((n,), device=ro.device)
            rgb = torch.zeros((n, 3), device=ro.device)
            alive = hits[:, 0] >= 0
            noise = torch.zeros((n,), device=ro.device)
            for j in range(-(-ms // s_max)):
                mr = march.march(ro, rd, hits, bits, scale, g, ms, noise, k,
                                 s_max, test=True, rank_start=j * s_max)
                mask = mr.mask & alive[:, None]
                flat = torch.nonzero(mask.reshape(-1)).squeeze(1)
                sig, col = fld.chunked(mr.xyzs.reshape(-1, 3)[flat],
                                       rd[flat // s_max])
                sigmas = sig.new_zeros(n * s_max).index_put((flat,), sig)
                rgbs = col.new_zeros((n * s_max, 3)).index_put((flat,), col)
                opacity, depth, rgb, alive = composite.composite_test_step(
                    sigmas.reshape(n, s_max), rgbs.reshape(n, s_max, 3),
                    mr.deltas, mr.ts, mr.mask, opacity, depth, rgb, alive,
                    T_threshold)
            outs.append((rgb + (1.0 - opacity)[:, None], opacity, depth))
    return {name: torch.cat([o[i] for o in outs])
            for i, name in enumerate(("rgb", "opacity", "depth"))}
