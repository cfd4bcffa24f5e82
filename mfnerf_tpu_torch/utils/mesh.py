"""Mesh extraction from a trained density field: port of
``mfnerf_tpu/utils/mesh.py``.

σ is :meth:`models.ngp.NGP.density` on a dense grid, in chunks on the
model's device (on the card: the encoder's forward kernel, ``hat_prod``
for LowRank, the hash-grid forward for the hash grids). With ``mcubes``
(and ``trimesh`` for the export) importable it runs marching cubes at
``sigma_threshold``, as the reference ``test.ipynb`` does; without them, as
on the card's machine, the surface-crossing voxel centres are the vertices,
written as an OBJ point cloud.
"""
import numpy as np
import torch


@torch.no_grad()
def density_on_grid(model, resolution=256, chunk=2 ** 18, bound=None):
    """σ on a (R, R, R) grid of ``np.linspace(-bound, bound, R)`` (float32)
    along x, y, z (``indexing="ij"``), bound the model's scale: float32
    numpy."""
    bound = bound if bound is not None else model.cfg.scale
    dev = next(model.parameters()).device
    xs = torch.from_numpy(np.linspace(-bound, bound, resolution,
                                      dtype=np.float32)).to(dev)
    n = resolution ** 3
    out = np.empty((n,), np.float32)
    for i in range(0, n, chunk):
        idx = torch.arange(i, min(i + chunk, n), device=dev)
        pts = torch.stack([xs[idx // resolution ** 2],
                           xs[idx // resolution % resolution],
                           xs[idx % resolution]], dim=-1)
        out[i:i + len(idx)] = model.density(pts).cpu().numpy()
    return out.reshape(resolution, resolution, resolution)


def surface_voxels(sigma, sigma_threshold):
    """(M, 3) indices of the voxels above ``sigma_threshold`` with a face
    neighbour (periodic, as ``np.roll`` wraps) at or below it."""
    occ = sigma > sigma_threshold
    interior = occ.copy()
    for axis in range(3):
        interior &= np.roll(occ, 1, axis) & np.roll(occ, -1, axis)
    return np.argwhere(occ & ~interior)


def extract_mesh(model, resolution=256, sigma_threshold=20.0, out_path=None,
                 bound=None):
    """Marching-cubes mesh, or the surface voxels' centres, of the σ
    isosurface. Returns (vertices, triangles); triangles is None on the
    fallback. With ``out_path``, writes the mesh (trimesh) or an OBJ."""
    sigma = density_on_grid(model, resolution, bound=bound)
    bound = bound if bound is not None else model.cfg.scale
    scale = 2 * bound / (resolution - 1)
    try:
        import mcubes
        verts, tris = mcubes.marching_cubes(sigma, sigma_threshold)
        verts = verts * scale - bound
    except ImportError:
        verts = surface_voxels(sigma, sigma_threshold).astype(
            np.float32) * scale - bound
        tris = None
    if out_path is not None:
        if tris is not None:
            try:
                import trimesh
                trimesh.Trimesh(verts, tris).export(out_path)
                return verts, tris
            except ImportError:
                pass
        with open(out_path, "w") as f:      # a minimal OBJ
            for v in verts:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
            if tris is not None:
                for t in tris:
                    f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")
    return verts, tris
