"""Morton (Z-order) codes and occupancy-bitfield packing.

Port of ``mfnerf_tpu/ops/morton.py`` (``morton3d``, ``morton3d_invert``,
``packbits``, ``bitfield_lookup``). The JAX package computes in uint32 with
wrapping magic-mask multiplies; torch's uint32 support is partial, so the
port computes in int64 and masks to the same bits: every mask fits in 32
bits, so the result equals the wrapped uint32 one.

The occupancy grid stores one density per cell, addressed by
``mip * grid_size**3 + morton3d(cell_xyz)``; the bitfield packs 8 cells per
byte with bit ``i`` of byte ``n`` covering cell ``8*n + i``.
"""
import torch


def _expand_bits(v):
    """Spread the low 10 bits of ``v`` so consecutive bits are 3 apart."""
    v = v.to(torch.int64) & 0xFFFFFFFF
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3d(coords):
    """(..., 3) integer coords in [0, 1024) -> (...,) int64 Morton codes."""
    x = _expand_bits(coords[..., 0])
    y = _expand_bits(coords[..., 1])
    z = _expand_bits(coords[..., 2])
    return x | (y << 1) | (z << 2)


def _compact_bits(x):
    x = x & 0x49249249
    x = (x | (x >> 2)) & 0xC30C30C3
    x = (x | (x >> 4)) & 0x0F00F00F
    x = (x | (x >> 8)) & 0xFF0000FF
    x = (x | (x >> 16)) & 0x0000FFFF
    return x


def morton3d_invert(indices):
    """Invert :func:`morton3d`: (...,) codes -> (..., 3) int32 coords."""
    indices = indices.to(torch.int64) & 0xFFFFFFFF
    x = _compact_bits(indices)
    y = _compact_bits(indices >> 1)
    z = _compact_bits(indices >> 2)
    return torch.stack([x, y, z], dim=-1).to(torch.int32)


def packbits(density_grid, density_threshold):
    """Threshold a density grid (Morton order, any shape with C*G^3 cells)
    into a (C*G^3//8,) uint8 bitfield: bit i of byte n = cell 8n+i > thr."""
    flat = density_grid.reshape(-1, 8)
    bits = (flat > density_threshold).to(torch.uint8)
    weights = torch.tensor([1 << i for i in range(8)], dtype=torch.uint8,
                           device=flat.device)
    return (bits * weights).sum(dim=-1).to(torch.uint8)


def bitfield_lookup(bitfield, idx):
    """Occupancy bit ``idx`` (mip*G^3 + Morton code) of a packed bitfield."""
    idx = idx.to(torch.int64)
    byte = bitfield[idx >> 3].to(torch.int64)
    return ((byte >> (idx & 7)) & 1).to(torch.bool)
