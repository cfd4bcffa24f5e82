"""Morton (Z-order) codes and occupancy-bitfield packing.

Port of ``mfnerf_tpu/ops/morton.py`` (``morton3d``, ``morton3d_invert``,
``packbits``, ``bitfield_lookup``, the Morton <-> raster helpers and
``union_bitfield``). The JAX package computes in uint32 with
wrapping magic-mask multiplies; torch's uint32 support is partial, so the
port computes in int64 and masks to the same bits: every mask fits in 32
bits, so the result equals the wrapped uint32 one.

The occupancy grid stores one density per cell, addressed by
``mip * grid_size**3 + morton3d(cell_xyz)``; the bitfield packs 8 cells per
byte with bit ``i`` of byte ``n`` covering cell ``8*n + i``.
"""
import torch

_RASTER_CODES = {}   # (g, device) -> Morton code of each raster cell


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


def _pack(bits):
    """(8n,) bool -> (n,) uint8: bit i of byte n is ``bits[8n + i]``."""
    # 1 << i made on the device: no copy from the host, so that a CUDA
    # graph can capture the refresh
    weights = torch.bitwise_left_shift(
        torch.ones(8, dtype=torch.uint8, device=bits.device),
        torch.arange(8, dtype=torch.uint8, device=bits.device))
    return (bits.reshape(-1, 8).to(torch.uint8) * weights).sum(
        dim=-1).to(torch.uint8)


def packbits(density_grid, density_threshold):
    """Threshold a density grid (Morton order, any shape with C*G^3 cells)
    into a (C*G^3//8,) uint8 bitfield: bit i of byte n = cell 8n+i > thr."""
    return _pack(density_grid.reshape(-1) > density_threshold)


def unpack_bits_morton(bitfield, n_cells):
    """Packed uint8 bitfield -> (n_cells,) bool in Morton cell order."""
    shifts = torch.arange(8, device=bitfield.device)
    bits = (bitfield.to(torch.int64)[:, None] >> shifts) & 1
    return bits.reshape(-1)[:n_cells].to(torch.bool)


def raster_codes(g, device):
    """(g, g, g) int64 [z, y, x]: the Morton code of each raster cell."""
    codes = _RASTER_CODES.get((g, device))
    if codes is None:
        r = torch.arange(g, device=device)
        zyx = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1)
        codes = _RASTER_CODES[(g, device)] = morton3d(zyx.flip(-1))
    return codes


def morton_values_to_spatial(v, g):
    """(g^3,) Morton-ordered per-cell values -> (g, g, g) raster [z, y, x]."""
    return v[raster_codes(g, v.device)]


def spatial_to_morton_values(a, g):
    """(g, g, g) raster [z, y, x] -> (g^3,) Morton-ordered values (inverse of
    :func:`morton_values_to_spatial`)."""
    out = torch.empty(g ** 3, dtype=a.dtype, device=a.device)
    out[raster_codes(g, a.device).reshape(-1)] = a.reshape(-1)
    return out


def union_bitfield(fine_bitfield, grid_size, cascades, dilate):
    """The dilated world-space union of every cascade's occupancy: the
    stage-A grid of the multi-cascade training march.

    One grid of ``grid_size``^3 cells over the largest cascade's box; a
    cell is occupied when any cascade has an occupied cell inside it.
    Cascade c's box is f = 2^(cascades-1-c) times smaller, so its cells
    pool by OR over f^3 blocks into the central (G/f)^3 cells. The union is
    then dilated ``dilate`` cells on each axis, with wrap-around, so that
    one cell tested at a stratum's midpoint covers every rung of it
    (``ray_march.cascades_stratum``).

    Returns:
        (grid_size^3 // 8,) uint8, Morton order (``bitfield_lookup``).
    """
    g = grid_size
    n = g ** 3
    union = torch.zeros((g, g, g), dtype=torch.bool,
                        device=fine_bitfield.device)
    for c in range(cascades):
        f = 1 << (cascades - 1 - c)
        occ = morton_values_to_spatial(unpack_bits_morton(
            fine_bitfield[c * n // 8:(c + 1) * n // 8], n), g)
        if f > 1:
            gf, lo = g // f, (g - g // f) // 2
            pooled = occ.reshape(gf, f, gf, f, gf, f).any(5).any(3).any(1)
            union[lo:lo + gf, lo:lo + gf, lo:lo + gf] |= pooled
        else:
            union |= occ
    for axis in range(3):
        for _ in range(dilate):
            union = union | torch.roll(union, 1, axis) \
                | torch.roll(union, -1, axis)
    return _pack(spatial_to_morton_values(union, g))


def bitfield_lookup(bitfield, idx):
    """Occupancy bit ``idx`` (mip*G^3 + Morton code) of a packed bitfield."""
    idx = idx.to(torch.int64)
    byte = bitfield[idx >> 3].to(torch.int64)
    return ((byte >> (idx & 7)) & 1).to(torch.bool)
