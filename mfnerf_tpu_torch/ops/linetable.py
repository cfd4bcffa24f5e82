"""Line-table kernels: the two-row lerp of a line table and one axis of the
hat basis's table gradient.

Ports of the Pallas kernels of the encoder formulation probes
(``benchmarking/probe_pallas_gather.py``, ``probe_pallas_gather2.py``):

* :func:`table_lerp` — ``k_onehot``, ``k_index`` and ``k_gather``, one
  function of a (K, R) table::

      out[n] = T[i_n] * (1 - f_n) + T[i_n + 1] * f_n              (N, R)

  with (i_n, f_n) given, or computed from positions u as ``k_gather`` does:
  ``pos = u * (K-1)``, ``i = clamp(trunc(pos), 0, K-2)``, ``f = pos - i``.
  A given index is clamped to [0, K-2] as well.
* :func:`hat_basis_dw` — ``k_bwd``::

      dW = B_K(u)^T @ bf16(g)                                     (K, R)

  with B_K the dense piecewise-linear hat basis (bf16), fp32 sums.

On CUDA tensors the wrappers launch the hand-written kernels of
``csrc/linetable.cu``; on CPU tensors they compute the plain versions
:func:`table_lerp_plain` and :func:`hat_basis_dw_plain`. The kernel of
:func:`table_lerp` repeats the plain version's fp32 operations one by one and
equals it bit for bit; that of :func:`hat_basis_dw` sums in another order,
the same on every launch, which :func:`hat_basis_dw_order_plain` repeats
bit for bit. No probe differentiates, so neither is an autograd function.
"""
import ctypes
import functools

import torch

from .. import build
from .hatmul import _bf16, _pos_basis, _stream

# Stage 1 of hat_basis_dw keeps a (K, 32) fp32 slab in a block's shared
# memory: K <= 1,816 fits Hopper's 227 KB a block.
DW_MAX_K = 1816
DW_COLS = 32                   # columns a block of stage 1
DW_WARPS = 8                   # walker warps a block (kDwWarps)
# Samples a chunk: at least DW_MIN_CHUNK, and chunks enough for about
# DW_BLOCKS blocks (three slabs of K = 513 on each of an H100's 132 SMs).
# The order of dW's sums follows the chunks, so it is a function of N and R.
DW_MIN_CHUNK, DW_BLOCKS = 1024, 396


def _lerp(table, i, f):
    f = f[:, None]
    return table[i] * (1 - f) + table[i + 1] * f


def _u_index(u, k):
    """(row, fraction) of positions u, as ``k_gather`` computes them."""
    pos = u * (k - 1)
    i = pos.to(torch.int32).clamp(0, k - 2)
    return i, pos - i.to(torch.float32)


def table_lerp_plain(table, idx=None, frac=None, u=None, k=None):
    """The two-row lerp, op by op; arguments as :func:`table_lerp`."""
    if u is not None:
        i, f = _u_index(u, table.shape[0] if k is None else k)
    else:
        i, f = idx.clamp(0, table.shape[0] - 2), frac
    return _lerp(table, i.long(), f)


def hat_basis_dw_plain(u, g, k):
    """The dense form: bf16 hat basis (N, K), transposed, @ bf16(g) in
    fp32."""
    ks = torch.arange(k, dtype=torch.float32, device=u.device)
    return _pos_basis(u, k, ks)[1].T @ _bf16(g)


def hat_rows(u, k):
    """(i, w0, w1) of each sample, as the kernel computes them: its hat row
    ``i = clamp(floor(u (K-1)), 0, K-2)`` (int64) and the bf16 weights of
    rows i and i + 1 (the dense basis's two nonzeros, fp32)."""
    pos = u * (k - 1)
    i = torch.floor(pos).clamp(0, k - 2)
    w0 = _bf16(torch.clamp_min(1.0 - (pos - i).abs(), 0.0))
    w1 = _bf16(torch.clamp_min(1.0 - (pos - (i + 1)).abs(), 0.0))
    return i.long(), w0, w1


def dw_row_ranges(k):
    """The slab rows [lo, hi) each walker warp of stage 1 owns, in warp
    order, as the kernel splits K: contiguous spans of ceil(K / DW_WARPS)
    rows (empty past K)."""
    span = -(-k // DW_WARPS)
    return [(min(w * span, k), min((w + 1) * span, k))
            for w in range(DW_WARPS)]


def dw_walks(i, lo, hi):
    """Whether the warp that owns rows [lo, hi) walks a sample of hat row
    i: one of rows i, i + 1 is its own.

    This and :func:`dw_row_ranges` mirror the kernel's map so that a CPU
    test can show it takes each contribution once; on the card the kernel
    itself is held to the map by its bit-for-bit equality with
    :func:`hat_basis_dw_order_plain`, which a missed or doubled
    contribution would break."""
    return (i + 1 >= lo) & (i < hi)


def hat_basis_dw_order_plain(u, g, k):
    """:func:`hat_basis_dw`'s kernel, sum for sum: within each chunk of
    :func:`dw_chunking`, every dW element adds its samples' bf16 products in
    sample order to an fp32 sum from 0; stage 2 adds the chunks' sums in
    chunk order, from 0. Equal to the kernel's dW bit for bit."""
    n, r = g.shape
    dw = torch.zeros((k, r), dtype=torch.float32, device=g.device)
    if n == 0:
        return dw
    chunk, chunks = dw_chunking(n, r)
    i, w0, w1 = hat_rows(u, k)
    s = torch.arange(n, device=g.device).repeat(2)
    row, w = torch.cat([i, i + 1]), torch.cat([w0, w1])
    key = s // chunk * k + row              # the slab element (chunk, row)
    # each element's contributions in sample order; then the p-th of every
    # element together, p = 0, 1, ...
    key, order = torch.sort(key * n + s)
    key, s, w = key // n, s[order], w[order]
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    start = torch.cummax(torch.where(first, torch.arange(
        key.numel(), device=g.device), 0), 0).values
    rank = torch.arange(key.numel(), device=g.device) - start
    rank, order = torch.sort(rank, stable=True)
    key, s, w = key[order], s[order], w[order]
    slabs = torch.zeros((chunks * k, r), dtype=torch.float32, device=g.device)
    gd = _bf16(g)
    for a, b in _runs(rank):
        slabs[key[a:b]] = slabs[key[a:b]] + w[a:b, None] * gd[s[a:b]]
    for c in range(chunks):
        dw = dw + slabs[c * k:(c + 1) * k]
    return dw


def _runs(sorted_vals):
    """[(start, end)] of the runs of equal values of a sorted 1-D tensor."""
    counts = torch.unique_consecutive(sorted_vals, return_counts=True)[1]
    ends = torch.cumsum(counts, 0).tolist()
    return list(zip([0] + ends[:-1], ends))


@functools.cache
def _kernels():
    """The C entry points of csrc/linetable.cu (built on first use)."""
    lib = build.load_library("linetable")
    lerp, dw = lib.table_lerp, lib.hat_basis_dw
    lerp.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    dw.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    lerp.restype = dw.restype = ctypes.c_int
    return lerp, dw


def _check_vector(name, x, dtype, n, device):
    if x.dtype != dtype or x.dim() != 1 or (n is not None and x.shape[0] != n):
        want = "(N,)" if n is None else f"({n},)"
        raise ValueError(f"{name} must be {want} {dtype}, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name} on {x.device} but the table on {device}")


def _check_device(x):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the line-table kernels run on cpu or cuda, not "
                         f"{x.device}")


def _check_size(n):
    if n >= 2 ** 31:
        raise ValueError(f"N = {n} exceeds the kernels' int32 sample index")


def _check_lerp(table, idx, frac, u, k):
    """Mode, shape, type and device checks of :func:`table_lerp`; returns
    (N, K)."""
    _check_device(table)
    if table.dtype != torch.float32 or table.dim() != 2:
        raise ValueError(f"table must be (K, R) float32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    rows, r = table.shape
    if r % 4:
        raise ValueError(f"the table's R = {r} must be a multiple of 4")
    if u is not None:
        if idx is not None or frac is not None:
            raise ValueError("give either (idx, frac) or (u, k), not both")
        k = rows if k is None else k
        if not 2 <= k <= rows:
            raise ValueError(f"need 2 <= k <= {rows} table rows, got k={k}")
        _check_vector("u", u, torch.float32, None, table.device)
        n = u.shape[0]
    else:
        if idx is None or frac is None or k is not None:
            raise ValueError("give either (idx, frac) or (u, k)")
        k = rows
        if k < 2:
            raise ValueError(f"the table needs two rows, has {k}")
        _check_vector("idx", idx, torch.int32, None, table.device)
        n = idx.shape[0]
        _check_vector("frac", frac, torch.float32, n, table.device)
    _check_size(n)
    return n, k


def table_lerp(table, idx=None, frac=None, u=None, k=None):
    """``T[i] * (1 - f) + T[i + 1] * f`` for each sample -> (N, R) float32.

    Args:
        table: (K, R) float32, R a multiple of 4.
        idx, frac: (N,) int32 rows (clamped to [0, K-2]) and (N,) float32
            fractions; or
        u, k: (N,) float32 positions and the knot count (default: the
            table's rows; rows past k are never read): ``pos = u * (k-1)``,
            ``i = clamp(trunc(pos), 0, k-2)``, ``f = pos - i``.

    CUDA tensors launch the kernel (``csrc/linetable.cu``), which equals
    :func:`table_lerp_plain` bit for bit; CPU tensors run the plain version.
    ``table_lerp.launches`` counts kernel launches.
    """
    n, k = _check_lerp(table, idx, frac, u, k)
    if table.device.type == "cpu":
        return table_lerp_plain(table, idx, frac, u, k)
    table = table.contiguous()
    out = torch.empty((n, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    if n == 0:
        return out
    if table.data_ptr() % 16:
        raise ValueError("table_lerp needs a 16-byte aligned table")
    ptrs = ((idx.contiguous().data_ptr(), frac.contiguous().data_ptr(), None)
            if u is None else (None, None, u.contiguous().data_ptr()))
    rc = _kernels()[0](table.data_ptr(), *ptrs, out.data_ptr(), n, k,
                       table.shape[1], _stream(table.device))
    if rc != 0:
        raise RuntimeError(f"table_lerp launch failed: cudaError {rc}")
    table_lerp.launches += 1
    return out


def dw_chunking(n, r):
    """(chunk, chunks) of :func:`hat_basis_dw`'s stage 1 for N samples and
    R columns."""
    tiles = -(-r // DW_COLS)
    chunks = max(1, min(n // DW_MIN_CHUNK, DW_BLOCKS // tiles))
    return -(-n // chunks), chunks


def hat_basis_dw(u, g, k):
    """``B_K(u)^T @ bf16(g)`` -> (K, R) float32: one axis of the hat
    backward's table gradient, hat weights and g rounded to bf16, fp32 sums.

    Args:
        u: (N,) float32 positions in [0, 1].
        g: (N, R) float32.
        k: the knot count K >= 2.

    CUDA tensors run the two-stage kernel (``csrc/linetable.cu``), whose dW
    is bitwise the same on every launch and equals
    :func:`hat_basis_dw_order_plain`; CPU tensors run
    :func:`hat_basis_dw_plain`. ``hat_basis_dw.launches`` counts kernel
    launches (both stages are one).
    """
    _check_device(u)
    _check_vector("u", u, torch.float32, None, u.device)
    n = u.shape[0]
    if g.dtype != torch.float32 or g.dim() != 2 or g.shape[0] != n:
        raise ValueError(f"g must be ({n}, R) float32, got {tuple(g.shape)} "
                         f"{g.dtype}")
    if g.device != u.device:
        raise ValueError(f"u on {u.device} but g on {g.device}")
    if not 2 <= k <= DW_MAX_K:
        raise ValueError(f"need 2 <= K <= {DW_MAX_K} (the shared-memory "
                         f"slab), got K={k}")
    _check_size(n)
    if u.device.type == "cpu":
        return hat_basis_dw_plain(u, g, k)
    r = g.shape[1]
    u, g = u.contiguous(), g.contiguous()
    dw = torch.empty((k, r), dtype=torch.float32, device=u.device)
    if r == 0:
        return dw
    chunk, chunks = dw_chunking(n, r)
    slabs = torch.empty((chunks, k, r), dtype=torch.float32, device=u.device)
    rc = _kernels()[1](u.data_ptr(), g.data_ptr(), dw.data_ptr(),
                       slabs.data_ptr(), n, k, r, chunk, chunks,
                       _stream(u.device))
    if rc != 0:
        raise RuntimeError(f"hat_basis_dw launch failed: cudaError {rc}")
    hat_basis_dw.launches += 1
    return dw


table_lerp.launches = 0
hat_basis_dw.launches = 0
