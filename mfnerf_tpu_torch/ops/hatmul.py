"""Fused hat-basis CP product — the LowRank encoder's hot op.

Port of ``mfnerf_tpu/ops/hatmul.py::hat_prod``, forward and backward. Per
LowRank frame:

    a_d = B(u_d) @ W_d,    out = a_0 * a_1 * a_2          (N, R)

with B(u) the dense piecewise-linear hat basis (N, K), two nonzeros per row.
Its vector-Jacobian product, as ``_hat_cp_prod_bwd``
(``mfnerf_tpu/ops/lowrank.py``) and the Pallas backward compute it:

    g_d  = bf16(g * a_e * a_f)                e, f != d
    dW_d = B_d^T @ g_d                        (K, R)
    du_d = sum_k (g_d @ W_d^T)[k] * dhat_k
    dhat_k = -(K-1) sign(pos - k) where |pos - k| < 1, else 0

so du is exactly 0 on the knots (the hat's subgradient there).

:func:`hat_prod` is differentiable through :class:`HatProd`. On CUDA tensors
both directions launch the hand-written Hopper kernels of ``csrc/hatmul.cu``;
on CPU tensors they compute :func:`hat_prod_plain` and
:func:`hat_prod_bwd_plain`. Each takes the operand type ``dtype`` of the
JAX fused encoder's ``lr_matmul_dtype``: with "bfloat16" (the default)
all of them round the hat weights, ``W`` and ``g_d`` to bf16 and
accumulate in fp32; with "float32" they compute in fp32 end to end (the
kernels' fp32 instantiation), as the JAX ``_hat_cp_prod`` with ``mm_dtype``
float32 does.

Every function takes an optional ``count``, a one-element int64 tensor on
the operands' device: the valid count of a static buffer of N rows (the
trainer's capacity layout, ``models/rendering.py``). Rows at or past it
get a zero output, add nothing to dW and get du 0; the rows before it are
computed as without it, bit for bit, and dW's order stays a function of N.
"""
import ctypes
import functools

import torch

from .. import build


MATMUL_DTYPES = ("bfloat16", "float32")


def _bf16(x):
    """Round to bf16 and back: bf16 x bf16 products are exact in fp32, so
    rounding the operands and multiplying in fp32 is a bf16 matmul with fp32
    accumulation."""
    return x.to(torch.bfloat16).float()


def _operand(x, dtype):
    """``x`` as an operand of type ``dtype``, in fp32: rounded to bf16 for
    "bfloat16", unchanged for "float32"."""
    return _bf16(x) if dtype == "bfloat16" else x.to(torch.float32)


def _check_dtype(dtype):
    if dtype not in MATMUL_DTYPES:
        raise ValueError(f"dtype={dtype!r}: one of {MATMUL_DTYPES}")


def _pos_basis(u, k_res, ks, dtype="bfloat16"):
    """(pos - k, dense basis as ``dtype`` operands) of one axis: (N, K)
    each, fp32 positions."""
    diff = u[:, None].to(torch.float32) * (k_res - 1) - ks
    return diff, _operand(torch.clamp_min(1.0 - diff.abs(), 0.0), dtype)


def _rows_before(count, n, device):
    """(N, 1) bool: row < count (all rows when ``count`` is None)."""
    rows = torch.arange(n, device=device)[:, None]
    return rows < (n if count is None else count.reshape(()))


def hat_prod_plain(u3, w3, k_res, dtype="bfloat16", count=None):
    """Dense-basis form: basis @ W_d on ``dtype`` operands (bf16 or fp32),
    fp32 accumulation.

    Args:
        u3: (N, 3) float32 in [0, 1].
        w3: (3, K, R) float32 or bfloat16.
        k_res: number of knots K.
        dtype: the operand type, "bfloat16" or "float32".
        count: the valid count (module docstring), or None.
    Returns:
        (N, R) float32.
    """
    _check_dtype(dtype)
    ks = torch.arange(k_res, dtype=torch.float32, device=u3.device)
    prod = None
    for d in range(3):
        a = _pos_basis(u3[:, d], k_res, ks, dtype)[1] \
            @ _operand(w3[d], dtype)
        prod = a if prod is None else prod * a
    if count is not None:
        prod = torch.where(_rows_before(count, u3.shape[0], u3.device),
                           prod, 0.0)
    return prod


def hat_prod_bwd_plain(u3, w3, k_res, g, need_du=True, dtype="bfloat16",
                       count=None):
    """Dense-basis VJP of :func:`hat_prod_plain` — ``_hat_cp_prod_bwd``.

    Args:
        u3, w3, k_res, dtype: the forward's operands and operand type.
        g: (N, R) cotangent of the output.
        need_du: compute du (else None).
        count: the valid count (module docstring), or None.
    Returns:
        (du (N, 3) in u3's dtype or None, dW (3, K, R) in w3's dtype).
    """
    _check_dtype(dtype)
    ks = torch.arange(k_res, dtype=torch.float32, device=u3.device)
    w_op = [_operand(w3[d], dtype) for d in range(3)]
    a = [_pos_basis(u3[:, d], k_res, ks, dtype)[1] @ w_op[d]
         for d in range(3)]
    g = g.to(torch.float32)
    before = None
    if count is not None:
        before = _rows_before(count, u3.shape[0], u3.device)
        g = torch.where(before, g, 0.0)
    scale = float(k_res - 1)
    dw, du = [], []
    for d in range(3):
        e, f = (d + 1) % 3, (d + 2) % 3
        g_d = _operand(g * a[e] * a[f], dtype)                # (N, R)
        diff, basis = _pos_basis(u3[:, d], k_res, ks, dtype)  # rebuild
        dw.append(basis.T @ g_d)                              # (K, R)
        if need_du:
            db = g_d @ w_op[d].T                              # (N, K)
            dhat = torch.where(diff.abs() < 1.0, -torch.sign(diff) * scale,
                               0.0)
            du.append((db * dhat).sum(dim=1))
    du = torch.stack(du, dim=1).to(u3.dtype) if need_du else None
    if du is not None and before is not None:
        du = torch.where(before, du, 0.0)
    return du, torch.stack(dw).to(w3.dtype)


@functools.cache
def _kernels(dtype="bfloat16"):
    """The C entry points (forward, backward) of csrc/hatmul.cu for the
    operand type ``dtype`` (built on first use)."""
    lib = build.load_library("hatmul")
    suffix = "" if dtype == "bfloat16" else "_f32"
    fwd = getattr(lib, "hat_prod_fwd" + suffix)
    bwd = getattr(lib, "hat_prod_bwd" + suffix)
    fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p] * 2
    bwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] \
        + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


# The backward's stage 1 keeps a (3, K, 32) fp32 slab of dW in a block's
# shared memory, beside a 15,360-byte ring (bf16; fp32: 13,824 bytes, two
# steps of fp32 pairs): K <= 565 (569) fits Hopper's 227 KB a block.
BWD_MAX_K = {"bfloat16": 565, "float32": 569}
BWD_COLS = 32                  # columns a block of the backward
# Samples a chunk: at least BWD_MIN_CHUNK, and chunks enough for about
# BWD_BLOCKS blocks (two on each of an H100's 132 SMs). The order of dW's
# sums follows the chunks, so it is a function of N and R alone.
BWD_MIN_CHUNK, BWD_BLOCKS = 1024, 264


def bwd_chunking(n, r):
    """(chunk, chunks) of the backward's stage 1 for N samples, R columns."""
    tiles = -(-r // BWD_COLS)
    chunks = max(1, min(n // BWD_MIN_CHUNK, BWD_BLOCKS // tiles))
    return -(-n // chunks), chunks


def _g_in_place(g):
    """(g as fp32 rows the kernel reads in place, their stride in floats).
    A column slice of a wider fp32 tensor is read through its row stride;
    g is copied only when it is not fp32 or its rows are not 16-byte
    aligned."""
    g = g.to(torch.float32)
    ldg = g.stride(0) if g.shape[0] > 1 else g.shape[1]
    if g.stride(1) != 1 or ldg % 4 or g.data_ptr() % 16:
        g = g.contiguous()
        ldg = g.shape[1]
    return g, ldg


def _check_device(u3):
    if u3.device.type not in ("cpu", "cuda"):
        raise ValueError(f"hat_prod runs on cpu or cuda, not {u3.device}")


def _check_operands(u3, w3, k_res):
    """Shape, type and size checks shared by both kernels; (N, R)."""
    if u3.dtype != torch.float32 or u3.dim() != 2 or u3.shape[1] != 3:
        raise ValueError(f"u3 must be (N, 3) float32, got {tuple(u3.shape)} "
                         f"{u3.dtype}")
    if w3.dim() != 3 or w3.shape[0] != 3 or w3.shape[1] != k_res:
        raise ValueError(f"w3 must be (3, {k_res}, R), got {tuple(w3.shape)}")
    n, r = u3.shape[0], w3.shape[2]
    if k_res < 2 or r % 8:
        raise ValueError(f"need K >= 2 and R % 8 == 0, got K={k_res} R={r}")
    if w3.device != u3.device:
        raise ValueError(f"u3 on {u3.device} but w3 on {w3.device}")
    if n >= 2 ** 31:
        raise ValueError(f"N = {n} exceeds the kernel's int32 sample index")
    return n, r


def _count_ptr(count, device):
    """The valid count's device pointer (None for no count), after checking
    it is one int64 on ``device``."""
    if count is None:
        return None
    if count.dtype != torch.int64 or count.numel() != 1 \
            or count.device != device:
        raise ValueError(f"count must be one int64 on {device}, got "
                         f"{tuple(count.shape)} {count.dtype} on "
                         f"{count.device}")
    return count.contiguous().data_ptr()


def _check_aligned(*tensors):
    for t in tensors:                # 16-byte row loads and stores
        if t.data_ptr() % 16:
            raise ValueError("hat_prod needs 16-byte aligned buffers")


def _stream(device):
    with torch.cuda.device(device):
        return torch.cuda.current_stream().cuda_stream


def _w_operand(w3, dtype):
    """W as the kernels read it: contiguous bf16 or fp32."""
    return w3.detach().to(getattr(torch, dtype)).contiguous()


def _launch(u3, w3, k_res, dtype="bfloat16", count=None):
    n, r = _check_operands(u3, w3, k_res)
    n_valid = _count_ptr(count, u3.device)
    u3 = u3.contiguous()
    w_op = _w_operand(w3, dtype)
    out = torch.empty((n, r), dtype=torch.float32, device=u3.device)
    if n == 0:
        return out
    _check_aligned(w_op, out)
    rc = _kernels(dtype)[0](u3.data_ptr(), w_op.data_ptr(), out.data_ptr(),
                            n, k_res, r, n_valid, _stream(u3.device))
    if rc != 0:
        raise RuntimeError(f"hat_prod_fwd launch failed: cudaError {rc}")
    hat_prod.launches += 1
    return out


def _launch_bwd(u3, w3, k_res, g, need_du, dtype="bfloat16", count=None):
    n, r = _check_operands(u3, w3, k_res)
    n_valid = _count_ptr(count, u3.device)
    if g.shape != (n, r) or g.device != u3.device:
        raise ValueError(f"g must be ({n}, {r}) on {u3.device}, got "
                         f"{tuple(g.shape)} on {g.device}")
    if k_res > BWD_MAX_K[dtype]:
        raise ValueError(f"K = {k_res} exceeds the backward's shared-memory "
                         f"slab (K <= {BWD_MAX_K[dtype]} for {dtype})")
    u3 = u3.contiguous()
    w_op = _w_operand(w3, dtype)
    g, ldg = _g_in_place(g)
    dev = u3.device
    if n == 0:
        du = torch.zeros((0, 3), dtype=torch.float32, device=dev)
        return (du if need_du else None), torch.zeros_like(w3)
    chunk, chunks = bwd_chunking(n, r)
    dw = torch.empty((3, k_res, r), dtype=torch.float32, device=dev)
    slabs = torch.empty((chunks, 3, k_res, r), dtype=torch.float32,
                        device=dev)
    du = part = None
    if need_du:
        du = torch.empty((n, 3), dtype=torch.float32, device=dev)
        part = torch.empty((-(-r // BWD_COLS), n, 3), dtype=torch.float32,
                           device=dev)
    rc = _kernels(dtype)[1](u3.data_ptr(), w_op.data_ptr(), g.data_ptr(),
                            ldg,
                       None if du is None else du.data_ptr(), dw.data_ptr(),
                       slabs.data_ptr(),
                       None if part is None else part.data_ptr(),
                       n, k_res, r, chunk, chunks, n_valid, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"hat_prod_bwd launch failed: cudaError {rc}")
    hat_prod_bwd.launches += 1
    return du, dw.to(w3.dtype)


class HatProd(torch.autograd.Function):
    """:func:`hat_prod` with its exact VJP. Saves ``(u3, w3)`` only: the
    backward recomputes ``a_d`` from them, as the Pallas backward does."""

    @staticmethod
    def forward(ctx, u3, w3, k_res, dtype="bfloat16", count=None):
        ctx.save_for_backward(u3, w3, count)
        ctx.k_res, ctx.dtype = k_res, dtype
        if u3.device.type == "cpu":
            return hat_prod_plain(u3, w3, k_res, dtype, count)
        return _launch(u3, w3, k_res, dtype=dtype, count=count)

    @staticmethod
    def backward(ctx, g):
        u3, w3, count = ctx.saved_tensors
        counted = {} if count is None else {"count": count}
        du, dw = hat_prod_bwd(u3, w3, ctx.k_res, g,
                              need_du=ctx.needs_input_grad[0],
                              dtype=ctx.dtype, **counted)
        return du, dw, None, None, None


def hat_prod(u3, w3, k_res, dtype="bfloat16", count=None):
    """prod_d B_K(u3[:, d]) @ w3[d] -> (N, R) float32, differentiable in
    ``u3`` and ``w3``, on ``dtype`` operands ("bfloat16" or "float32");
    with ``count`` (module docstring) rows at or past it are zero and get
    no gradient.

    CUDA tensors run the kernels (``csrc/hatmul.cu``, the instantiation for
    ``dtype``); CPU tensors run the plain versions. ``hat_prod.launches``
    counts forward kernel launches of either type.
    """
    _check_device(u3)
    _check_dtype(dtype)
    return HatProd.apply(u3, w3, k_res, dtype, count)


def hat_prod_bwd(u3, w3, k_res, g, need_du=True, dtype="bfloat16",
                 count=None):
    """(du, dW) of :func:`hat_prod` for the output cotangent ``g`` (N, R).

    CUDA tensors run the backward kernel, whose dW is bitwise the same on
    every launch; an fp32 ``g`` with 16-byte aligned rows, such as a column
    slice of a wider feature gradient, is read in place through its row
    stride. CPU tensors run :func:`hat_prod_bwd_plain`.
    ``hat_prod_bwd.launches`` counts kernel launches (both stages are one).
    du is None unless ``need_du``. ``dtype``: the forward's operand type;
    ``count``: the valid count (module docstring), or None.
    """
    _check_device(u3)
    _check_dtype(dtype)
    if u3.device.type == "cpu":
        return hat_prod_bwd_plain(u3, w3, k_res, g, need_du, dtype, count)
    return _launch_bwd(u3, w3, k_res, g, need_du, dtype=dtype, count=count)


hat_prod.launches = 0
hat_prod_bwd.launches = 0
