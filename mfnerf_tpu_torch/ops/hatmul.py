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
:func:`hat_prod_bwd_plain`. All of them round the hat weights, ``W`` and
``g_d`` to bf16 and accumulate in fp32, as the JAX fused encoder does
(``lr_matmul_dtype="bfloat16"``).
"""
import ctypes
import functools

import torch

from .. import build


def _bf16(x):
    """Round to bf16 and back: bf16 x bf16 products are exact in fp32, so
    rounding the operands and multiplying in fp32 is a bf16 matmul with fp32
    accumulation."""
    return x.to(torch.bfloat16).float()


def _pos_basis(u, k_res, ks):
    """(pos - k, bf16 dense basis) of one axis: (N, K) each, fp32 positions."""
    diff = u[:, None].to(torch.float32) * (k_res - 1) - ks
    return diff, _bf16(torch.clamp_min(1.0 - diff.abs(), 0.0))


def hat_prod_plain(u3, w3, k_res):
    """Dense-basis form: bf16 basis @ bf16 W_d, fp32 accumulation.

    Args:
        u3: (N, 3) float32 in [0, 1].
        w3: (3, K, R) float32 or bfloat16.
        k_res: number of knots K.
    Returns:
        (N, R) float32.
    """
    ks = torch.arange(k_res, dtype=torch.float32, device=u3.device)
    prod = None
    for d in range(3):
        a = _pos_basis(u3[:, d], k_res, ks)[1] @ _bf16(w3[d])
        prod = a if prod is None else prod * a
    return prod


def hat_prod_bwd_plain(u3, w3, k_res, g, need_du=True):
    """Dense-basis VJP of :func:`hat_prod_plain` — ``_hat_cp_prod_bwd``.

    Args:
        u3, w3, k_res: the forward's operands.
        g: (N, R) cotangent of the output.
        need_du: compute du (else None).
    Returns:
        (du (N, 3) in u3's dtype or None, dW (3, K, R) in w3's dtype).
    """
    ks = torch.arange(k_res, dtype=torch.float32, device=u3.device)
    w_bf = [_bf16(w3[d]) for d in range(3)]
    a = [_pos_basis(u3[:, d], k_res, ks)[1] @ w_bf[d] for d in range(3)]
    g = g.to(torch.float32)
    scale = float(k_res - 1)
    dw, du = [], []
    for d in range(3):
        e, f = (d + 1) % 3, (d + 2) % 3
        g_d = _bf16(g * a[e] * a[f])                          # (N, R)
        diff, basis = _pos_basis(u3[:, d], k_res, ks)         # rebuild
        dw.append(basis.T @ g_d)                              # (K, R)
        if need_du:
            db = g_d @ w_bf[d].T                              # (N, K)
            dhat = torch.where(diff.abs() < 1.0, -torch.sign(diff) * scale,
                               0.0)
            du.append((db * dhat).sum(dim=1))
    du = torch.stack(du, dim=1).to(u3.dtype) if need_du else None
    return du, torch.stack(dw).to(w3.dtype)


@functools.cache
def _kernels():
    """The C entry points of csrc/hatmul.cu (built on first use)."""
    lib = build.load_library("hatmul")
    fwd, bwd = lib.hat_prod_fwd, lib.hat_prod_bwd
    fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


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


def _check_aligned(*tensors):
    for t in tensors:                # 16-byte row loads, stores and atomics
        if t.data_ptr() % 16:
            raise ValueError("hat_prod needs 16-byte aligned buffers")


def _stream(device):
    with torch.cuda.device(device):
        return torch.cuda.current_stream().cuda_stream


def _launch(u3, w3, k_res):
    n, r = _check_operands(u3, w3, k_res)
    u3 = u3.contiguous()
    w_bf = w3.detach().to(torch.bfloat16).contiguous()
    out = torch.empty((n, r), dtype=torch.float32, device=u3.device)
    if n == 0:
        return out
    _check_aligned(w_bf, out)
    rc = _kernels()[0](u3.data_ptr(), w_bf.data_ptr(), out.data_ptr(), n,
                       k_res, r, _stream(u3.device))
    if rc != 0:
        raise RuntimeError(f"hat_prod_fwd launch failed: cudaError {rc}")
    hat_prod.launches += 1
    return out


def _launch_bwd(u3, w3, k_res, g, need_du):
    n, r = _check_operands(u3, w3, k_res)
    if g.shape != (n, r) or g.device != u3.device:
        raise ValueError(f"g must be ({n}, {r}) on {u3.device}, got "
                         f"{tuple(g.shape)} on {g.device}")
    if r > 2048:
        raise ValueError(f"R = {r} exceeds the backward's 256 threads a "
                         f"sample (R <= 2048)")
    u3 = u3.contiguous()
    w_bf = w3.detach().to(torch.bfloat16).contiguous()
    g = g.to(torch.float32).contiguous()
    dw = torch.zeros((3, k_res, r), dtype=torch.float32, device=u3.device)
    du = (torch.empty((n, 3), dtype=torch.float32, device=u3.device)
          if need_du else None)
    if n == 0:
        return du, dw.to(w3.dtype)
    _check_aligned(w_bf, g, dw)
    rc = _kernels()[1](u3.data_ptr(), w_bf.data_ptr(), g.data_ptr(),
                       None if du is None else du.data_ptr(), dw.data_ptr(),
                       n, k_res, r, _stream(u3.device))
    if rc != 0:
        raise RuntimeError(f"hat_prod_bwd launch failed: cudaError {rc}")
    hat_prod_bwd.launches += 1
    return du, dw.to(w3.dtype)


class HatProd(torch.autograd.Function):
    """:func:`hat_prod` with its exact VJP. Saves ``(u3, w3)`` only: the
    backward recomputes ``a_d`` from them, as the Pallas backward does."""

    @staticmethod
    def forward(ctx, u3, w3, k_res):
        ctx.save_for_backward(u3, w3)
        ctx.k_res = k_res
        if u3.device.type == "cpu":
            return hat_prod_plain(u3, w3, k_res)
        return _launch(u3, w3, k_res)

    @staticmethod
    def backward(ctx, g):
        u3, w3 = ctx.saved_tensors
        du, dw = hat_prod_bwd(u3, w3, ctx.k_res, g,
                              need_du=ctx.needs_input_grad[0])
        return du, dw, None


def hat_prod(u3, w3, k_res):
    """prod_d B_K(u3[:, d]) @ w3[d] -> (N, R) float32, differentiable in
    ``u3`` and ``w3``.

    CUDA tensors run the kernels (``csrc/hatmul.cu``); CPU tensors run the
    plain versions. ``hat_prod.launches`` counts forward kernel launches.
    """
    _check_device(u3)
    return HatProd.apply(u3, w3, k_res)


def hat_prod_bwd(u3, w3, k_res, g, need_du=True):
    """(du, dW) of :func:`hat_prod` for the output cotangent ``g`` (N, R).

    CUDA tensors run the backward kernel; CPU tensors run
    :func:`hat_prod_bwd_plain`. ``hat_prod_bwd.launches`` counts kernel
    launches. du is None unless ``need_du``.
    """
    _check_device(u3)
    if u3.device.type == "cpu":
        return hat_prod_bwd_plain(u3, w3, k_res, g, need_du)
    return _launch_bwd(u3, w3, k_res, g, need_du)


hat_prod.launches = 0
hat_prod_bwd.launches = 0
