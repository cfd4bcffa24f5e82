"""Fused hat-basis CP product — the LowRank encoder's hot op.

Port of ``mfnerf_tpu/ops/hatmul.py::hat_prod`` (forward). Per LowRank frame:

    a_d = B(u_d) @ W_d,    out = a_0 * a_1 * a_2          (N, R)

with B(u) the dense piecewise-linear hat basis (N, K), two nonzeros per row.

:func:`hat_prod` launches the hand-written Hopper kernel
``csrc/hatmul.cu`` on CUDA tensors and computes :func:`hat_prod_plain` on
CPU tensors. Both round the hat weights and ``W`` to bf16 and accumulate in
fp32, as the JAX fused encoder does (``lr_matmul_dtype="bfloat16"``).
"""
import ctypes
import functools

import torch

from .. import build


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
        pos = u3[:, d, None].to(torch.float32) * (k_res - 1)
        basis = torch.clamp_min(1.0 - (pos - ks).abs(), 0.0)
        # bf16 x bf16 products are exact in fp32, so rounding the operands
        # and multiplying in fp32 is a bf16 matmul with fp32 accumulation
        w = w3[d].to(torch.bfloat16).float()
        a = basis.to(torch.bfloat16).float() @ w
        prod = a if prod is None else prod * a
    return prod


@functools.cache
def _kernel():
    """The C entry point of csrc/hatmul.cu (built on first use)."""
    fn = build.load_library("hatmul").hat_prod_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(u3, w3, k_res):
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
    u3 = u3.contiguous()
    w_bf = w3.to(torch.bfloat16).contiguous()
    out = torch.empty((n, r), dtype=torch.float32, device=u3.device)
    if n == 0:
        return out
    for t in (w_bf, out):            # 16-byte row loads and stores
        if t.data_ptr() % 16:
            raise ValueError("hat_prod needs 16-byte aligned buffers")
    with torch.cuda.device(u3.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(u3.data_ptr(), w_bf.data_ptr(), out.data_ptr(), n,
                       k_res, r, stream)
    if rc != 0:
        raise RuntimeError(f"hat_prod_fwd launch failed: cudaError {rc}")
    hat_prod.launches += 1
    return out


def hat_prod(u3, w3, k_res):
    """prod_d B_K(u3[:, d]) @ w3[d] -> (N, R) float32.

    CUDA tensors run the kernel (``csrc/hatmul.cu``); CPU tensors run
    :func:`hat_prod_plain`. ``hat_prod.launches`` counts kernel launches.
    """
    if u3.device.type == "cpu":
        return hat_prod_plain(u3, w3, k_res)
    if u3.device.type != "cuda":
        raise ValueError(f"hat_prod runs on cpu or cuda, not {u3.device}")
    return _launch(u3, w3, k_res)


hat_prod.launches = 0
