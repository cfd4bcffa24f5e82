"""Low-rank (CP) multiresolution encoding.

Port of ``mfnerf_tpu/ops/lowrank.py``:

    phi(x) = W · concat_{m,l} [ prod_d ( B_l((R_m x)_d) @ T[m,l,d] ) ]

a CP factorisation per resolution level l, evaluated in M rotated frames,
with B_l the dense piecewise-linear hat basis of K_l knots.

With ``fused`` (nested levels, (K_max-1) % (K_l-1) == 0) every level folds
exactly onto the finest basis (:func:`_prolongation`), so each frame is one
hat-CP product ``(N, 3) x (3, K_max, L*rank)`` — :func:`hatmul.hat_prod`,
the hand-written CUDA kernel on the card, on bf16 or (``matmul_dtype``)
fp32 operands. Feature order: frame-major, then
level-major columns of ``rank`` each, as in the JAX package.
"""
import dataclasses
import functools
import math
from typing import Tuple

import numpy as np
import torch

from .hatmul import hat_prod


@dataclasses.dataclass(frozen=True)
class LowRankConfig:
    levels: Tuple[int, ...] = (32, 48, 72, 108, 162, 243, 364, 512)
    rank: int = 16
    n_frames: int = 2
    out_dim: int = 32
    # nested levels evaluated as one hat-CP product per frame, on
    # matmul_dtype operands ("bfloat16", the JAX lr_matmul_dtype default,
    # or "float32") with fp32 accumulation
    fused: bool = False
    matmul_dtype: str = "bfloat16"

    @staticmethod
    def create(n_levels=8, k_min=32, k_max=512, rank=16, n_frames=2,
               out_dim=32, fused=False, matmul_dtype="bfloat16"
               ) -> "LowRankConfig":
        if fused:
            # nested ladder: K-1 halves per level down from the finest;
            # k_max is rounded up to 2^m + 1 so every level divides exactly
            base = 1 << max(n_levels - 1,
                            math.ceil(math.log2(max(k_max - 1, 2))))
            ks = tuple(base // (1 << i) + 1
                       for i in reversed(range(n_levels)))
        elif n_levels == 1:
            ks = (k_max,)
        else:
            b = (k_max / k_min) ** (1.0 / (n_levels - 1))
            ks = tuple(int(round(k_min * b ** i)) for i in range(n_levels))
        return LowRankConfig(levels=ks, rank=rank, n_frames=n_frames,
                             out_dim=out_dim, fused=fused,
                             matmul_dtype=matmul_dtype)

    @property
    def n_components(self) -> int:
        return len(self.levels) * self.n_frames * self.rank


def _frame_rotations(n_frames: int) -> np.ndarray:
    """Fixed rotations (M, 3, 3); frame 0 is identity, the rest are the QR of
    seeded Gaussians — the JAX package's exact numpy draw."""
    rots = [np.eye(3, dtype=np.float32)]
    rng = np.random.default_rng(12345)
    while len(rots) < n_frames:
        q, r = np.linalg.qr(rng.normal(size=(3, 3)))
        q = q * np.sign(np.diag(r))
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        rots.append(q.astype(np.float32))
    return np.stack(rots)


def init_lowrank_params(cfg: LowRankConfig,
                        generator: torch.Generator) -> dict:
    """Line tables T[m][l][d] (K_l, rank) ~ 1{d=0} + N(0, 0.3), and the
    He-uniform projection (n_components, out_dim) — the JAX init law."""
    lines = []
    for _ in range(cfg.n_frames):
        per_level = []
        for k_res in cfg.levels:
            axes = []
            for d in range(3):
                t = 0.3 * torch.randn((k_res, cfg.rank),
                                      generator=generator)
                if d == 0:
                    t = t + 1.0
                axes.append(t)
            per_level.append(axes)
        lines.append(per_level)
    bound = math.sqrt(6.0 / cfg.n_components)
    proj = torch.rand((cfg.n_components, cfg.out_dim),
                      generator=generator) * (2 * bound) - bound
    return {"lines": lines, "proj": proj}


def _hat_basis(u, k_res):
    """(N,) in [0,1] -> (N, K) dense hat basis, max(0, 1 - |u(K-1) - k|)."""
    pos = u[:, None] * (k_res - 1)
    ks = torch.arange(k_res, dtype=torch.float32, device=u.device)[None, :]
    return torch.clamp_min(1.0 - (pos - ks).abs(), 0.0)


def _prolongation(k_fine: int, k_coarse: int) -> np.ndarray:
    """(K_fine, K_coarse) P with B_Kc(u) == B_Kf(u) @ P exactly (nested
    piecewise-linear bases): P[i, j] = coarse hat j at fine knot i."""
    assert (k_fine - 1) % (k_coarse - 1) == 0, (k_fine, k_coarse)
    r = (k_fine - 1) // (k_coarse - 1)
    i = np.arange(k_fine, dtype=np.float64)[:, None] / r
    j = np.arange(k_coarse, dtype=np.float64)[None, :]
    return np.maximum(0.0, 1.0 - np.abs(i - j)).astype(np.float32)


@functools.cache
def _prolongation_on(k_fine: int, k_coarse: int, device) -> torch.Tensor:
    """:func:`_prolongation` as a tensor on ``device``, made once: a field
    call would otherwise copy it from the host each time."""
    return torch.from_numpy(_prolongation(k_fine, k_coarse)).to(device)


@functools.cache
def _rotations_on(n_frames: int, device) -> torch.Tensor:
    """:func:`_frame_rotations` as a tensor on ``device``, made once."""
    return torch.from_numpy(_frame_rotations(n_frames)).to(device)


def _frame_coords(xf, rots, m):
    """Sample coords in frame m: rotated about the domain centre, rescaled
    into [0, 1] and clipped."""
    if m == 0:
        u3 = xf
    else:
        u3 = (xf - 0.5) @ rots[m].T / 1.7320508 + 0.5
    return torch.clamp(u3, 0.0, 1.0)


def fold_frame(params: dict, cfg: LowRankConfig, m: int) -> torch.Tensor:
    """Frame m's line tables folded onto the finest knots: (3, K_max, L*R)
    with level-major columns."""
    k_max = cfg.levels[-1]
    lines = params["lines"][m]
    prols = [_prolongation_on(k_max, k, lines[0][0].device)
             for k in cfg.levels]
    return torch.stack([
        torch.cat([p @ lines[li][d] for li, p in enumerate(prols)], dim=1)
        for d in range(3)])


def matmul_f32(a, b, dtype):
    """a @ b in fp32, or with ``dtype`` bfloat16 on bf16-rounded operands
    with fp32 sums and result (the JAX ``preferred_element_type=float32``;
    the MLPs' last layers use it too): a product of two bf16 values is
    exact in fp32.
    Autograd rounds the operands' gradients to bf16, as the transpose of the
    JAX package's cast does."""
    if dtype == torch.float32:
        return a @ b
    return a.to(dtype).float() @ b.to(dtype).float()


def lowrank_encode(params: dict, x: torch.Tensor, cfg: LowRankConfig,
                   dtype=torch.float32, count=None) -> torch.Tensor:
    """Encode positions x (N, 3) in [0, 1] -> (N, out_dim) float32.

    Fused: one :func:`hat_prod` per frame (the CUDA kernel on the card) on
    ``cfg.matmul_dtype`` operands, whatever ``dtype`` is. Unfused: per-level
    dense hat-basis
    matmuls. ``dtype`` (``NGPConfig.compute_dtype``) is the operand type of
    the unfused matmuls and of the output projection, which sum in fp32, as
    the JAX ``lowrank_encode(dtype=)``. ``count``: the valid count of a
    static buffer (``hatmul``'s module docstring), which the fused encoder's
    kernels take; the unfused matmuls evaluate every row.
    """
    rots = _rotations_on(cfg.n_frames, x.device)
    xf = x.to(torch.float32)
    feats = []
    for m in range(cfg.n_frames):
        u3 = _frame_coords(xf, rots, m)
        if cfg.fused:
            feats.append(hat_prod(u3, fold_frame(params, cfg, m),
                                  cfg.levels[-1], cfg.matmul_dtype, count))
            continue
        for li, k_res in enumerate(cfg.levels):
            prod = None
            for d in range(3):
                a = matmul_f32(_hat_basis(u3[:, d], k_res),
                               params["lines"][m][li][d], dtype)
                prod = a if prod is None else prod * a
            feats.append(prod)
    return matmul_f32(torch.cat(feats, dim=1), params["proj"], dtype)
