"""Multiresolution hash-grid encoding (Hash / Window / MixedFeature).

Port of ``mfnerf_tpu/ops/hashgrid.py``. L levels of resolution
``N_min * b**level``, F features per level, trilinear interpolation of the
8 corner rows of a level's cell. A level whose dense grid fits the table is
indexed directly; a larger one hashes its corners with the Instant-NGP XOR
primes. ``MixedFeature`` stores the L levels in ``N_tables`` shared tables
(hashed levels of one table decorrelated by a per-level salt); ``Window``
multiplies each level by a coarse-to-fine weight (:func:`window_weights`).

:func:`hashgrid_encode` is differentiable through :class:`HashGridEncode`,
whose backward is the JAX custom VJP (``_encode_bwd``), not autograd of the
forward: the table gradient scatters ``w_c * g`` to the 8 corner rows, or,
with ``grad_noise`` and ``grad_corners < 8``, the unweighted ``g / m`` to
``m`` corners drawn by trilinear weight. On CUDA tensors both directions
launch the hand-written kernels of ``csrc/hashgrid.cu``, whose table
gradient is bitwise the same on every launch; on CPU tensors they compute
:func:`hashgrid_encode_plain` and :func:`hashgrid_bwd_plain`, which repeat
the JAX functions operation for operation. :func:`hashgrid_bwd_fixed_plain`
models the backward kernel's fixed-point table gradient bit for bit.

Torch has no wrapping uint32 multiply, so corner rows are hashed in int64:
a product or XOR of int64 values has the same low 32 bits as its uint32
counterpart, and the row keeps only the low ``log2_T`` bits.
"""
import ctypes
import dataclasses
import functools
import math
from typing import Tuple

import numpy as np
import torch

from .. import build

# spatial-hash primes from the Instant-NGP paper (Eq. 4 of arXiv 2201.05989)
_PRIMES = (1, 2654435761, 805459861)
# per-level salt prime for levels sharing a MixedFeature table
_LEVEL_SALT_PRIME = 3674653429


@dataclasses.dataclass(frozen=True)
class LevelSpec:
    scale: float          # grid scale s: pos = x*s + 0.5
    res: int              # corner resolution = ceil(scale) + 1
    offset: int           # start row of this level's storage in the table
    size: int             # number of rows addressable by this level
    dense: bool           # dense (direct) indexing vs spatial hash
    salt: int             # hash salt (0 unless sharing a table)


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    """Static encoding configuration, as ``mfnerf_tpu``'s: the same fields,
    layout and ``create``."""
    L: int = 16
    F: int = 2
    log2_T: int = 19
    N_min: int = 16
    b: float = 1.3819128800392336  # exp(ln(2048*0.5/16)/15), the Lego default
    grid_type: str = "Hash"        # Hash | MixedFeature | Window
    N_tables: int = 1
    levels: Tuple[LevelSpec, ...] = ()
    n_params: int = 0
    # corners (of 8) that receive the table gradient's scatter-adds, drawn
    # by trilinear weight when the encoder is given grad_noise; 8 = exact
    grad_corners: int = 8

    @staticmethod
    def create(L=16, F=2, log2_T=19, N_min=16, b=1.3819128800392336,
               grid_type="Hash", N_tables=1,
               grad_corners=8) -> "HashGridConfig":
        if grid_type not in ("Hash", "Window", "MixedFeature"):
            raise ValueError(f"unknown grid type {grid_type!r}")
        hashmap_size = 1 << log2_T

        def level(lvl):
            scale = N_min * (b ** lvl) - 1.0
            return scale, int(math.ceil(scale)) + 1

        specs = []
        if grid_type in ("Hash", "Window") or N_tables <= 0:
            # one (logical) table per level, as in Instant-NGP / tcnn
            offset = 0
            for lvl in range(L):
                scale, res = level(lvl)
                dense_size = res ** 3
                if dense_size <= hashmap_size:
                    size = -(-dense_size // 8) * 8  # align to 8 rows
                    dense = True
                else:
                    size = hashmap_size
                    dense = False
                specs.append(LevelSpec(scale, res, offset, size, dense, 0))
                offset += size
        else:
            # MixedFeature: group the L levels into N_tables shared tables
            levels_per_table = -(-L // N_tables)
            offset = 0
            specs = [None] * L
            for t in range(N_tables):
                group = range(t * levels_per_table,
                              min((t + 1) * levels_per_table, L))
                sizes = [-(-level(lvl)[1] ** 3 // 8) * 8 for lvl in group]
                if sum(sizes) <= hashmap_size:
                    # pack the dense levels at the front of the shared table
                    sub = 0
                    for lvl, sz in zip(group, sizes):
                        specs[lvl] = LevelSpec(*level(lvl), offset + sub, sz,
                                               True, 0)
                        sub += sz
                    table_size = sub
                else:
                    table_size = hashmap_size
                    for j, lvl in enumerate(group):
                        salt = (j * _LEVEL_SALT_PRIME) & 0xFFFFFFFF
                        specs[lvl] = LevelSpec(*level(lvl), offset,
                                               hashmap_size, False, salt)
                offset += table_size
        return HashGridConfig(L=L, F=F, log2_T=log2_T, N_min=N_min, b=b,
                              grid_type=grid_type, N_tables=N_tables,
                              levels=tuple(specs), n_params=offset,
                              grad_corners=grad_corners)

    @property
    def out_dim(self) -> int:
        return self.L * self.F


def init_hashgrid_params(cfg: HashGridConfig, generator: torch.Generator,
                         dtype=torch.float32) -> torch.Tensor:
    """(n_params, F) table, U(-1e-4, 1e-4) (tcnn's hash-table init)."""
    u = torch.rand((cfg.n_params, cfg.F), generator=generator, dtype=dtype)
    return u * 2e-4 - 1e-4


def window_weights(cfg: HashGridConfig, alpha: float = 1.0,
                   device="cpu") -> torch.Tensor:
    """Coarse-to-fine level window of the Window grid type: levels below
    alpha*L on, one transition level on a raised cosine, finer levels off.
    alpha = 1 is the identity (== Hash)."""
    ls = torch.arange(cfg.L, dtype=torch.float32, device=device)
    t = torch.clamp(alpha * cfg.L - ls, 0.0, 1.0)
    return 0.5 * (1.0 - torch.cos(math.pi * t))


# ------------------------------------------------------------ plain versions
@functools.cache
def _level_arrays(cfg: HashGridConfig, device: torch.device):
    """(scale f32, res, offset, size, salt int64, dense bool), each (L,)."""
    lv = cfg.levels
    col = [torch.tensor([getattr(m, k) for m in lv], dtype=torch.int64,
                        device=device)
           for k in ("res", "offset", "size", "salt")]
    scale = torch.tensor(np.array([m.scale for m in lv], np.float32),
                         device=device)
    dense = torch.tensor([m.dense for m in lv], device=device)
    return (scale, *col, dense)


def _corner_index(corner, res, offset, size, salt, dense):
    """Global table row (L, M) of integer corner coords (L, M, 3) >= 0."""
    res = res[:, None]
    # the clamp only acts on the box face x == 1.0
    c = torch.minimum(corner, (res - 1)[..., None])
    dense_idx = c[..., 0] + c[..., 1] * res + c[..., 2] * res * res
    h = (c[..., 0] * _PRIMES[0] ^ c[..., 1] * _PRIMES[1]
         ^ c[..., 2] * _PRIMES[2] ^ salt[:, None])
    hash_idx = h & (size - 1)[:, None]
    return torch.where(dense[:, None], dense_idx, hash_idx) + offset[:, None]


def _cells(x, cfg):
    """Level arrays, and each level's cell of x: base (L, N, 3) int64 and
    frac (L, N, 3) fp32, with pos = x * scale + 0.5 unfused."""
    arrays = _level_arrays(cfg, x.device)
    pos = x.to(torch.float32)[None, :, :] * arrays[0][:, None, None] + 0.5
    base = torch.floor(pos)
    return arrays, base.to(torch.int64), pos - base


_BITS = [(c & 1, (c >> 1) & 1, (c >> 2) & 1) for c in range(8)]


def _corner(c, base, frac, arrays):
    """(rows (L, N), weights (L, N), per-axis weights (L, N, 3), bits) of
    corner c."""
    bits = torch.tensor(_BITS[c], device=base.device)
    wb = torch.where(bits.to(torch.bool), frac, 1.0 - frac)
    w = wb[..., 0] * wb[..., 1] * wb[..., 2]
    return _corner_index(base + bits, *arrays[1:]), w, wb, bits


def _before(count, n, device):
    """(N,) bool: row < count (:func:`hashgrid_encode`'s ``count``)."""
    return torch.arange(n, device=device) < count.reshape(())


def hashgrid_encode_plain(params, x, cfg: HashGridConfig, window=None,
                          count=None):
    """(N, 3) in [0, 1] -> (N, L*F) fp32, level-major: ``_fwd_impl``; with
    ``count`` the rows at or past it are zero."""
    arrays, base, frac = _cells(x, cfg)
    n = x.shape[0]
    out = torch.zeros((cfg.L, n, cfg.F), dtype=torch.float32,
                      device=x.device)
    for c in range(8):
        idx, w, _, _ = _corner(c, base, frac, arrays)
        out = out + w[..., None] * params[idx].to(torch.float32)
    if window is not None:
        out = out * window[:, None, None]
    out = out.transpose(0, 1).reshape(n, cfg.L * cfg.F)
    if count is not None:
        out = torch.where(_before(count, n, x.device)[:, None], out, 0.0)
    return out


def hashgrid_bwd_plain(params, x, cfg: HashGridConfig, g, window=None,
                       grad_noise=None, need_dx=True, count=None):
    """The VJP of :func:`hashgrid_encode_plain`: ``_encode_bwd``.

    Args:
        g: (N, L*F) cotangent of the output.
        window: the forward's (L,) window, or None.
        grad_noise: (N, cfg.grad_corners) uniforms in [0, 1): with
            ``grad_corners < 8`` the table gradient scatters the unweighted
            ``g / m`` to m corners drawn by weight (inverse CDF); else exact.
        need_dx: compute d_x (else None).
        count: the valid count (:func:`hashgrid_encode`), or None: the
            rows at or past it add nothing and get d_x 0.
    Returns:
        (d_params like params, d_x (N, 3) in x's dtype or None, d_window
        (L,) or None when window is None).
    """
    if count is not None:
        g = torch.where(_before(count, x.shape[0], x.device)[:, None], g,
                        0.0)
    arrays, base, frac = _cells(x, cfg)
    scale = arrays[0]
    n, nl, nf = x.shape[0], cfg.L, cfg.F
    gl = g.to(torch.float32).reshape(n, nl, nf).transpose(0, 1)  # (L, N, F)
    gl_tab = gl if window is None else gl * window[:, None, None]
    d_params = torch.zeros(params.shape, dtype=torch.float32,
                           device=params.device)
    d_x = torch.zeros((n, 3), dtype=torch.float32, device=x.device)
    stochastic = grad_noise is not None and cfg.grad_corners < 8
    ws = []
    for c in range(8):
        idx, w, wb, bits = _corner(c, base, frac, arrays)
        if stochastic:
            ws.append(w)
        else:
            d_params.index_add_(0, idx.reshape(-1),
                                (w[..., None] * gl_tab).reshape(-1, nf))
        if need_dx:
            gdot = (params[idx].to(torch.float32) * gl_tab).sum(-1)  # (L, N)
            sgn = torch.where(bits.to(torch.bool), 1.0, -1.0)
            dw = torch.stack([sgn[0] * wb[..., 1] * wb[..., 2],
                              sgn[1] * wb[..., 0] * wb[..., 2],
                              sgn[2] * wb[..., 0] * wb[..., 1]], dim=-1)
            d_x = d_x + ((gdot[..., None] * dw)
                         * scale[:, None, None]).sum(0)
    if stochastic:
        m = cfg.grad_corners
        cumw = torch.cumsum(torch.stack(ws), dim=0)             # (8, L, N)
        u = grad_noise.to(torch.float32).T                      # (m, N)
        cstar = torch.clamp_max(
            (cumw[None] < u[:, None, None, :]).sum(1), 7)       # (m, L, N)
        bits = torch.stack([cstar & 1, (cstar >> 1) & 1, (cstar >> 2) & 1],
                           dim=-1)                              # (m, L, N, 3)
        corner = (base[None] + bits).transpose(0, 1)           # (L, m, N, 3)
        idx_s = _corner_index(corner.reshape(nl, m * n, 3), *arrays[1:])
        upd = (gl_tab[:, None] / m).expand(nl, m, n, nf).reshape(-1, nf)
        d_params.index_add_(0, idx_s.reshape(-1), upd)
    d_window = None
    if window is not None:
        out_l = hashgrid_encode_plain(params, x, cfg).reshape(n, nl, nf)
        d_window = (out_l.transpose(0, 1) * gl).sum(dim=(1, 2))
    if count is not None:
        d_x = torch.where(_before(count, n, x.device)[:, None], d_x, 0.0)
    return (d_params.to(params.dtype),
            d_x.to(x.dtype) if need_dx else None, d_window)


def fixed_point_scale(g, cfg: HashGridConfig, window=None) -> float:
    """2^k, the backward kernel's fixed-point scale: the power of two with
    S * 2^k < 2^61 for S = sum |g * window| in fp64 (1 for S = 0, NaN for
    an S that is not finite). The exponent is clamped to [-1000, 1000]."""
    n = g.shape[0]
    gl = g.to(torch.float32).reshape(n, cfg.L, cfg.F)
    if window is not None:
        gl = gl * window.to(torch.float32)[None, :, None]
    s = float(gl.abs().to(torch.float64).sum())
    if not math.isfinite(s):
        return math.nan
    if s == 0.0:
        return 1.0
    e = math.frexp(s)[1]                       # s < 2^e
    return math.ldexp(1.0, max(-1000, min(1000, 61 - e)))


def hashgrid_bwd_fixed_plain(params, x, cfg: HashGridConfig, g, window=None,
                             grad_noise=None):
    """d_params as the backward kernel computes it, in 64-bit fixed point.

    Each update ``w_c * (g * window)`` (or ``(g * window) / m`` at the m
    drawn corners) is rounded in fp32 operation by operation as in
    :func:`hashgrid_bwd_plain`, scaled by :func:`fixed_point_scale` and
    rounded half to even to an int64; the updates are summed with an int64
    ``index_add_`` and the sums converted to fp32. Integer sums do not
    depend on their order, so the result is bitwise the same for any order
    of the samples, as the kernel's is for any grouping of its atomics.
    """
    arrays, base, frac = _cells(x, cfg)
    n, nl, nf = x.shape[0], cfg.L, cfg.F
    gl = g.to(torch.float32).reshape(n, nl, nf).transpose(0, 1)  # (L, N, F)
    gl_tab = gl if window is None else gl * window[:, None, None]
    scale = fixed_point_scale(g, cfg, window)
    if not math.isfinite(scale):
        return torch.full(params.shape, math.nan, dtype=torch.float32,
                          device=params.device)
    acc = torch.zeros(params.shape, dtype=torch.int64, device=params.device)

    def add(idx, upd):
        q = torch.round(upd.to(torch.float64) * scale).to(torch.int64)
        acc.index_add_(0, idx.reshape(-1), q.reshape(-1, nf))

    if grad_noise is not None and cfg.grad_corners < 8:
        m = cfg.grad_corners
        ws = [_corner(c, base, frac, arrays)[1] for c in range(8)]
        cumw = torch.cumsum(torch.stack(ws), dim=0)             # (8, L, N)
        u = grad_noise.to(torch.float32).T                      # (m, N)
        cstar = torch.clamp_max(
            (cumw[None] < u[:, None, None, :]).sum(1), 7)       # (m, L, N)
        upd = gl_tab / m
        for j in range(m):
            bits = torch.stack([cstar[j] & 1, (cstar[j] >> 1) & 1,
                                (cstar[j] >> 2) & 1], dim=-1)   # (L, N, 3)
            add(_corner_index(base + bits, *arrays[1:]), upd)
    else:
        for c in range(8):
            idx, w, _, _ = _corner(c, base, frac, arrays)
            add(idx, w[..., None] * gl_tab)
    return (acc.to(torch.float64) * (1.0 / scale)).to(torch.float32)


# ------------------------------------------------------------------ kernels
MAX_LEVELS = 32        # csrc/hashgrid.cu's level table
MAX_F = 16             # features the backward kernel takes
BWD_SAMPLES = 128      # samples a backward block: a warp a 32 of them
BWD_BLOCKS = 2112      # backward blocks at most: sixteen an H100 SM
PREP_BLOCKS = 264      # blocks of the pass that sums |g|: two an SM


@functools.cache
def _kernels():
    """The C entry points of csrc/hashgrid.cu (built on first use)."""
    lib = build.load_library("hashgrid")
    fwd, bwd = lib.hashgrid_fwd, lib.hashgrid_bwd
    fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] \
        + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
    bwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] \
        + [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2 \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


@functools.cache
def level_table(cfg: HashGridConfig) -> np.ndarray:
    """(L, 6) uint32 rows {scale's fp32 bits, res, offset, size - 1, salt,
    dense} that the kernels take by value."""
    table = np.array([[0, m.res, m.offset, m.size - 1, m.salt, int(m.dense)]
                      for m in cfg.levels], np.uint32)
    table[:, 0] = np.array([m.scale for m in cfg.levels],
                           np.float32).view(np.uint32)
    return table


def bwd_grid(n):
    """(samples a block, blocks) of the backward's scatter for N samples: a
    warp holds 32 consecutive samples and walks the levels in order. Blocks
    walk the sample tiles in a fixed stride, and each keeps one partial of
    d_window a level, so their order is a function of N and L alone."""
    return BWD_SAMPLES, max(1, min(-(-n // BWD_SAMPLES), BWD_BLOCKS))


def _stream(device):
    with torch.cuda.device(device):
        return torch.cuda.current_stream().cuda_stream


def _check(params, x, cfg, window, extra=()):
    """Shape, type and device checks shared by both kernels."""
    if cfg.L > MAX_LEVELS or cfg.F > MAX_F or cfg.n_params >= 2 ** 31:
        raise ValueError(f"the kernels take L <= {MAX_LEVELS}, F <= {MAX_F} "
                         f"and fewer than 2^31 rows, got L={cfg.L}, "
                         f"F={cfg.F}, {cfg.n_params} rows")
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"x must be (N, 3) float32, got {tuple(x.shape)} "
                         f"{x.dtype}")
    if params.shape != (cfg.n_params, cfg.F) \
            or params.dtype != torch.float32:
        raise ValueError(f"params must be ({cfg.n_params}, {cfg.F}) float32, "
                         f"got {tuple(params.shape)} {params.dtype}")
    if window is not None and window.shape != (cfg.L,):
        raise ValueError(f"window must be ({cfg.L},), got "
                         f"{tuple(window.shape)}")
    for t in (params, window, *extra):
        if t is not None and t.device != x.device:
            raise ValueError(f"x on {x.device} but an operand on {t.device}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _rows(params):
    """The table as the kernels read it: contiguous, 8-byte aligned rows."""
    params = params.detach().contiguous()
    return params.clone() if params.data_ptr() % 8 else params


def _f32(t):
    return None if t is None else t.detach().to(torch.float32).contiguous()


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


def _launch_fwd(params, x, cfg, window, count=None):
    _check(params, x, cfg, window)
    n_valid = _count_ptr(count, x.device)
    params, x, window = _rows(params), x.contiguous(), _f32(window)
    n = x.shape[0]
    out = torch.empty((n, cfg.out_dim), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    rc = _kernels()[0](_ptr(params), _ptr(x), _ptr(window), _ptr(out), n,
                       cfg.L, cfg.F, level_table(cfg).ctypes.data, n_valid,
                       _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"hashgrid_fwd launch failed: cudaError {rc}")
    hashgrid_encode.launches += 1
    return out


def _launch_bwd(params, x, cfg, g, window, grad_noise, need_dx, count=None):
    n, nl = x.shape[0], cfg.L
    n_valid = _count_ptr(count, x.device)
    if g.shape != (n, cfg.out_dim):
        raise ValueError(f"g must be ({n}, {cfg.out_dim}), got "
                         f"{tuple(g.shape)}")
    m = cfg.grad_corners if grad_noise is not None \
        and cfg.grad_corners < 8 else 0
    if m and grad_noise.shape != (n, m):
        raise ValueError(f"grad_noise must be ({n}, {m}), got "
                         f"{tuple(grad_noise.shape)}")
    _check(params, x, cfg, window, (g, grad_noise))
    params, x = _rows(params), x.contiguous()
    g, window = _f32(g), _f32(window)
    noise = _f32(grad_noise) if m else None
    dev = x.device
    d_params = torch.empty((cfg.n_params, cfg.F), dtype=torch.float32,
                           device=dev)
    d_x = torch.empty((n, 3), dtype=torch.float32, device=dev) \
        if need_dx else None
    d_window = None if window is None else torch.empty(
        (nl,), dtype=torch.float32, device=dev)
    if n == 0:
        return (d_params.zero_(), d_x,
                None if d_window is None else d_window.zero_())
    spb, blocks = bwd_grid(n)
    acc = torch.empty((cfg.n_params, cfg.F), dtype=torch.int64, device=dev)
    sums = torch.empty((PREP_BLOCKS + 1,), dtype=torch.float64, device=dev)
    win_part = None if window is None else torch.empty(
        (blocks, nl), dtype=torch.float64, device=dev)
    rc = _kernels()[1](
        _ptr(params), _ptr(x), _ptr(g), _ptr(window), _ptr(noise), m,
        _ptr(d_params), _ptr(acc), _ptr(sums), _ptr(win_part), _ptr(d_x),
        _ptr(d_window), n, cfg.n_params, nl, cfg.F, spb, blocks,
        PREP_BLOCKS, level_table(cfg).ctypes.data, n_valid, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"hashgrid_bwd launch failed: cudaError {rc}")
    hashgrid_bwd.launches += 1
    return d_params, d_x, d_window


class HashGridEncode(torch.autograd.Function):
    """:func:`hashgrid_encode` with the JAX VJP. Saves the operands; the
    backward recomputes the cells and weights from them."""

    @staticmethod
    def forward(ctx, params, x, cfg, window, grad_noise, count=None):
        ctx.save_for_backward(params, x, window, grad_noise, count)
        ctx.cfg = cfg
        if x.device.type == "cpu":
            return hashgrid_encode_plain(params, x, cfg, window, count)
        return _launch_fwd(params, x, cfg, window, count)

    @staticmethod
    def backward(ctx, g):
        params, x, window, grad_noise, count = ctx.saved_tensors
        counted = {} if count is None else {"count": count}
        d_params, d_x, d_window = hashgrid_bwd(
            params, x, ctx.cfg, g, window, grad_noise,
            need_dx=ctx.needs_input_grad[1], **counted)
        return d_params, d_x, None, d_window, None, None


def _check_device(x):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"hashgrid runs on cpu or cuda, not {x.device}")


def hashgrid_encode(params, x, cfg: HashGridConfig, window=None,
                    grad_noise=None, count=None):
    """Encode positions x (N, 3) in [0, 1] with the table ``params``
    (n_params, F): (N, L*F) fp32, level-major, differentiable in ``params``,
    ``x`` and ``window``.

    ``window``: optional (L,) level weights (:func:`window_weights`).
    ``grad_noise``: optional (N, cfg.grad_corners) uniforms in [0, 1) for
    the sampled-corner table gradient; the forward is always exact.
    ``count``: one int64 on x's device, the valid count of a static buffer
    of N rows (the trainer's capacity layout): rows at or past it are zero,
    add nothing to d_params or d_window and get d_x 0; the rows before it
    are computed as without it, bit for bit.
    CUDA tensors run the kernels (``csrc/hashgrid.cu``), CPU tensors the
    plain versions. ``hashgrid_encode.launches`` counts forward launches.
    """
    _check_device(x)
    return HashGridEncode.apply(params, x, cfg, window, grad_noise, count)


def hashgrid_bwd(params, x, cfg: HashGridConfig, g, window=None,
                 grad_noise=None, need_dx=True, count=None):
    """(d_params, d_x, d_window) of :func:`hashgrid_encode` for the output
    cotangent g (N, L*F), as :func:`hashgrid_bwd_plain` returns them.

    CUDA tensors run the backward kernels, whose d_params is bitwise the
    same on every launch; CPU tensors run :func:`hashgrid_bwd_plain`.
    ``hashgrid_bwd.launches`` counts launches (its passes are one).
    """
    _check_device(x)
    if x.device.type == "cpu":
        return hashgrid_bwd_plain(params, x, cfg, g, window, grad_noise,
                                  need_dx, count)
    return _launch_bwd(params, x, cfg, g, window, grad_noise, need_dx,
                       count=count)


hashgrid_encode.launches = 0
hashgrid_bwd.launches = 0
