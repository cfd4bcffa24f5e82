"""Front-to-back volume compositing over padded (N, S) sample rows.

Port of ``mfnerf_tpu/ops/composite.py``:

* :func:`composite_train` (the reference's ``composite_train_fw/bw``): the
  transmittance before each sample is an exclusive cumulative product of
  ``1 - alpha``. On CUDA tensors its backward is the analytic one of
  :func:`composite_train_bwd_plain` (:class:`CompositeTrain`); on CPU
  tensors autograd differentiates the plain version's cumprod, as the JAX
  package differentiates it, to the same gradients.
* :func:`composite_test_step` (the reference's ``composite_test_fw``): each
  ray resumes from its accumulated transmittance ``1 - opacity`` and folds a
  new block of samples into its accumulators; :func:`composite_test_step_into`
  is its in-place form for the serving loop's alive rows (up to an
  optional alive count in device memory).

A sample contributes iff it is valid (``mask``) and the transmittance before
it exceeds ``T_threshold``.

On CUDA tensors the three functions launch the hand-written kernels of
``csrc/composite.cu`` (a row on up to a warp's lanes, a shuffle scan of
``1 - alpha``; the training forward and backward keep a row of up to four
passes in registers, :func:`bwd_passes`, modelled operation by operation
by :func:`composite_train_fwd_order_plain` and
:func:`composite_train_bwd_order_plain`); on CPU tensors they run their
plain versions (:func:`composite_train_plain` and
:func:`composite_train_fwd_plain`, :func:`composite_train_bwd_plain`,
:func:`composite_test_step_plain`). The kernels round every operation on
its own but scan and sum in another order than torch, so they agree with
the plain versions to rounding, and with themselves bit for bit from launch
to launch. ``composite_train.launches``, ``composite_train_bwd.launches``
and ``composite_test_step.launches`` count kernel launches.
"""
import ctypes
import functools
from typing import NamedTuple

import torch

from .. import build

# the two-walk backward kernel's shared memory holds a float a pass of 32
# slots for each of a block's 8 rows: 48 KB
MAX_BWD_SLOTS = 49152
_FLOATS = (torch.float32, torch.bfloat16)    # --bf16 may hand either


class CompositeResults(NamedTuple):
    opacity: torch.Tensor     # (N,)
    depth: torch.Tensor       # (N,)
    rgb: torch.Tensor         # (N, 3)
    ws: torch.Tensor          # (N, S) per-sample weights
    vr_samples: torch.Tensor  # () int64 composited samples (train/vr_s)


def _exclusive_transmittance(one_minus):
    """T before each sample: cumprod of [1, 1-alpha_0, ..., 1-alpha_{S-2}]."""
    return torch.cumprod(
        torch.cat([torch.ones_like(one_minus[:, :1]), one_minus[:, :-1]],
                  dim=1), dim=1)


def _weights(sigmas, deltas, mask, T_threshold, t_start=None):
    """(alpha, 1 - alpha, T before each sample, included, w) of a block,
    from the transmittance ``t_start`` (N,) or 1."""
    alpha = torch.where(mask, 1.0 - torch.exp(
        -sigmas.to(torch.float32) * deltas.to(torch.float32)), 0.0)
    one_minus = 1.0 - alpha
    t_excl = _exclusive_transmittance(one_minus)
    if t_start is not None:
        t_excl = t_start[:, None] * t_excl
    include = (t_excl > T_threshold) & mask
    w = torch.where(include, alpha * t_excl, 0.0)
    return alpha, one_minus, t_excl, include, w


def composite_train_fwd_plain(sigmas, rgbs, deltas, ts, mask, T_threshold):
    """The plain version of :func:`composite_train_fwd`: (opacity, depth,
    rgb, ws, each row's included samples as int32)."""
    _, _, _, include, w = _weights(sigmas, deltas, mask, T_threshold)
    return (w.sum(dim=1), (w * ts).sum(dim=1),
            (w[..., None] * rgbs.to(torch.float32)).sum(dim=1), w,
            include.sum(dim=1, dtype=torch.int32))


def composite_train_plain(sigmas, rgbs, deltas, ts, mask, T_threshold=1e-4):
    """The plain version of :func:`composite_train`, differentiable by
    autograd through ``cumprod`` (as the JAX package differentiates it). A
    sample with sigma * delta beyond ~17 has ``1 - alpha == 0`` exactly;
    torch's cumprod backward takes its zero-aware path there."""
    opacity, depth, rgb, w, counts = composite_train_fwd_plain(
        sigmas, rgbs, deltas, ts, mask, T_threshold)
    return CompositeResults(opacity=opacity, depth=depth, rgb=rgb, ws=w,
                            vr_samples=counts.sum())


def composite_train_bwd_plain(sigmas, rgbs, deltas, ts, mask, g_opacity,
                              g_depth, g_rgb, g_ws, T_threshold=1e-4):
    """The analytic backward of :func:`composite_train`, division-free with
    true suffix sums: for each included sample k, ``G_k = g_ws[k] +
    g_opacity + g_depth t_k + sum_c g_rgb[c] rgb_k[c]``, and

        B_i = G_i T_i (1 - alpha_i) - sum_{k > i, included} G_k w_k
            = T_i (1 - alpha_i) (G_i - R_i),
        R_i = sum_{k > i, included} G_k alpha_k prod_{i < j < k} (1 - alpha_j)
        d sigma_i = delta_i B_i,  d delta_i = sigma_i B_i,
        d rgb_i = w_i g_rgb,      d t_i = w_i g_depth,

    0 for the excluded slots. R is taken back to front, ``R_i = [i+1
    included] G_{i+1} alpha_{i+1} + (1 - alpha_{i+1}) R_{i+1}``; the leading
    ``1 - alpha_i`` is ``exp(-sigma_i delta_i)``, its exact value, as
    autodiff through the exp takes it (the rounded ``1 - (1 - e)`` of a
    dense sample is off by up to 3e-8 / e of itself, and 0 above sigma *
    delta ~17). Each incoming gradient (g_opacity, g_depth (N,), g_rgb
    (N, 3), g_ws (N, S)) may be None (0). Returns (d_sigmas, d_rgbs,
    d_deltas, d_ts) in float32."""
    f32 = torch.float32
    sigmas, rgbs, deltas, ts = (x.to(f32) for x in (sigmas, rgbs, deltas,
                                                   ts))
    alpha, one_minus, t_excl, include, w = _weights(sigmas, deltas, mask,
                                                    T_threshold)
    big_g = torch.zeros_like(w) if g_ws is None else g_ws.to(f32).clone()
    if g_opacity is not None:
        big_g = big_g + g_opacity.to(f32)[:, None]
    if g_depth is not None:
        big_g = big_g + g_depth.to(f32)[:, None] * ts
    if g_rgb is not None:
        big_g = big_g + (g_rgb.to(f32)[:, None, :] * rgbs).sum(dim=2)
    g_alpha = torch.where(include, big_g * alpha, 0.0)
    r = torch.empty_like(w)
    after = torch.zeros_like(w[:, 0])
    for i in range(w.shape[1] - 1, -1, -1):
        r[:, i] = after
        after = g_alpha[:, i] + one_minus[:, i] * after
    big_b = torch.where(include, t_excl * torch.exp(-sigmas * deltas)
                        * (big_g - r), 0.0)
    return (
        deltas * big_b, torch.zeros_like(rgbs) if g_rgb is None
        else w[..., None] * g_rgb.to(f32)[:, None, :],
        sigmas * big_b, torch.zeros_like(ts) if g_depth is None
        else w * g_depth.to(f32)[:, None])


def _lane_excl_product(v):
    """csrc/composite.cu's ``excl_product`` over the last axis (a pass's
    lanes): the shuffle scan's products in its order, then the product
    before each lane (1 on the first) and the pass's."""
    width = v.shape[-1]
    lane = torch.arange(width, device=v.device)
    d = 1
    while d < width:
        y = torch.cat([v[..., :d], v[..., :-d]], dim=-1)     # lane - d
        v = torch.where(lane >= d, y * v, v)
        d <<= 1
    before = torch.cat([torch.ones_like(v[..., :1]), v[..., :-1]], dim=-1)
    return before, v[..., -1]


def _lane_affine_suffix(c, m):
    """csrc/composite.cu's ``affine_suffix`` over the last axis."""
    width = c.shape[-1]
    lane = torch.arange(width, device=c.device)
    d = 1
    while d < width:
        c2 = torch.cat([c[..., d:], c[..., -d:]], dim=-1)    # lane + d
        m2 = torch.cat([m[..., d:], m[..., -d:]], dim=-1)
        keep = lane + d < width
        c, m = torch.where(keep, c + m * c2, c), torch.where(keep, m * m2, m)
        d <<= 1
    return c, m


class _Lanes:
    """A block of n rows of s slots as csrc/composite.cu's training kernels
    lay it on a warp's lanes: a row on ``row_width(s)`` lanes, 32 / width
    rows a warp (padded to whole warps, the padding rows dead), walked in
    passes of width slots; ``lay`` takes (n, s, ...) to (rows, passes,
    width, ...), ``unlay`` back."""

    def __init__(self, n, s, device):
        self.n, self.s, self.device = n, s, device
        self.width = row_width(s)
        self.per_warp = 32 // self.width
        self.passes = -(-s // self.width)
        self.rows = -(-n // self.per_warp) * self.per_warp
        self.live = torch.arange(self.rows, device=device) < n

    def lay(self, x, fill=0.0):
        pad = torch.full((self.rows, self.passes * self.width)
                         + tuple(x.shape[2:]), fill, dtype=x.dtype,
                         device=self.device)
        pad[:self.n, :self.s] = x
        return pad.view((self.rows, self.passes, self.width)
                        + tuple(x.shape[2:]))

    def unlay(self, x):
        return x.reshape((self.rows, self.passes * self.width)
                         + tuple(x.shape[3:]))[:self.n, :self.s]

    def warp_all(self, x):
        """Whether x (rows,) holds on every row of each row's warp."""
        return x.view(-1, self.per_warp).all(1) \
            .repeat_interleave(self.per_warp)


class _FrontWalk(NamedTuple):
    e: torch.Tensor        # exp(-sigma delta), 1 where masked
    a: torch.Tensor        # alpha
    om: torch.Tensor       # 1 - alpha
    ti: torch.Tensor       # T before each slot
    walked: torch.Tensor   # (rows,) passes before the warp's stop
    reached: torch.Tensor  # (rows, passes, 1): pass before the stop
    inc: torch.Tensor      # included: valid, reached and T before > thr
    w: torch.Tensor        # alpha T where included, else +0


def _front_walk(lanes, m, sg, dl, T_threshold, skip=True):
    """The training kernels' front walk on laid-out operands (float32,
    each product rounded on its own): alpha and 1 - alpha as the plain
    version computes them, the exclusive product of 1 - alpha by the
    kernels' shuffle scan, the transmittance carried across passes, and
    the stop at the pass at which every row of the warp has fallen to the
    threshold. With ``skip`` (the register kernels) a pass masked on the
    whole warp skips its scan: T before each slot is t, and t is kept."""
    e = torch.where(m, torch.exp(-(sg * dl)), 1.0)
    a = torch.where(m, 1.0 - e, 0.0)
    om = torch.where(m, 1.0 - a, 1.0)
    before, total = _lane_excl_product(om)
    rows, passes = lanes.rows, lanes.passes
    t = torch.ones(rows, dtype=torch.float32, device=lanes.device)
    walked = torch.full((rows,), passes, dtype=torch.int64,
                        device=lanes.device)
    stopped = torch.zeros(rows, dtype=torch.bool, device=lanes.device)
    ti = torch.zeros_like(sg)
    for p in range(passes):
        now = lanes.warp_all(~(lanes.live & (t > T_threshold))) & ~stopped
        walked = torch.where(now, p, walked)
        stopped |= now
        scanned = ~lanes.warp_all(~m[:, p].any(1)) if skip \
            else torch.ones_like(stopped)
        ti[:, p] = torch.where(scanned[:, None], t[:, None] * before[:, p],
                               t[:, None])
        t = torch.where(scanned, t * total[:, p], t)
    reached = (torch.arange(passes, device=lanes.device)[None, :]
               < walked[:, None])[..., None]
    inc = m & reached & (ti > T_threshold)
    w = torch.where(inc, a * ti, 0.0)
    return _FrontWalk(e, a, om, ti, walked, reached, inc, w)


def composite_train_fwd_order_plain(sigmas, rgbs, deltas, ts, mask,
                                    T_threshold=1e-4, skip=True):
    """:func:`composite_train_fwd_plain` in the order of csrc/composite.cu's
    training forward kernels, operation by operation (float32, each product
    and sum rounded on its own): the front walk of :func:`_front_walk` (its
    ``skip`` the register kernel's; both give the same bits); each lane's
    partial sums of its included slots in pass order (opacity w, depth
    w t, rgb w rgb, the count); then the sum over a row's lanes by the
    kernels' xor tree (``seg_sum``; ``warp_sums`` splits the values between
    a warp's lanes as it goes and gives the same bits). On CUDA tensors the
    kernels' bits (torch's exp is expf there); on the CPU torch's exp may
    round otherwise by an ulp.
    Returns (opacity, depth, rgb, ws, counts) as the kernels write them."""
    f32 = torch.float32
    n, s = sigmas.shape
    lanes = _Lanes(n, s, sigmas.device)
    m = lanes.lay(mask, False)
    sg, dl, tv = (lanes.lay(x.to(f32)) for x in (sigmas, deltas, ts))
    col = lanes.lay(rgbs.to(f32))
    walk = _front_walk(lanes, m, sg, dl, T_threshold, skip)
    sums = [torch.zeros_like(sg[:, 0]) for _ in range(5)]
    count = torch.zeros(sums[0].shape, dtype=torch.int32,
                        device=sigmas.device)
    for p in range(lanes.passes):
        inc, w = walk.inc[:, p], walk.w[:, p]
        terms = (w, w * tv[:, p], w * col[:, p, :, 0], w * col[:, p, :, 1],
                 w * col[:, p, :, 2])
        sums = [torch.where(inc, acc + x, acc) for acc, x in zip(sums,
                                                                 terms)]
        count = count + inc.to(torch.int32)
    lane = torch.arange(lanes.width, device=sigmas.device)
    d = lanes.width >> 1
    while d:
        sums = [v + v[:, lane ^ d] for v in sums]
        count = count + count[:, lane ^ d]
        d >>= 1
    op, de, r, g, b = (v[:n, 0] for v in sums)
    return (op, de, torch.stack([r, g, b], dim=1), lanes.unlay(walk.w),
            count[:n, 0])


def composite_train_bwd_order_plain(sigmas, rgbs, deltas, ts, mask,
                                    g_opacity, g_depth, g_rgb, g_ws,
                                    T_threshold=1e-4, skip=True):
    """:func:`composite_train_bwd_plain` in the order of csrc/composite.cu's
    backward kernels, operation by operation (float32, each product and sum
    rounded on its own): the front walk of :func:`_front_walk` (the rest of
    a row past the warp's stop gets +0); R by the suffix scan of the affine
    maps within a pass and carried across passes. With ``skip`` (the
    register kernel) a pass masked on the whole warp skips its front scan,
    and a pass in which no slot of the warp is included skips its back scan
    and carries R as 0 + R; without it (the two-walk kernel) every pass is
    scanned. Both give the same bits, and on CUDA tensors the kernels'
    (torch's exp is expf there); on the CPU torch's exp may round otherwise
    by an ulp. Returns (d_sigmas, d_rgbs, d_deltas, d_ts) in float32, as
    the kernels write them."""
    f32 = torch.float32
    n, s = sigmas.shape
    dev = sigmas.device
    lanes = _Lanes(n, s, dev)
    rows, passes, width = lanes.rows, lanes.passes, lanes.width
    m = lanes.lay(mask, False)
    sg, dl, tv = (lanes.lay(x.to(f32)) for x in (sigmas, deltas, ts))
    col = lanes.lay(rgbs.to(f32))
    gw = lanes.lay(g_ws.to(f32)) if g_ws is not None \
        else torch.zeros_like(sg)

    def row_grad(g, k=None):
        out = torch.zeros(rows, dtype=f32, device=dev)
        if g is not None:
            out[:n] = g.to(f32) if k is None else g.to(f32)[:, k]
        return out[:, None, None]

    go, gd = row_grad(g_opacity), row_grad(g_depth)
    gr, gg, gb = (row_grad(g_rgb, k) for k in range(3))
    walk = _front_walk(lanes, m, sg, dl, T_threshold, skip)
    e, a, om, ti, inc, w = walk.e, walk.a, walk.om, walk.ti, walk.inc, walk.w
    big_g = gw + go
    big_g = big_g + gd * tv
    big_g = big_g + gr * col[..., 0]
    big_g = big_g + gg * col[..., 1]
    big_g = big_g + gb * col[..., 2]
    big_g = torch.where(inc, big_g, 0.0)
    c, mm = _lane_affine_suffix(torch.where(inc, big_g * a, 0.0), om)
    lane = torch.arange(width, device=dev)
    # back to front
    included = inc.view(-1, lanes.per_warp, passes, width).any(3).any(1) \
        .repeat_interleave(lanes.per_warp, 0)
    behind = torch.zeros(rows, dtype=f32, device=dev)
    big_b = torch.zeros_like(sg)
    for p in range(passes - 1, -1, -1):
        c_next = torch.cat([c[:, p, 1:], c[:, p, -1:]], dim=1)
        m_next = torch.cat([mm[:, p, 1:], mm[:, p, -1:]], dim=1)
        r = torch.where(lane + 1 < width, c_next + m_next * behind[:, None],
                        behind[:, None])
        big_b[:, p] = torch.where(
            inc[:, p], (ti[:, p] * e[:, p]) * (big_g[:, p] - r), 0.0)
        scanned = c[:, p, 0] + mm[:, p, 0] * behind
        if skip:
            scanned = torch.where(included[:, p], scanned, 0.0 + behind)
        behind = torch.where(p < walk.walked, scanned, behind)
    reached = walk.reached
    d_sigmas = torch.where(inc, dl * big_b, 0.0)
    d_deltas = torch.where(inc, sg * big_b, 0.0)
    d_ts = torch.where(reached, w * gd, 0.0)
    d_rgbs = torch.where(reached[..., None], torch.stack(
        [w * gr, w * gg, w * gb], dim=-1), 0.0)
    return (lanes.unlay(d_sigmas), lanes.unlay(d_rgbs), lanes.unlay(d_deltas),
            lanes.unlay(d_ts))


def composite_test_step_plain(sigmas, rgbs, deltas, ts, mask, opacity, depth,
                              rgb, alive, T_threshold, count=None):
    """The plain version of :func:`composite_test_step`. ``count``: None,
    or a (1,) int64 alive count: the rows at or past it add nothing to
    their accumulators and come back not alive."""
    if count is not None:
        alive = alive & (torch.arange(alive.shape[0], device=alive.device)
                         < count)
    mask = mask & alive[:, None]
    _, one_minus, t_excl, _, w = _weights(sigmas, deltas, mask, T_threshold,
                                          1.0 - opacity)
    opacity = opacity + w.sum(dim=1)
    depth = depth + (w * ts).sum(dim=1)
    rgb = rgb + (w[..., None] * rgbs.to(torch.float32)).sum(dim=1)
    t_final = t_excl[:, -1] * one_minus[:, -1]
    alive = alive & (t_final > T_threshold)
    return opacity, depth, rgb, alive


# ------------------------------------------------------------- the kernels
@functools.cache
def _kernels():
    """The C entry points of csrc/composite.cu (built on first use)."""
    lib = build.load_library("composite")
    fw, bw, test = (lib.composite_train_fw, lib.composite_train_bw,
                    lib.composite_test)
    head = [ctypes.c_longlong, ctypes.c_int, ctypes.c_float]
    with_passes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float]
    fw.argtypes = with_passes + [ctypes.c_void_p] * 11
    bw.argtypes = with_passes + [ctypes.c_void_p] * 14
    test.argtypes = head + [ctypes.c_void_p] * 16
    fw.restype = bw.restype = test.restype = ctypes.c_int
    return fw, bw, test


def _stream(device):
    with torch.cuda.device(device):
        return torch.cuda.current_stream().cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_device(t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"compositing runs on cpu or cuda, not {t.device}")


def _check(name, t, shape, dtypes, device):
    """Raise ValueError unless ``t`` has ``shape``, one of ``dtypes`` and
    ``device``."""
    if tuple(t.shape) != tuple(shape) or t.dtype not in dtypes \
            or t.device != device:
        want = "/".join(str(d).replace("torch.", "") for d in dtypes)
        raise ValueError(f"{name} must be {tuple(shape)} {want} on {device}, "
                         f"got {tuple(t.shape)} {t.dtype} on {t.device}")


def _check_block(sigmas, rgbs, deltas, ts, mask):
    """The (N, S) block's checks; returns (N, S)."""
    _check_device(sigmas)
    if sigmas.dim() != 2:
        raise ValueError(f"sigmas must be (N, S), got {tuple(sigmas.shape)}")
    n, s = sigmas.shape
    dev = sigmas.device
    _check("sigmas", sigmas, (n, s), _FLOATS, dev)
    _check("rgbs", rgbs, (n, s, 3), _FLOATS, dev)
    _check("deltas", deltas, (n, s), _FLOATS, dev)
    _check("ts", ts, (n, s), _FLOATS, dev)
    _check("mask", mask, (n, s), (torch.bool,), dev)
    if s < 1:
        raise ValueError("a row needs at least one slot")
    return n, s


def _contiguous(*tensors):
    return [None if t is None else t.contiguous() for t in tensors]


def _launch_train_fwd(sigmas, rgbs, deltas, ts, mask, T_threshold,
                      passes=None):
    """composite_train_fw on fp32 operands: the kernel of
    :func:`bwd_passes` (a row's P passes in registers), or of ``passes``
    (0: the pass-by-pass kernel, for any s), as (opacity, depth, rgb, ws,
    counts)."""
    n, s = sigmas.shape
    if passes is None:
        passes = bwd_passes(s)
    dev, f32 = sigmas.device, torch.float32
    sigmas, rgbs, deltas, ts, mask = _contiguous(sigmas, rgbs, deltas, ts,
                                                 mask)
    opacity = torch.empty((n,), dtype=f32, device=dev)
    depth = torch.empty((n,), dtype=f32, device=dev)
    rgb = torch.empty((n, 3), dtype=f32, device=dev)
    ws = torch.empty((n, s), dtype=f32, device=dev)
    counts = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        rc = _kernels()[0](
            n, s, passes, T_threshold, sigmas.data_ptr(), rgbs.data_ptr(),
            deltas.data_ptr(), ts.data_ptr(), mask.data_ptr(),
            opacity.data_ptr(), depth.data_ptr(), rgb.data_ptr(),
            ws.data_ptr(), counts.data_ptr(), _stream(dev))
        if rc != 0:
            raise RuntimeError(f"composite_train_fw launch failed: "
                               f"cudaError {rc}")
        composite_train.launches += 1
    return opacity, depth, rgb, ws, counts


def row_width(s):
    """Lanes a row of ``s`` slots takes in csrc/composite.cu: the power of
    two at or above s, at most 32."""
    return min(32, 1 << max(s - 1, 0).bit_length())


def bwd_passes(s):
    """The training kernels for rows of ``s`` slots, forward and backward
    alike: the passes of ``row_width(s)`` slots they keep in registers (the
    template P of ``composite_train_fw_regs_kernel`` and
    ``composite_train_bw_regs_kernel``: 1, 2 or 4, the fewest that cover
    the row), or 0, the pass-by-pass forward and the two-walk backward, for
    rows of more than four passes."""
    passes = -(-s // row_width(s))
    return next((p for p in (1, 2, 4) if passes <= p), 0)


def _launch_train_bwd(sigmas, rgbs, deltas, ts, mask, g_opacity, g_depth,
                      g_rgb, g_ws, T_threshold, needs, passes=None):
    """composite_train_bw on fp32 operands: the kernel of
    :func:`bwd_passes`, or of ``passes`` (0: the two-walk kernel, which
    takes every row :func:`bwd_passes` takes, up to MAX_BWD_SLOTS)."""
    n, s = sigmas.shape
    if s > MAX_BWD_SLOTS:
        raise ValueError(f"{s} slots a row: the backward kernel takes at "
                         f"most {MAX_BWD_SLOTS}")
    if passes is None:
        passes = bwd_passes(s)
    dev, f32 = sigmas.device, torch.float32
    sigmas, rgbs, deltas, ts, mask, g_opacity, g_depth, g_rgb, g_ws = \
        _contiguous(sigmas, rgbs, deltas, ts, mask, g_opacity, g_depth,
                    g_rgb, g_ws)
    outs = [torch.empty(shape, dtype=f32, device=dev) if need else None
            for need, shape in zip(needs, ((n, s), (n, s, 3), (n, s),
                                           (n, s)))]
    if n and any(needs):
        rc = _kernels()[1](
            n, s, passes, T_threshold, sigmas.data_ptr(), rgbs.data_ptr(),
            deltas.data_ptr(), ts.data_ptr(), mask.data_ptr(),
            _ptr(g_opacity), _ptr(g_depth), _ptr(g_rgb), _ptr(g_ws),
            *(_ptr(t) for t in outs), _stream(dev))
        if rc != 0:
            raise RuntimeError(f"composite_train_bw launch failed: "
                               f"cudaError {rc}")
        composite_train_bwd.launches += 1
    return tuple(outs)


def _launch_test(sigmas, rgbs, deltas, ts, mask, index, opacity, depth, rgb,
                 alive, T_threshold, out, count=None):
    """composite_test on fp32 operands: the accumulators ``opacity``,
    ``depth``, ``rgb`` at each row's ``index`` entry (None: the row's own),
    written to ``out`` (three tensors, which may be the inputs); with
    ``count`` (a (1,) int64 on the device) only the rows before it; returns
    alive after the round (N,)."""
    n, s = sigmas.shape
    dev = sigmas.device
    sigmas, rgbs, deltas, ts, mask = _contiguous(sigmas, rgbs, deltas, ts,
                                                 mask)
    alive_out = torch.empty((n,), dtype=torch.bool, device=dev)
    if n:
        rc = _kernels()[2](
            n, s, T_threshold, sigmas.data_ptr(), rgbs.data_ptr(),
            deltas.data_ptr(), ts.data_ptr(), mask.data_ptr(), _ptr(index),
            _ptr(count), opacity.data_ptr(), depth.data_ptr(), rgb.data_ptr(),
            _ptr(alive), *(t.data_ptr() for t in out), alive_out.data_ptr(),
            _stream(dev))
        if rc != 0:
            raise RuntimeError(f"composite_test launch failed: cudaError "
                               f"{rc}")
        composite_test_step.launches += 1
    return alive_out


class CompositeTrain(torch.autograd.Function):
    """composite_train's forward and analytic backward on fp32 operands:
    the kernels on CUDA tensors; on CPU tensors the plain forward and
    :func:`composite_train_bwd_plain`. Returns (opacity, depth, rgb, ws,
    each row's included samples as int32)."""

    @staticmethod
    def forward(ctx, sigmas, rgbs, deltas, ts, mask, T_threshold):
        ctx.set_materialize_grads(False)
        out = _train_fwd(sigmas, rgbs, deltas, ts, mask, T_threshold)
        ctx.save_for_backward(sigmas, rgbs, deltas, ts, mask)
        ctx.T_threshold = T_threshold
        ctx.mark_non_differentiable(out[4])
        return out

    @staticmethod
    def backward(ctx, g_opacity, g_depth, g_rgb, g_ws, _):
        sigmas, rgbs, deltas, ts, mask = ctx.saved_tensors
        need = ctx.needs_input_grad
        grads = _train_bwd(
            sigmas, rgbs, deltas, ts, mask, g_opacity, g_depth, g_rgb, g_ws,
            ctx.T_threshold, (need[0], need[1] and g_rgb is not None,
                              need[2], need[3] and g_depth is not None))
        return (*grads, None, None)


def _train_fwd(sigmas, rgbs, deltas, ts, mask, T_threshold):
    """composite_train_fwd on checked fp32 operands."""
    if sigmas.is_cuda:
        return _launch_train_fwd(sigmas, rgbs, deltas, ts, mask, T_threshold)
    return composite_train_fwd_plain(sigmas, rgbs, deltas, ts, mask,
                                     T_threshold)


def _train_bwd(sigmas, rgbs, deltas, ts, mask, g_opacity, g_depth, g_rgb,
               g_ws, T_threshold, needs):
    """composite_train_bwd on checked fp32 operands and gradients."""
    if sigmas.is_cuda:
        return _launch_train_bwd(sigmas, rgbs, deltas, ts, mask, g_opacity,
                                 g_depth, g_rgb, g_ws, T_threshold, needs)
    grads = composite_train_bwd_plain(sigmas, rgbs, deltas, ts, mask,
                                      g_opacity, g_depth, g_rgb, g_ws,
                                      T_threshold)
    return tuple(g if need else None for g, need in zip(grads, needs))


def _analytic(sigmas, rgbs, deltas, ts, mask, T_threshold):
    """composite_train_analytic on checked operands."""
    f32 = torch.float32
    opacity, depth, rgb, ws, counts = CompositeTrain.apply(
        sigmas.to(f32), rgbs.to(f32), deltas.to(f32), ts.to(f32), mask,
        float(T_threshold))
    return CompositeResults(opacity=opacity, depth=depth, rgb=rgb, ws=ws,
                            vr_samples=counts.sum())


def composite_train_analytic(sigmas, rgbs, deltas, ts, mask,
                             T_threshold=1e-4):
    """:func:`composite_train` through :class:`CompositeTrain` on either
    device: operands cast to fp32 (their gradients come back in their
    dtypes), differentiable in sigmas, rgbs, deltas and ts by the analytic
    backward; any of opacity, depth, rgb and ws may be left out of the
    loss. On CUDA tensors it is what :func:`composite_train` runs; on CPU
    tensors it runs the plain forward and :func:`composite_train_bwd_plain`
    (the tests hold it to autograd through the plain version's cumprod).
    Raises ValueError for a shape, dtype or device the kernels do not take.
    """
    _check_block(sigmas, rgbs, deltas, ts, mask)
    return _analytic(sigmas, rgbs, deltas, ts, mask, T_threshold)


def composite_train(sigmas, rgbs, deltas, ts, mask, T_threshold=1e-4):
    """Composite padded sample rows front to back.

    Args:
        sigmas, deltas, ts: (N, S) fp32 or bf16 (computed in fp32);
            rgbs: (N, S, 3) fp32 or bf16.
        mask: (N, S) bool sample validity; masked slots may sit between
            valid ones.
    Returns:
        :class:`CompositeResults`, differentiable in sigmas, rgbs, deltas
        and ts (their gradients in their dtypes).

    CUDA tensors run :func:`composite_train_analytic`: csrc/composite.cu's
    forward kernel, and its backward kernel in the backward. CPU tensors run
    :func:`composite_train_plain`, differentiated by autograd as the JAX
    package differentiates it. Raises ValueError for a shape, dtype or
    device the kernels do not take.
    """
    _check_block(sigmas, rgbs, deltas, ts, mask)
    if sigmas.is_cuda:
        return _analytic(sigmas, rgbs, deltas, ts, mask, T_threshold)
    return composite_train_plain(sigmas, rgbs, deltas, ts, mask, T_threshold)


def composite_train_fwd(sigmas, rgbs, deltas, ts, mask, T_threshold=1e-4):
    """:func:`composite_train`'s outputs without autograd: (opacity, depth,
    rgb, ws, each row's included samples as int32), float32. CUDA tensors
    launch csrc/composite.cu's forward kernel (``composite_train.launches``
    counts it), CPU tensors run :func:`composite_train_fwd_plain`."""
    _check_block(sigmas, rgbs, deltas, ts, mask)
    f32 = torch.float32
    return _train_fwd(sigmas.to(f32), rgbs.to(f32), deltas.to(f32),
                      ts.to(f32), mask, float(T_threshold))


def composite_train_bwd(sigmas, rgbs, deltas, ts, mask, g_opacity, g_depth,
                        g_rgb, g_ws, T_threshold=1e-4,
                        needs=(True, True, True, True)):
    """:func:`composite_train_bwd_plain`'s gradients (d_sigmas, d_rgbs,
    d_deltas, d_ts) in float32, each only where ``needs`` asks for it (else
    None): CUDA tensors launch csrc/composite.cu's backward kernel, CPU
    tensors run the plain version."""
    n, s = _check_block(sigmas, rgbs, deltas, ts, mask)
    f32 = torch.float32
    for name, g, shape in (("g_opacity", g_opacity, (n,)),
                           ("g_depth", g_depth, (n,)),
                           ("g_rgb", g_rgb, (n, 3)),
                           ("g_ws", g_ws, (n, s))):
        if g is not None:
            _check(name, g, shape, (f32,), sigmas.device)
    return _train_bwd(sigmas.to(f32), rgbs.to(f32), deltas.to(f32),
                      ts.to(f32), mask, g_opacity, g_depth, g_rgb, g_ws,
                      float(T_threshold), needs)


def _check_accumulators(n_acc, opacity, depth, rgb, device):
    f32 = (torch.float32,)
    _check("opacity", opacity, (n_acc,), f32, device)
    _check("depth", depth, (n_acc,), f32, device)
    _check("rgb", rgb, (n_acc, 3), f32, device)


def composite_test_step(sigmas, rgbs, deltas, ts, mask, opacity, depth, rgb,
                        alive, T_threshold):
    """One compositing round.

    Args:
        sigmas, deltas, ts, mask: (N, S) new samples; rgbs (N, S, 3).
        opacity, depth: (N,); rgb: (N, 3) running accumulators (fp32).
        alive: (N,) bool rays still marching.
    Returns:
        (opacity, depth, rgb, alive); a ray dies when its transmittance after
        the block is <= T_threshold.

    CUDA tensors launch csrc/composite.cu's round kernel; CPU tensors run
    :func:`composite_test_step_plain`.
    """
    n, _ = _check_block(sigmas, rgbs, deltas, ts, mask)
    dev = sigmas.device
    _check_accumulators(n, opacity, depth, rgb, dev)
    _check("alive", alive, (n,), (torch.bool,), dev)
    if not sigmas.is_cuda:
        return composite_test_step_plain(sigmas, rgbs, deltas, ts, mask,
                                         opacity, depth, rgb, alive,
                                         T_threshold)
    f32 = torch.float32
    opacity, depth, rgb, alive = _contiguous(opacity, depth, rgb, alive)
    out = (torch.empty_like(opacity), torch.empty_like(depth),
           torch.empty_like(rgb))
    alive = _launch_test(sigmas.to(f32), rgbs.to(f32), deltas.to(f32),
                         ts.to(f32), mask, None, opacity, depth, rgb, alive,
                         float(T_threshold), out)
    return (*out, alive)


def composite_test_step_into(sigmas, rgbs, deltas, ts, mask, index, opacity,
                             depth, rgb, T_threshold, count=None):
    """:func:`composite_test_step` in place, for the alive rows of a frame:
    row r of the block composites into entry ``index[r]`` of the frame's
    accumulators ``opacity``, ``depth`` (M,) and ``rgb`` (M, 3), which it
    updates; every row is alive. ``index`` (N,) int64 holds distinct
    entries. ``count``: None, or a (1,) int64 alive count on the block's
    device (the serving rounds' capacity buffers): the rows at or past it
    read and write no accumulator (their ``index`` entries may be
    anything) and come back not alive. Returns alive after the round (N,)
    bool.

    CUDA tensors launch csrc/composite.cu's round kernel (one launch, with
    ``composite_test_step.launches``), which reads the count on the device;
    CPU tensors gather the rows before the count, run
    :func:`composite_test_step_plain` and scatter back."""
    n, _ = _check_block(sigmas, rgbs, deltas, ts, mask)
    dev = sigmas.device
    _check("index", index, (n,), (torch.int64,), dev)
    _check_accumulators(opacity.shape[0], opacity, depth, rgb, dev)
    if count is not None:
        _check("count", count, (1,), (torch.int64,), dev)
    if not sigmas.is_cuda:
        k = n if count is None else max(0, min(int(count), n))
        rows = index[:k]
        op, de, co, alive = composite_test_step_plain(
            sigmas[:k], rgbs[:k], deltas[:k], ts[:k], mask[:k],
            opacity[rows], depth[rows], rgb[rows],
            torch.ones((k,), dtype=torch.bool, device=dev), T_threshold)
        opacity[rows], depth[rows], rgb[rows] = op, de, co
        return torch.cat([alive, alive.new_zeros(n - k)])
    for name, t in (("opacity", opacity), ("depth", depth), ("rgb", rgb)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous: it is updated in "
                             f"place")
    f32 = torch.float32
    return _launch_test(sigmas.to(f32), rgbs.to(f32), deltas.to(f32),
                        ts.to(f32), mask, index.contiguous(), opacity, depth,
                        rgb, None, float(T_threshold), (opacity, depth, rgb),
                        count)


composite_train.launches = 0
composite_train_bwd.launches = 0
composite_test_step.launches = 0
