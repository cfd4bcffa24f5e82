"""The radiance field, plain: encoders, MLPs, spherical harmonics.

Frozen copies of the port's plain versions (``mfnerf_tpu_torch`` as of the
benchmark's first version):

* ``ops/lowrank.py``: ``LowRankConfig.create``'s nested levels,
  ``_frame_rotations``, ``_prolongation``, ``_frame_coords``,
  ``fold_frame``, the fused ``lowrank_encode``;
* ``ops/hatmul.py``: ``hat_prod_plain`` and its dense-basis VJP
  ``hat_prod_bwd_plain`` (operands rounded to the configured type, fp32
  sums; the backward rounds each axis's cotangent to that type, as the
  kernel does);
* ``ops/hashgrid.py``: ``HashGridConfig.create`` and
  ``hashgrid_encode_plain``, differentiated by autograd (the exact table
  gradient: each corner's weight times the cotangent, scatter-added);
* ``ops/sh.py::sh_encode``, ``ops/activations.py::trunc_exp``,
  ``models/ngp.py``: ``_normalize``, ``_mlp_apply`` (fp32), ``NGP.forward``
  with the Sigmoid head.

Parameters come as a dict under the port's state-dict names
(``lowrank.lines.<m>.<l>.<d>``, ``lowrank.proj``, ``hash_table``,
``sigma_mlp.<i>``, ``rgb_mlp.<i>``): the trained state is the program's,
the arithmetic on it is this file's.
"""
import dataclasses
import math

import numpy as np
import torch


# ---------------------------------------------------------------- LowRank
def lowrank_levels(n_levels, k_max):
    """The fused encoder's nested knot counts: K - 1 halving per level
    down from the finest, ``k_max`` rounded up to 2^m + 1."""
    base = 1 << max(n_levels - 1, math.ceil(math.log2(max(k_max - 1, 2))))
    return tuple(base // (1 << i) + 1 for i in reversed(range(n_levels)))


def frame_rotations(n_frames):
    """(M, 3, 3): identity, then the QR of seeded Gaussians."""
    rots = [np.eye(3, dtype=np.float32)]
    rng = np.random.default_rng(12345)
    while len(rots) < n_frames:
        q, r = np.linalg.qr(rng.normal(size=(3, 3)))
        q = q * np.sign(np.diag(r))
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        rots.append(q.astype(np.float32))
    return np.stack(rots)


def prolongation(k_fine, k_coarse):
    r = (k_fine - 1) // (k_coarse - 1)
    i = np.arange(k_fine, dtype=np.float64)[:, None] / r
    j = np.arange(k_coarse, dtype=np.float64)[None, :]
    return np.maximum(0.0, 1.0 - np.abs(i - j)).astype(np.float32)


def _operand(x, dtype):
    return x.to(torch.bfloat16).float() if dtype == "bfloat16" \
        else x.to(torch.float32)


def _pos_basis(u, k_res, ks, dtype):
    diff = u[:, None].to(torch.float32) * (k_res - 1) - ks
    return diff, _operand(torch.clamp_min(1.0 - diff.abs(), 0.0), dtype)


def hat_prod_fwd(u3, w3, k_res, dtype):
    """prod_d B_K(u3[:, d]) @ w3[d] on ``dtype`` operands, fp32 sums."""
    ks = torch.arange(k_res, dtype=torch.float32, device=u3.device)
    prod = None
    for d in range(3):
        a = _pos_basis(u3[:, d], k_res, ks, dtype)[1] @ _operand(w3[d], dtype)
        prod = a if prod is None else prod * a
    return prod


def hat_prod_dw(u3, w3, k_res, g, dtype):
    """dW (3, K, R) of :func:`hat_prod_fwd` for the cotangent ``g``."""
    ks = torch.arange(k_res, dtype=torch.float32, device=u3.device)
    w_op = [_operand(w3[d], dtype) for d in range(3)]
    a = [_pos_basis(u3[:, d], k_res, ks, dtype)[1] @ w_op[d]
         for d in range(3)]
    g = g.to(torch.float32)
    dw = []
    for d in range(3):
        e, f = (d + 1) % 3, (d + 2) % 3
        g_d = _operand(g * a[e] * a[f], dtype)
        dw.append(_pos_basis(u3[:, d], k_res, ks, dtype)[1].T @ g_d)
    return torch.stack(dw).to(w3.dtype)


class HatProd(torch.autograd.Function):
    """The hat product with its dense-basis VJP in the table (positions
    carry no gradient here)."""

    @staticmethod
    def forward(ctx, u3, w3, k_res, dtype):
        ctx.save_for_backward(u3, w3)
        ctx.k_res, ctx.dtype = k_res, dtype
        return hat_prod_fwd(u3, w3, k_res, dtype)

    @staticmethod
    def backward(ctx, g):
        u3, w3 = ctx.saved_tensors
        return None, hat_prod_dw(u3, w3, ctx.k_res, g, ctx.dtype), None, None


def lowrank_encode(params, x, hp):
    """(N, 3) in [0, 1] -> (N, L*F): one hat product a frame on the
    folded tables, then the projection."""
    levels = lowrank_levels(hp["lr_levels"], hp["lr_k_max"])
    k_max = levels[-1]
    dev = x.device
    rots = torch.from_numpy(frame_rotations(hp["lr_frames"])).to(dev)
    prols = [torch.from_numpy(prolongation(k_max, k)).to(dev)
             for k in levels]
    dtype = hp.get("lr_matmul_dtype", "bfloat16")
    feats = []
    for m in range(hp["lr_frames"]):
        u3 = x if m == 0 else (x - 0.5) @ rots[m].T / 1.7320508 + 0.5
        u3 = torch.clamp(u3, 0.0, 1.0)
        w3 = torch.stack([
            torch.cat([p @ params[f"lowrank.lines.{m}.{li}.{d}"]
                       for li, p in enumerate(prols)], dim=1)
            for d in range(3)])
        feats.append(HatProd.apply(u3, w3, k_max, dtype))
    return torch.cat(feats, dim=1) @ params["lowrank.proj"]


# ------------------------------------------------------------- hash grids
_PRIMES = (1, 2654435761, 805459861)
_LEVEL_SALT_PRIME = 3674653429


@dataclasses.dataclass(frozen=True)
class Level:
    scale: float
    res: int
    offset: int
    size: int
    dense: bool
    salt: int


def hash_levels(hp, scale):
    """(levels, n_params) of the Hash or MixedFeature grid of ``hp``."""
    L, N_min = hp["L"], hp.get("N_min", 16)
    b = math.exp(math.log(hp.get("N_max", 2048) * scale / N_min) / (L - 1))
    hashmap = 1 << hp.get("T", 19)
    n_tables = hp.get("N_tables", 1)

    def level(lvl):
        s = N_min * (b ** lvl) - 1.0
        return s, int(math.ceil(s)) + 1

    specs = [None] * L
    offset = 0
    if hp["grid"] == "Hash" or n_tables <= 0:
        for lvl in range(L):
            s, res = level(lvl)
            if res ** 3 <= hashmap:
                size, dense = -(-res ** 3 // 8) * 8, True
            else:
                size, dense = hashmap, False
            specs[lvl] = Level(s, res, offset, size, dense, 0)
            offset += size
        return tuple(specs), offset
    per = -(-L // n_tables)
    for t in range(n_tables):
        group = range(t * per, min((t + 1) * per, L))
        sizes = [-(-level(lvl)[1] ** 3 // 8) * 8 for lvl in group]
        if sum(sizes) <= hashmap:
            sub = 0
            for lvl, sz in zip(group, sizes):
                specs[lvl] = Level(*level(lvl), offset + sub, sz, True, 0)
                sub += sz
            offset += sub
        else:
            for j, lvl in enumerate(group):
                specs[lvl] = Level(*level(lvl), offset, hashmap, False,
                                   (j * _LEVEL_SALT_PRIME) & 0xFFFFFFFF)
            offset += hashmap
    return tuple(specs), offset


def hash_encode(table, x, levels):
    """(N, 3) in [0, 1] -> (N, L*F) level-major: trilinear blends of the 8
    corner rows of each level's cell."""
    dev = x.device
    col = [torch.tensor([getattr(m, k) for m in levels], dtype=torch.int64,
                        device=dev) for k in ("res", "offset", "size",
                                               "salt")]
    res, offset, size, salt = col
    scale = torch.tensor(np.array([m.scale for m in levels], np.float32),
                         device=dev)
    dense = torch.tensor([m.dense for m in levels], device=dev)
    pos = x.to(torch.float32)[None, :, :] * scale[:, None, None] + 0.5
    base_f = torch.floor(pos)
    base, frac = base_f.to(torch.int64), pos - base_f
    n, n_lev, f = x.shape[0], len(levels), table.shape[1]
    out = torch.zeros((n_lev, n, f), dtype=torch.float32, device=dev)
    for c in range(8):
        bits = torch.tensor((c & 1, (c >> 1) & 1, (c >> 2) & 1), device=dev)
        wb = torch.where(bits.to(torch.bool), frac, 1.0 - frac)
        w = wb[..., 0] * wb[..., 1] * wb[..., 2]
        corner = base + bits
        r = res[:, None]
        cc = torch.minimum(corner, (r - 1)[..., None])
        dense_idx = cc[..., 0] + cc[..., 1] * r + cc[..., 2] * r * r
        h = (cc[..., 0] * _PRIMES[0] ^ cc[..., 1] * _PRIMES[1]
             ^ cc[..., 2] * _PRIMES[2] ^ salt[:, None])
        idx = torch.where(dense[:, None], dense_idx,
                          h & (size - 1)[:, None]) + offset[:, None]
        out = out + w[..., None] * table[idx].to(torch.float32)
    return out.transpose(0, 1).reshape(n, n_lev * f)


# ---------------------------------------------------------- the MLP heads
def sh_encode(dirs01):
    """(..., 3) directions mapped to [0, 1] -> (..., 16) real SH, degree 4."""
    d = dirs01.to(torch.float32) * 2.0 - 1.0
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xy, yz, xz = x * y, y * z, x * z
    x2, y2, z2 = x * x, y * y, z * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y, 0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * xy, -1.0925484305920792 * yz,
        0.94617469575755997 * z2 - 0.31539156525251999,
        -1.0925484305920792 * xz, 0.54627421529603959 * (x2 - y2),
        0.59004358992664352 * y * (-3.0 * x2 + y2),
        2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * z2),
        0.3731763325901154 * z * (5.0 * z2 - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * z2),
        1.4453057213202769 * z * (x2 - y2),
        0.59004358992664352 * x * (-x2 + 3.0 * y2)], dim=-1)


class TruncExp(torch.autograd.Function):
    """exp(x); the backward's factor exp(clamp(x, -15, 15))."""

    @staticmethod
    def forward(ctx, x):
        x = x.to(torch.float32)
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def mlp(ws, x, sigmoid=False):
    """Bias-free MLP, ReLU hidden layers, fp32, weights (fan_in, fan_out)."""
    h = x
    for w in ws[:-1]:
        h = torch.relu(h @ w)
    h = h @ ws[-1]
    return torch.sigmoid(h) if sigmoid else h


def _layers(params, prefix):
    out, i = [], 0
    while f"{prefix}.{i}" in params:
        out.append(params[f"{prefix}.{i}"])
        i += 1
    return out


class Field:
    """sigma and rgb at positions with view directions, for the
    hyperparameters ``hp`` (a configuration file's ``hparams``) on the
    parameters ``params``."""

    def __init__(self, hp, params):
        if hp["grid"] not in ("LowRank", "Hash", "MixedFeature"):
            raise NotImplementedError(f"grid {hp['grid']}")
        if hp.get("bf16") or hp.get("use_exposure"):
            raise NotImplementedError("the reference serves fp32 Sigmoid "
                                      "heads")
        self.hp, self.params = hp, params
        self.scale = hp["scale"]
        self.levels = None
        if hp["grid"] != "LowRank":
            self.levels, n_params = hash_levels(hp, self.scale)
            if params["hash_table"].shape[0] != n_params:
                raise ValueError("hash table rows differ from the config's")
        self.sigma = _layers(params, "sigma_mlp")
        self.rgb = _layers(params, "rgb_mlp")

    def encode(self, xn):
        if self.levels is None:
            return lowrank_encode(self.params, xn, self.hp)
        return hash_encode(self.params["hash_table"], xn, self.levels)

    def __call__(self, x, d):
        s = self.scale
        xn = torch.clamp((x + s) / (2 * s), 0.0, 1.0)
        h = mlp(self.sigma, self.encode(xn))
        sigmas = TruncExp.apply(h[:, 0])
        d = d / torch.linalg.norm(d, dim=1, keepdim=True)
        rgbs = mlp(self.rgb, torch.cat([sh_encode((d + 1.0) / 2.0), h], 1),
                   sigmoid=True)
        return sigmas, rgbs

    @torch.no_grad()
    def chunked(self, x, d, chunk=1 << 18):
        """:meth:`__call__` without autograd, ``chunk`` samples at a time."""
        outs = [self(x[i:i + chunk], d[i:i + chunk])
                for i in range(0, x.shape[0], chunk)]
        if not outs:
            return x.new_zeros((0,)), x.new_zeros((0, 3))
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])

