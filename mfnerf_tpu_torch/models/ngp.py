"""NGP radiance field: an encoder + sigma/rgb MLPs + occupancy grid.

Port of ``mfnerf_tpu/models/ngp.py``. The encoder is the LowRank grid
(``ops/lowrank.py``) or one of the Hash, Window and MixedFeature grids
(``ops/hashgrid.py``). ``NGP`` is an ``nn.Module`` whose parameters carry
the JAX pytree's names (``lowrank.lines.<m>.<l>.<d>`` and ``lowrank.proj``,
or ``hash_table``; ``sigma_mlp.<i>``, ``rgb_mlp.<i>``), so a JAX checkpoint
loads through ``utils.ckpt.params_from_numpy``. MLPs are bias-free, weights
stored (fan_in, fan_out) and applied as ``h @ W``.

``NGPConfig.grid`` defaults to ``"LowRank"``, where the JAX package's
default is ``"Hash"``: the port's callers were written for LowRank, and the
JAX default would turn each of them into a hash-grid model without a word.
Pass ``grid="Hash"`` (or ``Window``, ``MixedFeature``) for the hash grids.

The HDR tonemappers, the sampled (``sparse``) occupancy refresh and the
TPU-only occupancy tables (coarse, neighbourhood, union) are not ported
here.
"""
import dataclasses
import math

import torch
from torch import nn

from ..device import resolve_device
from ..ops.activations import trunc_exp
from ..ops.hashgrid import (HashGridConfig, hashgrid_encode,
                            init_hashgrid_params, window_weights)
from ..ops.lowrank import LowRankConfig, init_lowrank_params, lowrank_encode
from ..ops.morton import morton3d_invert, packbits
from ..ops.sh import sh_encode

NEAR_DISTANCE = 0.01  # the reference's models/rendering.py:8


@dataclasses.dataclass(frozen=True)
class NGPConfig:
    """The fields of ``mfnerf_tpu.models.ngp.NGPConfig`` that the port uses,
    with the same names and defaults, except ``grid`` (module docstring)."""
    scale: float = 0.5
    grid: str = "LowRank"         # LowRank | Hash | Window | MixedFeature
    L: int = 16                   # L * F is the encoder's output width
    F: int = 2
    log2_T: int = 19
    N_min: int = 16
    N_max: int = 2048
    N_tables: int = 1
    # hash grids: corners (of 8) that receive the table gradient, drawn by
    # trilinear weight (ops/hashgrid.HashGridConfig.grad_corners); 8 = exact
    hash_grad_samples: int = 8
    rgb_channels: int = 64
    rgb_layers: int = 2
    grid_size: int = 128
    sigma_neurons: int = 64
    geo_feat_dim: int = 16
    sh_degree: int = 4
    lr_levels: int = 8
    lr_rank: int = 16
    lr_frames: int = 2
    lr_k_min: int = 32
    lr_k_max: int = 512
    lr_fused: bool = False
    # bound on |rays_d| (directions are unnormalized): sizes the training
    # march's strata (ops/ray_march.twolevel_stratum)
    dir_norm: float = 1.0
    # the strata's stage-A grid is the fine grid pooled pool_a to a side
    # (0: 2, the JAX coarse table)
    pool_a: int = 0

    @property
    def cascades(self) -> int:
        return max(1 + int(math.ceil(math.log2(2 * self.scale))), 1)

    @property
    def per_level_scale(self) -> float:
        """The growth factor b of the hash grids' level resolutions."""
        return math.exp(
            math.log(self.N_max * self.scale / self.N_min) / (self.L - 1))

    @property
    def hash_cfg(self) -> HashGridConfig:
        if self.grid == "LowRank":
            raise ValueError("LowRank grid has no hash config")
        return HashGridConfig.create(
            L=self.L, F=self.F, log2_T=self.log2_T, N_min=self.N_min,
            b=self.per_level_scale, grid_type=self.grid,
            N_tables=self.N_tables, grad_corners=self.hash_grad_samples)

    @property
    def lowrank_cfg(self) -> LowRankConfig:
        return LowRankConfig.create(
            n_levels=self.lr_levels, k_min=self.lr_k_min,
            k_max=self.lr_k_max, rank=self.lr_rank,
            n_frames=self.lr_frames, out_dim=self.L * self.F,
            fused=self.lr_fused)

    @property
    def n_cells(self) -> int:
        return self.grid_size ** 3


@dataclasses.dataclass
class OccupancyState:
    """Occupancy grid: per-cell density (C, G^3) in Morton order, its packed
    bitfield (C*G^3//8,) uint8, and the fraction of training cameras that see
    each cell (C, G^3), which ``erode`` reads (None until set)."""
    density_grid: torch.Tensor
    density_bitfield: torch.Tensor
    count_grid: torch.Tensor = None

    @staticmethod
    def create(cfg: NGPConfig, device=None) -> "OccupancyState":
        """An empty grid on ``device`` (default: the CUDA device; raises
        without one)."""
        c, n = cfg.cascades, cfg.n_cells
        device = resolve_device(device)
        return OccupancyState(
            density_grid=torch.zeros((c, n), dtype=torch.float32,
                                     device=device),
            density_bitfield=torch.zeros((c * n // 8,), dtype=torch.uint8,
                                         device=device),
            count_grid=torch.zeros((c, n), dtype=torch.float32,
                                   device=device))


def _mlp_params(sizes):
    return nn.ParameterList(
        [nn.Parameter(torch.empty(fan_in, fan_out))
         for fan_in, fan_out in zip(sizes[:-1], sizes[1:])])


def _mlp_apply(ws, x, sigmoid=False):
    h = x
    for w in ws[:-1]:
        h = torch.relu(h @ w)
    h = h @ ws[-1]
    return torch.sigmoid(h) if sigmoid else h


class NGP(nn.Module):
    """The NGP field on ``device`` (default: the CUDA device; raises without
    one). Parameters are drawn by :meth:`init`."""

    def __init__(self, cfg: NGPConfig, generator: torch.Generator = None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.is_lowrank = cfg.grid == "LowRank"
        self.lowrank_cfg = cfg.lowrank_cfg if self.is_lowrank else None
        self.hash_cfg = None if self.is_lowrank else cfg.hash_cfg
        if self.is_lowrank:
            lr = self.lowrank_cfg
            self.lowrank = nn.Module()
            self.lowrank.lines = nn.ModuleList([
                nn.ModuleList([
                    nn.ParameterList([nn.Parameter(torch.empty(k, lr.rank))
                                      for _ in range(3)])
                    for k in lr.levels])
                for _ in range(lr.n_frames)])
            self.lowrank.proj = nn.Parameter(
                torch.empty(lr.n_components, lr.out_dim))
        else:
            self.hash_table = nn.Parameter(
                torch.empty(self.hash_cfg.n_params, self.hash_cfg.F))
        self.sigma_mlp = _mlp_params(
            [cfg.L * cfg.F, cfg.sigma_neurons, cfg.geo_feat_dim])
        self.rgb_mlp = _mlp_params(
            [cfg.sh_degree ** 2 + cfg.geo_feat_dim]
            + [cfg.rgb_channels] * cfg.rgb_layers + [3])
        self.to(resolve_device(device))
        self.init(generator if generator is not None
                  else torch.Generator().manual_seed(0))

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        """Draw every parameter from ``generator`` with the JAX init law:
        lines 1{d=0} + N(0, 0.3) and a He-uniform projection, or a
        U(-1e-4, 1e-4) hash table; He-uniform MLPs."""
        if self.is_lowrank:
            lr = init_lowrank_params(self.lowrank_cfg, generator)
            for m, per_level in enumerate(lr["lines"]):
                for li, axes in enumerate(per_level):
                    for d, t in enumerate(axes):
                        self.lowrank.lines[m][li][d].copy_(t)
            self.lowrank.proj.copy_(lr["proj"])
        else:
            self.hash_table.copy_(init_hashgrid_params(self.hash_cfg,
                                                       generator))
        for w in [*self.sigma_mlp, *self.rgb_mlp]:
            bound = math.sqrt(6.0 / w.shape[0])
            w.copy_(torch.rand(w.shape, generator=generator) * (2 * bound)
                    - bound)
        return self

    @property
    def device(self):
        return self.sigma_mlp[0].device

    def _normalize(self, x):
        s = self.cfg.scale
        return torch.clamp((x + s) / (2 * s), 0.0, 1.0)

    def density(self, x, return_feat=False, window_alpha=None,
                grad_noise=None):
        """sigma (N,) at world positions x (N, 3) [and the (N, 16) sigma-MLP
        output whose channel 0 is log-sigma].

        ``window_alpha``: the Window grid's level window (none when None).
        ``grad_noise``: optional (N, hash_grad_samples) uniforms for the hash
        grids' sampled-corner table gradient (training only).
        """
        xn = self._normalize(x)
        if self.is_lowrank:
            enc = lowrank_encode(
                {"lines": self.lowrank.lines, "proj": self.lowrank.proj},
                xn, self.lowrank_cfg)
        else:
            win = None
            if self.cfg.grid == "Window" and window_alpha is not None:
                win = window_weights(self.hash_cfg, window_alpha, xn.device)
            enc = hashgrid_encode(self.hash_table, xn, self.hash_cfg, win,
                                  grad_noise)
        h = _mlp_apply(self.sigma_mlp, enc)
        sigmas = trunc_exp(h[:, 0])
        if return_feat:
            return sigmas, h
        return sigmas

    def forward(self, x, d, window_alpha=None, grad_noise=None):
        """(sigma (N,), rgb (N, 3)) at positions x with view directions d."""
        sigmas, h = self.density(x, return_feat=True,
                                 window_alpha=window_alpha,
                                 grad_noise=grad_noise)
        d = d / torch.linalg.norm(d, dim=1, keepdim=True)
        sh = sh_encode((d + 1.0) / 2.0, self.cfg.sh_degree)
        rgbs = _mlp_apply(self.rgb_mlp, torch.cat([sh, h], dim=1),
                          sigmoid=True)
        return sigmas, rgbs

    # ----------------------------------------------------- occupancy helpers
    def all_cell_coords(self):
        """(G^3, 3) int32 coords of every cell in Morton storage order."""
        return morton3d_invert(torch.arange(self.cfg.n_cells,
                                            device=self.device))

    def _cell_world_coords(self, coords, cascade, noise=None):
        """Cell coords -> world positions in the cascade's box, jittered by
        ``noise`` (same shape, uniform in [-1, 1)) times half a cell."""
        g = self.cfg.grid_size
        s = min(2 ** (cascade - 1), self.cfg.scale)
        half_grid_size = s / g
        xyzs = coords.to(torch.float32) / (g - 1) * 2.0 - 1.0
        xyzs_w = xyzs * (s - half_grid_size)
        if noise is not None:
            xyzs_w = xyzs_w + noise * half_grid_size
        return xyzs_w

    @torch.no_grad()
    def mark_invisible_cells(self, occ: OccupancyState, K, poses, img_wh,
                             chunk=64 ** 3) -> OccupancyState:
        """Frustum culling, once before training: a cell seen by no camera at
        depth >= NEAR_DISTANCE, or lying closer than that in front of any
        camera's image, gets density -1; every other cell 0. Also sets
        ``count_grid``, the fraction of cameras that see each cell.

        Args:
            K: (3, 3) intrinsics; poses: (N_cams, 3, 4) c2w; img_wh: (W, H).
        """
        g = self.cfg.grid_size
        w, h = int(img_wh[0]), int(img_wh[1])
        dev = self.device
        K = torch.as_tensor(K, dtype=torch.float32, device=dev)
        poses = torch.as_tensor(poses, dtype=torch.float32, device=dev)
        w2c_r = poses[:, :3, :3].transpose(1, 2)
        w2c_t = -torch.einsum("nij,nj->ni", w2c_r, poses[:, :3, 3])
        xyzs = self.all_cell_coords().to(torch.float32) / (g - 1) * 2.0 - 1.0
        counts, grids = [], []
        for c in range(self.cfg.cascades):
            s = min(2 ** (c - 1), self.cfg.scale)
            xyzs_w = xyzs * (s - s / g)
            for chunk_xyz in xyzs_w.split(chunk):
                xc = torch.einsum("nij,kj->nki", w2c_r, chunk_xyz) \
                    + w2c_t[:, None, :]
                uvd = torch.einsum("ij,nkj->nki", K, xc)
                depth = uvd[..., 2]
                uv = uvd[..., :2] / depth[..., None]
                in_image = ((depth >= 0) & (uv[..., 0] >= 0) & (uv[..., 0] < w)
                            & (uv[..., 1] >= 0) & (uv[..., 1] < h))
                count = ((depth >= NEAR_DISTANCE) & in_image).sum(0) \
                    .to(torch.float32) / poses.shape[0]
                too_near = ((depth < NEAR_DISTANCE) & in_image).any(0)
                counts.append(count)
                grids.append(torch.where((count > 0) & ~too_near, 0.0, -1.0))
        shape = (self.cfg.cascades, self.cfg.n_cells)
        return dataclasses.replace(
            occ, density_grid=torch.cat(grids).reshape(shape),
            count_grid=torch.cat(counts).reshape(shape))

    @torch.no_grad()
    def update_density_grid(self, occ: OccupancyState, density_threshold,
                            noise, decay=0.95, half=None,
                            erode=False) -> OccupancyState:
        """Dense refresh: evaluate sigma at a jittered point of every cell,
        EMA-merge into the grid, repack the bitfield.

        Args:
            noise: (C, M, 3) uniform jitter in [-1, 1) for the M cells
                evaluated: every cell (M = G^3), or with ``half`` every
                other one (M = G^3 / 2).
            density_threshold: the training threshold, 0.01*1024/sqrt(3);
                the bitfield uses min(mean positive density, it).
            half: 0 or 1 evaluates only the even or odd Morton cells; the
                skipped half decays like the reference's unsampled cells.
            erode: decay cells seen by few cameras faster (``count_grid``).
        """
        first, step = (0, 1) if half is None else (int(half), 2)
        coords = morton3d_invert(torch.arange(first, self.cfg.n_cells, step,
                                              device=self.device))
        grid = occ.density_grid
        tmp = torch.zeros_like(grid)
        for c in range(self.cfg.cascades):
            tmp[c, first::step] = self.density(
                self._cell_world_coords(coords, c, noise[c]))
        if erode:
            decay = torch.clamp(
                decay ** (1.0 / torch.clamp_min(occ.count_grid, 1e-8)),
                0.1, 0.95)
        new_grid = torch.where(grid < 0, grid,
                               torch.maximum(grid * decay, tmp))
        pos = new_grid > 0
        mean_density = torch.where(pos, new_grid, 0.0).sum() / \
            torch.clamp_min(pos.sum(), 1)
        threshold = torch.clamp_max(mean_density, density_threshold)
        return dataclasses.replace(
            occ, density_grid=new_grid,
            density_bitfield=packbits(new_grid, threshold))
