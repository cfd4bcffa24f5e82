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

``rgb_act="None"`` is HDR-NeRF's head (``--use_exposure``): the rgb MLP
outputs log radiance, which three bias-free 1 -> 64 -> 1 tonemappers
(``tonemappers.<c>.<i>``) map to rgb at a ray's exposure
(:meth:`NGP.log_radiance_to_rgb`, always in fp32). ``compute_dtype=
"bfloat16"`` (``--bf16``) runs the MLPs and the LowRank projection on bf16
operands with fp32 accumulation, as the JAX package's ``_mlp_apply`` and
``lowrank_encode`` do: the input and each hidden activation are rounded to
bf16, and a layer whose output the next op reads in fp32 (an MLP's last
layer, the projection) keeps its fp32 sums. Hidden layers are bf16 GEMMs;
the fp32-output layers multiply the bf16-rounded operands in fp32, which is
exact per product, so that their sums are not rounded to bf16.

``OccupancyState`` carries the training march's stage-A grids, derived
from the bitfield wherever it changes (``refresh_coarse``, the JAX name).
The TPU-only neighbourhood-row tables are not ported.
"""
import dataclasses
import math

import torch
from torch import nn

from ..device import resolve_device
from ..ops.activations import trunc_exp
from ..ops.hashgrid import (HashGridConfig, hashgrid_encode,
                            init_hashgrid_params, window_weights)
from ..ops.lowrank import (LowRankConfig, init_lowrank_params,
                           lowrank_encode, matmul_f32)
from ..ops.morton import morton3d_invert, packbits, union_bitfield
from ..ops.ray_march import cascades_stratum, stage_a_grid
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
    rgb_act: str = "Sigmoid"      # "Sigmoid" | "None" (HDR: log radiance)
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
    # the fused encoder's hat-product operands: "bfloat16" | "float32"
    # (the JAX lr_matmul_dtype; csrc/hatmul.cu has a kernel for each)
    lr_matmul_dtype: str = "bfloat16"
    # the MLPs' and the projection's operands: "float32" | "bfloat16"
    compute_dtype: str = "float32"
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
            fused=self.lr_fused, matmul_dtype=self.lr_matmul_dtype)

    @property
    def n_cells(self) -> int:
        return self.grid_size ** 3


@dataclasses.dataclass
class OccupancyState:
    """Occupancy grid: per-cell density (C, G^3) in Morton order, its packed
    bitfield (C*G^3//8,) uint8, the fraction of training cameras that see
    each cell (C, G^3), which ``erode`` reads (None until set), and the
    training march's stage-A grids, which :meth:`refresh_coarse` derives
    from the bitfield: ``stage_a`` at one cascade (``ray_march
    .stage_a_grid``), ``union_bits`` at several (``morton.union_bitfield``,
    where ``ray_march.cascades_stratum`` gives a stratum); None elsewhere.
    ``derived_from`` is the bitfield they were derived from;
    ``stage_a_share`` the share of ``stage_a``'s cells that are set, which
    the serving loop reads once a derivation (None until then)."""
    density_grid: torch.Tensor
    density_bitfield: torch.Tensor
    count_grid: torch.Tensor = None
    stage_a: torch.Tensor = None
    union_bits: torch.Tensor = None
    derived_from: torch.Tensor = dataclasses.field(default=None, repr=False)
    stage_a_share: float = dataclasses.field(default=None, repr=False)

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
                                   device=device)).refresh_coarse(cfg)

    def refresh_coarse(self, cfg: NGPConfig,
                       in_place=False) -> "OccupancyState":
        """Derive the stage-A grids from ``density_bitfield`` (after a
        refresh, a checkpoint load or a direct edit of the bitfield): a new
        state, or ``in_place`` written into this state's grids (which must
        have been derived before), so that a captured CUDA graph that reads
        them reads the new ones."""
        bits, stage_a, union = self.density_bitfield, None, None
        if cfg.cascades == 1:
            stage_a = stage_a_grid(bits, cfg.grid_size, cfg.pool_a or 2)
        else:
            stratum, dilate = cascades_stratum(
                1 / 256, cfg.scale, cfg.cascades, dir_norm=cfg.dir_norm)
            if stratum:
                union = union_bitfield(bits, cfg.grid_size, cfg.cascades,
                                       dilate)
        if not in_place:
            return dataclasses.replace(self, stage_a=stage_a,
                                       union_bits=union, derived_from=bits,
                                       stage_a_share=None)
        for name, new in (("stage_a", stage_a), ("union_bits", union)):
            old = getattr(self, name)
            if (old is None) != (new is None):
                raise ValueError(f"{name}: nothing to refresh in place")
            if new is not None:
                old.copy_(new)
        self.derived_from, self.stage_a_share = bits, None
        return self

    def to(self, device) -> "OccupancyState":
        """A copy on ``device``, its derived grids with it."""
        moved = {f.name: None if getattr(self, f.name) is None
                 else getattr(self, f.name).to(device)
                 for f in dataclasses.fields(self)
                 if f.name not in ("derived_from", "stage_a_share")}
        fresh = self.derived_from is self.density_bitfield
        return OccupancyState(**moved, derived_from=(
            moved["density_bitfield"] if fresh else None),
            stage_a_share=self.stage_a_share)


def _mlp_params(sizes):
    return nn.ParameterList(
        [nn.Parameter(torch.empty(fan_in, fan_out))
         for fan_in, fan_out in zip(sizes[:-1], sizes[1:])])




def _mlp_apply(ws, x, sigmoid=False, dtype=torch.float32):
    """Bias-free MLP, ReLU hidden layers. With ``dtype`` bfloat16: the input
    and each hidden activation in bf16 (bf16 GEMMs), the last layer's sums
    and output in fp32."""
    if dtype == torch.float32:
        h = x
        for w in ws[:-1]:
            h = torch.relu(h @ w)
        h = h @ ws[-1]
    else:
        h = x.to(dtype)
        for w in ws[:-1]:
            h = torch.relu(h @ w.to(dtype))
        h = matmul_f32(h, ws[-1], dtype)
    return torch.sigmoid(h) if sigmoid else h


class NGP(nn.Module):
    """The NGP field on ``device`` (default: the CUDA device; raises without
    one). Parameters are drawn by :meth:`init`."""

    def __init__(self, cfg: NGPConfig, generator: torch.Generator = None,
                 device=None):
        super().__init__()
        if cfg.rgb_act not in ("Sigmoid", "None"):
            raise ValueError(f"rgb_act={cfg.rgb_act!r}: Sigmoid or None")
        if cfg.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype={cfg.compute_dtype!r}: float32 "
                             f"or bfloat16")
        if cfg.lr_matmul_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"lr_matmul_dtype={cfg.lr_matmul_dtype!r}: "
                             f"float32 or bfloat16")
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.compute_dtype)
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
        if cfg.rgb_act == "None":   # HDR-NeRF: one tonemapper a channel
            self.tonemappers = nn.ModuleList(
                [_mlp_params([1, 64, 1]) for _ in range(3)])
        self.to(resolve_device(device))
        self.init(generator if generator is not None
                  else torch.Generator().manual_seed(0))

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        """Draw every parameter from ``generator`` with the JAX init law:
        lines 1{d=0} + N(0, 0.3) and a He-uniform projection, or a
        U(-1e-4, 1e-4) hash table; He-uniform MLPs (the tonemappers
        last)."""
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
        tms = [w for tm in getattr(self, "tonemappers", []) for w in tm]
        for w in [*self.sigma_mlp, *self.rgb_mlp, *tms]:
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
                grad_noise=None, count=None):
        """sigma (N,) at world positions x (N, 3) [and the (N, 16) sigma-MLP
        output whose channel 0 is log-sigma].

        ``window_alpha``: the Window grid's level window (none when None).
        ``grad_noise``: optional (N, hash_grad_samples) uniforms for the hash
        grids' sampled-corner table gradient (training only).
        ``count``: the valid count of a static buffer of N samples (one
        int64 on x's device, the trainer's capacity layout): the encoder
        kernels evaluate and differentiate the rows before it only (the
        rows past it encode to zeros).
        """
        xn = self._normalize(x)
        if self.is_lowrank:
            enc = lowrank_encode(
                {"lines": self.lowrank.lines, "proj": self.lowrank.proj},
                xn, self.lowrank_cfg, dtype=self.dtype, count=count)
        else:
            win = None
            if self.cfg.grid == "Window" and window_alpha is not None:
                win = window_weights(self.hash_cfg, window_alpha, xn.device)
            enc = hashgrid_encode(self.hash_table, xn, self.hash_cfg, win,
                                  grad_noise, count)
        h = _mlp_apply(self.sigma_mlp, enc, dtype=self.dtype)
        sigmas = trunc_exp(h[:, 0])
        if return_feat:
            return sigmas, h
        return sigmas

    def log_radiance_to_rgb(self, log_radiances, exposure=None):
        """HDR-NeRF tonemapping (``rgb_act="None"``): channel c's log
        radiance plus log(exposure) through tonemapper c, a sigmoid out; in
        fp32 whatever ``compute_dtype`` is. ``exposure``: (N, 1) or (1, 1),
        or None for exposure 1."""
        if exposure is not None:
            log_radiances = log_radiances + torch.log(exposure)
        return torch.cat([_mlp_apply(tm, log_radiances[:, c:c + 1],
                                     sigmoid=True)
                          for c, tm in enumerate(self.tonemappers)], dim=1)

    def forward(self, x, d, exposure=None, output_radiance=False,
                window_alpha=None, grad_noise=None, count=None):
        """(sigma (N,), rgb (N, 3)) at positions x with view directions d.
        With ``rgb_act="None"`` the rgb head's log radiance is tonemapped at
        ``exposure`` (per sample (N, 1) or (1, 1)), or with
        ``output_radiance`` returned as radiance; a Sigmoid head ignores
        both. ``count``: :meth:`density`'s."""
        sigmas, h = self.density(x, return_feat=True,
                                 window_alpha=window_alpha,
                                 grad_noise=grad_noise, count=count)
        d = d / torch.linalg.norm(d, dim=1, keepdim=True)
        sh = sh_encode((d + 1.0) / 2.0, self.cfg.sh_degree)
        inp = torch.cat([sh, h], dim=1)
        if self.cfg.rgb_act == "Sigmoid":
            return sigmas, _mlp_apply(self.rgb_mlp, inp, sigmoid=True,
                                      dtype=self.dtype)
        rgbs = _mlp_apply(self.rgb_mlp, inp, dtype=self.dtype)
        if output_radiance:
            return sigmas, trunc_exp(rgbs)
        return sigmas, self.log_radiance_to_rgb(rgbs, exposure)

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

    def _sampled_cells(self, grid, density_threshold, idx_uniform, u):
        """The sampled refresh's cells of one cascade: ``idx_uniform`` and as
        many occupied cells (density above the threshold) drawn uniformly by
        inverse CDF from the uniforms ``u``, or ``idx_uniform`` again when
        no cell is occupied."""
        csum = torch.cumsum((grid > density_threshold).to(torch.float32), 0)
        n_occ = csum[-1]
        idx_occupied = torch.clamp(
            torch.searchsorted(csum, u * n_occ, right=True), 0,
            grid.shape[0] - 1)
        idx_occupied = torch.where(n_occ > 0, idx_occupied, idx_uniform)
        return torch.cat([idx_uniform, idx_occupied])

    @torch.no_grad()
    def update_density_grid(self, occ: OccupancyState, density_threshold,
                            noise, decay=0.95, half=None, erode=False,
                            sparse=None, in_place=False) -> OccupancyState:
        """Refresh: evaluate sigma at a jittered point of every cell (dense),
        of half of them, or of sampled cells; EMA-merge into the grid,
        repack the bitfield.

        Args:
            noise: (C, M, 3) uniform jitter in [-1, 1) for the M cells
                evaluated: every cell (M = G^3), with ``half`` every other
                one (M = G^3 / 2), with ``sparse`` the 2 G^3 / 4 sampled ones.
            density_threshold: the training threshold, 0.01*1024/sqrt(3);
                the bitfield uses min(mean positive density, it).
            half: 0 or 1 evaluates only the even or odd Morton cells; the
                skipped half decays like the reference's unsampled cells.
            erode: decay cells seen by few cameras faster (``count_grid``).
            sparse: the reference's sampled refresh (the JAX
                ``sparse=True``): (idx_uniform (C, G^3/4) int64 cell indices,
                u (C, G^3/4) uniforms in [0, 1)) draw G^3/4 uniform cells and
                as many occupied ones (:meth:`_sampled_cells`) a cascade;
                each cell keeps the largest of its draws' densities.
            in_place: write the new grid, bitfield and stage-A grids into
                ``occ``'s tensors (the trainer's refresh, which CUDA graphs
                capture) and return ``occ``; the values are bit for bit the
                new state's.
        """
        grid = occ.density_grid
        tmp = torch.zeros_like(grid)
        if sparse is not None:
            idx_uniform, u = sparse
            for c in range(self.cfg.cascades):
                idx = self._sampled_cells(grid[c], density_threshold,
                                          idx_uniform[c], u[c])
                sig = self.density(self._cell_world_coords(
                    morton3d_invert(idx), c, noise[c]))
                tmp[c].scatter_reduce_(0, idx, sig, reduce="amax")
        else:
            first, step = (0, 1) if half is None else (int(half), 2)
            coords = morton3d_invert(torch.arange(
                first, self.cfg.n_cells, step, device=self.device))
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
        if in_place:
            occ.density_grid.copy_(new_grid)
            occ.density_bitfield.copy_(packbits(new_grid, threshold))
            return occ.refresh_coarse(self.cfg, in_place=True)
        return dataclasses.replace(
            occ, density_grid=new_grid,
            density_bitfield=packbits(new_grid, threshold)
        ).refresh_coarse(self.cfg)
