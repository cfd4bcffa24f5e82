"""Training: port of ``mfnerf_tpu/train.py``'s ``NeRFSystem``.

``NeRFSystem(hparams)``, then ``setup(train_dataset, test_dataset)``, then
``configure()``, then ``fit()``: the same entry points, hyperparameter names
and step as the JAX package. A step samples a batch of rays on the device,
renders it with :func:`models.rendering.render_train`, takes ``NeRFLoss`` and
its gradient by autograd (through the hand-written hat-product kernels on the
card) and applies Adam (eps 1e-15) on the cosine-staircase learning rate. The
occupancy grid is culled to the training cameras once, then refreshed every
``UPDATE_INTERVAL`` steps (alternating even/odd Morton halves with
``refresh_half``).

The JAX package's fused multi-step runner exists to spare TPU dispatch round
trips and is not ported; the port runs one step per call. Not ported yet:
the on-disk dataset loaders and the CLI, ``optimize_ext``, HDR exposure,
the Hash grids, data parallelism and the sampled (``sparse``) refresh.
"""
import math

import torch

from .datasets.ray_utils import get_rays
from .losses import NeRFLoss
from .models.ngp import NGP, NGPConfig, OccupancyState
from .models.rendering import (MAX_SAMPLES, RenderConfig, render_test,
                               render_train)
from .utils.metrics import psnr as psnr_fn

# the reference's grid warm-up length (train.py:61); the dense refresh makes
# warm-up and steady-state refreshes the same program, as in the JAX package
WARMUP_STEPS = 256
UPDATE_INTERVAL = 16      # steps between occupancy refreshes
STEPS_PER_EPOCH = 1000


def cosine_staircase_lr(lr0, num_epochs, steps_per_epoch=STEPS_PER_EPOCH):
    """CosineAnnealingLR(T_max=num_epochs-1, eta_min=lr0*0.01) stepped once
    an epoch: step -> learning rate."""
    eta_min = lr0 * 0.01
    t_max = max(num_epochs - 1, 1)

    def schedule(step):
        epoch = min(step // steps_per_epoch, t_max)
        return eta_min + 0.5 * (lr0 - eta_min) * (
            1 + math.cos(math.pi * epoch / t_max))

    return schedule


class NeRFSystem:
    """Trainer of a LowRank NGP field on an in-memory dataset."""

    def __init__(self, hparams, device=None):
        hp = hparams
        unported = {"grid": hp.grid != "LowRank",
                    "use_exposure": hp.use_exposure,
                    "optimize_ext": hp.optimize_ext,
                    "bf16": getattr(hp, "bf16", False)}
        for name, on in unported.items():
            if on:
                raise NotImplementedError(f"{name}={getattr(hp, name)} is "
                                          f"not ported")
        self.hparams = hp
        self.device = torch.device(
            device or ("cuda" if torch.cuda.is_available() else "cpu"))
        self.model_cfg = NGPConfig(
            scale=hp.scale, L=hp.L, F=hp.F, rgb_channels=hp.rgb_channels,
            rgb_layers=hp.rgb_layers,
            grid_size=getattr(hp, "grid_size", 128),
            lr_levels=getattr(hp, "lr_levels", 8),
            lr_rank=getattr(hp, "lr_rank", 16),
            lr_frames=getattr(hp, "lr_frames", 2),
            lr_k_min=getattr(hp, "lr_k_min", 32),
            lr_k_max=getattr(hp, "lr_k_max", 512),
            lr_fused=getattr(hp, "lr_fused", False))
        self.rcfg = RenderConfig(
            exp_step_factor=1 / 256 if hp.scale > 0.5 else 0.0,
            random_bg=hp.random_bg,
            max_samples=getattr(hp, "max_samples", MAX_SAMPLES),
            s_max_train=hp.s_max_train, s_max_test=hp.s_max_test,
            test_chunk=hp.test_chunk)
        self.loss = NeRFLoss(lambda_distortion=hp.distortion_loss_w)
        self.density_threshold = 0.01 * MAX_SAMPLES / (3 ** 0.5)
        self.steps_per_epoch = getattr(hp, "steps_per_epoch",
                                       STEPS_PER_EPOCH)
        self.refresh_half = getattr(hp, "refresh_half", False)
        self.erode = getattr(hp, "dataset_name", "") == "colmap"

    def setup(self, train_dataset, test_dataset=None):
        """In-memory datasets (``datasets.memory.MemoryDataset``)."""
        self.train_dataset = train_dataset
        self.test_dataset = test_dataset

    def configure(self, seed=0):
        """Draw the field from ``seed``, stage the training views on the
        device, and build the optimiser, the schedule and the generator of
        ray batches, march jitter and refresh jitter (``hparams.seed``)."""
        hp, dev = self.hparams, self.device
        self.model = NGP(self.model_cfg, torch.Generator().manual_seed(seed),
                         device=dev)
        self.occ = OccupancyState.create(self.model_cfg, dev)
        ds = self.train_dataset
        self.poses = torch.from_numpy(ds.poses).to(dev)
        self.directions = torch.from_numpy(ds.directions).to(dev)
        self.rays = torch.from_numpy(ds.rays).to(dev)   # (N_img, H*W, 3)
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=hp.lr,
                                          eps=1e-15)
        schedule = cosine_staircase_lr(hp.lr, hp.num_epochs,
                                       self.steps_per_epoch)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, lambda step: schedule(step) / hp.lr)
        self.generator = torch.Generator(device=dev).manual_seed(hp.seed)
        self.global_step = 0
        self.n_refresh = 0
        self.culled = False

    def _rand(self, *shape):
        return torch.rand(shape, generator=self.generator, device=self.device)

    def update_grid(self):
        """One occupancy refresh: every cell, or with ``refresh_half`` the
        even or odd Morton half, alternating from refresh to refresh."""
        cfg = self.model_cfg
        half = self.n_refresh % 2 if self.refresh_half else None
        n = cfg.n_cells if half is None else cfg.n_cells // 2
        self.occ = self.model.update_density_grid(
            self.occ, self.density_threshold,
            self._rand(cfg.cascades, n, 3) * 2 - 1, half=half,
            erode=self.erode)
        self.n_refresh += 1

    def train_step(self):
        """One optimiser step on a fresh ray batch; its metrics as 0-d
        tensors on the device (the learning rate as a float)."""
        b, dev = self.hparams.batch_size, self.device
        n_img, hw = self.rays.shape[:2]
        img = torch.randint(n_img, (b,), generator=self.generator, device=dev)
        pix = torch.randint(hw, (b,), generator=self.generator, device=dev)
        rays_o, rays_d = get_rays(self.directions[pix], self.poses[img])
        target = {"rgb": self.rays[img, pix]}
        bg = self._rand(3) if self.rcfg.random_bg else None
        results = render_train(self.model, self.occ, rays_o, rays_d,
                               self._rand(b), self.rcfg, bg)
        loss = sum(v.mean() for v in self.loss(results, target).values())
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        lr = self.optimizer.param_groups[0]["lr"]
        self.scheduler.step()
        with torch.no_grad():
            return {"loss": loss.detach(),
                    "psnr": psnr_fn(results["rgb"], target["rgb"]),
                    "rm_s": results["rm_samples"] / b,
                    "vr_s": results["vr_samples"] / b, "lr": lr}

    def fit(self, n_steps=None):
        """Train ``n_steps`` more steps (default: up to num_epochs *
        steps_per_epoch). The first call culls the grid to the training
        cameras. Returns each step's loss, psnr, rm_s, vr_s and lr as CPU
        tensors of length n_steps."""
        total = self.hparams.num_epochs * self.steps_per_epoch
        end = total if n_steps is None else self.global_step + n_steps
        if not self.culled:
            ds = self.train_dataset
            self.occ = self.model.mark_invisible_cells(
                self.occ, ds.K, self.poses, ds.img_wh)
            self.culled = True
        steps = []
        while self.global_step < end:
            if self.global_step % UPDATE_INTERVAL == 0:
                self.update_grid()
            steps.append(self.train_step())
            self.global_step += 1
        if not steps:
            return {}
        out = {k: torch.stack([m[k] for m in steps]).cpu()
               for k in ("loss", "psnr", "rm_s", "vr_s")}
        out["lr"] = torch.tensor([m["lr"] for m in steps])
        return out

    @torch.no_grad()
    def validate(self):
        """Render every test view with ``render_test``; their mean PSNR."""
        ds, dev = self.test_dataset, self.device
        directions = torch.from_numpy(ds.directions).to(dev)
        psnrs = []
        for i in range(len(ds)):
            view = ds[i]
            out = render_test(self.model, self.occ, *get_rays(
                directions, torch.from_numpy(view["pose"]).to(dev)),
                self.rcfg)
            psnrs.append(float(psnr_fn(out["rgb"],
                                       torch.from_numpy(view["rgb"]).to(dev))))
        return {"test/psnr": sum(psnrs) / len(psnrs)}
