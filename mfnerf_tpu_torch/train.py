"""Training: port of ``mfnerf_tpu/train.py``'s ``NeRFSystem``.

``NeRFSystem(hparams)``, then ``setup(train_dataset, test_dataset)``, then
``configure()``, then ``fit()``: the same entry points, hyperparameter names
and step as the JAX package. A step samples a batch of rays on the device,
renders it with :func:`models.rendering.render_train`, takes ``NeRFLoss`` and
its gradient by autograd (through the hand-written encoder kernels on the
card: the hat product of the LowRank grid, or the hash-grid encoder of the
Hash, Window and MixedFeature grids) and applies Adam (eps 1e-15) on the
cosine-staircase learning rate. The occupancy grid is culled to the training
cameras once, then refreshed every ``UPDATE_INTERVAL`` steps (alternating
even/odd Morton halves with ``refresh_half``). Rays come from all images, or
with ``ray_sampling_strategy="same_image"`` from one image a batch.

The JAX package's fused multi-step runner exists to spare TPU dispatch round
trips and is not ported; the port runs one step per call. Not ported yet:
the on-disk dataset loaders and the CLI, ``optimize_ext``, HDR exposure,
the ``weight_path`` warm start, data parallelism (``num_gpus`` > 1) and the
sampled (``sparse``) refresh; the trainer raises ``NotImplementedError`` for
those of its hyperparameters.
"""
import math

import torch

from .datasets.ray_utils import get_rays
from .device import resolve_device
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
GRIDS = ("LowRank", "Hash", "Window", "MixedFeature")
SAMPLING = ("all_images", "same_image")    # ray_sampling_strategy


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
    """Trainer of an NGP field on an in-memory dataset, on ``device``
    (default: the CUDA device; raises without one, never falls back to the
    CPU)."""

    def __init__(self, hparams, device=None):
        hp = hparams
        unported = {"grid": hp.grid not in GRIDS,
                    "use_exposure": hp.use_exposure,
                    "optimize_ext": hp.optimize_ext,
                    "bf16": getattr(hp, "bf16", False),
                    "weight_path": getattr(hp, "weight_path", None),
                    "num_gpus": getattr(hp, "num_gpus", 1) > 1}
        for name, on in unported.items():
            if on:
                raise NotImplementedError(f"{name}={getattr(hp, name)} is "
                                          f"not ported")
        strategy = getattr(hp, "ray_sampling_strategy", "all_images")
        if strategy not in SAMPLING:
            raise ValueError(f"ray_sampling_strategy={strategy!r}: not one "
                             f"of {SAMPLING}")
        self.same_image = strategy == "same_image"
        self.hparams = hp
        self.device = resolve_device(device)
        self.model_cfg = NGPConfig(
            scale=hp.scale, grid=hp.grid, L=hp.L, F=hp.F,
            log2_T=getattr(hp, "T", 19), N_min=getattr(hp, "N_min", 16),
            N_max=getattr(hp, "N_max", 2048),
            N_tables=getattr(hp, "N_tables", 1),
            hash_grad_samples=getattr(hp, "hash_grad_samples", 8),
            rgb_channels=hp.rgb_channels, rgb_layers=hp.rgb_layers,
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

    def sample_batch(self):
        """(image, pixel) indices of a ray batch, drawn on the device: an
        image a ray, or with ``ray_sampling_strategy="same_image"`` one image
        a batch (``mfnerf_tpu/train.py:353-358``); pixels uniform."""
        b, dev = self.hparams.batch_size, self.device
        n_img, hw = self.rays.shape[:2]
        img = torch.randint(n_img, (1 if self.same_image else b,),
                            generator=self.generator, device=dev).expand(b)
        pix = torch.randint(hw, (b,), generator=self.generator, device=dev)
        return img, pix

    def train_step(self):
        """One optimiser step on a fresh ray batch; its metrics as 0-d
        tensors on the device (the learning rate as a float)."""
        b = self.hparams.batch_size
        img, pix = self.sample_batch()
        rays_o, rays_d = get_rays(self.directions[pix], self.poses[img])
        target = {"rgb": self.rays[img, pix]}
        bg = self._rand(3) if self.rcfg.random_bg else None
        m = self.model_cfg.hash_grad_samples
        grad_noise = None       # the exact table gradient (and LowRank)
        if self.model_cfg.grid != "LowRank" and m < 8:
            def grad_noise(n_valid):
                return self._rand(n_valid, m)
        results = render_train(self.model, self.occ, rays_o, rays_d,
                               self._rand(b), self.rcfg, bg, grad_noise)
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
