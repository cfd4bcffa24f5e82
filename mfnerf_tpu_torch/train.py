"""Training: port of ``mfnerf_tpu/train.py``'s ``NeRFSystem`` and ``main``.

``NeRFSystem(hparams)``, then ``setup()``, then ``configure()``, then
``fit()`` and ``validate()``: the same entry points, hyperparameter names
and step as the JAX package. ``setup()`` without datasets loads
``--dataset_name`` from ``--root_dir`` (``datasets.dataset_dict``); tests
and benchmarks pass in-memory datasets instead. A step samples a batch
of rays on the device, renders it with
:func:`models.rendering.render_train`, takes ``NeRFLoss`` and its
gradient by autograd (through the hand-written encoder kernels on the
card: the hat product of the LowRank grid, or the hash-grid encoder of
the Hash, Window and MixedFeature grids) and applies Adam (eps 1e-15) on
the cosine-staircase learning rate. The occupancy grid is culled to the
training cameras once, then refreshed every ``UPDATE_INTERVAL`` steps
(alternating even/odd Morton halves with ``refresh_half``). Rays come
from all images, or with ``ray_sampling_strategy="same_image"`` from one
image a batch.

The command line is the JAX package's (``opt.py``):

    python -m mfnerf_tpu_torch.train --root_dir <dir> --exp_name <name> ...

:func:`main` trains, writes ``ckpts/<dataset>/<exp>/epoch=<E>.ckpt.npz``
and its slim copy, validates the test views (PSNR and SSIM) and writes
``results/<dataset>/<exp>/NNN.png`` and ``NNN_d.png``, all relative to the
working directory; ``--val_only --ckpt_path`` validates a checkpoint. The
checkpoints are the JAX package's format (``utils/ckpt.py``).

The march keeps the JAX package's strata budget on synthetic scenes
(``models/rendering.py``): ``setup`` sizes the strata from the cameras'
largest ``|d|`` (``dir_norm``) and ``--s_max_train``, their coarse grid
pools ``--pool_a`` cells to a side, and from step ``FLAT_AFTER`` a batch
keeps ``--s_flat`` samples a ray on average. The JAX package's fused
multi-step runner exists to spare TPU dispatch round trips and is not
ported; the port runs one step per call. Not ported yet: ``optimize_ext``,
HDR exposure (``use_exposure``), ``bf16``, data parallelism (``num_gpus`` >
1), LPIPS (``eval_lpips``), the profiler (``profile``), the sampled
(``sparse``) refresh and the mp4 assembly; the trainer raises
``NotImplementedError`` for those of its hyperparameters.
"""
import dataclasses
import math
import os
import time

import numpy as np
import torch

from .datasets import dataset_dict
from .datasets.png import write_png
from .datasets.ray_utils import get_rays
from .device import resolve_device
from .losses import NeRFLoss
from .models.ngp import NGP, NGPConfig, OccupancyState
from .models.rendering import (MAX_SAMPLES, RenderConfig, render_test,
                               render_train)
from .ops.ray_march import twolevel_stratum
from .opt import TPU_ONLY, get_opts
from .utils.ckpt import (adam_state_from_numpy, adam_state_to_numpy,
                         load_ckpt, load_params, occupancy_from_numpy,
                         occupancy_to_numpy, params_to_numpy, save_ckpt,
                         slim_ckpt)
from .utils.metrics import psnr as psnr_fn
from .utils.metrics import ssim as ssim_fn

# the reference's grid warm-up length (train.py:61); the dense refresh makes
# warm-up and steady-state refreshes the same program, as in the JAX package
WARMUP_STEPS = 256
UPDATE_INTERVAL = 16      # steps between occupancy refreshes
FLAT_AFTER = 512          # the first step with the --s_flat budget
STEPS_PER_EPOCH = 1000
GRIDS = ("LowRank", "Hash", "Window", "MixedFeature")
SAMPLING = ("all_images", "same_image")    # ray_sampling_strategy
# cv2.COLORMAP_TURBO as cv2.applyColorMap returns it (BGR) for the values
# 0-255: 256 x 3 uint8, hex. The JAX package saves that BGR output as RGB
# (mfnerf_tpu/train.py:45-50,612-619); depth2img keeps its channel order.
TURBO_BGR = np.frombuffer(bytes.fromhex(
    "3b12304315324a1833511b34581e355f21366624376d2738732a39792d3a802f3b86323c"
    "8b353d91383e973b3f9c3e3fa24040a74341ac4641b14942b54b42ba4e43bf5144c35444"
    "c75644cb5945cf5c45d35e45d66146da6446dd6646e06946e36b46e66e47e97147eb7347"
    "ee7647f07847f27b47f47d46f68046f88246fa8546fb8746fc8a45fd8c45fe8f44fe9143"
    "ff9442ff9641ff9940fe9b3efe9e3dfda03bfca33afba538faa837f8ab35f7ad33f5af31"
    "f4b22ff2b42ef0b72ceeb92aebbc28e9be27e7c025e4c323e2c522dfc720ddc91fdacb1e"
    "d8cd1cd5d01bd2d21ad0d41acdd519cad718c8d918c5db18c2dd18c0de18bde018bbe219"
    "b9e319b6e41ab4e61cb2e71dafe91facea20aaeb22a7ec25a4ee27a1ef2a9ef02c9bf12f"
    "98f23294f33591f4388ef53c8af63f87f74384f84680f84a7df94e7afa5276fa5573fb59"
    "6ffc5d6cfc6169fd6566fd6962fe6d5ffe715cfe7559fe7956ff7d53ff8051ff844eff88"
    "4bff8b49ff8f47ff9244fe9642fe9940fe9c3ffd9f3dfda13cfca43afca739fba938fbac"
    "37faaf36f9b136f8b435f7b735f6b934f5bc34f4be34f3c134f1c334f0c634efc834edcb"
    "34eccd34ead035e9d235e7d435e5d736e4d936e2db37e0dd37dfdf37dde138dbe338d9e5"
    "39d7e739d5e939d3eb3ad1ec3acfee3acdef3acbf13ac9f23ac7f43ac5f53ac3f63ac1f7"
    "39bef839bcf939bafa38b8fb37b6fb36b3fc36b1fc35aefd34acfd33a9fe32a7fe31a4fe"
    "30a1fe2f9efe2d9bfe2c99fe2b96fe2a93fe2990fe278dfd268afd2587fc2384fc2281fb"
    "217efb1f7bfa1e78f91d75f91c72f81a6ff7196cf61869f51766f41563f31460f2135df1"
    "125bf01158ef1055ed0f53ec0e50eb0d4eea0c4be80c49e70b47e50a45e40a43e20941e1"
    "083fdf083ddd073bdc0739da0637d80635d60533d40531d2052fd0042dce042bcc042aca"
    "0328c80326c50325c30223c10221be0220bc021eb9021db7011bb4011ab20118af0117ac"
    "0116a90114a70113a40112a101109e010f9b010e98010d95010b92010a8e02098b020888"
    "02078502068102057e03047a"), np.uint8).reshape(256, 3)


def depth2img(depth):
    """Colourise a depth map as the JAX package does: min-max normalised,
    to uint8, through cv2's TURBO table (BGR order). (H, W) -> (H, W, 3)."""
    depth = (depth - depth.min()) / (depth.max() - depth.min() + 1e-8)
    return TURBO_BGR[(depth * 255).astype(np.uint8)]


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
    """Trainer of an NGP field on ``device`` (default: the CUDA device;
    raises without one, never falls back to the CPU)."""

    def __init__(self, hparams, device=None):
        hp = hparams
        unported = {"grid": hp.grid not in GRIDS,
                    "use_exposure": hp.use_exposure,
                    "optimize_ext": hp.optimize_ext,
                    "bf16": getattr(hp, "bf16", False),
                    "num_gpus": getattr(hp, "num_gpus", 1) > 1,
                    "eval_lpips": getattr(hp, "eval_lpips", False),
                    "profile": getattr(hp, "profile", False)}
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
            lr_fused=getattr(hp, "lr_fused", False),
            pool_a=(getattr(hp, "pool_a", 0) if getattr(hp, "grid_size", 128)
                    % max(getattr(hp, "pool_a", 0), 1) == 0 else 0))
        self.rcfg = RenderConfig(
            exp_step_factor=1 / 256 if hp.scale > 0.5 else 0.0,
            random_bg=hp.random_bg,
            max_samples=getattr(hp, "max_samples", MAX_SAMPLES),
            s_max_train=hp.s_max_train, s_max_test=hp.s_max_test,
            test_chunk=hp.test_chunk,
            # multi-cascade scenes march ~50 samples a ray: no flat budget
            s_flat=0 if hp.scale > 0.5 else getattr(hp, "s_flat", 0))
        self.loss = NeRFLoss(lambda_distortion=hp.distortion_loss_w)
        self.density_threshold = 0.01 * MAX_SAMPLES / (3 ** 0.5)
        self.steps_per_epoch = getattr(hp, "steps_per_epoch",
                                       STEPS_PER_EPOCH)
        self.refresh_half = getattr(hp, "refresh_half", False)
        self.erode = getattr(hp, "dataset_name", "") == "colmap"

    def setup(self, train_dataset=None, test_dataset=None):
        """The datasets: in-memory ones (``datasets.memory.MemoryDataset``),
        or without them ``--dataset_name``'s loader on ``--root_dir``, its
        ``--split`` for training and its ``test`` split, at
        ``--downsample``."""
        hp = self.hparams
        if train_dataset is None:
            dataset = dataset_dict[hp.dataset_name]
            kwargs = {"root_dir": hp.root_dir, "downsample": hp.downsample}
            train_dataset = dataset(split=hp.split, **kwargs)
            test_dataset = dataset(split="test", **kwargs)
        self.train_dataset = train_dataset
        self.test_dataset = test_dataset
        # the strata's bound on |rays_d| (directions are unnormalized), to
        # 1/16 above the cameras' largest, and their budget: about 2.25 x
        # s_max_train rungs (mfnerf_tpu/train.py:170-209)
        dn = max([1.0] + [
            float(np.linalg.norm(ds.directions, axis=-1).max())
            for ds in (train_dataset, test_dataset)
            if getattr(ds, "directions", None) is not None])
        cfg = self.model_cfg = dataclasses.replace(
            self.model_cfg, dir_norm=math.ceil(dn * 16.0) / 16.0)
        stratum = twolevel_stratum(self.rcfg.exp_step_factor,
                                   self.rcfg.max_samples, cfg.scale,
                                   cfg.grid_size, cfg.cascades, cfg.dir_norm)
        s_max = self.rcfg.s_max_train
        self.rcfg = dataclasses.replace(self.rcfg, s_strata=(
            max(4, -(-(9 * s_max // 4) // stratum)) if stratum
            else max(4, s_max // 8)))

    def configure(self, seed=0):
        """Draw the field from ``seed`` (then, with ``--weight_path``, load
        the parameters that checkpoint holds), stage the training views on
        the device, and build the optimiser, the schedule and the generator
        of ray batches, march jitter and refresh jitter (``hparams.seed``)."""
        hp, dev = self.hparams, self.device
        self.model = NGP(self.model_cfg, torch.Generator().manual_seed(seed),
                         device=dev)
        weight_path = getattr(hp, "weight_path", None)
        if weight_path:   # partial warm start (mfnerf_tpu/train.py:224-226)
            load_params(self.model, load_ckpt(weight_path)["params"])
        self.occ = OccupancyState.create(self.model_cfg, dev)
        ds = self.train_dataset
        self.poses = torch.from_numpy(ds.poses).to(dev)
        self.directions = torch.from_numpy(ds.directions).to(dev)
        self.rays = torch.from_numpy(ds.rays).to(dev)   # (N_img, H*W, 3)
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=hp.lr,
                                          eps=1e-15)
        self.schedule = cosine_staircase_lr(hp.lr, hp.num_epochs,
                                            self.steps_per_epoch)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, lambda step: self.schedule(step) / hp.lr)
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
        rcfg = self.rcfg if self.global_step >= FLAT_AFTER \
            else dataclasses.replace(self.rcfg, s_flat=0)
        results = render_train(self.model, self.occ, rays_o, rays_d,
                               self._rand(b), rcfg, bg, grad_noise)
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

    def synchronize(self):
        """Wait for the device's queued work (host timings)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def set_step(self, step):
        """Continue from ``step``: the global step, and the learning rate an
        uninterrupted run would use at it."""
        self.global_step = step
        self.scheduler.last_epoch = step
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(step)

    def save(self, ckpt_dir):
        """Write ``epoch=<E>.ckpt.npz`` (parameters, occupancy, Adam state,
        step) and its slim copy under ``ckpt_dir``."""
        epoch = self.hparams.num_epochs - 1
        path = os.path.join(ckpt_dir, f"epoch={epoch}.ckpt.npz")
        save_ckpt(path, params_to_numpy(self.model),
                  occ=occupancy_to_numpy(self.occ),
                  opt_state=adam_state_to_numpy(self.optimizer, self.model),
                  step=self.global_step)
        slim_ckpt(path, os.path.join(ckpt_dir,
                                     f"epoch={epoch}_slim.ckpt.npz"))

    def restore(self, path, with_optimizer=True):
        """Load a checkpoint of either package: parameters (a partial,
        shape-checked load), the occupancy grids and, ``with_optimizer``,
        the Adam state; then continue from its step (:meth:`set_step`)."""
        ck = load_ckpt(path)
        load_params(self.model, ck["params"])
        if "occ" in ck:
            self.occ = occupancy_from_numpy(ck["occ"], self.model_cfg,
                                            self.device)
        if with_optimizer and "opt_state" in ck:
            adam_state_from_numpy(self.optimizer, self.model,
                                  ck["opt_state"])
        self.set_step(ck["step"])

    @torch.no_grad()
    def validate(self, save_dir=None):
        """Render every test view with ``render_test``; print a line an
        image and return the mean ``test/psnr`` and ``test/ssim``. With
        ``save_dir``, write each view's ``NNN.png`` and its depth map
        ``NNN_d.png`` there."""
        ds, dev = self.test_dataset, self.device
        w, h = ds.img_wh
        directions = torch.from_numpy(ds.directions).to(dev)
        psnrs, ssims = [], []
        for i in range(len(ds)):
            view = ds[i]
            self.synchronize()
            t0 = time.perf_counter()
            out = render_test(self.model, self.occ, *get_rays(
                directions, torch.from_numpy(view["pose"]).to(dev)),
                self.rcfg)
            self.synchronize()
            ms = (time.perf_counter() - t0) * 1e3      # the render's time
            rgb_pred = out["rgb"].reshape(h, w, 3)
            logs = {}
            if "rgb" in view:
                rgb_gt = torch.from_numpy(view["rgb"]).to(dev).reshape(h, w, 3)
                logs["psnr"] = float(psnr_fn(rgb_pred, rgb_gt))
                logs["ssim"] = float(ssim_fn(rgb_pred, rgb_gt))
                psnrs.append(logs["psnr"])
                ssims.append(logs["ssim"])
            if save_dir is not None:
                write_png(os.path.join(save_dir, f"{i:03d}.png"),
                          (rgb_pred.cpu().numpy() * 255).astype(np.uint8))
                write_png(os.path.join(save_dir, f"{i:03d}_d.png"),
                          depth2img(out["depth"].reshape(h, w).cpu().numpy()))
            print(f"val image {i + 1}/{len(ds)}: " + ", ".join(
                f"{k}={v:.4f}" for k, v in logs.items())
                + f" [{ms:.1f} ms]", flush=True)
        if not psnrs:
            return {}
        return {"test/psnr": float(np.mean(psnrs)),
                "test/ssim": float(np.mean(ssims))}


def main(hparams, device=None):
    """The command line's run (``mfnerf_tpu/train.py:640-729``) on ``device``
    (default: the CUDA device; raises without one): train unless
    ``--val_only``, save the checkpoints, validate, print and return the
    test metrics. ``--ckpt_path`` restores parameters, occupancy, the Adam
    state (not under ``--val_only``) and the step first."""
    t_start = time.time()
    if hparams.val_only and not hparams.ckpt_path:
        raise ValueError("You need to provide a @ckpt_path for validation!")
    for name, default in TPU_ONLY.items():
        if getattr(hparams, name) != default:
            print(f"--{name} {getattr(hparams, name)}: a TPU formulation "
                  f"flag of the JAX package; the port ignores it", flush=True)

    system = NeRFSystem(hparams, device=device)
    system.setup()
    system.configure(hparams.seed)

    ckpt_dir = f"ckpts/{hparams.dataset_name}/{hparams.exp_name}"
    os.makedirs(ckpt_dir, exist_ok=True)
    log_dir = f"logs/{hparams.dataset_name}/{hparams.exp_name}"
    os.makedirs(log_dir, exist_ok=True)
    writer = None
    try:
        from tensorboardX import SummaryWriter
        writer = SummaryWriter(log_dir)
    except ImportError:
        pass

    if hparams.ckpt_path:
        system.restore(hparams.ckpt_path,
                       with_optimizer=not hparams.val_only)

    train_ms = None
    if not hparams.val_only:
        total = hparams.num_epochs * system.steps_per_epoch
        start = system.global_step
        system.synchronize()
        t0 = time.perf_counter()
        while system.global_step < total:
            m = system.fit(min(system.steps_per_epoch,
                               total - system.global_step))
            print(f"step {system.global_step:6d}/{total} "
                  f"loss {float(m['loss'][-1]):.4f} "
                  f"psnr {float(m['psnr'][-1]):.2f} "
                  f"rm_s {float(m['rm_s'][-1]):.1f} "
                  f"vr_s {float(m['vr_s'][-1]):.1f} "
                  f"[{time.perf_counter() - t0:.0f}s]", flush=True)
            if writer is not None:    # the chunk's last step, as JAX logs
                writer.add_scalar("lr", float(m["lr"][-1]),
                                  system.global_step - 1)
                for key in ("loss", "rm_s", "vr_s", "psnr"):
                    writer.add_scalar(f"train/{key}", float(m[key][-1]),
                                      system.global_step - 1)
        system.synchronize()
        train_s = time.perf_counter() - t0
        print(f"training took {train_s:.1f}s", flush=True)
        if system.global_step > start:
            train_ms = train_s * 1e3 / (system.global_step - start)
        system.save(ckpt_dir)

    save_dir = None
    if not hparams.no_save_test:
        save_dir = f"results/{hparams.dataset_name}/{hparams.exp_name}"
        os.makedirs(save_dir, exist_ok=True)
    metrics = system.validate(save_dir=save_dir)
    if train_ms is not None:     # host clock, synchronised around fit
        metrics["train/ms_per_step"] = train_ms
    for k, v in metrics.items():
        print(f"{k}: {v:.4f}")
        if writer is not None:
            writer.add_scalar(k, v, system.global_step)
    if save_dir is not None and hparams.dataset_name == "nsvf" \
            and "Synthetic" in hparams.root_dir:
        print("video assembly skipped: the port writes no mp4", flush=True)
    if writer is not None:
        writer.close()
    runtime = time.strftime("%H:%M:%S", time.gmtime(time.time() - t_start))
    print(f"Total runtime: {runtime}", flush=True)
    return metrics


if __name__ == "__main__":
    main(get_opts())
