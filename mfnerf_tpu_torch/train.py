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
pools ``--pool_a`` cells to a side. The field runs on a static buffer of
slots (the capacity layout), so the step has no host read: the padded
step's N * s_max_train slots (the JAX padded branch) from step 0, and on
single-cascade scenes from step ``FLAT_AFTER`` the flat step's
``--s_flat`` samples a ray on average (``NeRFSystem.step_kind``).
Multi-cascade scenes (``--scale`` above 0.5) have no flat budget and take
the padded step to the end.

The fused runner (the JAX ``make_fused_train_fn``): on the card, ``fit``
replays CUDA graphs of the step and of the occupancy refresh (one a
refresh parity) instead of launching each step's ~200-400 kernels from the
host (:class:`FusedRunner`), as the JAX ``fit`` fuses every step
(``mfnerf_tpu/train.py:480-525``: ``fused_warm`` before ``FLAT_AFTER``; its
``mesh`` branch with the gradients' all-reduce inside, its
``optimize_ext`` branch with the poses refined inside). A replayed step is
bit for bit the same step run eagerly. :meth:`NeRFSystem.fused_ok` is the
rule: on a CUDA device, outside a process group or inside an NCCL one
(one card a rank), with or without ``--optimize_ext``, it serves every
step; on the CPU and in a gloo group (whose collectives run on the host
and cannot be captured) every step runs one at a time
(:meth:`NeRFSystem.train_step`).

``--use_exposure`` (HDR-NeRF) trains the log-radiance head with its
tonemappers at each ray's exposure (the rays' 4th column), adds the
unit-exposure loss and validates each view at its exposure.
``--optimize_ext`` refines the training poses: per image an axis-angle
``dR`` and a translation ``dT``, zero at the start, applied before
``get_rays`` and trained by their own Adam at ``--pose_lr`` (optax's
defaults, no schedule). ``--bf16`` runs the MLPs and the LowRank
projection on bf16 operands (``NGPConfig.compute_dtype``). ``--profile``
traces one epoch of 48 steps with ``torch.profiler`` (CPU and, on the
card, CUDA activities) into ``logs/<dataset>/<exp>/profile/trace.json``
before training, then resets the step counter to 0 as the JAX ``main``
does. The mp4 assembly is not ported.

Data parallelism (``--num_gpus N``, ``parallel/dist.py``): inside a
process group (``main`` starts one, or ``torchrun`` did) each rank draws
the whole batch of ``batch_size`` rays, its jitter, background and
refresh points from the same generator state and trains on its contiguous
slice; the gradients are averaged over the ranks by one all-reduce a
step, so parameters, optimiser state and occupancy stay the same on every
rank. The flat budget and the flat step's hash-grid gradient noise count
the samples of the ranks before this one (an exclusive prefix); the padded
step's noise is the rank's rows of the global batch's draw. So the W
ranks' step is the 1-rank step up to the order of the sums. Rank 0 alone
writes checkpoints, logs, test images and the profiler trace; validation
renders the test views round-robin and gathers the metrics. ``--eval_lpips
--lpips_weights <npz>`` adds ``test/lpips_vgg`` (``utils/lpips.py``).
``NGPConfig.lr_matmul_dtype`` picks the fused LowRank encoder's operand
type, bf16 (the default) or fp32: an ``hparams`` attribute
(``lr_matmul_dtype``), not a flag, as the command line keeps the JAX
package's flags.
"""
import dataclasses
import math
import os
import time
import weakref

import numpy as np
import torch

from .datasets import dataset_dict
from .datasets.png import write_png
from .datasets.ray_utils import axisangle_to_R, get_rays
from .device import no_tf32, resolve_device
from .losses import NeRFLoss
from .models.ngp import NGP, NGPConfig, OccupancyState
from .models.rendering import (MAX_SAMPLES, RenderConfig, capture_graph,
                               render_test, render_train, replay_graph,
                               side_stream_run)
from .ops.ray_march import twolevel_stratum
from .opt import TPU_ONLY, get_opts
from .parallel import dist as pdist
from .utils.lpips import load_lpips_weights
from .utils.ckpt import (adam_state_from_numpy, adam_state_to_numpy,
                         load_ckpt, load_params, occupancy_from_numpy,
                         occupancy_to_numpy, params_to_numpy, save_ckpt,
                         slim_ckpt)
from .utils.metrics import lpips_vgg
from .utils.metrics import psnr as psnr_fn
from .utils.metrics import ssim as ssim_fn

# the reference's grid warm-up length (train.py:61); the dense refresh makes
# warm-up and steady-state refreshes the same program, as in the JAX package
WARMUP_STEPS = 256
UPDATE_INTERVAL = 16      # steps between occupancy refreshes
FLAT_AFTER = 512          # the first step with the --s_flat budget
# the fused runner's eager steps on its side stream before it captures the
# step (PyTorch's whole-network recipe): real training steps, which also
# load the kernels and set their attributes
FUSED_WARMUP = 3
METRICS = ("loss", "psnr", "rm_s", "vr_s")   # a step's device metrics
STEPS_PER_EPOCH = 1000
PROFILE_STEPS = 48        # --profile's traced epoch (mfnerf_tpu/train.py:683)
GRIDS = ("LowRank", "Hash", "Window", "MixedFeature")
# --eval_lpips without --lpips_weights (the JAX message, mfnerf_tpu/
# train.py:545-558, naming the port's files): raised before any render
LPIPS_WEIGHTS_MISSING = (
    "--eval_lpips needs --lpips_weights <npz>. Write it once on a machine "
    "with network access and the lpips package: `pip install lpips && "
    "python misc/export_lpips_weights.py --out lpips_vgg.npz` (the JAX "
    "package's script), then pass --lpips_weights lpips_vgg.npz. The VGG16 "
    "weights do not ship with the repository; "
    "mfnerf_tpu_torch/utils/lpips.py computes the metric from them and "
    "tests/test_torch_lpips.py holds it to the JAX package's on seeded "
    "random weights.")
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


def check_lpips_weights(path):
    """Refuse LPIPS before any step or render: without weights (the JAX
    message, LPIPS_WEIGHTS_MISSING) or with a file that is not the
    canonical npz (its loader's ``ValueError``)."""
    if path is None:
        raise ValueError(LPIPS_WEIGHTS_MISSING)
    load_lpips_weights(path)


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
        if hp.grid not in GRIDS:
            raise NotImplementedError(f"grid={hp.grid} is not ported")
        if getattr(hp, "eval_lpips", False) \
                and getattr(hp, "lpips_weights", None) is None:
            raise ValueError(LPIPS_WEIGHTS_MISSING)
        strategy = getattr(hp, "ray_sampling_strategy", "all_images")
        if strategy not in SAMPLING:
            raise ValueError(f"ray_sampling_strategy={strategy!r}: not one "
                             f"of {SAMPLING}")
        self.same_image = strategy == "same_image"
        self.hparams = hp
        self.device = resolve_device(device)
        # data parallelism: this rank's shard of every batch inside a
        # process group (even of one rank), else None
        self.rank, self.world = pdist.world()
        num_gpus = getattr(hp, "num_gpus", 1)
        if num_gpus > 1 and num_gpus != self.world:
            raise ValueError(
                f"num_gpus={num_gpus} needs a process group of {num_gpus} "
                f"ranks (this process has {self.world}): run main, which "
                f"starts them, or torchrun")
        self.shard = pdist.Shard.of(hp.batch_size, self.device) \
            if pdist.in_group() else None
        self.model_cfg = NGPConfig(
            scale=hp.scale, grid=hp.grid, L=hp.L, F=hp.F,
            log2_T=getattr(hp, "T", 19), N_min=getattr(hp, "N_min", 16),
            N_max=getattr(hp, "N_max", 2048),
            N_tables=getattr(hp, "N_tables", 1),
            hash_grad_samples=getattr(hp, "hash_grad_samples", 8),
            rgb_channels=hp.rgb_channels, rgb_layers=hp.rgb_layers,
            rgb_act="None" if hp.use_exposure else "Sigmoid",
            grid_size=getattr(hp, "grid_size", 128),
            lr_levels=getattr(hp, "lr_levels", 8),
            lr_rank=getattr(hp, "lr_rank", 16),
            lr_frames=getattr(hp, "lr_frames", 2),
            lr_k_min=getattr(hp, "lr_k_min", 32),
            lr_k_max=getattr(hp, "lr_k_max", 512),
            lr_fused=getattr(hp, "lr_fused", False),
            lr_matmul_dtype=getattr(hp, "lr_matmul_dtype", "bfloat16"),
            compute_dtype="bfloat16" if getattr(hp, "bf16", False)
            else "float32",
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
        self.use_exposure = hp.use_exposure
        self._fused_logged = False

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
        of ray batches, march jitter and refresh jitter (``hparams.seed``).
        With ``--optimize_ext`` the poses' corrections ``dR`` and ``dT``
        ((N_img, 3) each, zero) are a second parameter group whose Adam
        runs at ``--pose_lr`` with optax's defaults and no schedule
        (``mfnerf_tpu/train.py:219-240``). On the card Adam becomes
        capturable at the first step (:meth:`_capturable_adam`); on the CPU
        it stays PyTorch's default."""
        hp, dev = self.hparams, self.device
        self.init_model(seed)
        ds = self.train_dataset
        if hp.optimize_ext:
            self.ext = {name: torch.nn.Parameter(torch.zeros(
                (len(ds.poses), 3), device=dev)) for name in ("dR", "dT")}
        weight_path = getattr(hp, "weight_path", None)
        if weight_path:   # partial warm start (mfnerf_tpu/train.py:224-226)
            load_params(self.model, load_ckpt(weight_path)["params"],
                        self.ext)
        self.poses = torch.from_numpy(ds.poses).to(dev)
        self.directions = torch.from_numpy(ds.directions).to(dev)
        # (N_img, H*W, 3), or 4 columns with each image's exposure
        self.rays = torch.from_numpy(ds.rays).to(dev)
        self.unit_exposure_rgb = getattr(ds, "unit_exposure_rgb", None)
        if self.use_exposure and self.unit_exposure_rgb is None:
            raise ValueError("use_exposure needs the training dataset's "
                             "unit_exposure_rgb")
        if self.unit_exposure_rgb is not None:   # once: no copy a step
            self.unit_exposure_rgb = torch.as_tensor(
                self.unit_exposure_rgb, dtype=torch.float32, device=dev)
        groups = [{"params": list(self.model.parameters()), "lr": hp.lr,
                   "eps": 1e-15}]
        if self.ext:    # optax.adam(pose_lr): eps 1e-8, betas (0.9, 0.999)
            groups.append({"params": list(self.ext.values()),
                           "lr": getattr(hp, "pose_lr", 1e-6), "eps": 1e-8})
        self.optimizer = torch.optim.Adam(groups)
        self.schedule = cosine_staircase_lr(hp.lr, hp.num_epochs,
                                            self.steps_per_epoch)
        # the schedule scales the network's group only
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, [lambda step: self.schedule(step) / hp.lr]
            + [lambda step: 1.0] * (len(groups) - 1))
        self.lr = hp.lr   # the network's learning rate, as the host knows it
        self.generator = torch.Generator(device=dev).manual_seed(hp.seed)
        self.global_step = 0
        self.n_refresh = 0
        self.culled = False
        self.fused = None           # the FusedRunner, once fit needs it
        # step kind -> the parameters with a gradient on every rank, as an
        # eager step's all-reduce found them (average_gradients)
        self.grad_sets = {}

    def init_model(self, seed=0):
        """The field drawn from ``seed`` and an empty occupancy state, with
        no pose corrections: all that serving a checkpoint needs
        (:meth:`restore` with ``with_optimizer=False``; eval and the
        viewer). :meth:`configure` starts from it."""
        self.model = NGP(self.model_cfg, torch.Generator().manual_seed(seed),
                         device=self.device)
        self.ext = {}
        self.occ = OccupancyState.create(self.model_cfg, self.device)

    def _rand(self, *shape):
        return torch.rand(shape, generator=self.generator, device=self.device)

    def update_grid(self):
        """One occupancy refresh: every cell, or with ``refresh_half`` the
        even or odd Morton half, alternating from refresh to refresh over
        the whole run. The grid, bitfield and stage-A grids are written in
        place (the fused runner's graphs read those tensors)."""
        self._refresh(self.n_refresh % 2 if self.refresh_half else None)
        self.n_refresh += 1

    def _refresh(self, half):
        """The refresh of ``half`` (None: every cell) in place: what the
        fused runner's refresh graphs capture."""
        cfg = self.model_cfg
        n = cfg.n_cells if half is None else cfg.n_cells // 2
        self.model.update_density_grid(
            self.occ, self.density_threshold,
            self._rand(cfg.cascades, n, 3) * 2 - 1, half=half,
            erode=self.erode, in_place=True)

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

    def batch_poses(self, img):
        """The c2w poses of the images ``img``: with ``--optimize_ext``
        refined, ``R(dR) @ pose[:, :3]`` and ``pose[:, 3] + dT``
        (``mfnerf_tpu/train.py:273-280``). The rotation and its product
        are taken in float64 and rounded once to float32, so that a pose is
        the same on every device: in float32 the card's sin, cos and
        fused multiply-adds differ from the CPU's in the last bit, and the
        last bit of a ray moves the fused encoder's bf16 hat weights
        (PERF.md §6)."""
        pose = self.poses[img]
        if not self.ext:
            return pose
        rot = (axisangle_to_R(self.ext["dR"][img].double())
               @ pose[..., :3].double()).float()
        return torch.cat([rot, (pose[..., 3] + self.ext["dT"][img])[
            ..., None]], dim=-1)

    def losses(self, results, target):
        """The loss terms of a step: ``NeRFLoss``'s, and with
        ``--use_exposure`` the unit-exposure term, half the squared error
        of zero log radiance's rgb at exposure 1 against the dataset's
        ``unit_exposure_rgb`` (``mfnerf_tpu/train.py:286-294``; a float32
        tensor on the device since :meth:`configure`). The
        tonemappers are bias-free, so that rgb is sigmoid(0) = 0.5 whatever
        their weights: the term is a constant, in both packages."""
        terms = self.loss(results, target)
        if self.use_exposure:
            dev = self.device
            unit_rgb = self.model.log_radiance_to_rgb(
                torch.zeros((1, 3), device=dev),
                exposure=torch.ones((1, 1), device=dev))
            terms["unit_exposure"] = 0.5 * (
                unit_rgb - self.unit_exposure_rgb) ** 2
        return terms

    def step_loss(self, img, pix, noise, bg=None, grad_noise=None):
        """The training loss on the rays of pixels ``pix`` of images ``img``
        (the JAX trainer's ``loss_fn``): the rays of the (refined) poses,
        ``render_train`` with the march jitter ``noise``, the background
        ``bg`` and the hash grids' ``grad_noise``, each ray's exposure where
        the rays carry one, and the loss terms (:meth:`losses`), on the step
        kind's buffer (:meth:`step_kind`); under data parallelism the rays
        are this rank's shard (:attr:`shard`). Returns (loss, results,
        target)."""
        rays_o, rays_d = get_rays(self.directions[pix], self.batch_poses(img))
        picked = self.rays[img, pix]
        target = {"rgb": picked[:, :3]}
        # HDR-NeRF rays carry their exposure; a Sigmoid head ignores it
        exposure = picked[:, 3:4] if picked.shape[1] == 4 else None
        rcfg = self.rcfg if self.step_kind() == "flat" \
            else dataclasses.replace(self.rcfg, s_flat=0)
        results = render_train(self.model, self.occ, rays_o, rays_d, noise,
                               rcfg, bg, grad_noise, exposure,
                               shard=self.shard)
        loss = sum(v.mean() for v in self.losses(results, target).values())
        return loss, results, target

    def train_step(self):
        """One optimiser step on a fresh ray batch, eagerly; its metrics as
        0-d tensors on the device (the learning rate as a float); the
        schedule advances a step. Under data parallelism every rank draws
        the global batch, its jitter, the background and the gradient noise
        of every valid sample, and takes its own part of each; the metrics
        are the global batch's."""
        out = dict(zip(METRICS, self._device_step().unbind()))
        out["lr"] = self.lr
        self._next_lr()
        return out

    def _next_lr(self):
        """Advance the schedule a step (LambdaLR: on the card it fills the
        network's rate tensor in place) and keep the new rate on the host,
        as LambdaLR computes it."""
        sch = self.scheduler
        sch.step()
        self.lr = sch.base_lrs[0] * sch.lr_lambdas[0](sch.last_epoch)

    def step_kind(self):
        """The kind of the next step, which sets its buffer: "flat" with
        ``s_flat`` > 0 from ``FLAT_AFTER`` (N * s_flat slots), else
        "padded" (N * s_max_train slots, the JAX padded branch)."""
        if self.rcfg.s_flat and self.global_step >= FLAT_AFTER:
            return "flat"
        return "padded"

    def _device_step(self):
        """:meth:`train_step`'s work on the device, which the fused runner
        captures: batch, rays, march, field, composite, loss, backward and
        Adam. Returns the metrics METRICS as one (4,) float32 tensor."""
        b, sh = self.hparams.batch_size, self.shard
        self._capturable_adam()
        img, pix = self.sample_batch()
        bg = self._rand(3) if self.rcfg.random_bg else None
        noise = self._rand(b)
        m = self.model_cfg.hash_grad_samples
        grad_noise = None       # the exact table gradient (and LowRank)
        if self.model_cfg.grid != "LowRank" and m < 8:
            if self.step_kind() == "flat":
                # the JAX flat branch's draw, a row a slot of the budget
                grad_noise = self._rand(b * self.rcfg.s_flat, m)
            else:
                # the JAX padded branch's draw, a row an entry of the
                # global batch's (N, S) rows; a shard takes its rays' rows
                s = self.rcfg.s_max_train
                grad_noise = self._rand(b * s, m)
                if sh is not None:
                    grad_noise = grad_noise[sh.lo * s:sh.hi * s]
        if sh is not None:
            img, pix, noise = sh.take(img), sh.take(pix), sh.take(noise)
        loss, results, target = self.step_loss(img, pix, noise, bg,
                                               grad_noise)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if sh is not None:
            self.average_gradients()
        self.optimizer.step()
        with torch.no_grad():
            if sh is None:
                return torch.stack([
                    loss.detach(), psnr_fn(results["rgb"], target["rgb"]),
                    results["rm_samples"] / b, results["vr_samples"] / b])
            # the ranks' means of loss and squared error (equal shards),
            # and their sample totals
            stats = pdist.all_sum(torch.stack([
                loss.detach().double(),
                torch.mean((results["rgb"] - target["rgb"]) ** 2).double(),
                results["rm_samples"].double(),
                results["vr_samples"].double()]))
            return torch.stack([
                (stats[0] / sh.world).float(),
                -10.0 * torch.log10((stats[1] / sh.world).float()),
                stats[2].long() / b, stats[3].long() / b])

    def average_gradients(self):
        """Average every gradient the optimiser holds (the field's, and
        ``dR``/``dT`` under ``--optimize_ext``) over the ranks. An eager
        call reads on the host which parameters carry a gradient (the
        flags of ``parallel/dist.py::average_gradients``) and keeps that set
        for the step's kind (:meth:`step_kind`; within a kind it is fixed:
        the capacity layout gives every field parameter a gradient, on a
        rank with no valid sample too), or None where the ranks disagree. A
        call inside a CUDA graph's capture (the fused runner's, after its
        eager warm-up steps of the kind) takes the kept set and reads
        nothing; without one it raises."""
        params = [p for group in self.optimizer.param_groups
                  for p in group["params"]]
        kind = self.step_kind()
        if not _capturing(self.device):
            self.grad_sets[kind] = pdist.average_gradients(params)
            return
        present = self.grad_sets.get(kind)
        if present is None:
            raise RuntimeError(
                f"the {kind} step's gradient all-reduce cannot be captured: "
                f"no eager step of its kind found one set of parameters "
                f"with a gradient on every rank")
        pdist.average_gradients(params, present)

    def fused_ok(self):
        """Whether the fused runner serves the next step (the rule, logged
        once): the device is CUDA and there is no process group, or its
        backend is NCCL (every rank on a card of its own:
        ``parallel/dist.py::backend_for``), whose collectives a CUDA graph
        captures. It then serves every step, of both kinds
        (:meth:`step_kind`): the padded step from step 0, on multi-cascade
        scenes (``s_flat`` 0) to the end, and from ``FLAT_AFTER`` the flat
        one where ``s_flat`` > 0; with or without ``--optimize_ext``,
        ``--use_exposure`` and ``--random_bg``. On the CPU and in a gloo
        group (CPU ranks, and ranks that share a card) every step runs one
        at a time."""
        backend = pdist.backend()
        why = ("not on a CUDA device" if self.device.type != "cuda"
               else f"inside a {backend} process group: {backend} "
               f"collectives cannot be captured"
               if backend not in (None, "nccl") else None)
        if not self._fused_logged and self.rank == 0:
            kinds = (f"the padded step from step 0, the flat step from "
                     f"step {FLAT_AFTER}" if self.rcfg.s_flat
                     else "the padded step (s_flat 0) from step 0 to the "
                     "end")
            group = (f", in an NCCL process group of {self.world} rank"
                     f"{'s' if self.world > 1 else ''}"
                     if backend == "nccl" else "")
            how = (f"CUDA graphs of {kinds} and of the refresh{group}"
                   if why is None else f"off ({why}), one step at a time")
            print(f"fused runner: {how}", flush=True)
        self._fused_logged = True
        return why is None

    def make_fused_train_fn(self):
        """The fused runner of this system (:class:`FusedRunner`), made once
        and kept: its graphs persist across :meth:`fit` calls."""
        if self.fused is None:
            self._capturable_adam()
            self.fused = FusedRunner(self)
        return self.fused

    def _capturable_adam(self):
        """On the card, Adam's state for CUDA graphs (:meth:`_device_step`
        calls it from the first step): every group capturable, each step
        count a float32 on the parameter's device, the network's learning
        rate a device tensor that the schedule fills in place (its base rate
        stays a float, so the scheduler reads nothing from the device).
        Every step, eager or replayed, with or without the runner, runs the
        same update. Done once; on the CPU Adam stays the default."""
        if self.device.type != "cuda" or self.optimizer.param_groups[0].get(
                "capturable"):
            return
        dev = self.device
        for group in self.optimizer.param_groups:
            group["capturable"] = True
            for p in group["params"]:
                state = self.optimizer.state.get(p, {})
                if "step" in state:
                    state["step"] = state["step"].to(dev, torch.float32)
        group = self.optimizer.param_groups[0]
        group["lr"] = torch.tensor(group["lr"], device=dev)

    def fit(self, n_steps=None):
        """Train ``n_steps`` more steps (default: up to num_epochs *
        steps_per_epoch). The first call culls the grid to the training
        cameras. A block of UPDATE_INTERVAL steps starts with an occupancy
        refresh; the fused runner replays both where :meth:`fused_ok`
        allows (``n_steps`` may start and end mid-block).
        Returns each step's loss, psnr, rm_s, vr_s and lr as CPU tensors of
        length n_steps."""
        total = self.hparams.num_epochs * self.steps_per_epoch
        end = total if n_steps is None else self.global_step + n_steps
        if not self.culled:
            ds = self.train_dataset
            self.occ = self.model.mark_invisible_cells(
                self.occ, ds.K, self.poses, ds.img_wh)
            self.culled = True
        n = end - self.global_step
        if n <= 0:
            return {}
        vecs = torch.empty((n, len(METRICS)), device=self.device)
        lrs = []
        runner = None
        for i in range(n):
            if runner is None and self.fused_ok():
                runner = self.make_fused_train_fn()
                runner.bind()
            if self.global_step % UPDATE_INTERVAL == 0:
                if runner is None:
                    self.update_grid()
                else:
                    runner.refresh()
            vecs[i] = self._device_step() if runner is None \
                else runner.step()
            lrs.append(self.lr)
            self._next_lr()
            self.global_step += 1
        out = dict(zip(METRICS, vecs.cpu().unbind(1)))
        out["lr"] = torch.tensor(lrs)
        return out

    def synchronize(self):
        """Wait for the device's queued work (host timings)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def set_step(self, step):
        """Continue from ``step``: the global step, and the learning rate an
        uninterrupted run would use at it (the poses' group keeps
        ``--pose_lr``); a rate tensor is filled in place."""
        self.global_step = step
        self.scheduler.last_epoch = step
        self.lr = self.schedule(step)
        group = self.optimizer.param_groups[0]
        if torch.is_tensor(group["lr"]):
            group["lr"].fill_(self.lr)
        else:
            group["lr"] = self.lr

    def save(self, ckpt_dir):
        """Write ``epoch=<E>.ckpt.npz`` (parameters with ``dR``/``dT``,
        occupancy, Adam state, step, and with ``--optimize_ext`` the
        training poses) and its slim copy, which keeps those poses, under
        ``ckpt_dir``."""
        epoch = self.hparams.num_epochs - 1
        path = os.path.join(ckpt_dir, f"epoch={epoch}.ckpt.npz")
        save_ckpt(path, params_to_numpy(self.model, self.ext),
                  occ=occupancy_to_numpy(self.occ),
                  opt_state=adam_state_to_numpy(self.optimizer, self.model,
                                                self.ext),
                  step=self.global_step,
                  poses=self.poses.cpu().numpy() if self.ext else None)
        slim_ckpt(path, os.path.join(ckpt_dir,
                                     f"epoch={epoch}_slim.ckpt.npz"),
                  save_poses=bool(self.ext))

    def restore(self, path, with_optimizer=True):
        """Load a checkpoint of either package: parameters (a partial,
        shape-checked load, ``dR``/``dT`` included), the occupancy grids
        and, ``with_optimizer``, the Adam state; then continue from its step
        (:meth:`set_step`). A system that :meth:`init_model` alone built
        takes the parameters and the occupancy, and the step as its
        counter."""
        ck = load_ckpt(path)
        load_params(self.model, ck["params"], self.ext)
        if "occ" in ck:
            self.occ = occupancy_from_numpy(ck["occ"], self.model_cfg,
                                            self.device)
        if not hasattr(self, "optimizer"):      # serving only
            self.global_step = ck["step"]
            return
        if with_optimizer and "opt_state" in ck:
            adam_state_from_numpy(self.optimizer, self.model,
                                  ck["opt_state"], self.ext)
        self.set_step(ck["step"])

    @torch.no_grad()
    def validate(self, save_dir=None, eval_lpips=False):
        """Render every test view with ``render_test`` (HDR-NeRF views at
        their own exposure); print a line an image and return the mean
        ``test/psnr`` and ``test/ssim`` and, with ``eval_lpips``,
        ``test/lpips_vgg`` (the weights of ``--lpips_weights``, checked
        before the first render). With ``save_dir``, write each view's
        ``NNN.png`` and its depth map ``NNN_d.png`` there. Under data
        parallelism rank r renders the views i with i % W == r, the
        metrics are gathered (``allgather_ragged``) and every rank returns
        the same dict; rank 0 writes every view's images."""
        lpips_weights = getattr(self.hparams, "lpips_weights", None)
        if eval_lpips:
            check_lpips_weights(lpips_weights)
        ds, dev = self.test_dataset, self.device
        rank, size = self.rank, self.world
        w, h = ds.img_wh
        directions = torch.from_numpy(ds.directions).to(dev)
        psnrs, ssims, lpipss = [], [], []
        for i in range(len(ds)):
            if i % size == rank:
                view = ds[i]
                self.synchronize()
                t0 = time.perf_counter()
                out = render_test(self.model, self.occ, *get_rays(
                    directions, torch.from_numpy(view["pose"]).to(dev)),
                    self.rcfg, exposure=view.get("exposure"))
                self.synchronize()
                ms = (time.perf_counter() - t0) * 1e3  # the render's time
                rgb_pred = out["rgb"].reshape(h, w, 3)
                logs = {}
                if "rgb" in view:
                    rgb_gt = torch.from_numpy(view["rgb"]).to(dev).reshape(
                        h, w, 3)
                    logs["psnr"] = float(psnr_fn(rgb_pred, rgb_gt))
                    logs["ssim"] = float(ssim_fn(rgb_pred, rgb_gt))
                    psnrs.append(logs["psnr"])
                    ssims.append(logs["ssim"])
                    if eval_lpips:
                        logs["lpips"] = float(lpips_vgg(
                            rgb_pred, rgb_gt, weights_path=lpips_weights))
                        lpipss.append(logs["lpips"])
                print(f"val image {i + 1}/{len(ds)}: " + ", ".join(
                    f"{k}={v:.4f}" for k, v in logs.items())
                    + f" [{ms:.1f} ms]", flush=True)
            if save_dir is None:
                continue
            if size > 1:     # the view's rgb and depth to every rank
                both = torch.zeros((h * w, 4), device=dev)
                if i % size == rank:
                    both[:, :3] = rgb_pred.reshape(-1, 3)
                    both[:, 3] = out["depth"]
                pdist.all_sum(both)
                rgb_pred, depth = both[:, :3].reshape(h, w, 3), both[:, 3]
            else:
                depth = out["depth"]
            if rank == 0:
                write_png(os.path.join(save_dir, f"{i:03d}.png"),
                          (rgb_pred.cpu().numpy() * 255).astype(np.uint8))
                write_png(os.path.join(save_dir, f"{i:03d}_d.png"),
                          depth2img(depth.reshape(h, w).cpu().numpy()))
        if size > 1:
            n = len(ds)
            psnrs, ssims, lpipss = (pdist.allgather_ragged(v, n, dev)
                                    for v in (psnrs, ssims, lpipss))
        out = {}
        if psnrs:
            out["test/psnr"] = float(np.mean(psnrs))
            out["test/ssim"] = float(np.mean(ssims))
        if lpipss:
            out["test/lpips_vgg"] = float(np.mean(lpipss))
        return out


class FusedRunner:
    """The JAX ``make_fused_train_fn`` (``mfnerf_tpu/train.py:321-457``) on
    the card: a training step (:meth:`NeRFSystem._device_step` on the
    capacity layout: no host read, static shapes) and the occupancy
    refresh of each parity (in place), each captured once as a CUDA graph
    and replayed by :meth:`NeRFSystem.fit`, one host call a step instead of
    a few hundred launches.

    The step graph is of one step kind (:meth:`NeRFSystem.step_kind`): the
    padded step (the JAX ``fused_warm``, N * s_max_train slots) from step
    0, and on single-cascade scenes from ``FLAT_AFTER`` the flat one (N *
    s_flat slots). A step of another kind than the graph's
    drops the graph, frees its memory pool and captures its own after its
    own warm-up.

    Capture follows PyTorch's whole-network recipe: FUSED_WARMUP eager
    steps of the kind on a side stream first (real training steps), the
    gradients set to None inside the capture, the trainer's generator
    registered with each graph, so that every replay draws fresh batches,
    jitter and refresh points as the eager steps would, bit for bit. A
    refresh parity's first refresh runs eagerly on the side stream and its
    graph is captured after it. The refresh halves alternate with
    ``n_refresh`` over the whole run, as the eager trainer does (the JAX
    runner restarts the parity at each dispatch). Each graph has a memory
    pool of its own.

    :meth:`bind` (``fit`` calls it) checks that the parameters, the Adam
    state, the staged rays and the learning rate are still the tensors
    captured, and captures anew if not; an occupancy that replaced the
    captured one (a checkpoint, a caller) is copied into the captured
    tensors. Each replay adds the kernel launches that its capture recorded
    to the wrappers' ``launches``, so that they read as an eager run's.
    A capture that fails, or meets a host sync, raises: so does one made
    while a caller still holds the autograd graph of an eager step on the
    default stream (its gradient accumulators keep that stream).

    Under ``--optimize_ext`` the graphs read and write ``dR``, ``dT`` and
    their Adam group too (:meth:`bind` checks them): the poses' float64
    refinement, the march's differentiable recomputation of the samples,
    the gathers' backward and the encoders' point gradients are captured
    with the step. Inside an NCCL process group (one card a rank) the
    step's collectives are captured with it: the flat budget's prefix
    (``Shard.prefix``), the gradients' all-reduce (with the set of
    parameters that carry a gradient, which the kind's eager warm-up steps
    found on every rank: :meth:`NeRFSystem.average_gradients`) and the
    metrics' sums. What this build (PyTorch 2.11 with CUDA 12.8 and NCCL
    2.28) needs for it, as ``tools/nccl_capture_probe.py`` found on an
    H100: the communicator must exist before the first capture (the
    kind's warm-up steps make it, their collectives run on the side
    stream where the capture then runs; an all-reduce captured with no
    communicator yet invalidates the capture); NCCL runs each collective on
    a stream of its own, which the capture joins to the side stream by
    events; and nothing else: the process group's watchdog thread, which
    polls the warm-up steps' collectives, left every capture in the
    default mode intact. No environment variable is set. A gloo group's
    collectives run on the host and cannot be captured
    (:meth:`NeRFSystem.fused_ok`)."""

    def __init__(self, system):
        # a proxy: the system owns the runner, and a deleted system frees
        # the graphs' memory pools with it (no reference cycle to wait for)
        self.system = weakref.proxy(system)
        self.stream = torch.cuda.Stream(system.device)
        self._reset()

    def _reset(self):
        self.kind = None                # the step graph's step kind
        self.step_graph = None
        self.refresh_graphs = {}        # parity (None: every cell) -> graph
        self.launches = {}              # graph -> {wrapper: launches}
        self.metrics = None             # the step graph's (4,) output
        self.warm = 0                   # eager warm-up steps of the kind
        self.occ = self.system.occ
        self.tensors = self._tensors()

    def _drop_step(self):
        """Forget the step graph, its memory pool freed, and its warm-up."""
        if self.step_graph is not None:
            del self.launches[self.step_graph]
            self.step_graph.reset()
            self.step_graph = self.metrics = None
            torch.cuda.empty_cache()
        self.warm = 0

    def _tensors(self):
        """The data pointers of every tensor the graphs read but the
        occupancy: parameters (with ``--optimize_ext``'s ``dR`` and
        ``dT``), their Adam state, staged rays, the network's learning
        rate."""
        s = self.system
        params = [*s.model.parameters(), *s.ext.values()]
        state = [t for p in params
                 for t in s.optimizer.state.get(p, {}).values()
                 if torch.is_tensor(t)]
        lr = s.optimizer.param_groups[0]["lr"]
        return tuple(t.data_ptr() for t in (
            *params, *state, s.rays, s.directions, s.poses, lr)
            if torch.is_tensor(t))

    def bind(self):
        """Before replays: capture anew if a tensor the graphs read was
        replaced; copy a replaced occupancy into the captured one."""
        s = self.system
        if self._tensors() != self.tensors:
            self._reset()
            return
        if s.occ is self.occ:
            return
        new = s.occ
        if new.derived_from is not new.density_bitfield:
            new = new.refresh_coarse(s.model_cfg)
        names = ("density_grid", "density_bitfield", "count_grid",
                 "stage_a", "union_bits")
        pairs = [(getattr(self.occ, k), getattr(new, k)) for k in names]
        if any((a is None) != (b is None)
               or (a is not None and a.shape != b.shape) for a, b in pairs):
            self._reset()
            return
        for a, b in pairs:
            if a is not None:
                a.copy_(b)
        self.occ.derived_from, self.occ.stage_a_share = \
            self.occ.density_bitfield, None
        s.occ = self.occ

    def _side(self, fn):
        """``fn()`` eagerly on the side stream."""
        return side_stream_run(self.stream, fn, self.system.device)

    def _capture(self, fn):
        """(graph, fn's output inside it) of ``fn`` captured on the side
        stream; the launch counts its capture recorded are kept for the
        replays and taken off the wrappers' counts."""
        graph, out, self.launches[graph] = capture_graph(
            fn, self.stream, self.system.generator)
        return graph, out

    def _replay(self, graph):
        replay_graph(graph, self.launches[graph])

    def refresh(self):
        """The occupancy refresh of the system's next parity."""
        s = self.system
        half = s.n_refresh % 2 if s.refresh_half else None
        graph = self.refresh_graphs.get(half)
        if graph is None:
            self._side(lambda: s._refresh(half))
            self.refresh_graphs[half] = self._capture(
                lambda: s._refresh(half))[0]
        else:
            self._replay(graph)
        s.occ.stage_a_share = None
        s.n_refresh += 1

    def step(self):
        """One training step; its metrics METRICS as a (4,) tensor (the
        step graph's output, overwritten by the next replay)."""
        s = self.system
        kind = s.step_kind()
        if kind != self.kind:
            self._drop_step()
            self.kind = kind
        if self.step_graph is None and self.warm < FUSED_WARMUP:
            self.warm += 1
            return self._side(s._device_step)
        if self.step_graph is None:
            self.step_graph, self.metrics = self._capture(s._device_step)
            # what bind checks: with Adam's state, which the first step made
            self.tensors = self._tensors()
        self._replay(self.step_graph)
        return self.metrics


def _capturing(device):
    """Whether a CUDA graph is being captured on ``device``'s current
    stream."""
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def profile(system, trace_dir):
    """Trace one epoch of PROFILE_STEPS training steps with
    ``torch.profiler`` (CPU activities, and CUDA ones on the card) into
    ``trace_dir/trace.json`` (a Chrome trace), as the JAX ``main``'s
    ``--profile`` does (``mfnerf_tpu/train.py:677-688``); then restore the
    epoch settings and set the step counter to 0, as it does. Returns the
    trace's path."""
    from torch.profiler import ProfilerActivity
    activities = [ProfilerActivity.CPU]
    if system.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    hp = system.hparams
    saved = hp.num_epochs, system.steps_per_epoch
    hp.num_epochs, system.steps_per_epoch = 1, PROFILE_STEPS
    try:
        with torch.profiler.profile(activities=activities) as prof:
            system.fit()
            system.synchronize()
    finally:
        hp.num_epochs, system.steps_per_epoch = saved
    system.set_step(0)
    path = os.path.join(trace_dir, "trace.json")
    if system.rank == 0:      # under data parallelism rank 0's trace
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(path)
        print(f"profiler trace written to {trace_dir}", flush=True)
    return path


def main(hparams, device=None, devices=None):
    """The command line's run (``mfnerf_tpu/train.py:640-729``) on ``device``
    (default: the CUDA device; raises without one): train unless
    ``--val_only``, save the checkpoints, validate, print and return the
    test metrics. ``--ckpt_path`` restores parameters, occupancy, the Adam
    state (not under ``--val_only``) and the step first.

    Data parallelism: inside a process group (``torchrun`` made one, or
    the caller did) every rank runs the same; else ``--num_gpus N > 1``
    starts N ranks (``parallel/dist.py::spawn``), one a card: asking for
    more cards than the machine has raises ``ValueError``. With
    ``device="cpu"`` the ranks are CPU processes (gloo); ``devices``, a
    list of a device a rank, is for tests, where ranks may share a card.
    Returns rank 0's metrics."""
    if hparams.val_only and not hparams.ckpt_path:
        raise ValueError("You need to provide a @ckpt_path for validation!")
    if hparams.eval_lpips:       # before any step or render
        check_lpips_weights(getattr(hparams, "lpips_weights", None))
    no_tf32()
    if pdist.in_group():
        return _run(hparams, device)
    joined = pdist.join_from_env()       # under torchrun
    if joined is not None:
        return _run(hparams, joined)
    num = getattr(hparams, "num_gpus", 1)
    if num > 1:
        return pdist.spawn(_run_rank, pdist.rank_devices(num, device, devices),
                           (hparams,))[0]
    return _run(hparams, device)


def _run_rank(rank, device, hparams):
    return _run(hparams, device)


def _run(hparams, device):
    """:func:`main`'s run in one process (a rank of a process group, or
    alone)."""
    t_start = time.time()
    for name, default in TPU_ONLY.items():
        if getattr(hparams, name) != default:
            print(f"--{name} {getattr(hparams, name)}: a TPU formulation "
                  f"flag of the JAX package; the port ignores it", flush=True)

    system = NeRFSystem(hparams, device=device)
    system.setup()
    system.configure(hparams.seed)
    lead = system.rank == 0      # rank 0 alone writes and logs

    ckpt_dir = f"ckpts/{hparams.dataset_name}/{hparams.exp_name}"
    log_dir = f"logs/{hparams.dataset_name}/{hparams.exp_name}"
    writer = None
    if lead:
        os.makedirs(ckpt_dir, exist_ok=True)
        os.makedirs(log_dir, exist_ok=True)
        try:
            from tensorboardX import SummaryWriter
            writer = SummaryWriter(log_dir)
        except ImportError:
            pass

    if hparams.ckpt_path:
        system.restore(hparams.ckpt_path,
                       with_optimizer=not hparams.val_only)

    if getattr(hparams, "profile", False) and not hparams.val_only:
        profile(system, os.path.join(log_dir, "profile"))

    train_ms = None
    if not hparams.val_only:
        total = hparams.num_epochs * system.steps_per_epoch
        start = system.global_step
        system.synchronize()
        t0 = time.perf_counter()
        while system.global_step < total:
            m = system.fit(min(system.steps_per_epoch,
                               total - system.global_step))
            if lead:
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
        if lead:
            print(f"training took {train_s:.1f}s", flush=True)
            system.save(ckpt_dir)
        if system.global_step > start:
            train_ms = train_s * 1e3 / (system.global_step - start)

    save_dir = None
    if not hparams.no_save_test:
        save_dir = f"results/{hparams.dataset_name}/{hparams.exp_name}"
        if lead:
            os.makedirs(save_dir, exist_ok=True)
    metrics = system.validate(save_dir=save_dir,
                              eval_lpips=hparams.eval_lpips)
    if train_ms is not None:     # host clock, synchronised around fit
        metrics["train/ms_per_step"] = train_ms
    if not lead:
        return metrics
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
