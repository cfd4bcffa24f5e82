"""Drive the PyTorch/CUDA port's serving and training paths once on one
NVIDIA GPU, for a LowRank field and for a MixedFeature hash-grid field, and
the encoder formulation probes (mfnerf_tpu_torch/benchmarking/).

    python3 chip_smoke.py

Phases (one line each; any failure ends the run with a non-zero exit):

1. device: the card's name and power limit (nvidia-smi), CUDA, nvcc, Triton;
2. build, 11. build_hashgrid and 16a. build_linetable: compile the
   hat-product, the hash-grid and the line-table kernels from
   mfnerf_tpu_torch/csrc/, one nvcc each, started together;
3. kernel: hat_prod's kernel against its plain torch version at the serving
   shapes (N = 2^20 samples, K = 257 knots, R = 128 columns), with both times;
4. state: a seeded bench-width LowRank field and one dense occupancy refresh
   (2,097,152 cells through the kernel);
5. serve: eight distinct 800x800 frames of the procedural scene through
   render_test (the alive-ray loop), T_threshold 1e-2; the kernel's launch
   count is reset just before and read just after;
6. oracle: a strided ~8k-ray subset of frame 0 against the plain dense
   oracle render_test_dense (run on the CPU, where hat_prod is the plain
   version);
7. kernel_bwd: hat_prod's backward kernel against its plain torch version at
   the padded training step's largest shapes (N = 8192 x 64 = 2^19 samples
   of uniform u, K = 257, R = 128): dW bitwise equal across launches (with
   and without du), dW and du against the plain version, the kernel's time
   beside its bound; then the same checks on ragged edges (R = 40, N =
   2,100 in two chunks, a strided g);
8. train_step_oracle: one training step's loss and parameter gradients on
   the card (both kernels) against the same step on the CPU (the plain
   versions), same weights, rays and march jitter;
9. train: the JAX bench's training configuration (bench.py: 8192-ray
   batches, lr 1e-2, half-dense refresh every 16 steps) on 16 procedural
   800x800 views for 900 steps through NeRFSystem.fit; both kernels' launch
   counts are reset just before and read just after;
10. test_view: the held-out 800x800 view through render_test (T_threshold
   1e-4) before and after training;
7b. kernel_bwd (shape "train"): phase 7's checks and times on the operands
   of one real training step of the trained field (one LowRank frame's u
   and g as HatProd.backward receives them: g a column slice of the (N, 2R)
   feature gradient, read in place), and hat_prod's time on the same u
   (through its wrapper, so at this size mostly the host's;
   tools/hat_bwd_ab.py times the kernel alone);
12. kernel_hashgrid: the hash-grid kernels against their plain torch
   versions for the CLI's default Hash grid (L 16, F 2, T 19) and the
   reference's MixedFeature benchmark grid (T 20, 8 tables), both 5,710,032
   rows, at N = 2^19 uniform x with points on the box faces; for the
   MixedFeature grid also at 2^19 samples along 40,330 rays (13 consecutive
   samples a ray at the march step, as training orders them) and at a
   degenerate set in which each warp's 32 samples share one point: the
   forward bit for bit, the backward's d_params bitwise equal across three
   launches and to the fixed-point model hashgrid_bwd_fixed_plain (exact,
   sampled at one corner with the same uniforms, and windowed), d_params,
   d_x and d_window (window alpha 0.6) within HASH_TOL of the plain
   version, the fixed-point scale 2^k, the backward's atomics with one an
   update and after the warp's merge of equal rows, the kernels' device
   times by CUDA-graph replay beside their bounds (and, host time included,
   through their wrappers) and the plain times; then the kernels' generic
   path (F 4, L 12) at 2^16 points;
13. train_step_oracle_mf: one step of the MixedFeature bench configuration
   (benchmarking/benchmark_synthetic_nerf_mf.sh: batch 16384, lr 2e-2, rgb
   128 x 2) on the card against the same step on the CPU, exact and with
   the sampled-corner table gradient (the same uniforms);
14. train_mf: 900 steps of it on the 16 procedural views through
   NeRFSystem.fit; the hash-grid kernels' launch counts are reset just
   before and read just after;
15. test_view_mf: the held-out view through render_test before and after
   training, with the forward kernel's launch count (a gain of 8 dB over
   the untrained field, and at least MF_PSNR_MIN);
12b. kernel_hashgrid (shape "train"): phase 12's checks and times on one
   real step's operands of the trained MixedFeature field (x and g as
   HashGridEncode.backward receives them);
19. cli: the command line (mfnerf_tpu_torch/train.py main, CLI_ARGS: the
   bench.py LowRank model, 600 steps) on the 800x800 procedural scene
   (16 train and 2 test views) written in the NSVF layout under a temporary
   working directory: the load time (datasets/png.py), the loaded rays
   against the in-memory images (CLI_LOAD_TOL), main in process (ms/step
   synced around fit, both hat kernels' launch counts over the run, test
   PSNR at least PSNR_MIN and SSIM, the checkpoints' sizes, the result
   PNGs), then "python -m mfnerf_tpu_torch.train --val_only --ckpt_path"
   as a subprocess, whose test PSNR must equal the in-process one within
   CLI_PSNR_TOL;
16. probe_gather: the port of benchmarking/probe_pallas_gather.py, run()
   at its shape (N = 2^20, RANK 8, K 128): table_lerp in idx mode bit for
   bit against its plain version, beside grid_sample; then at a ragged N;
17. probe_gather2: the port of probe_pallas_gather2.py (N = 2^19, K 513,
   R 128): table_lerp in u mode the same way, and hat_basis_dw's dW
   bitwise equal across three launches, within 1e-4 x max of its plain
   version and bit for bit equal to the model of its sums
   (hat_basis_dw_order_plain); then at a ragged N, and dW the same way on
   2^19 sorted u and 2^19 u on the knots, each set's time by CUDA-graph
   replay beside its bound;
18. probe_hatmul: the port of probe_pallas_hatmul.py, hat_prod at N = 2^19,
   K 513, R 128 bit for bit against hat_prod_plain; then at a ragged N.
   Each probe's run() is its kernels' path: their launch counts are reset
   just before it and read just after.

Each phase that times a kernel prints it beside its bound (bytes at
3.35 TB/s or fp32 operations at 67 TFLOP/s), its plain version's time and,
where one PyTorch call computes the same function, that call's time.

The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits
non-zero and prints no result.
"""
import argparse
import concurrent.futures
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from mfnerf_tpu_torch.benchmarking import bound, cuda_ms, graph_ms

SEED = 0
N_KERNEL = 1 << 20
WH = 800
N_FRAMES = 8
T_THRESHOLD = 1e-2
ORACLE_STRIDE = 78          # 640,000 rays / 78 = 8,206 oracle rays
KERNEL_TOL = 1e-4           # same bf16 operands; summation order only
RGB_TOL, DEPTH_TOL = 2e-3, 5e-3
N_BWD = 8192 * 64           # the padded step's most samples, 2^19
# dW sums up to 2^19 contributions per row, in chunk and run order
DW_TOL = 1e-3               # x max |dW_plain|
# du off the knots, relative to max(|du_plain|, 1e-3 max |du_plain|): the
# kernel sums g_d (W[i+1] - W[i]) over R columns, the plain version takes
# the difference of two such sums
DU_TOL_MOST, DU_TOL_ALL = 1e-4, 1e-2   # on >= 99% of samples / on all
N_ORACLE_RAYS = 1024
# the card's step vs the CPU's: XLA-free but still two devices. Frame 1's
# rotation matmul rounds differently on the card, which moves a few bf16
# hat weights by one step; sums run in other orders
LOSS_TOL = 1e-4             # relative
GRAD_TOL = 1e-2             # relative L2 error of each parameter's gradient
BENCH_HP = dict(            # bench.py:115-130 (TPU-only knobs dropped)
    dataset_name="nsvf", scale=0.5, use_exposure=False, distortion_loss_w=0.0,
    batch_size=8192, num_epochs=1, lr=1e-2, optimize_ext=False,
    random_bg=False, grid="LowRank", L=16, F=2, rgb_channels=64,
    rgb_layers=2, seed=1337, s_max_train=64, s_max_test=256,
    test_chunk=65536, steps_per_epoch=1000, grid_size=128, max_samples=1024,
    lr_levels=8, lr_rank=16, lr_frames=2, lr_k_max=256, bf16=False,
    refresh_half=True, lr_fused=True)
N_TRAIN_VIEWS = 16
WARM_STEPS, CHUNK, N_CHUNKS = 300, 100, 6   # bench.py: 300 + 600 steps
TEST_T = 1e-4
PSNR_MIN, PSNR_GAIN = 20.0, 8.0   # tests/test_e2e_train.py:69-70
# the reference's MixedFeature benchmark (benchmarking/
# benchmark_synthetic_nerf_mf.sh:15-17), the rest as BENCH_HP
MF_HP = dict(BENCH_HP, grid="MixedFeature", L=16, F=2, T=20, N_min=16,
             N_max=2048, N_tables=8, rgb_channels=128, rgb_layers=2,
             batch_size=16384, lr=2e-2)
# the CLI's default grid (mfnerf_tpu/opt.py:89-105)
HASH_GRID = dict(grid="Hash", L=16, F=2, log2_T=19, N_min=16, N_max=2048,
                 N_tables=1)
N_HASH = 1 << 19
N_FACE = 384                # of them on the box faces (the corner clamp)
# the "rays" set: 13 samples a ray (the MixedFeature step's mean, PERF.md
# §5) at the march step sqrt(3) / 1024 of the unit box
RAY_SAMPLES, RAY_STEP = 13, math.sqrt(3) / 1024
# the forward repeats the plain version's fp32 operations: 0 expected
HASH_FWD_TOL = 1e-6         # x max |plain|
# d_params: fixed-point sums against fp32 scatter-adds; d_x and d_window:
# sums over levels and samples in another order
HASH_TOL = 1e-5             # x max |plain|
WINDOW_ALPHA = 0.6
# The MixedFeature recipe (batch 16384, lr 2e-2, rgb 128 x 2) plateaus on
# this scene: train PSNR ~22.4 and the held-out view 19.76 dB at 900 steps,
# 19.81 at 1800, the same with the Hash grid in its place
# (tools/train_grid.py, PERF.md §6). Its view must gain PSNR_GAIN over the
# untrained field and stay above this floor; PSNR_MIN is LowRank's.
MF_PSNR_MIN = 19.0
N_RAGGED = (1 << 16) + 37   # the probes' ragged size: part-filled tiles
# the cli phase: the README's command line on the procedural scene written
# to disk (the bench.py LowRank model at full width, 600 steps), at the
# command line's default --seed
CLI_ARGS = ("--dataset_name", "nsvf", "--exp_name", "cli", "--grid",
            "LowRank", "--lr_k_max", "256", "--num_epochs", "1",
            "--steps_per_epoch", "600", "--batch_size", "8192", "--lr", "1e-2")
CLI_TEST_VIEWS = 2
# the loaded rays against the in-memory images: the PNG's uint8 truncation
CLI_LOAD_TOL = 1 / 255 + 1e-6
CLI_PSNR_TOL = 1e-3         # --val_only in a subprocess against in process


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def phase(label, **fields):
    print(json.dumps({"phase": label, **fields}), flush=True)


def fwd_bound(n, k, r):
    """hat_prod: read u and W once, write out; per (sample, column) three
    two-row lerps (3 operations each) and two products."""
    return bound(12 * n + 6 * k * r + 4 * n * r, 11 * n * r)


def bwd_bound(n, k, r, need_du):
    """hat_prod_bwd: read u, g and W once, write dW (and du); per (sample,
    column, axis) a lerp (3), g_d (2), two row sums (4) and with du a
    difference and a product (2)."""
    n_bytes = 12 * n + 4 * n * r + 6 * k * r + 12 * k * r \
        + (12 * n if need_du else 0)
    return bound(n_bytes, (11 if need_du else 9) * 3 * n * r)


def check_bwd(label, u3, w3, k, g):
    """Phase 7 on one set of operands: two launches give the same dW bytes,
    dW within DW_TOL of the plain version, du 0 on the knots and within
    DU_TOL elsewhere; the kernel's times (with and without du) beside their
    bounds. Returns the phase's fields."""
    from mfnerf_tpu_torch.ops.hatmul import hat_prod_bwd, hat_prod_bwd_plain
    n, r = g.shape
    du, dw = hat_prod_bwd(u3, w3, k, g)
    dw_again = hat_prod_bwd(u3, w3, k, g)[1]
    dw_no_du = hat_prod_bwd(u3, w3, k, g, need_du=False)[1]
    du_p, dw_p = hat_prod_bwd_plain(u3, w3, k, g)
    torch.cuda.synchronize()
    check(du.shape == (n, 3) and dw.shape == w3.shape,
          f"hat_prod_bwd shapes {tuple(du.shape)} {tuple(dw.shape)}")
    bitwise = torch.equal(dw, dw_again) and torch.equal(dw, dw_no_du)
    dw_spread = float((dw - dw_again).abs().max())
    dw_scale = float(dw_p.abs().max())
    dw_err = float((dw - dw_p).abs().max())
    pos = u3 * (k - 1)
    knot = pos == torch.floor(pos)
    du_knot = max(float(torch.where(knot, du.abs(), 0.0).max()),
                  float(torch.where(knot, du_p.abs(), 0.0).max()))
    du_scale = float(du_p.abs().max())
    du_rel = ((du - du_p).abs()
              / du_p.abs().clamp_min(1e-3 * du_scale))[~knot]
    du_within = float((du_rel <= DU_TOL_MOST).float().mean())
    du_rel_max = float(du_rel.max())
    ms = cuda_ms(lambda: hat_prod_bwd(u3, w3, k, g), 20)
    ms_no_du = cuda_ms(lambda: hat_prod_bwd(u3, w3, k, g, need_du=False), 20)
    plain_ms = cuda_ms(lambda: hat_prod_bwd_plain(u3, w3, k, g), 5)
    bound_ms, bound_by = bwd_bound(n, k, r, True)
    bound_no_du = bwd_bound(n, k, r, False)[0]
    fields = dict(
        shape=label, n=n, k=k, r=r, g_row_stride=g.stride(0),
        g_contiguous=g.is_contiguous(), dw_bitwise_equal=bitwise,
        dw_launch_spread=dw_spread, dw_max_abs_err=dw_err,
        dw_max_abs=dw_scale, dw_tol=DW_TOL, du_knot_max_abs=du_knot,
        knot_samples=int(knot.any(dim=1).sum()),
        du_share_within_tol=du_within, du_rel_err_max=du_rel_max,
        du_tol_99=DU_TOL_MOST, du_tol_all=DU_TOL_ALL, ms=ms,
        bound_ms=bound_ms, bound_by=bound_by, share_of_bound=bound_ms / ms,
        ms_no_du=ms_no_du, bound_ms_no_du=bound_no_du, plain_ms=plain_ms)
    check(bitwise and dw_spread == 0.0,
          f"{label}: dW differs between launches by {dw_spread}")
    check(dw_err <= DW_TOL * dw_scale, f"{label}: dW vs plain: {dw_err}")
    check(du_knot == 0.0, f"{label}: du on the knots: {du_knot}")
    check(du_within >= 0.99 and du_rel_max <= DU_TOL_ALL,
          f"{label}: du vs plain: {du_within} within {DU_TOL_MOST}, "
          f"max {du_rel_max}")
    return fields


def capture_bwd_operands(system, seed, module):
    """One forward and backward of a training step of ``system`` on a ray
    batch drawn from ``seed`` (weights and optimiser untouched): the
    arguments that each call of ``module._launch_bwd`` received (the hat
    product's (u3, w3, k, g, need_du), the hash grid's (params, x, cfg, g,
    window, grad_noise, need_dx))."""
    from mfnerf_tpu_torch.datasets.ray_utils import get_rays
    from mfnerf_tpu_torch.models.rendering import render_train
    dev, b = system.device, system.hparams.batch_size
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_img, hw = system.rays.shape[:2]
    img = torch.randint(n_img, (b,), generator=gen, device=dev)
    pix = torch.randint(hw, (b,), generator=gen, device=dev)
    rays_o, rays_d = get_rays(system.directions[pix], system.poses[img])
    res = render_train(system.model, system.occ, rays_o, rays_d,
                       torch.rand((b,), generator=gen, device=dev),
                       system.rcfg)
    loss = sum(v.mean() for v in system.loss(
        res, {"rgb": system.rays[img, pix]}).values())
    captured, launch = [], module._launch_bwd

    def recorder(*args):
        captured.append(tuple(a.detach() if torch.is_tensor(a) else a
                              for a in args))
        return launch(*args)

    module._launch_bwd = recorder
    try:
        loss.backward()
    finally:
        module._launch_bwd = launch
        system.model.zero_grad(set_to_none=True)
    return captured


def step_oracle(model, cpu_model, occ, rcfg, loss_mod, batch, rows=None):
    """One training step's loss and parameter gradients on the card and on
    the CPU, same weights, rays, march jitter and, with ``rows``, the same
    sampled-corner uniforms (the first rows, one a valid sample). Checks
    the sample counts, LOSS_TOL and GRAD_TOL; returns the phase's fields and
    the card's gradients."""
    from mfnerf_tpu_torch.models.ngp import OccupancyState
    from mfnerf_tpu_torch.models.rendering import render_train
    steps = {}
    for where, model_, occ_ in (
            ("card", model, occ),
            ("cpu", cpu_model, OccupancyState(occ.density_grid.cpu(),
                                              occ.density_bitfield.cpu()))):
        on = {key: v.to(model_.device) for key, v in batch.items()}
        grad_noise = None if rows is None else (
            lambda k, d=model_.device: rows[:k].to(d))
        res = render_train(model_, occ_, on["rays_o"], on["rays_d"],
                           on["noise"], rcfg, grad_noise=grad_noise)
        loss = sum(v.mean() for v in loss_mod(
            res, {"rgb": on["rgb"]}).values())
        model_.zero_grad(set_to_none=True)
        loss.backward()
        steps[where] = (float(loss.detach()), int(res["rm_samples"]), {
            name: p_.grad.detach().cpu() for name, p_
            in model_.named_parameters()})
        model_.zero_grad(set_to_none=True)
    (loss_c, rm_c, grads_c), (loss_p, rm_p, grads_p) = \
        steps["card"], steps["cpu"]
    loss_rel = abs(loss_c - loss_p) / abs(loss_p)
    grad_rel = {name: float((grads_c[name] - grads_p[name]).norm()
                            / grads_p[name].norm()) for name in grads_p}
    check(rm_c == rm_p, f"samples on the card {rm_c} vs cpu {rm_p}")
    check(loss_rel <= LOSS_TOL, f"loss card {loss_c} vs cpu {loss_p}")
    check(max(grad_rel.values()) <= GRAD_TOL, f"gradients: {grad_rel}")
    return dict(rays=batch["noise"].shape[0], samples_card=rm_c,
                samples_cpu=rm_p, loss_card=loss_c, loss_cpu=loss_p,
                loss_rel_err=loss_rel, loss_tol=LOSS_TOL,
                grad_rel_err_max=max(grad_rel.values()),
                grad_rel_err_worst=max(grad_rel, key=grad_rel.get),
                grad_tol=GRAD_TOL), grads_c


def hash_distinct_rows(x, cfg):
    """The number of distinct table rows the 8 corners of x's cells read
    (the plain version's indices)."""
    from mfnerf_tpu_torch.ops import hashgrid as hg
    arrays, base, frac = hg._cells(x, cfg)
    rows = torch.cat([hg._corner(c, base, frac, arrays)[0].reshape(-1)
                      for c in range(8)])
    return int(torch.unique(rows).numel())


def hash_atomics(x, cfg):
    """The exact table gradient's atomics (the plain version's indices): one
    an update, 8 L F a sample; one a distinct (sample // 32, level, round,
    row) and feature, where round r takes each sample's corner
    r ^ (base & 1), the vertex of parity r (what merging all of a warp's
    equal rows would leave); and the backward kernel's, one a run of
    consecutive lanes with the same row in a (warp, level, round) and
    feature. Returns the three counts."""
    from mfnerf_tpu_torch.ops import hashgrid as hg
    arrays, base, frac = hg._cells(x, cfg)
    n = x.shape[0]
    warps = -(-n // 32)
    rows = torch.stack([hg._corner(c, base, frac, arrays)[0]
                        for c in range(8)])                      # (8, L, N)
    par = (base[..., 0] & 1) | (base[..., 1] & 1) << 1 \
        | (base[..., 2] & 1) << 2                                # (L, N)
    # (level, warp) a key, then the row: below 2^5 * 2^26 * 2^31
    lw = (torch.arange(cfg.L, device=x.device)[:, None] * warps
          + torch.arange(n, device=x.device)[None, :] // 32)
    first = torch.arange(n, device=x.device) % 32 == 0
    distinct = runs = 0
    for r in range(8):
        rows_r = rows.gather(0, (r ^ par)[None])[0]             # (L, N)
        distinct += int(torch.unique(lw * cfg.n_params + rows_r).numel())
        new_row = torch.ones_like(rows_r, dtype=torch.bool)
        new_row[:, 1:] = rows_r[:, 1:] != rows_r[:, :-1]
        runs += int((first | new_row).sum())
    return n * cfg.L * 8 * cfg.F, distinct * cfg.F, runs * cfg.F


def hash_fwd_bound(n, cfg, distinct):
    """hashgrid fwd: read x and the distinct rows once, write the output;
    per (sample, level) the cell (6 operations), 8 weights (2 each) and
    8 blends of F features (2 each)."""
    return bound(12 * n + 4 * n * cfg.out_dim + 4 * cfg.F * distinct,
                 n * cfg.L * (6 + 8 * (2 + 2 * cfg.F)))


def hash_bwd_bound(n, cfg, distinct, need_dx):
    """hashgrid bwd: read g and x, write d_params whole; with d_x read the
    distinct rows and write d_x; operations as the forward's, plus per
    corner and feature the update (1) and with d_x the row's dot (2) and the
    weight's partials (6 a corner)."""
    n_bytes = 12 * n + 4 * n * cfg.out_dim + 4 * cfg.n_params * cfg.F
    ops = n * cfg.L * (6 + 8 * (2 + 3 * cfg.F))
    if need_dx:
        n_bytes += 12 * n + 4 * cfg.F * distinct
        ops += n * cfg.L * 8 * (2 * cfg.F + 6)
    return bound(n_bytes, ops)


def check_hashgrid(label, cfg, params, x, g, seed):
    """Phase 12 on one set of operands: the forward bit for bit against the
    plain version; the backward's d_params bitwise equal across three
    launches and to the fixed-point model, exact, sampled at one corner (the
    same uniforms) and windowed (alpha 0.6); d_params, d_x and d_window
    within HASH_TOL of the plain version; the atomics before and after the
    merge; the kernels' device times by CUDA-graph replay beside their
    bounds, and through their wrappers call by call (host time included).
    Returns the phase's fields."""
    from mfnerf_tpu_torch.ops.hashgrid import (fixed_point_scale,
                                               hashgrid_bwd,
                                               hashgrid_bwd_fixed_plain,
                                               hashgrid_bwd_plain,
                                               hashgrid_encode,
                                               hashgrid_encode_plain,
                                               window_weights)
    n = x.shape[0]
    dev = x.device
    with torch.no_grad():
        out = hashgrid_encode(params, x, cfg)
        want = hashgrid_encode_plain(params, x, cfg)
    torch.cuda.synchronize()
    check(out.shape == (n, cfg.out_dim), f"{label}: output {out.shape}")
    fwd_err = float((out - want).abs().max())
    fwd_scale = float(want.abs().max())
    fwd_bitwise = bool(torch.equal(out, want))
    check(fwd_err <= HASH_FWD_TOL * fwd_scale and fwd_bitwise,
          f"{label}: forward vs plain: {fwd_err} of {fwd_scale}, bitwise "
          f"{fwd_bitwise}")

    def errs(got, ref):
        return float((got - ref).abs().max()), float(ref.abs().max())

    fields = dict(shape=label, grid=cfg.grid_type, n=n, levels=cfg.L,
                  features=cfg.F, rows=cfg.n_params,
                  fwd_max_abs_err=fwd_err, fwd_max_abs=fwd_scale,
                  fwd_bitwise_equal=fwd_bitwise)
    del out, want
    sampled = dataclasses.replace(cfg, grad_corners=1)
    noise = torch.rand((n, 1), generator=torch.Generator(
        device=dev).manual_seed(seed), device=dev)
    window = window_weights(cfg, WINDOW_ALPHA, dev)
    for name, cfg_, noise_, win in (("exact", cfg, None, None),
                                    ("sampled", sampled, noise, None),
                                    ("window", cfg, None, window)):
        runs = [hashgrid_bwd(params, x, cfg_, g, win, noise_,
                             need_dx=i == 2) for i in range(3)]
        dp_p, dx_p, dw_p = hashgrid_bwd_plain(params, x, cfg_, g, win,
                                              noise_)
        dp_fixed = hashgrid_bwd_fixed_plain(params, x, cfg_, g, win, noise_)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(runs[0][0], r[0]) for r in runs[1:])
        spread = max(float((runs[0][0] - r[0]).abs().max())
                     for r in runs[1:])
        fixed_equal = bool(torch.equal(runs[0][0], dp_fixed))
        log2_scale = math.log2(fixed_point_scale(g, cfg_, win))
        dp_err, dp_scale = errs(runs[2][0], dp_p)
        dx_err, dx_scale = errs(runs[2][1], dx_p)
        fields.update({f"{name}_dp_bitwise_equal": bitwise,
                       f"{name}_dp_launch_spread": spread,
                       f"{name}_dp_fixed_model_equal": fixed_equal,
                       f"{name}_log2_fixed_scale": log2_scale,
                       f"{name}_dp_max_abs_err": dp_err,
                       f"{name}_dp_max_abs": dp_scale,
                       f"{name}_dx_max_abs_err": dx_err,
                       f"{name}_dx_max_abs": dx_scale})
        check(bitwise and spread == 0.0,
              f"{label} {name}: d_params differs between launches")
        # a ratio of exactly 2 would be S on a power of two, not the merge
        check(fixed_equal, f"{label} {name}: d_params vs the fixed-point "
              f"model (2^{log2_scale}): max abs diff "
              f"{float((runs[0][0] - dp_fixed).abs().max())}")
        check(dp_err <= HASH_TOL * dp_scale,
              f"{label} {name}: d_params vs plain: {dp_err} of {dp_scale}")
        check(dx_err <= HASH_TOL * dx_scale,
              f"{label} {name}: d_x vs plain: {dx_err} of {dx_scale}")
        if win is not None:
            dw_err, dw_scale = errs(runs[2][2], dw_p)
            fields.update(window_alpha=WINDOW_ALPHA,
                          window_dw_max_abs_err=dw_err,
                          window_dw_max_abs=dw_scale)
            check(dw_err <= HASH_TOL * dw_scale,
                  f"{label}: d_window vs plain: {dw_err} of {dw_scale}")
        del runs, dp_p, dx_p, dw_p, dp_fixed
    distinct = hash_distinct_rows(x, cfg)
    atomics, atomics_distinct, merged = hash_atomics(x, cfg)
    fwd_bound_ms, fwd_bound_by = hash_fwd_bound(n, cfg, distinct)
    bwd_bound_ms, bwd_bound_by = hash_bwd_bound(n, cfg, distinct, False)

    def fwd():
        return hashgrid_encode(params, x, cfg)

    def bwd():
        return hashgrid_bwd(params, x, cfg, g, need_dx=False)

    fields.update(
        distinct_rows=distinct, atomics_per_update=atomics,
        atomics_distinct=atomics_distinct, atomics_merged=merged,
        atomics_merged_share=merged / atomics,
        tol=HASH_TOL, fwd_tol=HASH_FWD_TOL,
        fwd_ms=graph_ms(fwd, 20),
        fwd_wrapper_ms_host_inclusive=cuda_ms(fwd, 20),
        fwd_plain_ms=cuda_ms(lambda: hashgrid_encode_plain(params, x, cfg),
                             5),
        fwd_bound_ms=fwd_bound_ms, fwd_bound_by=fwd_bound_by,
        bwd_ms=graph_ms(bwd, 20),
        bwd_wrapper_ms_host_inclusive=cuda_ms(bwd, 20),
        bwd_sampled_ms=graph_ms(lambda: hashgrid_bwd(
            params, x, sampled, g, None, noise, need_dx=False), 20),
        bwd_dx_ms=graph_ms(lambda: hashgrid_bwd(params, x, cfg, g), 20),
        bwd_plain_ms=cuda_ms(lambda: hashgrid_bwd_plain(
            params, x, cfg, g, need_dx=False), 5),
        bwd_bound_ms=bwd_bound_ms, bwd_bound_by=bwd_bound_by,
        bwd_dx_bound_ms=hash_bwd_bound(n, cfg, distinct, True)[0])
    fields.update(fwd_share_of_bound=fwd_bound_ms / fields["fwd_ms"],
                  bwd_share_of_bound=bwd_bound_ms / fields["bwd_ms"])
    return fields


def hash_uniform_operands(cfg, seed, n=None):
    """A seeded N(0, 1) table, n (default N_HASH) uniform points (N_FACE of
    them on the box faces) and an N(0, 1) cotangent, on the card."""
    n = N_HASH if n is None else n
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = torch.randn((cfg.n_params, cfg.F), generator=gen,
                         device="cuda")
    x = torch.rand((n, 3), generator=gen, device="cuda")
    _on_faces(x)
    g = torch.randn((n, cfg.out_dim), generator=gen, device="cuda")
    return params, x, g


def _on_faces(x):
    """Put the first N_FACE + 16 points on the box faces and corner."""
    third = N_FACE // 3
    for d in range(3):
        x[d * third:(d + 1) * third, d] = 1.0
    x[N_FACE:N_FACE + 16] = 1.0


def hash_ray_operands(cfg, seed, n=None):
    """As hash_uniform_operands, but the points lie along rays, ray by ray
    as a training step hands them to the encoder: RAY_SAMPLES consecutive
    samples a ray RAY_STEP apart, from a uniform origin (inside the box by
    the ray's length) in a uniform direction; then the box-face points."""
    n = N_HASH if n is None else n
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = torch.randn((cfg.n_params, cfg.F), generator=gen,
                         device="cuda")
    rays = -(-n // RAY_SAMPLES)
    reach = RAY_SAMPLES * RAY_STEP
    o = reach + torch.rand((rays, 3), generator=gen, device="cuda") * (
        1 - 2 * reach)
    d = torch.randn((rays, 3), generator=gen, device="cuda")
    d = d / d.norm(dim=1, keepdim=True)
    t = torch.arange(RAY_SAMPLES, device="cuda") * RAY_STEP
    x = (o[:, None] + d[:, None] * t[None, :, None]).reshape(-1, 3)[:n]
    x = x.clamp(0.0, 1.0).contiguous()
    _on_faces(x)
    g = torch.randn((n, cfg.out_dim), generator=gen, device="cuda")
    return params, x, g


def hash_degenerate_operands(cfg, seed, n=None):
    """As hash_uniform_operands, but the 32 samples of each warp share one
    uniform point (every corner row of a warp is one group)."""
    params, x, g = hash_uniform_operands(cfg, seed, n)
    x = x[::32].repeat_interleave(32, dim=0)[:x.shape[0]].contiguous()
    return params, x, g


def hash_operand_sets():
    """Phase 12's operand sets: (label, config, operands maker, seed); the
    last is the kernels' generic path (F 4, L 12) at 2^16 points."""
    from mfnerf_tpu_torch.models.ngp import NGPConfig
    hash_cfg = NGPConfig(**HASH_GRID).hash_cfg
    mf_cfg = NGPConfig(**dict(HASH_GRID, grid="MixedFeature", log2_T=20,
                              N_tables=8)).hash_cfg
    generic = NGPConfig(grid="Hash", L=12, F=4, log2_T=16,
                        N_max=512).hash_cfg
    return [("uniform", hash_cfg, hash_uniform_operands, SEED + 10),
            ("uniform", mf_cfg, hash_uniform_operands, SEED + 11),
            ("rays", mf_cfg, hash_ray_operands, SEED + 13),
            ("degenerate", mf_cfg, hash_degenerate_operands, SEED + 14),
            ("generic", generic, lambda cfg, seed: hash_uniform_operands(
                cfg, seed, 1 << 16), SEED + 12)]


def start_system(hp, datasets, dev):
    """A NeRFSystem of the hyperparameters ``hp`` on the (train, test)
    datasets, its field drawn from SEED."""
    from mfnerf_tpu_torch.train import NeRFSystem
    system = NeRFSystem(argparse.Namespace(**hp), device=dev)
    system.setup(*datasets)
    system.configure(SEED)
    return system


def culled_state(system, seed):
    """The untrained field's occupancy: culled to the training cameras, then
    one dense refresh with jitter drawn from ``seed``."""
    ds, cfg, dev = system.train_dataset, system.model_cfg, system.device
    occ = system.model.mark_invisible_cells(system.occ, ds.K, system.poses,
                                            ds.img_wh)
    return system.model.update_density_grid(
        occ, system.density_threshold,
        torch.rand((cfg.cascades, cfg.n_cells, 3),
                   generator=torch.Generator(device=dev).manual_seed(seed),
                   device=dev) * 2 - 1)


def oracle_batch(ds, seed):
    """N_ORACLE_RAYS training rays (CPU tensors) and their march jitter."""
    from mfnerf_tpu_torch.datasets.ray_utils import get_rays
    pick = np.random.default_rng(seed)
    img = torch.from_numpy(pick.integers(0, N_TRAIN_VIEWS, N_ORACLE_RAYS))
    pix = torch.from_numpy(pick.integers(0, WH * WH, N_ORACLE_RAYS))
    ro, rd = get_rays(torch.from_numpy(ds.directions)[pix],
                      torch.from_numpy(ds.poses)[img])
    return {"rays_o": ro, "rays_d": rd,
            "rgb": torch.from_numpy(ds.rays)[img, pix],
            "noise": torch.from_numpy(pick.random(N_ORACLE_RAYS,
                                                  dtype=np.float32))}


def held_out_view(system):
    """(rays, rgb, render config at T_threshold TEST_T) of the test view."""
    from mfnerf_tpu_torch.datasets.ray_utils import get_rays
    dev, view = system.device, system.test_dataset[0]
    rays = get_rays(torch.from_numpy(system.train_dataset.directions).to(dev),
                    torch.from_numpy(view["pose"]).to(dev))
    return (rays, torch.from_numpy(view["rgb"]).to(dev),
            dataclasses.replace(system.rcfg, T_threshold=TEST_T))


def render_view(system, rays, rcfg, occ=None):
    """(render_test's output, synced host ms) of one view, with ``occ`` or
    the system's occupancy."""
    from mfnerf_tpu_torch.models.rendering import render_test
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = render_test(system.model, system.occ if occ is None else occ,
                      *rays, rcfg)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def train_steps(system, read_launches):
    """WARM_STEPS steps of ``system.fit``, then N_CHUNKS chunks of CHUNK
    steps timed on the host clock; ``read_launches()`` (the kernels' launch
    counts) just after them; then four half refreshes of the trained field,
    timed. Returns the train phase's fields."""
    hp = system.hparams
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = [system.fit(WARM_STEPS)]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    chunk_ms = []
    for _ in range(N_CHUNKS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics.append(system.fit(CHUNK))
        torch.cuda.synchronize()
        chunk_ms.append((time.perf_counter() - t0) * 1e3 / CHUNK)
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    m = {key: torch.cat([c[key] for c in metrics]) for key in metrics[0]}
    check(bool(torch.isfinite(m["loss"]).all()), "a training loss is not "
          "finite")
    occ_after = system.occ
    refresh_ms = []
    for _ in range(4):                 # the trained field's half refreshes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        system.update_grid()
        torch.cuda.synchronize()
        refresh_ms.append((time.perf_counter() - t0) * 1e3)
    system.occ = occ_after
    ms_step = float(np.median(chunk_ms))
    return dict(
        grid=hp.grid, steps=system.global_step, batch=hp.batch_size,
        ms_per_step=ms_step, chunk_ms_per_step=chunk_ms,
        warm_seconds=warm_s, rays_per_s=hp.batch_size / ms_step * 1e3,
        rm_s=float(m["rm_s"][-CHUNK:].mean()),
        vr_s=float(m["vr_s"][-CHUNK:].mean()),
        rm_s_first=float(m["rm_s"][0]),
        train_psnr=float(m["psnr"][-50:].mean()),
        train_psnr_last_step=float(m["psnr"][-1]),
        loss_last=float(m["loss"][-1]), refresh_ms=refresh_ms,
        **launches, max_memory_gb=peak_gb)


def val_ms(log):
    """The per-view render times that ``validate`` printed in ``log``."""
    return [float(ms) for ms in re.findall(r"^val image .*\[([0-9.]+) ms\]$",
                                           log, re.M)]


def cli_phase(dev, read_launches):
    """The command line, in process and then as a subprocess, on the 800x800
    procedural scene (N_TRAIN_VIEWS train and CLI_TEST_VIEWS test views)
    written in the NSVF layout under a temporary directory, which is also
    the working directory of both runs. Returns the phase's fields."""
    from mfnerf_tpu_torch.datasets.nsvf import NSVFDataset
    from mfnerf_tpu_torch.opt import get_opts
    from mfnerf_tpu_torch.train import main as train_main
    from mfnerf_tpu_torch.utils.procedural import make_scene, write_nsvf_scene

    repo = os.path.dirname(os.path.abspath(__file__))
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join("Synthetic_NeRF_proc", "Spheres")
        argv = ["--root_dir", root, *CLI_ARGS]
        hp = get_opts(argv)
        scene = make_scene(n_train=N_TRAIN_VIEWS, n_test=CLI_TEST_VIEWS,
                           wh=WH, seed=SEED)
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            write_nsvf_scene(root, scene)
            write_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            loaded = NSVFDataset(root, split=hp.split,
                                 downsample=hp.downsample)
            load_s = time.perf_counter() - t0
            load_err = float(np.abs(loaded.rays - scene["images"]).max())
            check(loaded.rays.shape == scene["images"].shape
                  and load_err <= CLI_LOAD_TOL,
                  f"loaded rays {loaded.rays.shape}: max error {load_err}")
            del loaded
            log = io.StringIO()
            read_launches(reset=True)
            with contextlib.redirect_stdout(log):
                metrics = train_main(hp, device=dev)
            launches = read_launches()
            print(log.getvalue(), end="", flush=True)
            ckpt_dir = os.path.join("ckpts", "nsvf", "cli")
            ckpt = os.path.join(ckpt_dir, "epoch=0.ckpt.npz")
            sizes = {name: os.path.getsize(os.path.join(ckpt_dir, name))
                     for name in ("epoch=0.ckpt.npz",
                                  "epoch=0_slim.ckpt.npz")}
            results = sorted(os.listdir(os.path.join("results", "nsvf",
                                                     "cli")))
            env = dict(os.environ, PYTHONPATH=os.pathsep.join(
                [repo, os.environ.get("PYTHONPATH", "")]))
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "mfnerf_tpu_torch.train", *argv,
                 "--val_only", "--ckpt_path", ckpt, "--no_save_test"],
                env=env, capture_output=True, text=True, timeout=300)
            val_only_s = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
    print(proc.stdout, end="", flush=True)
    check(proc.returncode == 0,
          f"--val_only exited {proc.returncode}: {proc.stderr[-2000:]}")
    val_psnr = float(re.search(r"^test/psnr: ([0-9.]+)$", proc.stdout,
                               re.M).group(1))
    return dict(
        write_seconds=write_s,
        load_seconds=load_s, load_max_abs_err=load_err,
        load_tol=CLI_LOAD_TOL, argv=argv, ms_per_step=metrics[
            "train/ms_per_step"], test_psnr=metrics["test/psnr"],
        test_ssim=metrics["test/ssim"], psnr_min=PSNR_MIN,
        val_ms_per_frame=val_ms(log.getvalue()), **launches,
        ckpt_bytes=sizes, results=results, val_only_psnr=val_psnr,
        val_only_ms_per_frame=val_ms(proc.stdout),
        val_only_seconds=val_only_s, psnr_tol=CLI_PSNR_TOL)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from mfnerf_tpu_torch import build
    from mfnerf_tpu_torch.benchmarking import (probe_gather, probe_gather2,
                                               probe_hatmul)
    from mfnerf_tpu_torch.datasets.memory import MemoryDataset
    from mfnerf_tpu_torch.datasets.ray_utils import get_rays
    from mfnerf_tpu_torch.models.ngp import NGP, NGPConfig, OccupancyState
    from mfnerf_tpu_torch.models.rendering import (RenderConfig, render_test,
                                                   render_test_dense)
    from mfnerf_tpu_torch.ops import hashgrid, hatmul
    from mfnerf_tpu_torch.ops.hashgrid import hashgrid_bwd, hashgrid_encode
    from mfnerf_tpu_torch.ops.hatmul import (hat_prod, hat_prod_bwd,
                                             hat_prod_plain)
    from mfnerf_tpu_torch.ops.linetable import hat_basis_dw, table_lerp
    from mfnerf_tpu_torch.ops.lowrank import fold_frame
    from mfnerf_tpu_torch.utils.metrics import psnr
    from mfnerf_tpu_torch.utils.procedural import make_scene

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)

    # ---- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    card = smi.splitlines()[0]
    nvcc = subprocess.run([build.nvcc(), "--version"], check=True,
                          capture_output=True, text=True).stdout
    nvcc = [line for line in nvcc.splitlines() if "release" in line][0]
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    print(f"card: {card}", flush=True)
    phase("device", name=name, nvidia_smi=smi, torch=torch.__version__,
          torch_cuda=torch.version.cuda,
          nvcc=nvcc.strip(), triton=triton_version,
          tf32=False)

    # ---- 2, 11 and 16a. build the kernels' sources, one nvcc each, together
    src = "mfnerf_tpu_torch/csrc/hatmul.cu"
    hash_src = "mfnerf_tpu_torch/csrc/hashgrid.cu"
    line_src = "mfnerf_tpu_torch/csrc/linetable.cu"

    def timed_build(lib):
        fresh = not build.library_path(lib).exists()
        t0 = time.perf_counter()
        build.load_library(lib)
        return fresh, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        builds = {lib: pool.submit(timed_build, lib)
                  for lib in ("hatmul", "hashgrid", "linetable")}
        for label, lib, source in (("build", "hatmul", src),
                                   ("build_hashgrid", "hashgrid", hash_src),
                                   ("build_linetable", "linetable",
                                    line_src)):
            fresh, seconds = builds[lib].result()
            phase(label, source=source, built=fresh, seconds=seconds,
                  card=card)

    # ---- 3. kernel against its plain version, at the serving shapes
    cfg = NGPConfig(lr_k_max=256, lr_fused=True)   # the bench model
    model = NGP(cfg, torch.Generator().manual_seed(SEED), device=dev)
    lr = model.lowrank_cfg
    k = lr.levels[-1]
    w3 = fold_frame({"lines": model.lowrank.lines}, lr, 0).detach()
    rng = np.random.default_rng(SEED)
    u = rng.random((N_KERNEL, 3), dtype=np.float32)
    u[:64] = 1.0                                   # the last knot
    u[64:128] = 0.0
    u[128:1024] = np.round(u[128:1024] * (k - 1)) / (k - 1)   # on knots
    u3 = torch.from_numpy(u).to(dev)
    got = hat_prod(u3, w3, k)
    want = hat_prod_plain(u3, w3, k)
    torch.cuda.synchronize()
    check(got.shape == (N_KERNEL, w3.shape[2]) and got.dtype == torch.float32,
          f"hat_prod output {tuple(got.shape)} {got.dtype}")
    err = (got - want).abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp_min(1e-3)).max())
    check(max_abs <= KERNEL_TOL and max_rel <= KERNEL_TOL,
          f"kernel vs plain: max abs {max_abs}, max rel {max_rel}")
    ms = cuda_ms(lambda: hat_prod(u3, w3, k), 20)
    plain_ms = cuda_ms(lambda: hat_prod_plain(u3, w3, k), 5)
    phase("kernel", name="hat_prod", n=N_KERNEL, k=k, r=w3.shape[2],
          max_abs_err=max_abs, max_rel_err=max_rel, tol=KERNEL_TOL, ms=ms,
          plain_ms=plain_ms, card=card)
    del got, want, err

    # ---- 4. serving state: seeded field, one dense occupancy refresh
    noise = torch.rand((cfg.cascades, cfg.n_cells, 3),
                       generator=torch.Generator().manual_seed(SEED + 1)
                       ).to(dev) * 2 - 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    occ = model.update_density_grid(OccupancyState.create(cfg, dev),
                                    0.01 * 1024 / math.sqrt(3), noise)
    torch.cuda.synchronize()
    refresh_ms = (time.perf_counter() - t0) * 1e3
    occupied = float(torch.from_numpy(np.unpackbits(
        occ.density_bitfield.cpu().numpy())).float().mean())
    check(0.0 < occupied < 1.0, f"occupied fraction {occupied}")
    phase("state", cells=cfg.cascades * cfg.n_cells, occupied=occupied,
          refresh_ms=refresh_ms, card=card)

    # ---- 5. serve eight distinct 800x800 frames through render_test
    scene = make_scene(n_train=1, n_test=N_FRAMES, wh=WH, seed=SEED)
    directions = torch.from_numpy(scene["directions"]).to(dev)
    rays = [get_rays(directions, torch.from_numpy(p).to(dev))
            for p in scene["test_poses"]]
    rcfg = RenderConfig(T_threshold=T_THRESHOLD)
    render_test(model, occ, *rays[0], rcfg)           # warm-up frame
    hat_prod.launches = 0
    frame_ms, samples, rounds, outs = [], [], [], []
    for ro, rd in rays:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = render_test(model, occ, ro, rd, rcfg)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        samples.append(out["total_samples"])
        rounds.append(out["rounds"])
        outs.append(out)
    launches = hat_prod.launches
    check(launches > 0, "render_test never launched the hat_prod kernel")
    for out in outs:
        op = out["opacity"]
        check(out["rgb"].shape == (WH * WH, 3)
              and bool(torch.isfinite(out["rgb"]).all())
              and bool(torch.isfinite(out["depth"]).all()),
              "frame not finite or of the wrong shape")
        # a sum of weights that telescopes to 1 - T, up to fp32 rounding
        check(bool(((op >= -1e-6) & (op <= 1 + 1e-6)).all()),
              "opacity outside [0, 1]")
    check(len({float(o["rgb"].sum()) for o in outs}) == N_FRAMES,
          "frames are not distinct")
    ms_med = float(np.median(frame_ms))
    phase("serve", frames=N_FRAMES, wh=WH, T_threshold=T_THRESHOLD,
          ms_per_frame=frame_ms, ms_median=ms_med, fps=1e3 / ms_med,
          samples_per_frame=samples, rounds_per_frame=rounds,
          hat_prod_launches=launches,
          max_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
          card=card)

    # ---- 6. oracle: plain dense renderer on a strided subset of frame 0
    cpu_model = NGP(cfg, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    cpu_occ = OccupancyState(occ.density_grid.cpu(),
                             occ.density_bitfield.cpu())
    ro, rd = rays[0]
    sub = slice(None, None, ORACLE_STRIDE)
    t0 = time.perf_counter()
    ref = render_test_dense(cpu_model, cpu_occ, ro[sub].cpu(), rd[sub].cpu(),
                            RenderConfig(T_threshold=T_THRESHOLD,
                                         test_chunk=2048))
    oracle_s = time.perf_counter() - t0
    errs = {key: float((outs[0][key][sub].cpu() - ref[key]).abs().max())
            for key in ("rgb", "opacity", "depth")}
    phase("oracle", rays=int(ref["opacity"].shape[0]), **{
        f"max_abs_{k_}": v for k_, v in errs.items()},
        tol_rgb_opacity=RGB_TOL, tol_depth=DEPTH_TOL,
        samples=ref["total_samples"], cpu_seconds=oracle_s, card=card)
    check(errs["rgb"] <= RGB_TOL and errs["opacity"] <= RGB_TOL
          and errs["depth"] <= DEPTH_TOL, f"render_test vs oracle: {errs}")

    del outs, out, ref
    torch.cuda.empty_cache()

    # ---- 7. backward kernel against its plain version, uniform u at 2^19
    u3 = torch.from_numpy(u[:N_BWD].copy()).to(dev)
    g = torch.from_numpy(rng.standard_normal((N_BWD, w3.shape[2]),
                                             dtype=np.float32)).to(dev)
    bwd_uniform = check_bwd("uniform", u3, w3, k, g)
    phase("kernel_bwd", name="hat_prod_bwd", **bwd_uniform, card=card)
    # ragged edges: a part-filled column tile (R = 40), two chunks of 1,050
    # samples whose last step holds 10, g a column slice (row stride 80)
    edge = np.random.default_rng(SEED + 5)
    u_e = torch.from_numpy(edge.random((2100, 3), dtype=np.float32)).to(dev)
    w_e = torch.from_numpy(edge.normal(size=(3, 65, 40)).astype(
        np.float32)).to(dev)
    g_e = torch.from_numpy(edge.standard_normal(
        (2100, 80), dtype=np.float32)).to(dev)[:, 40:]
    phase("kernel_bwd", name="hat_prod_bwd",
          **check_bwd("edge", u_e, w_e, 65, g_e), card=card)
    del u3, g, u_e, w_e, g_e
    torch.cuda.empty_cache()

    # ---- 12. the hash-grid kernels against their plain versions
    for label, hcfg, operands, seed in hash_operand_sets():
        phase("kernel_hashgrid", **check_hashgrid(
            label, hcfg, *operands(hcfg, seed), seed + 10), card=card)
        torch.cuda.empty_cache()

    # ---- 8. one training step on the card against the same step on the CPU
    train_scene = make_scene(n_train=N_TRAIN_VIEWS, n_test=1, wh=WH,
                             seed=SEED)
    datasets = (MemoryDataset.from_scene(train_scene, "train"),
                MemoryDataset.from_scene(train_scene, "test"))
    system = start_system(BENCH_HP, datasets, dev)
    occ0 = culled_state(system, SEED + 2)
    cpu_model = NGP(system.model_cfg, device="cpu")
    cpu_model.load_state_dict(system.model.state_dict())
    fields, grads_c = step_oracle(system.model, cpu_model, occ0, system.rcfg,
                                  system.loss,
                                  oracle_batch(system.train_dataset,
                                               SEED + 3))
    line_norms = [float(v.norm()) for name, v in grads_c.items()
                  if name.startswith("lowrank.lines.")]
    phase("train_step_oracle", **fields, line_tables=len(line_norms),
          line_grad_norm_min=min(line_norms), card=card)
    check(len(line_norms) == 3 * lr.n_frames * len(lr.levels)
          and min(line_norms) > 0, "a line table got no gradient")
    del cpu_model, grads_c

    # ---- 10a. the held-out view before training (culled + one refresh)
    test_rays, test_rgb, test_rcfg = held_out_view(system)
    out, _ = render_view(system, test_rays, test_rcfg, occ0)
    psnr_before = float(psnr(out["rgb"], test_rgb))
    del occ0, out

    # ---- 9. train: 300 steps, then 6 timed chunks of 100
    hat_prod.launches = hat_prod_bwd.launches = 0
    fields = train_steps(system, lambda: dict(
        hat_prod_launches=hat_prod.launches,
        hat_prod_bwd_launches=hat_prod_bwd.launches))
    phase("train", **fields, card=card)
    launches_fwd = fields["hat_prod_launches"]
    launches_bwd = fields["hat_prod_bwd_launches"]
    check(launches_fwd > 0 and launches_bwd > 0,
          f"training launched hat_prod {launches_fwd}, hat_prod_bwd "
          f"{launches_bwd} times")

    # ---- 10b. the held-out view after training
    render_view(system, test_rays, test_rcfg)      # warm-up frame
    out, view_ms = render_view(system, test_rays, test_rcfg)
    psnr_after = float(psnr(out["rgb"], test_rgb))
    phase("test_view", wh=WH, T_threshold=TEST_T, psnr_before=psnr_before,
          psnr_after=psnr_after, ms_per_frame=view_ms,
          samples_per_frame=out["total_samples"], rounds=out["rounds"],
          card=card)
    check(bool(torch.isfinite(out["rgb"]).all()), "test view not finite")
    check(psnr_after >= PSNR_MIN and psnr_after >= psnr_before + PSNR_GAIN,
          f"test PSNR {psnr_before} -> {psnr_after}")

    # ---- 7b. backward kernel on one real step's operands (trained field)
    captured = capture_bwd_operands(system, SEED + 4, hatmul)
    check(len(captured) == lr.n_frames, f"{len(captured)} hat backward calls")
    # both frames' g are column slices of the (N, 2R) feature gradient
    u3, w3_t, k_t, g, _ = captured[0]
    check(not g.is_contiguous() and g.stride(0) == 2 * g.shape[1],
          f"g of stride {g.stride()} is not a column slice")
    bwd_train = check_bwd("train", u3, w3_t, k_t, g)
    # hat_prod on the same frame's u (the wrapper: host time included)
    fwd_train_ms = cuda_ms(lambda: hat_prod(u3, w3_t, k_t), 20)
    fwd_train_bound = fwd_bound(u3.shape[0], k_t, w3_t.shape[2])[0]
    phase("kernel_bwd", name="hat_prod_bwd", **bwd_train,
          fwd_ms=fwd_train_ms, fwd_bound_ms=fwd_train_bound,
          fwd_share_of_bound=fwd_train_bound / fwd_train_ms, card=card)
    del captured, u3, g, system, out
    torch.cuda.empty_cache()

    # ---- 13. the MixedFeature bench configuration: one step, card vs CPU,
    # exact and with the sampled-corner table gradient (one corner)
    mf = start_system(MF_HP, datasets, dev)
    occ0 = culled_state(mf, SEED + 6)
    batch = oracle_batch(mf.train_dataset, SEED + 7)
    for mode, m_ in (("exact", 8), ("sampled", 1)):
        mcfg = dataclasses.replace(mf.model_cfg, hash_grad_samples=m_)
        model_c, model_p = (NGP(mcfg, device=d) for d in (dev, "cpu"))
        model_c.load_state_dict(mf.model.state_dict())
        model_p.load_state_dict(mf.model.state_dict())
        rows = None if m_ == 8 else torch.from_numpy(
            np.random.default_rng(SEED + 8).random(
                (N_ORACLE_RAYS * MF_HP["s_max_train"], m_),
                dtype=np.float32))
        fields, grads_c = step_oracle(model_c, model_p, occ0, mf.rcfg,
                                      mf.loss, batch, rows)
        table_norm = float(grads_c["hash_table"].norm())
        phase("train_step_oracle_mf", mode=mode, hash_grad_samples=m_,
              **fields, hash_table_grad_norm=table_norm, card=card)
        check(table_norm > 0, "the hash table got no gradient")
        del model_c, model_p, grads_c

    # ---- 15a. the held-out view before training (culled + one refresh)
    out, _ = render_view(mf, test_rays, test_rcfg, occ0)
    psnr_before = float(psnr(out["rgb"], test_rgb))
    del occ0, out

    # ---- 14. train the MixedFeature field: 300 steps, 6 timed chunks of 100
    hashgrid_encode.launches = hashgrid_bwd.launches = 0
    fields = train_steps(mf, lambda: dict(
        hashgrid_fwd_launches=hashgrid_encode.launches,
        hashgrid_bwd_launches=hashgrid_bwd.launches))
    phase("train_mf", **fields, card=card)
    mf_fwd = fields["hashgrid_fwd_launches"]
    mf_bwd = fields["hashgrid_bwd_launches"]
    check(mf_fwd > 0 and mf_bwd > 0,
          f"training launched hashgrid_fwd {mf_fwd}, hashgrid_bwd {mf_bwd} "
          f"times")

    # ---- 15b. the held-out view after training
    render_view(mf, test_rays, test_rcfg)          # warm-up frame
    hashgrid_encode.launches = 0
    out, view_ms = render_view(mf, test_rays, test_rcfg)
    view_launches = hashgrid_encode.launches
    psnr_after = float(psnr(out["rgb"], test_rgb))
    phase("test_view_mf", wh=WH, T_threshold=TEST_T,
          psnr_before=psnr_before, psnr_after=psnr_after,
          psnr_min=MF_PSNR_MIN, psnr_gain=PSNR_GAIN,
          ms_per_frame=view_ms, samples_per_frame=out["total_samples"],
          rounds=out["rounds"], hashgrid_fwd_launches=view_launches,
          card=card)
    check(bool(torch.isfinite(out["rgb"]).all()), "test view not finite")
    check(view_launches > 0, "render_test never launched hashgrid_fwd")
    check(psnr_after >= MF_PSNR_MIN
          and psnr_after >= psnr_before + PSNR_GAIN,
          f"MixedFeature test PSNR {psnr_before} -> {psnr_after}")
    del out

    # ---- 12b. the hash-grid kernels on one real step's operands
    captured = capture_bwd_operands(mf, SEED + 9, hashgrid)
    check(len(captured) == 1, f"{len(captured)} hash-grid backward calls")
    params_t, x_t, cfg_t, g_t, win_t, noise_t, need_dx_t = captured[0]
    check(win_t is None and noise_t is None and not need_dx_t,
          "the training step's hash-grid backward is not the exact one "
          "without d_x")
    hash_train = check_hashgrid("train", cfg_t, params_t, x_t, g_t,
                                SEED + 30)
    phase("kernel_hashgrid", **hash_train, card=card)
    del captured, params_t, x_t, g_t, mf
    torch.cuda.empty_cache()

    # ---- 19. cli: the command line on the procedural scene on disk
    def hat_launches(reset=False):
        if reset:
            hat_prod.launches = hat_prod_bwd.launches = 0
        return dict(hat_prod_launches=hat_prod.launches,
                    hat_prod_bwd_launches=hat_prod_bwd.launches)

    fields = cli_phase(dev, hat_launches)
    phase("cli", **fields, card=card)
    check(fields["hat_prod_launches"] > 0
          and fields["hat_prod_bwd_launches"] > 0,
          f"the command line launched hat_prod {fields['hat_prod_launches']}"
          f", hat_prod_bwd {fields['hat_prod_bwd_launches']} times")
    check(len(fields["results"]) == 2 * CLI_TEST_VIEWS,
          f"results written: {fields['results']}")
    check(fields["test_psnr"] >= PSNR_MIN,
          f"command line test PSNR {fields['test_psnr']}")
    check(abs(fields["val_only_psnr"] - fields["test_psnr"]) <= CLI_PSNR_TOL,
          f"--val_only PSNR {fields['val_only_psnr']} against "
          f"{fields['test_psnr']} in process")
    torch.cuda.empty_cache()

    # ---- 16-18. the encoder formulation probes: each run() at the probe's
    # shape is its kernels' path, then a run at a ragged size
    probes = {}
    for label, probe, kernels in (
            ("probe_gather", probe_gather, (table_lerp,)),
            ("probe_gather2", probe_gather2, (table_lerp, hat_basis_dw)),
            ("probe_hatmul", probe_hatmul, (hat_prod,))):
        for fn in kernels:
            fn.launches = 0
        res = probe.run(dev, SEED)
        counts = {fn.__name__: fn.launches for fn in kernels}
        ragged = probe.run(dev, SEED + 1, N_RAGGED)
        failed = res["failed"] + ragged["failed"]
        dw_sets = {}
        if probe is probe_gather2:     # hat_basis_dw on sorted u and knots
            for kind in ("sorted", "knots"):
                u_set, g_set = probe.dw_operands(kind, probe.N, SEED + 2, dev)
                dw_sets[kind] = probe.dw_row(u_set, g_set, failed,
                                             f"hat_basis_dw ({kind})")
                del u_set, g_set
        phase(label, **res["kernels"], launches=counts,
              ragged=ragged["kernels"], **dw_sets, failed=failed, card=card)
        check(not failed, f"{label}: {failed}")
        check(min(counts.values()) > 0, f"{label} launched {counts}")
        probes[label] = dict(res["kernels"], launches=counts, **dw_sets)
    lerp_idx = probes["probe_gather"]["table_lerp"]
    lerp_u = probes["probe_gather2"]["table_lerp"]
    probe_dw = probes["probe_gather2"]["hat_basis_dw"]
    probe_hat = probes["probe_hatmul"]["hat_prod"]

    fwd_bound_ms, fwd_bound_by = fwd_bound(N_KERNEL, k, w3.shape[2])
    print(json.dumps({"kernels": [{
        "name": "hat_prod", "route": "cuda", "source": src,
        "replaces": "mfnerf_tpu/ops/hatmul.py:54",
        "launches": launches_fwd, "max_abs_err": max_abs, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": fwd_bound_ms,
        "bound_by": fwd_bound_by, "library_ms": None}, {
        "name": "hat_prod_bwd", "route": "cuda", "source": src,
        "replaces": "mfnerf_tpu/ops/hatmul.py:68",
        "launches": launches_bwd,
        "max_abs_err": bwd_uniform["dw_max_abs_err"],
        "ms": bwd_uniform["ms"], "plain_ms": bwd_uniform["plain_ms"],
        "bound_ms": bwd_uniform["bound_ms"],
        "bound_by": bwd_uniform["bound_by"], "library_ms": None}, {
        "name": "hashgrid_fwd", "route": "cuda", "source": hash_src,
        "replaces": "mfnerf_tpu/ops/hashgrid.py:197",
        "launches": mf_fwd, "max_abs_err": hash_train["fwd_max_abs_err"],
        "ms": hash_train["fwd_ms"], "plain_ms": hash_train["fwd_plain_ms"],
        "bound_ms": hash_train["fwd_bound_ms"],
        "bound_by": hash_train["fwd_bound_by"], "library_ms": None}, {
        "name": "hashgrid_bwd", "route": "cuda", "source": hash_src,
        "replaces": "mfnerf_tpu/ops/hashgrid.py:246",
        "launches": mf_bwd,
        "max_abs_err": hash_train["exact_dp_max_abs_err"],
        "ms": hash_train["bwd_ms"], "plain_ms": hash_train["bwd_plain_ms"],
        "bound_ms": hash_train["bwd_bound_ms"],
        "bound_by": hash_train["bwd_bound_by"], "library_ms": None}, {
        "name": "table_lerp", "route": "cuda", "source": line_src,
        "replaces": "benchmarking/probe_pallas_gather.py:60, "
                    "benchmarking/probe_pallas_gather.py:105, "
                    "benchmarking/probe_pallas_gather2.py:88",
        "launches": probes["probe_gather"]["launches"]["table_lerp"]
        + probes["probe_gather2"]["launches"]["table_lerp"],
        "max_abs_err": max(lerp_idx["max_abs_err"], lerp_u["max_abs_err"]),
        "ms": lerp_u["ms"], "plain_ms": lerp_u["plain_ms"],
        "bound_ms": lerp_u["bound_ms"], "bound_by": lerp_u["bound_by"],
        "library_ms": lerp_u["library_ms"], "shape": "probe_gather2, u mode",
        "idx_mode": {key: lerp_idx[key] for key in (
            "n", "ms", "plain_ms", "bound_ms", "library_ms",
            "max_abs_err")}}, {
        "name": "hat_basis_dw", "route": "cuda", "source": line_src,
        "replaces": "benchmarking/probe_pallas_gather2.py:143",
        "launches": probes["probe_gather2"]["launches"]["hat_basis_dw"],
        "max_abs_err": probe_dw["max_abs_err"], "ms": probe_dw["ms"],
        "plain_ms": probe_dw["plain_ms"], "bound_ms": probe_dw["bound_ms"],
        "bound_by": probe_dw["bound_by"], "library_ms": None,
        "sets": {kind: {key: probes["probe_gather2"][kind][key] for key in (
            "ms", "bound_ms", "max_abs_err", "order_model_equal")}
            for kind in ("sorted", "knots")}}, {
        "name": "hat_prod_probe", "route": "cuda", "source": src,
        "replaces": "benchmarking/probe_pallas_hatmul.py:89",
        "launches": probes["probe_hatmul"]["launches"]["hat_prod"],
        "max_abs_err": probe_hat["max_abs_err"], "ms": probe_hat["ms"],
        "plain_ms": probe_hat["plain_ms"], "bound_ms": probe_hat["bound_ms"],
        "bound_by": probe_hat["bound_by"], "library_ms": None,
        "shape": "probe_hatmul: N 2^19, K 513, R 128"}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
