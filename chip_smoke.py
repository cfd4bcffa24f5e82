"""Drive the PyTorch/CUDA port's serving and training paths once on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (one line each; any failure ends the run with a non-zero exit):

1. device: the card's name and power limit (nvidia-smi), CUDA, nvcc, Triton;
2. build: compile the hat-product kernel from mfnerf_tpu_torch/csrc/;
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
   tools/hat_bwd_ab.py times the kernel alone).

The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits
non-zero and prints no result.
"""
import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

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
# NVIDIA H100 SXM peaks (data sheet): HBM bytes/s, fp32 FLOP/s off the
# tensor cores
HBM_BPS, FP32_FLOPS = 3.35e12, 67e12


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def phase(label, **fields):
    print(json.dumps({"phase": label, **fields}), flush=True)


def cuda_ms(fn, iters):
    """Mean device milliseconds per call, timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes, flops):
    """(least ms, "bytes" or "operations"): the bytes over HBM's rate or the
    fp32 operations over the peak, whichever takes longer."""
    by_bytes, by_ops = n_bytes / HBM_BPS * 1e3, flops / FP32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                          "operations")


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


def capture_bwd_operands(system, seed):
    """One forward and backward of a training step of ``system`` on a ray
    batch drawn from ``seed`` (weights and optimiser untouched): the
    (u3, w3, k, g) that each frame's HatProd.backward received."""
    from mfnerf_tpu_torch.datasets.ray_utils import get_rays
    from mfnerf_tpu_torch.models.rendering import render_train
    from mfnerf_tpu_torch.ops import hatmul
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
    captured, launch = [], hatmul._launch_bwd

    def recorder(u3, w3, k_res, g, need_du):
        captured.append((u3.detach(), w3.detach(), k_res, g))
        return launch(u3, w3, k_res, g, need_du)

    hatmul._launch_bwd = recorder
    try:
        loss.backward()
    finally:
        hatmul._launch_bwd = launch
        system.model.zero_grad(set_to_none=True)
    return captured


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from mfnerf_tpu_torch import build
    from mfnerf_tpu_torch.datasets.memory import MemoryDataset
    from mfnerf_tpu_torch.datasets.ray_utils import get_rays
    from mfnerf_tpu_torch.models.ngp import NGP, NGPConfig, OccupancyState
    from mfnerf_tpu_torch.models.rendering import (RenderConfig, render_test,
                                                   render_test_dense,
                                                   render_train)
    from mfnerf_tpu_torch.ops.hatmul import (hat_prod, hat_prod_bwd,
                                             hat_prod_plain)
    from mfnerf_tpu_torch.ops.lowrank import fold_frame
    from mfnerf_tpu_torch.train import NeRFSystem
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

    # ---- 2. build
    src = "mfnerf_tpu_torch/csrc/hatmul.cu"
    fresh = not build.library_path("hatmul").exists()
    t0 = time.perf_counter()
    build.load_library("hatmul")
    phase("build", source=src, built=fresh,
          seconds=time.perf_counter() - t0, card=card)

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

    # ---- 8. one training step on the card against the same step on the CPU
    train_scene = make_scene(n_train=N_TRAIN_VIEWS, n_test=1, wh=WH,
                             seed=SEED)
    hp = argparse.Namespace(**BENCH_HP)
    system = NeRFSystem(hp, device=dev)
    system.setup(MemoryDataset.from_scene(train_scene, "train"),
                 MemoryDataset.from_scene(train_scene, "test"))
    system.configure(SEED)
    ds = system.train_dataset
    occ0 = system.model.mark_invisible_cells(system.occ, ds.K, system.poses,
                                             ds.img_wh)
    tcfg = system.model_cfg
    occ0 = system.model.update_density_grid(
        occ0, system.density_threshold,
        torch.rand((tcfg.cascades, tcfg.n_cells, 3),
                   generator=torch.Generator(device=dev).manual_seed(SEED + 2),
                   device=dev) * 2 - 1)
    pick = np.random.default_rng(SEED + 3)
    img = torch.from_numpy(pick.integers(0, N_TRAIN_VIEWS, N_ORACLE_RAYS))
    pix = torch.from_numpy(pick.integers(0, WH * WH, N_ORACLE_RAYS))
    ro, rd = get_rays(torch.from_numpy(ds.directions)[pix],
                      torch.from_numpy(ds.poses)[img])
    batch = {"rays_o": ro, "rays_d": rd,
             "rgb": torch.from_numpy(ds.rays)[img, pix],
             "noise": torch.from_numpy(pick.random(N_ORACLE_RAYS,
                                                   dtype=np.float32))}
    cpu_model = NGP(system.model_cfg, device="cpu")
    cpu_model.load_state_dict(system.model.state_dict())
    steps = {}
    for where, model_, occ_ in (
            ("card", system.model, occ0),
            ("cpu", cpu_model, OccupancyState(occ0.density_grid.cpu(),
                                              occ0.density_bitfield.cpu()))):
        on = {key: v.to(model_.device) for key, v in batch.items()}
        res = render_train(model_, occ_, on["rays_o"], on["rays_d"],
                           on["noise"], system.rcfg)
        loss = sum(v.mean() for v in system.loss(
            res, {"rgb": on["rgb"]}).values())
        model_.zero_grad(set_to_none=True)
        loss.backward()
        steps[where] = (float(loss.detach()), int(res["rm_samples"]), {
            name: p_.grad.detach().cpu() for name, p_
            in model_.named_parameters()})
    system.model.zero_grad(set_to_none=True)
    (loss_c, rm_c, grads_c), (loss_p, rm_p, grads_p) = \
        steps["card"], steps["cpu"]
    loss_rel = abs(loss_c - loss_p) / abs(loss_p)
    grad_rel = {name: float((grads_c[name] - grads_p[name]).norm()
                            / grads_p[name].norm()) for name in grads_p}
    line_norms = [float(v.norm()) for name, v in grads_c.items()
                  if name.startswith("lowrank.lines.")]
    phase("train_step_oracle", rays=N_ORACLE_RAYS, samples_card=rm_c,
          samples_cpu=rm_p, loss_card=loss_c, loss_cpu=loss_p,
          loss_rel_err=loss_rel, loss_tol=LOSS_TOL,
          grad_rel_err_max=max(grad_rel.values()),
          grad_rel_err_worst=max(grad_rel, key=grad_rel.get),
          grad_tol=GRAD_TOL, line_tables=len(line_norms),
          line_grad_norm_min=min(line_norms), card=card)
    check(rm_c == rm_p, f"samples on the card {rm_c} vs cpu {rm_p}")
    check(loss_rel <= LOSS_TOL, f"loss card {loss_c} vs cpu {loss_p}")
    check(max(grad_rel.values()) <= GRAD_TOL, f"gradients: {grad_rel}")
    check(len(line_norms) == 3 * lr.n_frames * len(lr.levels)
          and min(line_norms) > 0, "a line table got no gradient")

    # ---- 10a. the held-out view before training (culled + one refresh)
    test_view = system.test_dataset[0]
    test_rays = get_rays(torch.from_numpy(ds.directions).to(dev),
                         torch.from_numpy(test_view["pose"]).to(dev))
    test_rgb = torch.from_numpy(test_view["rgb"]).to(dev)
    test_rcfg = dataclasses.replace(system.rcfg, T_threshold=TEST_T)

    def render_view():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = render_test(system.model, system.occ, *test_rays, test_rcfg)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    system.occ, occ_train = occ0, system.occ
    out, _ = render_view()
    psnr_before = float(psnr(out["rgb"], test_rgb))
    system.occ = occ_train
    del occ0, out

    # ---- 9. train: 300 steps, then 6 timed chunks of 100
    hat_prod.launches = hat_prod_bwd.launches = 0
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
    launches_fwd, launches_bwd = hat_prod.launches, hat_prod_bwd.launches
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    m = {key: torch.cat([c[key] for c in metrics]) for key in metrics[0]}
    check(bool(torch.isfinite(m["loss"]).all()), "a training loss is not "
          "finite")
    check(launches_fwd > 0 and launches_bwd > 0,
          f"training launched hat_prod {launches_fwd}, hat_prod_bwd "
          f"{launches_bwd} times")
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
    phase("train", steps=system.global_step, batch=hp.batch_size,
          ms_per_step=ms_step, chunk_ms_per_step=chunk_ms,
          warm_seconds=warm_s, rays_per_s=hp.batch_size / ms_step * 1e3,
          rm_s=float(m["rm_s"][-CHUNK:].mean()),
          vr_s=float(m["vr_s"][-CHUNK:].mean()),
          rm_s_first=float(m["rm_s"][0]),
          train_psnr=float(m["psnr"][-50:].mean()),
          train_psnr_last_step=float(m["psnr"][-1]),
          loss_last=float(m["loss"][-1]), refresh_ms=refresh_ms,
          hat_prod_launches=launches_fwd,
          hat_prod_bwd_launches=launches_bwd, max_memory_gb=peak_gb,
          card=card)

    # ---- 10b. the held-out view after training
    render_view()                                  # warm-up frame
    out, view_ms = render_view()
    psnr_after = float(psnr(out["rgb"], test_rgb))
    phase("test_view", wh=WH, T_threshold=TEST_T, psnr_before=psnr_before,
          psnr_after=psnr_after, ms_per_frame=view_ms,
          samples_per_frame=out["total_samples"], rounds=out["rounds"],
          card=card)
    check(bool(torch.isfinite(out["rgb"]).all()), "test view not finite")
    check(psnr_after >= PSNR_MIN and psnr_after >= psnr_before + PSNR_GAIN,
          f"test PSNR {psnr_before} -> {psnr_after}")

    # ---- 7b. backward kernel on one real step's operands (trained field)
    captured = capture_bwd_operands(system, SEED + 4)
    check(len(captured) == lr.n_frames, f"{len(captured)} hat backward calls")
    # both frames' g are column slices of the (N, 2R) feature gradient
    u3, w3_t, k_t, g = captured[0]
    check(not g.is_contiguous() and g.stride(0) == 2 * g.shape[1],
          f"g of stride {g.stride()} is not a column slice")
    bwd_train = check_bwd("train", u3, w3_t, k_t, g)
    # hat_prod on the same frame's u (the wrapper: host time included)
    fwd_train_ms = cuda_ms(lambda: hat_prod(u3, w3_t, k_t), 20)
    fwd_train_bound = fwd_bound(u3.shape[0], k_t, w3_t.shape[2])[0]
    phase("kernel_bwd", name="hat_prod_bwd", **bwd_train,
          fwd_ms=fwd_train_ms, fwd_bound_ms=fwd_train_bound,
          fwd_share_of_bound=fwd_train_bound / fwd_train_ms, card=card)
    del captured, u3, g

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
        "bound_by": bwd_uniform["bound_by"], "library_ms": None}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
