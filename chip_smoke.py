"""Drive the PyTorch/CUDA port's serving path once on one NVIDIA GPU.

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
   version).

The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits
non-zero and prints no result.
"""
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from mfnerf_tpu_torch import build
    from mfnerf_tpu_torch.datasets.ray_utils import get_rays
    from mfnerf_tpu_torch.models.ngp import NGP, NGPConfig, OccupancyState
    from mfnerf_tpu_torch.models.rendering import (RenderConfig, render_test,
                                                   render_test_dense)
    from mfnerf_tpu_torch.ops.hatmul import hat_prod, hat_prod_plain
    from mfnerf_tpu_torch.ops.lowrank import fold_frame
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
    cpu_model = NGP(cfg)
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

    print(json.dumps({"kernels": [{
        "name": "hat_prod", "route": "cuda", "source": src,
        "replaces": "mfnerf_tpu/ops/hatmul.py:54", "launches": launches,
        "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
