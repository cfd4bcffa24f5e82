"""Check and time the march kernels alone on the card.

    python3 tools/march_check.py [--views 4] [--ptxas] [--train-ab STEPS]

Builds ``mfnerf_tpu_torch/csrc/raymarch.cu``, then runs ``chip_smoke.py``'s
march checks (each kernel against its plain version on the card, bit for
bit) on the untrained bench.py LowRank field of the procedural scene
(culled, one dense refresh): one training step's march (the two-level
strata), the degenerate rays, an empty and a full bitfield, the dense
oracle's rank windows and every window march of one render_test frame;
then on a synthetic five-cascade scene (scale 8, exponential steps) with
the cascade march's union grid. Times the step's march and the frame's
first window by CUDA-graph replay beside their plain versions and bounds.
``--train-ab STEPS`` then trains ``chip_smoke.py``'s bench configuration
(BENCH_HP on its 16 views) STEPS steps three times from the same seed:
through the kernels, through the plain marches (the rendering module's
marches swapped for their plain versions), and through the kernels again;
and prints the first step whose loss differs from the first run's, whether
the parameters and the bitfield end bit for bit equal, and each run's
held-out view PSNR (render_test at T 1e-4). ``--ptxas`` first prints what ``nvcc -Xptxas -v`` says of each kernel
(registers, shared memory, spills). Prints one JSON line a set (the frame's windows in one); exits non-zero on a mismatch or without a
CUDA device.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def cascade_sets(dev, seed, n_rays=8192):
    """A synthetic --scale 8 scene: a sparse random bitfield at five
    cascades, its union grid, camera rays from a ring at 1.5 x scale, the
    cascade strata of RenderConfig(exp_step_factor=1/256)."""
    from mfnerf_tpu_torch.models.rendering import RenderConfig, _clamp_near
    from mfnerf_tpu_torch.ops.intersection import ray_aabb_intersect_single
    from mfnerf_tpu_torch.ops.morton import union_bitfield
    from mfnerf_tpu_torch.ops.ray_march import Strata, cascades_stratum
    scale, cascades, g, e = 8.0, 5, 128, 1.0 / 256
    rng = np.random.default_rng(seed)
    fine = rng.random(cascades * g ** 3) < 0.01
    bits = torch.from_numpy(np.packbits(fine, bitorder="little")).to(dev)
    stratum, dilate = cascades_stratum(e, scale, cascades)
    union = union_bitfield(bits, g, cascades, dilate)
    ang = rng.uniform(0, 2 * np.pi, n_rays)
    o = np.stack([np.cos(ang), np.sin(ang), np.zeros(n_rays)], 1) * 1.5 * scale
    d = -o / np.linalg.norm(o, axis=1, keepdims=True) \
        + rng.normal(scale=0.3, size=(n_rays, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ro = torch.from_numpy(o.astype(np.float32)).to(dev)
    rd = torch.from_numpy(d.astype(np.float32)).to(dev)
    rcfg = RenderConfig(exp_step_factor=e, s_max_train=64)
    hits = _clamp_near(ray_aabb_intersect_single(
        ro, rd, torch.zeros(3), torch.full((3,), scale)))
    noise = torch.from_numpy(rng.random(n_rays, dtype=np.float32)).to(dev)
    args = (ro, rd, hits, bits, cascades, scale, e, g, rcfg.max_samples,
            noise, rcfg.n_rungs(scale, g), rcfg.s_max_train)
    sets = [(f"cascades_s{s}", args, dict(strata=Strata(
        union, stratum, s, 1.0, union=True))) for s in (8, 4)]
    sets.append(("cascades_exact", args, {}))
    dt_scale = rcfg._dt_scale(scale, True)
    cursor = torch.from_numpy(rng.integers(0, 400, n_rays)).to(dev)
    alive = hits[:, 0] >= 0
    window = [(ro[alive], rd[alive], hits[alive, 0], hits[alive, 1],
               cursor[alive], bits, cascades, scale, e, g, rcfg.max_samples,
               w, cap, dt_scale) for w, cap in ((64, 8), (200, 64))]
    return sets, window


def train_ab(steps, dev, card):
    """--train-ab: the bench configuration trained through the kernels,
    the plain marches and the kernels again, from the same seed."""
    import chip_smoke
    from mfnerf_tpu_torch.datasets.memory import MemoryDataset
    from mfnerf_tpu_torch.models import rendering
    from mfnerf_tpu_torch.ops import ray_march
    from mfnerf_tpu_torch.utils.metrics import psnr
    from mfnerf_tpu_torch.utils.procedural import make_scene
    scene = make_scene(n_train=chip_smoke.N_TRAIN_VIEWS, n_test=1,
                       wh=chip_smoke.WH, seed=chip_smoke.SEED)
    datasets = (MemoryDataset.from_scene(scene, "train"),
                MemoryDataset.from_scene(scene, "test"))
    kernels = (rendering.march_rays_train, rendering.march_rays_window)
    plain = (ray_march.march_rays_train_plain,
             ray_march.march_rays_window_plain)
    runs = {}
    for label, marches in (("kernel", kernels), ("plain", plain),
                           ("kernel_again", kernels)):
        rendering.march_rays_train, rendering.march_rays_window = marches
        system = chip_smoke.start_system(chip_smoke.BENCH_HP, datasets, dev)
        t0 = time.perf_counter()
        loss = system.fit(steps)["loss"]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        rays, rgb, rcfg = chip_smoke.held_out_view(system)
        out, _ = chip_smoke.render_view(system, rays, rcfg)
        runs[label] = dict(
            loss=loss, seconds=seconds,
            state={k: v.detach().clone()
                   for k, v in system.model.state_dict().items()},
            bits=system.occ.density_bitfield.clone(),
            psnr=float(psnr(out["rgb"], rgb)))
        del system, out
    rendering.march_rays_train, rendering.march_rays_window = kernels
    first = runs["kernel"]
    for label in ("plain", "kernel_again"):
        run = runs[label]
        differ = torch.nonzero(run["loss"] != first["loss"])
        print(json.dumps({
            "train_ab": label, "against": "kernel", "steps": steps,
            "first_loss_step_differing": int(differ[0]) if len(differ)
            else None,
            "params_bit_equal": all(torch.equal(v, first["state"][k])
                                    for k, v in run["state"].items()),
            "bitfield_equal": torch.equal(run["bits"], first["bits"]),
            "test_psnr": run["psnr"], "kernel_test_psnr": first["psnr"],
            "seconds": run["seconds"], "kernel_seconds": first["seconds"],
            "card": card}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--train-ab", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("march_check: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from mfnerf_tpu_torch import build
    from mfnerf_tpu_torch.datasets.memory import MemoryDataset
    from mfnerf_tpu_torch.device import no_tf32
    from mfnerf_tpu_torch.utils.procedural import make_scene
    no_tf32()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    if args.ptxas:
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run(
            [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(build.BUILD_DIR / "raymarch-ptxas.so"),
             str(build.CSRC / "raymarch.cu")], capture_output=True,
            text=True)
        print(proc.stdout + proc.stderr, flush=True)
        if proc.returncode != 0:
            return proc.returncode
    t0 = time.perf_counter()
    build.load_library("raymarch")
    print(json.dumps({"build_seconds": time.perf_counter() - t0}),
          flush=True)
    dev = torch.device("cuda", 0)
    scene = make_scene(n_train=args.views, n_test=1, wh=chip_smoke.WH,
                       seed=chip_smoke.SEED)
    datasets = (MemoryDataset.from_scene(scene, "train"),
                MemoryDataset.from_scene(scene, "test"))
    system = chip_smoke.start_system(chip_smoke.BENCH_HP, datasets, dev)
    system.occ = chip_smoke.culled_state(system, chip_smoke.SEED + 2)
    rays, _, test_rcfg = chip_smoke.held_out_view(system)
    train_sets = chip_smoke.march_sets_of(system, chip_smoke.SEED + 80)
    train_sets += chip_smoke.oracle_march_sets(system, rays, test_rcfg)
    chip_smoke.march_phase(
        "bench_untrained", train_sets,
        chip_smoke.frame_window_sets(system, rays, test_rcfg))
    chip_smoke.march_phase("cascades_synthetic",
                           *cascade_sets(dev, chip_smoke.SEED + 81))
    if args.train_ab:
        train_ab(args.train_ab, dev, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
