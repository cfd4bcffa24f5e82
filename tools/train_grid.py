"""Train variants of a configuration on the card and compare their quality.

    python3 tools/train_grid.py [--base mf|bench] [--steps 900]
        [--variant '{"lr": 1e-2}'] ...

Each variant is the base hyperparameters (``chip_smoke.py``'s MF_HP or
BENCH_HP) updated by a JSON object. It trains on ``chip_smoke.py``'s 16
procedural 800x800 views through ``NeRFSystem.fit`` from the same seed and
prints, every 300 steps, the mean train PSNR of the last 50 steps, the
marched and composited samples a ray, ms/step (host clock, synced) and the
held-out view's PSNR through ``render_test`` (T 1e-4), with the card's name
and power limit. Without variants it trains the base alone. Exits non-zero
without a CUDA device.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", choices=("mf", "bench"), default="mf")
    ap.add_argument("--steps", type=int, default=900)
    ap.add_argument("--variant", action="append", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_grid: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke
    from mfnerf_tpu_torch.datasets.memory import MemoryDataset
    from mfnerf_tpu_torch.utils.metrics import psnr
    from mfnerf_tpu_torch.utils.procedural import make_scene
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    base = chip_smoke.MF_HP if args.base == "mf" else chip_smoke.BENCH_HP
    scene = make_scene(n_train=chip_smoke.N_TRAIN_VIEWS, n_test=1,
                       wh=chip_smoke.WH, seed=chip_smoke.SEED)
    datasets = (MemoryDataset.from_scene(scene, "train"),
                MemoryDataset.from_scene(scene, "test"))
    for variant in args.variant or ["{}"]:
        change = json.loads(variant)
        system = chip_smoke.start_system(dict(base, **change), datasets,
                                         torch.device("cuda"))
        rays, rgb, rcfg = chip_smoke.held_out_view(system)
        done = 0
        while done < args.steps:
            n = min(300, args.steps - done)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = system.fit(n)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / n
            done += n
            out, _ = chip_smoke.render_view(system, rays, rcfg)
            print(json.dumps({
                "base": args.base, "change": change, "steps": done,
                "train_psnr": float(m["psnr"][-50:].mean()),
                "rm_s": float(m["rm_s"][-50:].mean()),
                "vr_s": float(m["vr_s"][-50:].mean()),
                "ms_per_step": ms,
                "test_psnr": float(psnr(out["rgb"], rgb)),
                "test_samples": out["total_samples"], "card": card}),
                flush=True)
        del system
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
