"""Train one of ``chip_smoke.py``'s multi-cascade COLMAP recipes and render
every view: the train/test gap, and the serving loop against its oracle.

    python3 tools/view_gap.py [--config mf360_black|mf360|lr360] \
        [--steps 600] [--oracle_stride 97]

The recipe (``chip_smoke.py``'s MF360_BLACK_ARGS, MF360_ARGS or
LR360_ARGS) trains on its phase-20 COLMAP scene (written to a temporary
directory) through ``NeRFSystem.fit`` for ``--steps`` steps. Then every
train and test view goes through ``render_test`` (T 1e-4, as
``validate``): one JSON line a split with each view's PSNR, samples and
ms, beside the PSNR of an all-black frame. Last, a strided subset of the
first test view's rays through ``render_test`` against the dense oracle
``render_test_dense`` on the same card: the maximum absolute error of rgb,
opacity and depth. Prints the card's name and power limit; exits non-zero
without a CUDA device.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="mf360_black",
                    choices=("mf360_black", "mf360", "lr360"))
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--oracle_stride", type=int, default=97)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("view_gap: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke
    from mfnerf_tpu_torch.datasets.ray_utils import get_rays
    from mfnerf_tpu_torch.models.rendering import render_test_dense
    from mfnerf_tpu_torch.opt import get_opts
    from mfnerf_tpu_torch.utils.metrics import psnr
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    argv = {"mf360_black": chip_smoke.MF360_BLACK_ARGS,
            "mf360": chip_smoke.MF360_ARGS,
            "lr360": chip_smoke.LR360_ARGS}[args.config]
    with tempfile.TemporaryDirectory() as tmp:
        datasets = chip_smoke.colmap_views(
            os.path.join(tmp, chip_smoke.COLMAP_ROOT))[:2]
    system = chip_smoke.start_system(
        vars(get_opts(["--root_dir", "", *argv])), datasets,
        torch.device("cuda"))
    m = system.fit(args.steps)
    rcfg = dataclasses.replace(system.rcfg, T_threshold=chip_smoke.TEST_T)
    directions = torch.from_numpy(system.train_dataset.directions).cuda()
    for split, ds in zip(("train", "test"), datasets):
        views = []
        for i in range(len(ds)):
            rays = get_rays(directions,
                            torch.from_numpy(ds.poses[i]).cuda())
            out, ms = chip_smoke.render_view(system, rays, rcfg)
            gt = torch.from_numpy(ds.rays[i]).cuda()
            views.append(dict(psnr=float(psnr(out["rgb"], gt)),
                              black_psnr=float(psnr(torch.zeros_like(gt),
                                                    gt)),
                              samples=out["total_samples"], ms=ms))
        print(json.dumps({
            "config": args.config, "steps": args.steps, "split": split,
            "train_psnr": float(m["psnr"][-50:].mean()),
            "rm_s": float(m["rm_s"][-50:].mean()),
            "vr_s": float(m["vr_s"][-50:].mean()),
            "mean_psnr": sum(v["psnr"] for v in views) / len(views),
            "views": views, "card": card}), flush=True)
    ro, rd = get_rays(directions,
                      torch.from_numpy(datasets[1].poses[0]).cuda())
    sub = slice(None, None, args.oracle_stride)
    loop, _ = chip_smoke.render_view(system, (ro[sub], rd[sub]), rcfg)
    t0 = time.perf_counter()
    dense = render_test_dense(system.model, system.occ, ro[sub], rd[sub],
                              dataclasses.replace(rcfg, test_chunk=2048))
    print(json.dumps({
        "config": args.config, "part": "oracle",
        "rays": int(dense["opacity"].shape[0]),
        "seconds": time.perf_counter() - t0,
        **{f"max_abs_{key}": float((loop[key] - dense[key]).abs().max())
           for key in ("rgb", "opacity", "depth")},
        "samples_loop": loop["total_samples"],
        "samples_dense": dense["total_samples"], "card": card}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
