"""Train the command line's LowRank model from several seeds and compare
their quality.

    python3 tools/seed_sweep.py [--steps 600] [--seeds 1337 0 1 2 ...]
        [--batch_seed S] [--data memory|nsvf|colmap|hdr|rtmv] [--wh 800] \
        [--spread 5 --scale 4] [--perturb 0.03] [--extra --flag value ...]

The hyperparameters are ``get_opts`` of ``chip_smoke.py``'s CLI_ARGS with
``--seed`` set (the bench.py LowRank model, batch 8192, lr 1e-2). Each seed
draws the field (``NeRFSystem.configure(seed)``) and, as ``main`` does with
``--seed``, the ray batches and the refresh jitter; with ``--batch_seed``
those come from that one seed in every row, so the rows differ by the
init alone. The data are the cli phase's scene (16 train and 2 test views,
``--wh`` pixels a side), in memory or, with ``--data nsvf``, written in the
NSVF layout to a temporary directory and loaded from there as ``main``
loads it; ``--data colmap`` writes it (with a third test view) as
``chip_smoke.py``'s phase 20 does, a COLMAP reconstruction, and trains
with ``--dataset_name colmap`` (the eroding refresh). Each row prints the
occupied fraction of the grid after the first refresh and after
training, the mean train PSNR of the last 50 steps, the mean samples a
ray and the test views' PSNR and SSIM through ``validate``, with the
card's name and power limit. Exits non-zero
without a CUDA device. ``--wh 200`` is the scene of
``tools/seed_sweep_jax.py``, the reference trainer's sweep on the CPU;
``--spread`` and ``--scale`` are its too (``make_scene(spread=...)`` on
black, the command line's ``--scale``: at 4, four cascades and the
cascade march). ``--extra`` appends command-line flags (e.g.
``--s_max_train 512``, whose strata budget is 64) to every row's.
``--data hdr`` trains with ``--use_exposure`` on the scene in HDR-NeRF's
synthetic layout (``write_hdr_scene``, 18 train and 17 test poses,
``luckycat``'s exposures) and adds each test exposure's mean PSNR;
``--perturb SIGMA`` shifts the training poses (``perturb_poses``), trains
with ``--optimize_ext`` and adds the gauge-corrected camera-centre error
before and after: the counterparts of ``tools/seed_sweep_jax.py --hdr``
and ``--perturb``. ``--data rtmv`` trains ``chip_smoke.py``'s cli_rtmv
recipe (RTMV_ARGS: the Hash grid, batch 16384, lr 2e-2) on its scene
(RTMV_FRAMES distinct views written in the RTMV layout as PNG, loaded
with ``--dataset_name rtmv``: train frames 0-100, test 105-110) and adds
the first test view's rendered colour over its foreground (mean and
spread beside the true spread: a head whose sigmoid saturates renders one
colour). Every row gives the mean train PSNR of each 100 steps.
"""
import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def occupied(system):
    bits = system.occ.density_bitfield.cpu().numpy()
    return float(np.unpackbits(bits).mean())


def psnr_by_exposure(log, test_dataset):
    """{exposure: mean PSNR of the test views at it} from ``validate``'s
    lines in ``log``."""
    psnrs = [float(v) for v in re.findall(r"^val image .*psnr=([0-9.]+)",
                                          log, re.M)]
    exposures = [float(test_dataset[i]["exposure"])
                 for i in range(len(psnrs))]
    return {str(e): float(np.mean([p for p, e_ in zip(psnrs, exposures)
                                   if e_ == e]))
            for e in sorted(set(exposures), reverse=True)}


@torch.no_grad()
def unit_exposure_rgb(system):
    """The HDR head's rgb of zero log radiance at exposure 1 (the
    unit-exposure loss's prediction)."""
    dev = system.device
    return system.model.log_radiance_to_rgb(
        torch.zeros((1, 3), device=dev),
        torch.ones((1, 1), device=dev))[0].tolist()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[1337, 0, 1, 2, 3, 4, 5, 6, 7])
    ap.add_argument("--batch_seed", type=int, default=None)
    ap.add_argument("--perturb", type=float, default=None)
    ap.add_argument("--data", choices=("memory", "nsvf", "colmap", "hdr",
                                       "rtmv"), default="memory")
    ap.add_argument("--wh", type=int, default=None)
    ap.add_argument("--spread", type=float, default=1.0)
    ap.add_argument("--scale", type=float, default=None)
    ap.add_argument("--extra", nargs=argparse.REMAINDER, default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("seed_sweep: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke
    from mfnerf_tpu_torch.datasets.colmap import ColmapDataset
    from mfnerf_tpu_torch.datasets.memory import MemoryDataset
    from mfnerf_tpu_torch.datasets.nsvf import NSVFDataset
    from mfnerf_tpu_torch.datasets.rtmv import RTMVDataset
    from mfnerf_tpu_torch.opt import get_opts
    from mfnerf_tpu_torch.train import UPDATE_INTERVAL, NeRFSystem
    from mfnerf_tpu_torch.utils.procedural import (HDR_TEST, HDR_TRAIN,
                                                   gauge_center_error,
                                                   make_scene, perturb_poses,
                                                   write_colmap_scene,
                                                   write_hdr_scene,
                                                   write_nsvf_scene,
                                                   write_rtmv_scene)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    colmap = args.data in ("colmap", "hdr")
    hdr = args.data == "hdr"
    rtmv = args.data == "rtmv"
    scene = make_scene(n_train=HDR_TRAIN[0] if hdr
                       else chip_smoke.RTMV_FRAMES if rtmv
                       else chip_smoke.N_TRAIN_VIEWS,
                       n_test=HDR_TEST[0] if hdr
                       else chip_smoke.COLMAP_TEST_VIEWS if colmap
                       else chip_smoke.CLI_TEST_VIEWS,
                       wh=args.wh or chip_smoke.WH, seed=chip_smoke.SEED,
                       spread=args.spread)
    if hdr:
        with tempfile.TemporaryDirectory() as tmp:
            root = os.path.join(tmp, "HDR-NeRF", "syndata", "luckycat")
            write_hdr_scene(root, scene, spread=args.spread)
            with contextlib.redirect_stdout(io.StringIO()):
                datasets = (ColmapDataset(root, "train"),
                            ColmapDataset(root, "test"))
    elif colmap:
        with tempfile.TemporaryDirectory() as tmp:
            write_colmap_scene(tmp, scene, spread=args.spread)
            with contextlib.redirect_stdout(io.StringIO()):
                datasets = (ColmapDataset(tmp, "train"),
                            ColmapDataset(tmp, "test"))
    elif rtmv:
        with tempfile.TemporaryDirectory() as tmp:
            root = os.path.join(tmp, chip_smoke.RTMV_ROOT, "spheres_png")
            write_rtmv_scene(root, scene, n_frames=chip_smoke.RTMV_FRAMES)
            with contextlib.redirect_stdout(io.StringIO()):
                datasets = (RTMVDataset(root, "train"),
                            RTMVDataset(root, "test"))
    elif args.data == "nsvf":
        with tempfile.TemporaryDirectory() as tmp:
            root = os.path.join(tmp, "Synthetic_NeRF_proc", "Spheres")
            write_nsvf_scene(root, scene)
            datasets = (NSVFDataset(root, "train"), NSVFDataset(root, "test"))
    else:
        datasets = (MemoryDataset.from_scene(scene, "train"),
                    MemoryDataset.from_scene(scene, "test"))
    if args.perturb is not None:
        true_centers = datasets[0].poses[:, :, 3].copy()
        datasets[0].poses = perturb_poses(datasets[0].poses, args.perturb)[0]
    for seed in args.seeds:
        batch_seed = seed if args.batch_seed is None else args.batch_seed
        hp = get_opts(["--root_dir", "<memory>",
                       *(chip_smoke.RTMV_ARGS if rtmv
                         else chip_smoke.CLI_ARGS),
                       "--steps_per_epoch", str(args.steps),
                       "--seed", str(batch_seed)]
                      + (["--dataset_name", "colmap"] if colmap else [])
                      + (["--use_exposure"] if hdr else [])
                      + (["--optimize_ext"] if args.perturb is not None
                         else [])
                      + args.extra
                      + ([] if args.scale is None
                         else ["--scale", str(args.scale)]))
        system = NeRFSystem(hp, device=torch.device("cuda"))
        system.setup(*datasets)
        system.configure(seed)
        first_steps = system.fit(UPDATE_INTERVAL)
        first = occupied(system)
        m = system.fit(args.steps - UPDATE_INTERVAL)
        psnrs = torch.cat([first_steps["psnr"], m["psnr"]])
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            val = system.validate()
        extra = {}
        if hdr:
            extra["psnr_by_exposure"] = psnr_by_exposure(
                log.getvalue(), datasets[1])
            extra["unit_exposure_rgb"] = unit_exposure_rgb(system)
        if args.perturb is not None:
            pert = datasets[0].poses[:, :, 3]
            extra["center_err_before"] = gauge_center_error(pert,
                                                            true_centers)
            extra["center_err_after"] = gauge_center_error(
                pert + system.ext["dT"].detach().cpu().numpy(), true_centers)
        print(json.dumps({
            "data": args.data, "wh": scene["img_wh"][0], "init_seed": seed,
            "spread": args.spread, "scale": system.model_cfg.scale,
            "extra": args.extra, "s_strata": system.rcfg.s_strata,
            "batch_seed": batch_seed, "steps": args.steps,
            "occupied_first_refresh": first, "occupied_end": occupied(system),
            "train_psnr": float(m["psnr"][-50:].mean()),
            "train_psnr_per_100": [round(float(p.mean()), 2)
                                   for p in psnrs.split(100)],
            "foreground": (chip_smoke.foreground_colour(system)
                           if rtmv else None),
            "rm_s": float(m["rm_s"][-50:].mean()),
            "vr_s": float(m["vr_s"][-50:].mean()),
            "test_psnr": val["test/psnr"], "test_ssim": val["test/ssim"],
            **extra, "card": card}), flush=True)
        del system
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
