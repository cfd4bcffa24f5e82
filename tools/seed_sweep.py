"""Train the command line's LowRank model from several seeds and compare
their quality.

    python3 tools/seed_sweep.py [--steps 600] [--seeds 1337 0 1 2 ...]
        [--batch_seed S] [--data memory|nsvf] [--wh 800]

The hyperparameters are ``get_opts`` of ``chip_smoke.py``'s CLI_ARGS with
``--seed`` set (the bench.py LowRank model, batch 8192, lr 1e-2). Each seed
draws the field (``NeRFSystem.configure(seed)``) and, as ``main`` does with
``--seed``, the ray batches and the refresh jitter; with ``--batch_seed``
those come from that one seed in every row, so the rows differ by the
init alone. The data are the cli phase's scene (16 train and 2 test views,
``--wh`` pixels a side), in memory or, with ``--data nsvf``, written in the
NSVF layout to a temporary directory and loaded from there as ``main``
loads it. Each row prints the occupied fraction of the grid after the
first refresh and after training, the mean train PSNR of the last 50
steps, the mean samples a ray and the test views' PSNR and SSIM through
``validate``, with the card's name and power limit. Exits non-zero
without a CUDA device. ``--wh 200`` is the scene of
``tools/seed_sweep_jax.py``, the reference trainer's sweep on the CPU.
"""
import argparse
import contextlib
import io
import json
import os
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[1337, 0, 1, 2, 3, 4, 5, 6, 7])
    ap.add_argument("--batch_seed", type=int, default=None)
    ap.add_argument("--data", choices=("memory", "nsvf"), default="memory")
    ap.add_argument("--wh", type=int, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("seed_sweep: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke
    from mfnerf_tpu_torch.datasets.memory import MemoryDataset
    from mfnerf_tpu_torch.datasets.nsvf import NSVFDataset
    from mfnerf_tpu_torch.opt import get_opts
    from mfnerf_tpu_torch.train import UPDATE_INTERVAL, NeRFSystem
    from mfnerf_tpu_torch.utils.procedural import make_scene, write_nsvf_scene
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    scene = make_scene(n_train=chip_smoke.N_TRAIN_VIEWS,
                       n_test=chip_smoke.CLI_TEST_VIEWS,
                       wh=args.wh or chip_smoke.WH, seed=chip_smoke.SEED)
    if args.data == "nsvf":
        with tempfile.TemporaryDirectory() as tmp:
            root = os.path.join(tmp, "Synthetic_NeRF_proc", "Spheres")
            write_nsvf_scene(root, scene)
            datasets = (NSVFDataset(root, "train"), NSVFDataset(root, "test"))
    else:
        datasets = (MemoryDataset.from_scene(scene, "train"),
                    MemoryDataset.from_scene(scene, "test"))
    for seed in args.seeds:
        batch_seed = seed if args.batch_seed is None else args.batch_seed
        hp = get_opts(["--root_dir", "<memory>", *chip_smoke.CLI_ARGS,
                       "--steps_per_epoch", str(args.steps),
                       "--seed", str(batch_seed)])
        system = NeRFSystem(hp, device=torch.device("cuda"))
        system.setup(*datasets)
        system.configure(seed)
        system.fit(UPDATE_INTERVAL)
        first = occupied(system)
        m = system.fit(args.steps - UPDATE_INTERVAL)
        with contextlib.redirect_stdout(io.StringIO()):
            val = system.validate()
        print(json.dumps({
            "data": args.data, "wh": scene["img_wh"][0], "init_seed": seed,
            "batch_seed": batch_seed, "steps": args.steps,
            "occupied_first_refresh": first, "occupied_end": occupied(system),
            "train_psnr": float(m["psnr"][-50:].mean()),
            "rm_s": float(m["rm_s"][-50:].mean()),
            "vr_s": float(m["vr_s"][-50:].mean()),
            "test_psnr": val["test/psnr"], "test_ssim": val["test/ssim"],
            "card": card}), flush=True)
        del system
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
