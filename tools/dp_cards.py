"""Data parallelism on the cards of one machine: N ranks, one a card
(NCCL), against one rank.

    python3 tools/dp_cards.py [--cards N] [--steps 600]

Runs, with chip_smoke.py's configurations and helpers:

1. ``dp``: chip_smoke.py's phase-30 runs of DP_HP (bench.py's LowRank
   model, ``--s_flat 8 --pool_a 4``) on N ranks spawned one a card,
   against the same runs on one card in this process: the first step's
   averaged gradients (relative L2, chip_smoke.DP_GRAD_TOL), every rank
   bitwise equal to rank 0 at each checkpoint, the late run's distance
   and the steps whose flat cut fell inside rank 0; then
   ``render_test_sharded`` of the held-out view over the N ranks against
   ``render_test`` (phase 31's tolerances);
2. ``cli``: the command line (chip_smoke.CLI_ARGS, ``--steps`` steps) on
   chip_smoke's procedural scene written in the NSVF layout, with
   ``--num_gpus N`` (main spawns the ranks) and with one card: ms/step
   synced around training, test PSNR; then ``eval --num_gpus N``
   against one card on the N-rank checkpoint.

Prints one JSON line a part and the cards' ``nvidia-smi`` name and power
limit; exits non-zero if a check fails. ``--cpu`` runs N gloo ranks on
the CPU instead (a rehearsal; put a copy of chip_smoke.py with smaller
sizes first on PYTHONPATH).
"""
import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def dp_part(devices, datasets):
    """Part 1 on ``devices`` (one a rank); returns its fields and what
    failed."""
    from mfnerf_tpu_torch.parallel import dist as pdist
    t0 = time.perf_counter()
    ranks = pdist.spawn(cs.dp_rank, devices, ([("LowRank", cs.DP_HP)],),
                        timeout=1800)
    spawn_s = time.perf_counter() - t0
    runs = cs.dp_runs(cs.DP_HP, datasets, torch.device(devices[0]))
    r0 = ranks[0]["LowRank"]
    failed, fields = [], dict(world=len(devices), devices=devices,
                              backend=pdist.backend_for(devices),
                              spawn_seconds=spawn_s)
    for when, (_, metrics, ms, states, grads) in runs.items():
        rows = []
        for i, (stop, one) in enumerate(states):
            equal = all(r["LowRank"][when]["digests"][i]
                        == r0[when]["digests"][i] for r in ranks)
            two = r0[when]["states"][i][1]
            err = max(float(np.abs(two[k] - v).max()) for k, v in one.items()
                      if k != "density_bitfield")
            rows.append(dict(steps=stop, ranks_bitwise_equal=equal,
                             max_abs_err=err))
            if not equal:
                failed.append(f"{when} at {stop}: the ranks differ")
        fields[when] = dict(checkpoints=rows, one_rank_ms_per_step=ms,
                            ranks_ms_per_step=r0[when]["ms_per_step"])
        if grads is not None:
            rel = {k: float(np.linalg.norm(r0[when]["grads"][k] - g)
                            / max(np.linalg.norm(g), 1e-30))
                   for k, g in grads.items()}
            fields[when]["first_step_grad_rel_err_max"] = max(rel.values())
            failed += [f"first step: {k} off by {v}" for k, v in rel.items()
                       if not v <= cs.DP_GRAD_TOL]
    r1 = ranks[1]["LowRank"]
    budget = r1["n_global"] * r1["s_flat"]
    fields["late"]["steps_cut_in_rank0"] = sum(
        1 for before, _ in r1["cuts"] if before > budget)
    errs = r0["render_err"]
    fields["render"] = dict(max_abs_err=errs, sharded_ms=r0["sharded_ms"],
                            whole_ms=r0["whole_ms"])
    if not (errs["rgb"] <= cs.DP_RGB_TOL and errs["opacity"] <= cs.DP_RGB_TOL
            and errs["depth"] <= cs.DP_DEPTH_TOL):
        failed.append(f"render_test_sharded against render_test: {errs}")
    return fields, failed


def cli_part(n, steps, device, devices):
    """Part 2: main with --num_gpus n and with one card, then eval the same
    two ways; returns its fields."""
    from mfnerf_tpu_torch import eval as teval
    from mfnerf_tpu_torch.opt import get_opts
    from mfnerf_tpu_torch.train import main as train_main
    from mfnerf_tpu_torch.utils.procedural import make_scene, write_nsvf_scene
    cwd, out = os.getcwd(), {}
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            scene = make_scene(n_train=cs.N_TRAIN_VIEWS,
                               n_test=cs.CLI_TEST_VIEWS, wh=cs.WH,
                               seed=cs.SEED)
            scene["K"] = scene["K"] * np.float32([[800 / cs.WH],
                                                  [800 / cs.WH], [1]])
            root = os.path.join("Synthetic_NeRF_proc", "Spheres")
            write_nsvf_scene(root, scene)
            base = ["--root_dir", root, *cs.CLI_ARGS, "--steps_per_epoch",
                    str(steps), "--downsample", str(cs.WH / 800),
                    "--no_save_test"]
            for label, extra in (("ranks", ["--num_gpus", str(n),
                                            "--exp_name", "ranks"]),
                                 ("one", ["--exp_name", "one"])):
                log = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(log):
                    metrics = train_main(get_opts(base + extra),
                                         device=device, devices=devices
                                         if label == "ranks" else None)
                out[label] = dict(metrics, seconds=time.perf_counter() - t0)
            ckpt = os.path.join("ckpts", "nsvf", "ranks", "epoch=0.ckpt.npz")
            served = base + ["--exp_name", "ranks", "--ckpt_path", ckpt]
            for label, extra in (("eval_ranks", ["--num_gpus", str(n)]),
                                 ("eval_one", [])):
                with contextlib.redirect_stdout(io.StringIO()):
                    res = teval.main(served + extra, device=device,
                                     devices=devices if extra else None)
                out[label] = dict(mean_psnr=res["mean_psnr"],
                                  ms=res["ms"], mean_fps=res["mean_fps"])
        finally:
            os.chdir(cwd)
    return out


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--cards", type=int, default=None,
                        help="ranks, one a card (default: every card)")
    parser.add_argument("--steps", type=int, default=600,
                        help="the command line's training steps")
    parser.add_argument("--cpu", action="store_true",
                        help="gloo ranks on the CPU (a rehearsal)")
    args = parser.parse_args()
    from mfnerf_tpu_torch import build
    from mfnerf_tpu_torch.datasets.memory import MemoryDataset
    from mfnerf_tpu_torch.device import no_tf32
    from mfnerf_tpu_torch.utils.procedural import make_scene
    no_tf32()
    if args.cpu:
        n = args.cards or 4
        devices, device = ["cpu"] * n, "cpu"
    else:
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 1
        n = args.cards or torch.cuda.device_count()
        devices = [f"cuda:{i}" for i in range(n)]
        device = None                # the command line's default: the card
        for lib in ("hatmul", "hashgrid"):
            build.load_library(lib)
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True).stdout.strip(), flush=True)
    scene = make_scene(n_train=cs.N_TRAIN_VIEWS, n_test=1, wh=cs.WH,
                       seed=cs.SEED)
    datasets = (MemoryDataset.from_scene(scene, "train"),
                MemoryDataset.from_scene(scene, "test"))
    fields, failed = dp_part(devices, datasets)
    print(json.dumps({"part": "dp", **fields}), flush=True)
    cli = cli_part(n, args.steps, "cpu" if args.cpu else device,
                   devices if args.cpu else None)
    print(json.dumps({"part": "cli", "cards": n, **cli}), flush=True)
    for what in failed:
        print(f"FAILED: {what}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
