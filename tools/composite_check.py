"""Check and time the composite kernels alone on the card.

    python3 tools/composite_check.py [--views 4] [--ptxas] \
        [--train-ab STEPS] [--frame-ab STEPS] \
        [--fwd-ab STEPS --parent-tree DIR] [--bwd-ab STEPS --parent-tree DIR]

Builds ``mfnerf_tpu_torch/csrc/composite.cu``, then runs ``chip_smoke.py``'s
composite checks (each kernel against its plain version on the card: the
forward within COMPOSITE_FWD_TOL, the backward within COMPOSITE_BWD_TOL of
the plain backward and of autograd through the plain forward, each kernel
bit for bit across launches) on the untrained bench.py LowRank field of the
procedural scene (culled, one dense refresh): one training step's block,
the synthetic edge blocks, every round of one render_test frame and the
edge blocks as serving rounds. Times the step's forward and backward and
the frame's first round by CUDA-graph replay beside their plain versions
and bounds.

``--train-ab STEPS`` then trains ``chip_smoke.py``'s bench configuration
(BENCH_HP on its 16 views) STEPS steps three times from the same seed:
through the kernels, through the plain composite (the rendering module's
composite_train and composite_test_step_into swapped for their plain
versions), and through the kernels again; it prints each run's last-50-
step train PSNR, held-out view PSNR (render_test at T 1e-4), seconds, and
whether the two kernel runs end bit for bit equal.

``--frame-ab STEPS`` trains the bench configuration STEPS steps, then
serves its held-out 800x800 view at T 1e-2 in turns through the kernels
and through the plain composite (kernel, plain, plain, kernel, three
frames each after a warm-up): each frame's synced ms and, with CUDA events
around every compositing round (host gaps included), the rounds' share.

``--fwd-ab STEPS --parent-tree DIR`` trains the bench and the
MixedFeature configurations STEPS steps and takes one step's composite
operands of each, beside the edge blocks
(``chip_smoke.composite_edge_sets``); then runs composite_train_fwd on
every set with the tree at ``--parent-tree`` (an earlier commit unpacked
under a gitignored directory such as ``_parent/``) and with this tree in
turns (parent, this, this, parent), each in a process of its own: its
five outputs, held bit for bit to the first run's (the parent's), its
device time by CUDA-graph replay, and its kernels' registers and spills
(``build.ptxas_report``). ``--bwd-ab STEPS --parent-tree DIR``
does the same for composite_train_bwd, with the loss's incoming
gradients on the steps and seeded ones of all four outputs on the edge
blocks: its four gradients, and its time asking for d_sigmas and d_rgbs
(a training step's). With either, ``--trees A,B`` times more trees in the
same turns, as ``march_check.py --trees`` (variants cut to find where the
time goes: their outputs are reported against the parent's, and the exit
code holds only this tree to it).

``--ptxas`` first prints what ptxas said of each kernel in the build
(``build.ptxas_report``: registers, spills, shared memory). Prints one JSON
line a set (the frame's rounds in one) and the card's name and power limit;
exits non-zero on a mismatch or without a CUDA device.
"""
import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def plain_into(sigmas, rgbs, deltas, ts, mask, index, opacity, depth, rgb,
               T_threshold):
    """composite_test_step_into through the plain version on any device."""
    from mfnerf_tpu_torch.ops.composite import composite_test_step_plain
    op, de, co, alive = composite_test_step_plain(
        sigmas, rgbs, deltas, ts, mask, opacity[index], depth[index],
        rgb[index], torch.ones_like(mask[:, 0]), T_threshold)
    opacity[index], depth[index], rgb[index] = op, de, co
    return alive


@contextlib.contextmanager
def composites(plain):
    """The rendering module's composites: the plain versions with
    ``plain``, else as they are."""
    from mfnerf_tpu_torch.models import rendering
    from mfnerf_tpu_torch.ops.composite import composite_train_plain
    kept = rendering.composite_train, rendering.composite_test_step_into
    if plain:
        rendering.composite_train = composite_train_plain
        rendering.composite_test_step_into = plain_into
    try:
        yield
    finally:
        rendering.composite_train, rendering.composite_test_step_into = kept


def bench_datasets(views):
    import chip_smoke
    from mfnerf_tpu_torch.datasets.memory import MemoryDataset
    from mfnerf_tpu_torch.utils.procedural import make_scene
    scene = make_scene(n_train=views, n_test=1, wh=chip_smoke.WH,
                       seed=chip_smoke.SEED)
    return (MemoryDataset.from_scene(scene, "train"),
            MemoryDataset.from_scene(scene, "test"))


def train_ab(steps, dev, card):
    """--train-ab: the bench configuration through the kernels, the plain
    composite and the kernels again, from the same seed."""
    import chip_smoke
    from mfnerf_tpu_torch.utils.metrics import psnr
    datasets = bench_datasets(chip_smoke.N_TRAIN_VIEWS)
    runs = {}
    for label, plain in (("kernel", False), ("plain", True),
                         ("kernel_again", False)):
        with composites(plain):
            system = chip_smoke.start_system(chip_smoke.BENCH_HP, datasets,
                                             dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = system.fit(steps)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            rays, rgb, rcfg = chip_smoke.held_out_view(system)
            out, _ = chip_smoke.render_view(system, rays, rcfg)
        runs[label] = dict(
            loss=metrics["loss"], seconds=seconds,
            train_psnr=float(metrics["psnr"][-50:].mean()),
            state={k: v.detach().clone()
                   for k, v in system.model.state_dict().items()},
            psnr=float(psnr(out["rgb"], rgb)))
        del system, out
    first = runs["kernel"]
    for label, run in runs.items():
        print(json.dumps({
            "train_ab": label, "steps": steps,
            "train_psnr_last_50": run["train_psnr"],
            "test_psnr": run["psnr"], "seconds": run["seconds"],
            "ms_per_step": run["seconds"] * 1e3 / steps,
            "loss_last": float(run["loss"][-1]),
            "bit_equal_to_kernel": all(
                torch.equal(v, first["state"][k])
                for k, v in run["state"].items()),
            "card": card}), flush=True)


def frame_ab(steps, dev, card):
    """--frame-ab: a trained bench field's held-out frame at T 1e-2 through
    the kernels and through the plain composite, in turns."""
    import dataclasses
    import chip_smoke
    from mfnerf_tpu_torch.models import rendering
    datasets = bench_datasets(chip_smoke.N_TRAIN_VIEWS)
    system = chip_smoke.start_system(chip_smoke.BENCH_HP, datasets, dev)
    system.fit(steps)
    rays, _, rcfg = chip_smoke.held_out_view(system)
    rcfg = dataclasses.replace(rcfg, T_threshold=1e-2)
    res = {"kernel": [], "plain": []}
    for label in ("kernel", "plain", "plain", "kernel"):
        with composites(label == "plain"):
            chip_smoke.render_view(system, rays, rcfg)      # warm-up
            for _ in range(3):
                inner = rendering.composite_test_step_into
                pairs = []

                def timed_round(*args, inner=inner, pairs=pairs):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    out = inner(*args)
                    end.record()
                    pairs.append((start, end))
                    return out

                rendering.composite_test_step_into = timed_round
                try:
                    out, ms = chip_smoke.render_view(system, rays, rcfg)
                finally:
                    rendering.composite_test_step_into = inner
                rounds_ms = sum(s.elapsed_time(e) for s, e in pairs)
                res[label].append(dict(ms=ms, rounds=out["rounds"],
                                       composite_ms=rounds_ms))
    for label, frames in res.items():
        ms = [f["ms"] for f in frames]
        comp = [f["composite_ms"] for f in frames]
        print(json.dumps({
            "frame_ab": label, "trained_steps": steps, "wh": chip_smoke.WH,
            "T_threshold": 1e-2, "frames": len(frames),
            "ms_median": float(np.median(ms)), "ms": ms,
            "rounds": frames[0]["rounds"],
            "composite_ms_median": float(np.median(comp)),
            "composite_share": float(np.median(comp) / np.median(ms)),
            "card": card}), flush=True)


def ab_sets(steps, dev):
    """The A/B's operands: one step of the bench and the MixedFeature
    configurations after ``steps`` steps (the loss's incoming gradients)
    and the edge blocks (seeded incoming gradients of all four outputs), as
    [(label, (sigmas, rgbs, deltas, ts, mask), T_threshold, (g_opacity,
    g_depth, g_rgb, g_ws))]."""
    import chip_smoke
    datasets = bench_datasets(chip_smoke.N_TRAIN_VIEWS)
    sets = []
    for label, hp, seed in (("bench", chip_smoke.BENCH_HP,
                             chip_smoke.SEED + 90),
                            ("mf", chip_smoke.MF_HP, chip_smoke.SEED + 93)):
        system = chip_smoke.start_system(hp, datasets, dev)
        system.fit(steps)
        args, thr, grads = chip_smoke.step_composite_operands(system, seed)
        sets.append((f"{label}_step", args, thr, tuple(grads.get(k) for k in (
            "opacity", "depth", "rgb", "ws"))))
        del system
        torch.cuda.empty_cache()
    rng = np.random.default_rng(chip_smoke.SEED + 94)
    for label, args, thr in chip_smoke.composite_edge_sets(
            dev, chip_smoke.SEED + 91):
        n, s_ = args[0].shape
        sets.append((label, args, thr, tuple(
            torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                             ).to(dev)
            for shape in ((n,), (n,), (n, 3), (n, s_)))))
    return sets


def kernel_ab(kind, steps, parent_tree, dev, card, trees=()):
    """--fwd-ab / --bwd-ab: composite_train_fwd or composite_train_bwd
    (``kind`` "fwd" or "bwd") on the same operands with the parent's tree,
    this tree and ``trees`` in turns, each in a process of its own."""
    import tempfile
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from march_check import ab_trees
    sets = ab_sets(steps, dev)
    trees, order = ab_trees(parent_tree, trees)
    runs, firsts, equal = [], {}, True
    with tempfile.TemporaryDirectory() as tmp:
        state = os.path.join(tmp, "sets.pt")
        torch.save([(label, tuple(a.cpu() for a in args), thr,
                     tuple(None if g is None else g.cpu() for g in ups))
                    for label, args, thr, ups in sets], state)
        for i, label in enumerate(order):
            out = os.path.join(tmp, f"{kind}_{i}.pt")
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--time", kind,
                 "--sets", state, "--tree", trees[label], "--out", out],
                capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return proc.returncode
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            for name, got in torch.load(out).items():
                first = firsts.setdefault(name, got)
                res[name]["bit_equal_to_first"] = all(
                    torch.equal(a.view(torch.int32), b.view(torch.int32))
                    for a, b in zip(got, first))
                if label in ("parent", "this"):
                    equal &= res[name]["bit_equal_to_first"]
            res["tree"] = label
            runs.append(res)
            print(json.dumps({f"{kind}_ab": label, "run": i, "trained_steps":
                              steps, **res, "card": card}), flush=True)
    print(json.dumps({f"{kind}_ab": "summary", "bit_equal": equal, **{
        label: {name: [r[name]["ms"] for r in runs if r["tree"] == label]
                for name, _, _, _ in sets}
        for label in trees}, "card": card}), flush=True)
    return 0 if equal else 1


def time_kernel(kind, state_path, tree, out, device="cuda"):
    """--time: one run of --fwd-ab / --bwd-ab in the package of ``tree``:
    each set's outputs (saved) and its device time by CUDA-graph replay
    (the backward asking for d_sigmas and d_rgbs). Prints one JSON line."""
    sys.path.insert(0, tree)
    import mfnerf_tpu_torch
    from mfnerf_tpu_torch.benchmarking import graph_ms
    from mfnerf_tpu_torch.device import no_tf32
    from mfnerf_tpu_torch.ops import composite
    no_tf32()
    assert os.path.dirname(os.path.dirname(os.path.abspath(
        mfnerf_tpu_torch.__file__))) == tree
    result, saved = {"tree": "this" if tree == ROOT else "parent"}, {}
    for label, args, thr, ups in torch.load(state_path):
        args = tuple(a.to(device) for a in args)
        ups = tuple(None if g is None else g.to(device) for g in ups)
        if kind == "fwd":
            def call(args=args, thr=thr):
                return composite.composite_train_fwd(*args, thr)
            saved[label] = [x.cpu() for x in call()]
        else:
            saved[label] = [g.cpu() for g in composite.composite_train_bwd(
                *args, *ups, thr)]

            def call(args=args, ups=ups, thr=thr):
                return composite.composite_train_bwd(
                    *args, *ups, thr, needs=(True, True, False, False))
        result[label] = dict(rays=int(args[0].shape[0]),
                             s=int(args[0].shape[1]), ms=graph_ms(call, 20))
    from mfnerf_tpu_torch import build
    result["registers"] = build.ptxas_report(
        "composite", f"composite_train_{kind[:2]}_")
    torch.save(saved, out)
    print(json.dumps(result), flush=True)
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--train-ab", type=int, default=0)
    ap.add_argument("--frame-ab", type=int, default=0)
    ap.add_argument("--fwd-ab", type=int, default=0)
    ap.add_argument("--bwd-ab", type=int, default=0)
    ap.add_argument("--parent-tree", default=None)
    ap.add_argument("--trees", default="")
    ap.add_argument("--time", choices=("fwd", "bwd"), default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--sets", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--tree", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("composite_check: no CUDA device", file=sys.stderr)
        return 1
    if args.time:
        return time_kernel(args.time, args.sets, os.path.abspath(args.tree),
                           args.out)
    if (args.fwd_ab or args.bwd_ab) and not args.parent_tree:
        ap.error("--fwd-ab and --bwd-ab need --parent-tree")
    import chip_smoke
    from mfnerf_tpu_torch import build
    from mfnerf_tpu_torch.device import no_tf32
    no_tf32()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    build.load_library("composite")
    print(json.dumps({"build_seconds": time.perf_counter() - t0}),
          flush=True)
    if args.ptxas:
        print(json.dumps({"ptxas": build.ptxas_report("composite")}),
              flush=True)
    dev = torch.device("cuda", 0)
    system = chip_smoke.start_system(chip_smoke.BENCH_HP,
                                     bench_datasets(args.views), dev)
    system.occ = chip_smoke.culled_state(system, chip_smoke.SEED + 2)
    rays, _, test_rcfg = chip_smoke.held_out_view(system)
    chip_smoke.composite_phase(
        "bench_untrained",
        [("step", *chip_smoke.step_composite_operands(
            system, chip_smoke.SEED + 90))]
        + [(label, a, thr, None) for label, a, thr
           in chip_smoke.composite_edge_sets(dev, chip_smoke.SEED + 91)],
        chip_smoke.frame_round_sets(system, rays, test_rcfg))
    for label, a, thr in chip_smoke.composite_round_edge_sets(
            dev, chip_smoke.SEED + 92):
        chip_smoke.phase("composite", config="edges",
                         **chip_smoke.check_composite_round(label, a, thr))
    del system
    torch.cuda.empty_cache()
    if args.train_ab:
        train_ab(args.train_ab, dev, card)
    if args.frame_ab:
        frame_ab(args.frame_ab, dev, card)
    trees = [t for t in args.trees.split(",") if t]
    rc = 0
    for kind, steps in (("fwd", args.fwd_ab), ("bwd", args.bwd_ab)):
        if steps:
            rc = kernel_ab(kind, steps, args.parent_tree, dev, card,
                           trees) or rc
    return rc


if __name__ == "__main__":
    sys.exit(main())
