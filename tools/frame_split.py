"""Where a served frame's time goes on the card, an earlier tree beside
this one.

    python3 tools/frame_split.py --parent-tree _parent [--steps 900] \
        [--frames 5] [--fields bench,mf,cascades]

Builds ``chip_smoke.py``'s served fields in this tree: the bench
configuration (BENCH_HP) and the MixedFeature one (MF_HP) on its 16
procedural 800x800 views, each trained ``--steps`` steps through
``NeRFSystem.fit``, with their held-out view; and phase 20's five-cascade
frame (LR360_ARGS's untrained field on the COLMAP scene, written to a
temporary directory, culled with one dense refresh, its first test view
whole). Then serves the frames (the bench view at T 1e-2 and 1e-4, the
MixedFeature view and the five-cascade view at T 1e-4) with the tree at
``--parent-tree`` (an earlier commit unpacked under a gitignored
directory such as ``_parent/``) and with this tree in turns (parent,
this, this, parent), each in a process of its own that imports its tree's
package. Per frame and run: two warm-up frames (this tree's first captures
its CUDA graphs), ``--frames`` synced frames on the host clock, then
PROFILED frames under ``torch.profiler``: ms a frame, the device's busy ms
(its kernels', copies' and sets' durations summed), its idle share of the
window, device activities, the host's launch calls (kernel and graph
launches, copies and sets the CUDA runtime records), its synchronisations
(cudaStreamSynchronize: the host reads), the serving loop's own count of
host reads where the tree keeps one, and the top device operations; and
rgb, opacity and depth bit for bit against the same tree's first run and
within 1e-5 max abs of the parent's but on threshold ties
(``chip_smoke.frame_gap``). Prints one JSON line a run and a
summary, with the card's name and power limit; exits non-zero without a
CUDA device or where the frames disagree so.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROFILED = 3                  # frames a run's profile covers
SYNC_CALLS = ("cudaStreamSynchronize",)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")


def build_fields(steps, names, dev):
    """{frame name: the served field's state}: the trained bench and
    MixedFeature views (T 1e-2 and 1e-4 for bench) and the five-cascade
    view."""
    import dataclasses
    sys.path.insert(0, ROOT)
    import chip_smoke
    from mfnerf_tpu_torch.datasets.memory import MemoryDataset
    from mfnerf_tpu_torch.datasets.ray_utils import get_rays
    from mfnerf_tpu_torch.opt import get_opts
    from mfnerf_tpu_torch.utils.procedural import make_scene

    def state(model, occ, rays, rcfg, gt):
        return dict(cfg=dataclasses.asdict(model.cfg),
                    rcfg=dataclasses.asdict(rcfg),
                    state={k: v.cpu() for k, v in model.state_dict().items()},
                    bits=occ.density_bitfield.cpu(),
                    rays=tuple(r.cpu() for r in rays), gt=gt.cpu())

    fields = {}
    if {"bench", "mf"} & set(names):
        scene = make_scene(n_train=chip_smoke.N_TRAIN_VIEWS, n_test=1,
                           wh=chip_smoke.WH, seed=chip_smoke.SEED)
        datasets = (MemoryDataset.from_scene(scene, "train"),
                    MemoryDataset.from_scene(scene, "test"))
        for name, hp in (("bench", chip_smoke.BENCH_HP),
                         ("mf", chip_smoke.MF_HP)):
            if name not in names:
                continue
            system = chip_smoke.start_system(hp, datasets, dev)
            system.fit(steps)
            rays, gt, rcfg = chip_smoke.held_out_view(system)
            thresholds = (1e-2, 1e-4) if name == "bench" else (1e-4,)
            for thr in thresholds:
                fields[f"{name}_T{thr:g}"] = state(
                    system.model, system.occ, rays,
                    dataclasses.replace(rcfg, T_threshold=thr), gt)
            del system
            torch.cuda.empty_cache()
    if "cascades" in names:
        with tempfile.TemporaryDirectory() as tmp:
            train_v, test_v = chip_smoke.colmap_views(
                os.path.join(tmp, chip_smoke.COLMAP_ROOT))[:2]
        hp = vars(get_opts(["--root_dir", "", *chip_smoke.LR360_ARGS]))
        system = chip_smoke.start_system(hp, (train_v, test_v), dev)
        occ = chip_smoke.culled_state(system, chip_smoke.SEED + 40)
        ds = system.test_dataset
        rays = get_rays(torch.from_numpy(ds.directions).to(dev),
                        torch.from_numpy(ds.poses[0]).to(dev))
        rcfg = dataclasses.replace(system.rcfg,
                                   T_threshold=chip_smoke.TEST_T)
        fields["cascades_T0.0001"] = state(system.model, occ, rays, rcfg,
                                           torch.from_numpy(ds[0]["rgb"]))
        del system, occ
        torch.cuda.empty_cache()
    return fields


def serve(state_path, tree, out, n_frames):
    """One run: every frame of ``state_path`` served by ``tree``'s
    package (this process imports nothing else of a tree). Prints one
    JSON line."""
    import dataclasses
    sys.path.insert(0, tree)
    import mfnerf_tpu_torch
    from mfnerf_tpu_torch.device import no_tf32
    from mfnerf_tpu_torch.models import rendering
    from mfnerf_tpu_torch.models.ngp import NGP, NGPConfig, OccupancyState
    from mfnerf_tpu_torch.utils.metrics import psnr
    from torch.profiler import ProfilerActivity, profile
    no_tf32()
    assert os.path.dirname(os.path.dirname(os.path.abspath(
        mfnerf_tpu_torch.__file__))) == tree
    dev = torch.device("cuda")
    result, frames = {"tree": "this" if tree == ROOT else "parent"}, {}
    for name, saved in torch.load(state_path).items():
        cfg = NGPConfig(**saved["cfg"])
        model = NGP(cfg, device=dev)
        model.load_state_dict(saved["state"])
        occ = dataclasses.replace(OccupancyState.create(cfg, dev),
                                  density_bitfield=saved["bits"].to(dev)
                                  ).refresh_coarse(cfg)
        rcfg = rendering.RenderConfig(**saved["rcfg"])
        ro, rd = (r.to(dev).contiguous() for r in saved["rays"])

        def frame():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = rendering.render_test(model, occ, ro, rd, rcfg)
            torch.cuda.synchronize()
            return res, (time.perf_counter() - t0) * 1e3

        frame()
        first, _ = frame()
        ms = [frame()[1] for _ in range(n_frames)]
        reads = getattr(rendering.render_test, "host_reads", None)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILED):
                rendering.render_test(model, occ, ro, rd, rcfg)
            torch.cuda.synchronize()
            span_ms = (time.perf_counter() - t0) * 1e3
        if reads is not None:
            reads = (rendering.render_test.host_reads - reads) / PROFILED
        events = prof.events()
        device = [e for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3

        def calls(names):
            return sum(1 for e in events if e.name in names) / PROFILED

        top = sorted(prof.key_averages(),
                     key=lambda e: -getattr(e, "device_time_total", 0.0))
        frames[name] = {k: first[k].cpu() for k in ("rgb", "opacity",
                                                    "depth")}
        result[name] = dict(
            rounds=first["rounds"], samples=int(first["total_samples"]),
            psnr=float(psnr(first["rgb"], saved["gt"].to(dev))),
            ms=ms, ms_median=float(np.median(ms)),
            profiled_ms=span_ms / PROFILED,
            device_busy_ms=busy_ms / PROFILED,
            device_idle_share=1 - busy_ms / span_ms if device else None,
            device_activities=len(device) / PROFILED,
            host_launch_calls=calls(LAUNCH_CALLS),
            graph_launches=calls(("cudaGraphLaunch",)),
            host_syncs=calls(SYNC_CALLS), host_reads=reads,
            top_device_ms=[
                (e.key[:80], getattr(e, "device_time_total", 0.0) / 1e3
                 / PROFILED) for e in top[:10]])
        del model, occ
        torch.cuda.empty_cache()
    torch.save(frames, out)
    print(json.dumps(result), flush=True)
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent-tree")
    ap.add_argument("--steps", type=int, default=900)
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--fields", default="bench,mf,cascades")
    ap.add_argument("--serve")
    ap.add_argument("--tree")
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("frame_split: no CUDA device", file=sys.stderr)
        return 1
    if args.serve:
        return serve(args.serve, os.path.abspath(args.tree), args.out,
                     args.frames)
    if not args.parent_tree:
        ap.error("--parent-tree is needed")
    sys.path.insert(0, ROOT)
    from mfnerf_tpu_torch.device import no_tf32
    no_tf32()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    import math
    import chip_smoke
    fields = build_fields(args.steps, args.fields.split(","),
                          torch.device("cuda"))
    # each frame's threshold and far bound, for frame_gap
    bounds = {name: (f["rcfg"]["T_threshold"],
                     2 * math.sqrt(3) * f["cfg"]["scale"] + 1.0)
              for name, f in fields.items()}
    trees = {"parent": os.path.abspath(args.parent_tree), "this": ROOT}
    runs, firsts, ok = [], {}, True
    with tempfile.TemporaryDirectory() as tmp:
        state = os.path.join(tmp, "state.pt")
        torch.save(fields, state)
        del fields
        torch.cuda.empty_cache()
        for i, label in enumerate(("parent", "this", "this", "parent")):
            out = os.path.join(tmp, f"frames_{i}.pt")
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--serve", state,
                 "--tree", trees[label], "--out", out, "--frames",
                 str(args.frames)], capture_output=True, text=True,
                timeout=1200)
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return proc.returncode
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            for name, frame in torch.load(out).items():
                mine = firsts.setdefault((label, name), frame)
                res[name]["bit_equal_to_first"] = all(
                    torch.equal(frame[k].view(torch.int32),
                                mine[k].view(torch.int32)) for k in frame)
                parent = firsts.get(("parent", name))
                gap = None if parent is None else chip_smoke.frame_gap(
                    frame, parent, *bounds[name])
                res[name]["vs_parent"] = gap
                ok &= res[name]["bit_equal_to_first"] and (
                    gap is None or (max(gap["max_abs"].values())
                                    <= chip_smoke.SERVE_AB_TOL
                                    and not gap["untied"]))
            runs.append(res)
            print(json.dumps({"frame_split": label, "run": i,
                              "trained_steps": args.steps, **res,
                              "card": card}), flush=True)
    names = [k for k in runs[0] if k != "tree"]
    keys = ("ms_median", "profiled_ms", "device_busy_ms",
            "device_idle_share", "host_launch_calls", "graph_launches",
            "host_syncs", "device_activities", "rounds", "psnr")
    print(json.dumps({"frame_split": "summary", "agree": ok, **{
        label: {name: {key: [r[name][key] for r in runs
                             if r["tree"] == label] for key in keys}
                for name in names}
        for label in ("parent", "this")}, "card": card}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
