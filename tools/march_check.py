"""Check and time the march kernels alone on the card.

    python3 tools/march_check.py [--views 4] [--ptxas] [--train-ab STEPS] \
        [--frame-ab STEPS] [--march-ab STEPS] [--parent-tree DIR] \
        [--lanes-sweep] [--share-sweep S1,S2,..]

Builds ``mfnerf_tpu_torch/csrc/raymarch.cu``, then runs ``chip_smoke.py``'s
march checks (each kernel against its plain version on the card, bit for
bit; the window march in place, as the serving loop runs it) on the
untrained bench.py LowRank field of the procedural scene (culled, one
dense refresh): one training step's march (the two-level strata), the
degenerate rays, an empty and a full bitfield, the dense oracle's rank
windows, the training kernel's edge sets with gradients
(``chip_smoke.march_train_edge_sets``), every window march of one
render_test frame (the stage-A skip)
and the window edge sets, each window set also against the skip model;
then on a synthetic five-cascade scene (scale 8, exponential steps) with
the cascade march's union grid (the window walks every rung there). Times
the step's march and the frame's windows by CUDA-graph replay beside their
plain versions and bounds, and every window of the untrained frame with
the stage-A skip and without it.
``--train-ab STEPS`` then trains ``chip_smoke.py``'s bench configuration
(BENCH_HP on its 16 views) STEPS steps three times from the same seed:
through the kernels, through the plain marches (the rendering module's
marches swapped for their plain versions), and through the kernels again;
and prints the first step whose loss differs from the first run's, whether
the parameters and the bitfield end bit for bit equal, and each run's
held-out view PSNR (render_test at T 1e-4).

``--frame-ab STEPS`` trains the bench configuration STEPS steps in this
tree and keeps the field, its occupancy and the held-out 800x800 view, and
builds a five-cascade field (scale 8, exponential steps, seeded random
LowRank weights, a bitfield of a few balls) and a ring of FIVE_RAYS
camera rays at it; then serves both at T 1e-2 with the tree at
``--parent-tree`` (an earlier commit unpacked under a gitignored
directory such as ``_parent/``) and with this tree in turns (parent,
this, this, parent), each in a process of its own that imports its
tree's package. Per tree and field: the frame's synced ms (AB_FRAMES
frames after a warm-up), whether rgb, opacity and depth are bit for bit
the first run's, and every round's march as that tree's serving loop
runs it, timed by CUDA-graph replay on the rounds' inputs (captured once
in this tree: each round's alive rows and cursors): the parent's gathers
of the alive rows, its kernel and its cursor scatter, or this tree's
in-place kernel (each with the field's gather of rays_d, as both loops
take it; each replay restores the frame's cursor first, and that
restore's time is taken off); each kernel alone on the gathered rows too
(this tree's in place on them, in order); their sums.

``--share-sweep S1,S2,..`` trains the bench configuration to each of the
listed step counts in turn and at each serves the held-out view at T 1e-2
(culled, as the trainer's first step leaves it, at step 0), timing every
round in place with the loop's stage-A skip and with every rung walked:
the occupied share of the stage-A grid against the two sums, from which
``ray_march.SKIP_MAX_SHARE`` is set.

``--march-ab STEPS`` trains the bench and the MixedFeature
configurations STEPS steps, takes one step's training march of each and
of the synthetic five-cascade scene at 1,024 rays, and prints each set's
per-ray pass distribution (march_passes: a warp's stage-A passes, the
chosen strata, the rung passes of 32 rungs up to the cap or the exit;
mean, p99, max); with
``--parent-tree``, it then times march_train on the same sets with the
parent's tree and this tree in turns (parent, this, this, parent), each
in a process of its own, by CUDA-graph replay, every run's outputs held
bit for bit to the first; ``--trees A,B`` times more trees (variants of
this one unpacked beside it) in the same turns (parent, this, A, B, B, A,
this, parent), labelled by their directories' names.
With ``--parent-tree``, ``--train-ab`` also trains the bench configuration
through the kernels with the parent's tree (a process of its own) and
holds its parameters and bitfield to this tree's, bit for bit, beside its
held-out view's PSNR.

``--lanes-sweep`` times a few rounds of each frame at each lane count (4 to
32, ``ray_march.window_lanes`` replaced) with and without the skip, beside
the wrapper's choice. ``--ptxas`` first prints what ptxas said of each
kernel in the build (``build.ptxas_report``: registers, spills, shared
memory). Prints one JSON line a set (the frame's windows in one); exits
non-zero on a mismatch or without a CUDA device.
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

AB_FRAMES = 20          # synced frames a --frame-ab run, after a warm-up
FIVE_RAYS = 999         # the five-cascade frame's rays (as phase 20's)


def cascade_sets(dev, seed, n_rays=8192, s_strata=(8, 4)):
    """A synthetic --scale 8 scene: a sparse random bitfield at five
    cascades, its union grid, camera rays from a ring at 1.5 x scale, the
    cascade strata of RenderConfig(exp_step_factor=1/256) at each budget
    of ``s_strata``, and the exact march; and two window
    sets in place (march_rays_window_into's args: the rays that hit the box
    alive, mid-ladder cursors; no skip at five cascades)."""
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
    ro, rd = ring_rays(rng, n_rays, scale, dev)
    rcfg = RenderConfig(exp_step_factor=e, s_max_train=64)
    hits = _clamp_near(ray_aabb_intersect_single(
        ro, rd, torch.zeros(3), torch.full((3,), scale)))
    noise = torch.from_numpy(rng.random(n_rays, dtype=np.float32)).to(dev)
    args = (ro, rd, hits, bits, cascades, scale, e, g, rcfg.max_samples,
            noise, rcfg.n_rungs(scale, g), rcfg.s_max_train)
    sets = [(f"cascades_s{s}", args, dict(strata=Strata(
        union, stratum, s, 1.0, union=True))) for s in s_strata]
    sets.append(("cascades_exact", args, {}))
    dt_scale = rcfg._dt_scale(scale, True)
    cursor = torch.from_numpy(rng.integers(0, 400, n_rays)).to(dev)
    alive = torch.nonzero(hits[:, 0] >= 0).squeeze(1)
    window = [((ro, rd, hits[:, 0].contiguous(), hits[:, 1].contiguous(),
                cursor, alive, bits, cascades, scale, e, g, rcfg.max_samples,
                w, cap, dt_scale), {}) for w, cap in ((64, 8), (200, 64))]
    return sets, window


def ring_rays(rng, n, scale, dev):
    """Camera rays from a ring at 1.5 x scale towards the centre, jittered
    (unit directions)."""
    ang = rng.uniform(0, 2 * np.pi, n)
    o = np.stack([np.cos(ang), np.sin(ang), np.zeros(n)], 1) * 1.5 * scale
    d = -o / np.linalg.norm(o, axis=1, keepdims=True) \
        + rng.normal(scale=0.3, size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.from_numpy(o.astype(np.float32)).to(dev),
            torch.from_numpy(d.astype(np.float32)).to(dev))


def five_cascade_field(dev, seed):
    """The five-cascade field of --frame-ab: the LowRank model at scale 8
    (five cascades, grid 128) with seeded random weights, a bitfield of
    the cells of every cascade inside a few random balls about the centre,
    FIVE_RAYS ring rays, and the cascade render config (exp_step_factor
    1/256) at T 1e-2."""
    import dataclasses
    from mfnerf_tpu_torch.models.ngp import NGP, NGPConfig, OccupancyState
    from mfnerf_tpu_torch.models.rendering import RenderConfig
    from mfnerf_tpu_torch.ops.morton import morton3d
    cfg = NGPConfig(scale=8.0)
    model = NGP(cfg, torch.Generator().manual_seed(seed), device=dev)
    rng = np.random.default_rng(seed)
    g = cfg.grid_size
    centres = rng.uniform(-2.0, 2.0, (4, 3))
    radii = rng.uniform(0.5, 1.5, 4)
    ijk = torch.stack(torch.meshgrid(*[torch.arange(g, device=dev)] * 3,
                                     indexing="ij"), -1).reshape(-1, 3)
    codes = morton3d(ijk.to(torch.int32)).to(torch.int64)
    cells = torch.zeros(cfg.cascades * g ** 3, dtype=torch.bool, device=dev)
    c = torch.from_numpy(centres.astype(np.float32)).to(dev)
    r = torch.from_numpy(radii.astype(np.float32)).to(dev)
    for m in range(cfg.cascades):
        half = min(2.0 ** (m - 1), cfg.scale)
        x = (ijk.to(torch.float32) + 0.5) / g * 2 * half - half
        inside = (torch.cdist(x, c) < r).any(1)
        cells[m * g ** 3 + codes] = inside
    bits = torch.from_numpy(np.packbits(cells.cpu().numpy(),
                                        bitorder="little")).to(dev)
    occ = dataclasses.replace(OccupancyState.create(cfg, dev),
                              density_bitfield=bits).refresh_coarse(cfg)
    rays = ring_rays(rng, FIVE_RAYS, cfg.scale, dev)
    rcfg = RenderConfig(exp_step_factor=1.0 / 256, T_threshold=1e-2)
    return model, occ, rays, rcfg


def march_passes(args, kw):
    """Each ray's passes in the training march of march_rays_train's
    ``args`` and ``kw``, from the plain version's own tensors: stage-A
    passes of a warp (a lane a stratum: ceil(n_strata / 32)), the chosen
    strata (``_take_budget``), and the rung passes of 32 list positions
    walked up to the cap, the exit or the list's end. Returns {name: (N,)
    tensor} over the rays that hit the box."""
    from mfnerf_tpu_torch.ops.ray_march import (
        _jittered_start, _live_twolevel, _live_union, _occupancy_at,
        _take_budget)
    from mfnerf_tpu_torch.ops.stepping import calc_dt, t_ladder
    ro, rd, hits, bits, cascades, scale, e, grid, max_samples, noise, \
        n_rungs, s_max = args
    strata = kw.get("strata")
    rank_start = kw.get("rank_start", 0)
    dt_scale = kw.get("dt_scale", scale)
    ladder = (e, max_samples, grid, dt_scale)
    dev, n = ro.device, ro.shape[0]
    t2 = hits[:, 1]
    valid = hits[:, 0] >= 0
    t0 = _jittered_start(hits, noise, *ladder)
    ks = torch.arange(n_rungs, device=dev)
    ts = t_ladder(t0, ks, *ladder)
    past = ~(ts < t2[:, None])
    xyz = ro[:, None, :] + ts[..., None] * rd[:, None, :]
    occ = _occupancy_at(xyz, calc_dt(ts, *ladder), bits, cascades, scale,
                        grid) & ~past
    out = {}
    if strata is None:
        rung = ks.expand(n, n_rungs)
        list_len = torch.where(valid, n_rungs, 0)
        out["stage_a_passes"] = torch.zeros_like(list_len)
    else:
        if strata.union:
            live = _live_union(ro, rd, t0, t2, strata, scale, e,
                               max_samples, grid, n_rungs, dt_scale)
        else:
            live = _live_twolevel(ro, rd, t0, t2, strata, scale,
                                  max_samples, grid, n_rungs)
        chosen = _take_budget(live & valid[:, None], strata.s_strata)
        n_strata, st = chosen.shape[1], strata.stratum
        order = torch.sort(torch.where(
            chosen, torch.arange(n_strata, device=dev), n_strata),
            dim=1).values[:, :min(n_strata, strata.s_strata)]
        pos = torch.arange(order.shape[1] * st, device=dev)
        rung = order[:, pos // st] * st + pos % st
        out["chosen_strata"] = chosen.sum(1)
        list_len = out["chosen_strata"] * st
        out["stage_a_passes"] = torch.where(
            valid, -(-n_strata // 32), 0)
    width = rung.shape[1]
    n_sub = -(-width // 32)
    pad = n_sub * 32 - width
    pos = torch.arange(n_sub * 32, device=dev)
    rung = torch.nn.functional.pad(rung, (0, pad), value=n_rungs)
    exists = (pos[None, :] < list_len[:, None]) & (rung < n_rungs)
    r = rung.clamp_max(n_rungs - 1)
    occ_l = occ.gather(1, r) & exists
    past_l = past.gather(1, r) & exists
    per = occ_l.view(n, n_sub, 32).sum(2)
    before = torch.cumsum(per, 1) - per
    past_before = torch.cumsum(past_l.view(n, n_sub, 32).any(2).int(), 1) \
        - past_l.view(n, n_sub, 32).any(2).int()
    cap = min(max_samples, rank_start + s_max)
    b = torch.arange(n_sub, device=dev)
    stop = (b[None, :] * 32 >= list_len[:, None]) | (before >= cap) \
        | (past_before > 0)
    walked = torch.where(stop.any(1), stop.int().argmax(1), n_sub)
    out["rung_passes"] = walked
    return {k: v[valid] for k, v in out.items()}


def pass_stats(passes):
    """Mean, p99 and max of each of march_passes' per-ray counts."""
    return {k: dict(mean=float(v.float().mean()) if v.numel() else 0.0,
                    p99=float(torch.quantile(v.float(), 0.99))
                    if v.numel() else 0.0,
                    max=int(v.max()) if v.numel() else 0)
            for k, v in passes.items()}


def trained_march_sets(steps, dev, card):
    """One training step's march of the bench and the MixedFeature
    configurations after ``steps`` steps, and of the synthetic five-cascade
    scene at 1,024 rays: [(label, args, kwargs)]."""
    import chip_smoke
    from mfnerf_tpu_torch.datasets.memory import MemoryDataset
    from mfnerf_tpu_torch.utils.procedural import make_scene
    scene = make_scene(n_train=chip_smoke.N_TRAIN_VIEWS, n_test=1,
                       wh=chip_smoke.WH, seed=chip_smoke.SEED)
    datasets = (MemoryDataset.from_scene(scene, "train"),
                MemoryDataset.from_scene(scene, "test"))
    sets = []
    for label, hp, seed in (("bench", chip_smoke.BENCH_HP,
                             chip_smoke.SEED + 80),
                            ("mf", chip_smoke.MF_HP, chip_smoke.SEED + 82)):
        system = chip_smoke.start_system(hp, datasets, dev)
        system.fit(steps)
        args, kw = chip_smoke.step_march_operands(system, seed)
        sets.append((f"{label}_step", args, kw))
        del system
        torch.cuda.empty_cache()
    cascades, _ = cascade_sets(dev, chip_smoke.SEED + 81, n_rays=1024,
                               s_strata=(32,))
    sets.append(("cascades_step_1024", *cascades[0][1:]))
    return sets


def ab_trees(parent_tree, trees):
    """{label: tree} and the order of an A/B: the parent, this tree, each
    of ``trees`` (labelled by their directories' names), then the same
    back."""
    named = {"parent": os.path.abspath(parent_tree), "this": ROOT}
    named.update({os.path.basename(os.path.normpath(t)): os.path.abspath(t)
                  for t in trees})
    order = list(named)
    return named, order + order[::-1]


def march_ab(steps, parent_tree, dev, card, trees=()):
    """--march-ab: the pass distribution of each trained step's march,
    then, with ``parent_tree``, march_train on those steps with the
    parent's tree, this tree and ``trees`` in turns, each in a process of
    its own."""
    import tempfile
    sets = trained_march_sets(steps, dev, card)
    for label, args, kw in sets:
        passes = march_passes(args, kw)
        print(json.dumps({"march_passes": label, "trained_steps": steps,
                          "rays": int(args[0].shape[0]),
                          "rays_hitting": int(next(iter(
                              passes.values())).numel()),
                          **pass_stats(passes), "card": card}), flush=True)
    if parent_tree is None:
        return 0
    trees, order = ab_trees(parent_tree, trees)
    runs, firsts, equal = [], {}, True
    with tempfile.TemporaryDirectory() as tmp:
        state = os.path.join(tmp, "marches.pt")
        torch.save(sets, state)
        for i, label in enumerate(order):
            out = os.path.join(tmp, f"marches_{i}.pt")
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--time-marches",
                 state, "--tree", trees[label], "--out", out],
                capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return proc.returncode
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            for name, got in torch.load(out).items():
                first = firsts.setdefault(name, got)
                res[name]["bit_equal_to_first"] = all(
                    torch.equal(a.view(torch.int32) if a.dtype ==
                                torch.float32 else a,
                                b.view(torch.int32) if b.dtype ==
                                torch.float32 else b)
                    for a, b in zip(got, first))
                equal &= res[name]["bit_equal_to_first"]
            res["tree"] = label
            runs.append(res)
            print(json.dumps({"march_ab": label, "run": i, **res,
                              "card": card}), flush=True)
    print(json.dumps({"march_ab": "summary", "bit_equal": equal, **{
        label: {name: [r[name]["ms"] for r in runs if r["tree"] == label]
                for name, _, _ in sets}
        for label in trees}, "card": card}), flush=True)
    return 0 if equal else 1


def time_marches(state_path, tree, out, device="cuda"):
    """--time-marches: one run of --march-ab in the package of ``tree``:
    each set's march_train once (its outputs saved: ts, deltas, xyzs,
    mask, n_samples, t_start and k_idx on the valid slots) and by
    CUDA-graph replay. Prints one JSON line."""
    sys.path.insert(0, tree)
    import mfnerf_tpu_torch
    from mfnerf_tpu_torch.benchmarking import graph_ms
    from mfnerf_tpu_torch.device import no_tf32
    from mfnerf_tpu_torch.ops import ray_march
    no_tf32()
    assert os.path.dirname(os.path.dirname(os.path.abspath(
        mfnerf_tpu_torch.__file__))) == tree
    result, saved = {"tree": "this" if tree == ROOT else "parent"}, {}
    for label, args, kw in torch.load(state_path, weights_only=False):
        args = tuple(a.to(device) if torch.is_tensor(a) else a for a in args)
        mr = ray_march.march_rays_train(*args, **kw)
        saved[label] = [x.cpu() for x in (
            mr.ts, mr.deltas, mr.xyzs, mr.mask, mr.n_samples, mr.t_start,
            torch.where(mr.mask, mr.k_idx, -1))]
        result[label] = dict(ms=graph_ms(
            lambda: ray_march.march_rays_train(*args, **kw), 20),
            samples=int(mr.rm_samples))
    torch.save(saved, out)
    print(json.dumps(result), flush=True)
    return 0


def parent_training(steps, tree, out, device="cuda"):
    """--parent-train: the bench configuration trained ``steps`` steps
    through the kernels in the package of ``tree``: its parameters and
    bitfield saved, its held-out view's PSNR printed."""
    sys.path.insert(0, tree)
    import chip_smoke
    import mfnerf_tpu_torch
    from mfnerf_tpu_torch.datasets.memory import MemoryDataset
    from mfnerf_tpu_torch.device import no_tf32
    from mfnerf_tpu_torch.utils.metrics import psnr
    from mfnerf_tpu_torch.utils.procedural import make_scene
    no_tf32()
    assert os.path.dirname(os.path.dirname(os.path.abspath(
        mfnerf_tpu_torch.__file__))) == tree
    scene = make_scene(n_train=chip_smoke.N_TRAIN_VIEWS, n_test=1,
                       wh=chip_smoke.WH, seed=chip_smoke.SEED)
    datasets = (MemoryDataset.from_scene(scene, "train"),
                MemoryDataset.from_scene(scene, "test"))
    system = chip_smoke.start_system(chip_smoke.BENCH_HP, datasets,
                                     torch.device(device))
    system.fit(steps)
    rays, rgb, rcfg = chip_smoke.held_out_view(system)
    view, _ = chip_smoke.render_view(system, rays, rcfg)
    torch.save(dict(state={k: v.cpu() for k, v in
                           system.model.state_dict().items()},
                    bits=system.occ.density_bitfield.cpu()), out)
    print(json.dumps({"psnr": float(psnr(view["rgb"], rgb))}), flush=True)
    return 0


def plain_window_into(rays_o, rays_d, t_start, t2, cursor, alive, *rest,
                      skip=None):
    """march_rays_window_into through the plain version on any device."""
    from mfnerf_tpu_torch.ops.ray_march import march_rays_window_plain
    mr = march_rays_window_plain(rays_o[alive], rays_d[alive],
                                 t_start[alive], t2[alive], cursor[alive],
                                 *rest)
    cursor[alive] = mr.cursor
    return mr


def train_ab(steps, dev, card, parent_tree=None):
    """--train-ab: the bench configuration trained through the kernels,
    the plain marches and the kernels again, from the same seed; with
    ``parent_tree``, through the parent's kernels too (a process of its
    own). Returns 1 where a run's parameters differ from the first's."""
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
    kernels = (rendering.march_rays_train, rendering.march_rays_window_into)
    plain = (ray_march.march_rays_train_plain, plain_window_into)
    runs = {}
    for label, marches in (("kernel", kernels), ("plain", plain),
                           ("kernel_again", kernels)):
        rendering.march_rays_train, rendering.march_rays_window_into = \
            marches
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
    rendering.march_rays_train, rendering.march_rays_window_into = kernels
    first = runs["kernel"]
    status = 0
    for label in ("plain", "kernel_again"):
        run = runs[label]
        differ = torch.nonzero(run["loss"] != first["loss"])
        equal = all(torch.equal(v, first["state"][k])
                    for k, v in run["state"].items())
        status |= int(not equal)
        print(json.dumps({
            "train_ab": label, "against": "kernel", "steps": steps,
            "first_loss_step_differing": int(differ[0]) if len(differ)
            else None,
            "params_bit_equal": equal,
            "bitfield_equal": torch.equal(run["bits"], first["bits"]),
            "test_psnr": run["psnr"], "kernel_test_psnr": first["psnr"],
            "seconds": run["seconds"], "kernel_seconds": first["seconds"],
            "card": card}), flush=True)
    if parent_tree is None:
        return status
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "parent.pt")
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--parent-train",
             str(steps), "--tree", os.path.abspath(parent_tree), "--out",
             out], capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        parent = torch.load(out)
    equal = all(torch.equal(v.to(dev), first["state"][k])
                for k, v in parent["state"].items())
    print(json.dumps({
        "train_ab": "parent_tree", "against": "kernel", "steps": steps,
        "params_bit_equal": equal,
        "bitfield_equal": torch.equal(parent["bits"].to(dev), first["bits"]),
        "test_psnr": json.loads(proc.stdout.strip().splitlines()[-1])[
            "psnr"], "kernel_test_psnr": first["psnr"], "card": card}),
        flush=True)
    return status | int(not equal)


def captured_frame(model, occ, rays, rcfg):
    """One render_test frame's rounds as this tree's loop runs them: the
    frame's t_start and t2, and each round's alive rows, cursors before the
    round, window and s_cap (chip_smoke.capturing_marches)."""
    import chip_smoke
    from mfnerf_tpu_torch.models import rendering
    with torch.no_grad(), chip_smoke.capturing_marches() as captured:
        rendering.render_test(model, occ, *rays, rcfg, graphs=False)
    args = [c[1] for c in captured]
    n = rays[0].shape[0]      # the frame's rays (its arrays end in a sentinel)
    return dict(t_start=args[0][2][:n].cpu(), t2=args[0][3][:n].cpu(),
                rounds=[dict(alive=a[5].cpu(), cursor=a[4][:n].cpu(),
                             window=a[12], s_cap=a[13]) for a in args])


def field_state(model, occ, rays, rcfg):
    """A served field as --serve-frames loads it, with its captured
    rounds."""
    import dataclasses
    return dict(
        cfg=dataclasses.asdict(model.cfg), rcfg=dataclasses.asdict(rcfg),
        state={k: v.cpu() for k, v in model.state_dict().items()},
        bits=occ.density_bitfield.cpu(),
        rays=tuple(r.cpu() for r in rays),
        **captured_frame(model, occ, rays, rcfg))


def frame_ab(steps, parent_tree, dev, card, sweep=False):
    """--frame-ab: the trained bench frame and the five-cascade frame at T
    1e-2 served by the parent tree and this tree in turns, each in a
    process of its own."""
    import dataclasses
    import tempfile
    import chip_smoke
    from mfnerf_tpu_torch.datasets.memory import MemoryDataset
    from mfnerf_tpu_torch.utils.procedural import make_scene
    scene = make_scene(n_train=chip_smoke.N_TRAIN_VIEWS, n_test=1,
                       wh=chip_smoke.WH, seed=chip_smoke.SEED)
    datasets = (MemoryDataset.from_scene(scene, "train"),
                MemoryDataset.from_scene(scene, "test"))
    system = chip_smoke.start_system(chip_smoke.BENCH_HP, datasets, dev)
    system.fit(steps)
    rays, _, rcfg = chip_smoke.held_out_view(system)
    rcfg = dataclasses.replace(rcfg, T_threshold=1e-2)
    if sweep:
        windows = chip_smoke.frame_window_sets(system, rays, rcfg)
        lanes_sweep(windows, card, "bench_trained", rounds=range(11))
        skip_walk(windows, card, "bench_trained")
    fields = {"bench": field_state(system.model, system.occ, rays, rcfg),
              "cascades": field_state(*five_cascade_field(
                  dev, chip_smoke.SEED + 83))}
    del system
    torch.cuda.empty_cache()
    trees = {"parent": os.path.abspath(parent_tree), "this": ROOT}
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        state = os.path.join(tmp, "state.pt")
        torch.save(fields, state)
        firsts = {}
        for i, label in enumerate(("parent", "this", "this", "parent")):
            out = os.path.join(tmp, f"frame_{i}.pt")
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--serve-frames",
                 state, "--tree", trees[label], "--out", out],
                capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return proc.returncode
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            frames = torch.load(out)
            for name, frame in frames.items():
                first = firsts.setdefault(name, frame)
                res[name]["bit_equal_to_first"] = {
                    key: torch.equal(frame[key].view(torch.int32),
                                     first[key].view(torch.int32))
                    for key in ("rgb", "opacity", "depth")}
            runs.append(res)
            print(json.dumps({"frame_ab": label, "run": i,
                              "trained_steps": steps, "T_threshold": 1e-2,
                              **res, "card": card}), flush=True)
    equal = all(all(r[name]["bit_equal_to_first"].values())
                for r in runs for name in fields)
    print(json.dumps({"frame_ab": "summary", "bit_equal": equal, **{
        label: {name: {key: [r[name][key] for r in runs
                             if r["tree"] == label]
                       for key in ("ms_median", "window_ms_sum",
                                   "kernel_ms_sum", "rounds")}
                for name in fields}
        for label in ("parent", "this")}, "card": card}), flush=True)
    return 0 if equal else 1


def share_sweep(step_counts, dev, card):
    """--share-sweep: skip against walk (skip_walk) on the held-out frame
    at T 1e-2 as the bench field trains, at each step count."""
    import dataclasses
    import chip_smoke
    from mfnerf_tpu_torch.datasets.memory import MemoryDataset
    from mfnerf_tpu_torch.models.rendering import window_skip
    from mfnerf_tpu_torch.utils.procedural import make_scene
    scene = make_scene(n_train=chip_smoke.N_TRAIN_VIEWS, n_test=1,
                       wh=chip_smoke.WH, seed=chip_smoke.SEED)
    datasets = (MemoryDataset.from_scene(scene, "train"),
                MemoryDataset.from_scene(scene, "test"))
    system = chip_smoke.start_system(chip_smoke.BENCH_HP, datasets, dev)
    system.fit(0)
    for steps in step_counts:
        system.fit(steps - system.global_step)
        rays, _, rcfg = chip_smoke.held_out_view(system)
        rcfg = dataclasses.replace(rcfg, T_threshold=1e-2)
        windows = chip_smoke.frame_window_sets(system, rays, rcfg)
        for args, kw in windows:      # each round with the skip it may take
            kw["skip"] = window_skip(system.model_cfg, system.occ, rcfg)
        skip_walk(windows, card, f"bench_step_{steps}")
        del windows
        torch.cuda.empty_cache()


def serve_frames(state_path, tree, out, device="cuda"):
    """--serve-frames: one run of --frame-ab in the package of ``tree``
    (this process imports nothing else of a tree): per field, AB_FRAMES
    synced frames after a warm-up, then each captured round's march as the
    tree's loop runs it, timed by CUDA-graph replay. Prints one JSON
    line."""
    import dataclasses
    sys.path.insert(0, tree)
    import mfnerf_tpu_torch
    from mfnerf_tpu_torch.benchmarking import graph_ms
    from mfnerf_tpu_torch.device import no_tf32
    from mfnerf_tpu_torch.models import rendering
    from mfnerf_tpu_torch.models.ngp import NGP, NGPConfig, OccupancyState
    from mfnerf_tpu_torch.ops import ray_march
    no_tf32()
    assert os.path.dirname(os.path.dirname(os.path.abspath(
        mfnerf_tpu_torch.__file__))) == tree
    dev = torch.device(device)
    in_place = hasattr(ray_march, "march_rays_window_into")
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
        outs = [frame() for _ in range(AB_FRAMES)]
        frames[name] = {k: outs[0][0][k].cpu()
                        for k in ("rgb", "opacity", "depth")}
        t0, t2 = (saved[k].to(dev).contiguous() for k in ("t_start", "t2"))
        static = (occ.density_bitfield, cfg.cascades, cfg.scale,
                  rcfg.exp_step_factor, cfg.grid_size, rcfg.max_samples)
        dt_scale = rcfg._dt_scale(cfg.scale, True)
        skip = rendering.window_skip(cfg, occ, rcfg) if in_place else None
        march_ms, kernel_ms = [], []
        for rnd in saved["rounds"]:
            alive = rnd["alive"].to(dev)
            first = rnd["cursor"].to(dev)
            cursor = first.clone()
            tail = (rnd["window"], rnd["s_cap"], dt_scale)
            if in_place:
                def step():
                    cursor.copy_(first)
                    ray_march.march_rays_window_into(
                        ro, rd, t0, t2, cursor, alive, *static, *tail,
                        skip=skip)
                    rd[alive]
            else:
                def step():
                    cursor.copy_(first)
                    mr = ray_march.march_rays_window(
                        ro[alive], rd[alive], t0[alive], t2[alive],
                        cursor[alive], *static, *tail)
                    cursor[alive] = mr.cursor
            restore = graph_ms(lambda: cursor.copy_(first), 20)
            march_ms.append(graph_ms(step, 20) - restore)
            rows = tuple(x[alive] for x in (ro, rd, t0, t2, first))
            if in_place:
                # the kernel on the gathered rows, in order
                order = torch.arange(alive.shape[0], device=dev)
                cur = rows[4].clone()

                def gathered():
                    cur.copy_(rows[4])
                    ray_march.march_rays_window_into(
                        *rows[:4], cur, order, *static, *tail, skip=skip)
                kernel_ms.append(graph_ms(gathered, 20) - graph_ms(
                    lambda: cur.copy_(rows[4]), 20))
            else:
                kernel_ms.append(graph_ms(
                    lambda: ray_march.march_rays_window(*rows, *static,
                                                        *tail), 20))
        ms = [m for _, m in outs]
        result[name] = dict(
            ms=ms, ms_median=float(np.median(ms)), ms_mean=float(np.mean(ms)),
            rounds=outs[0][0]["rounds"], window_ms=march_ms,
            window_ms_sum=sum(march_ms), kernel_ms=kernel_ms,
            kernel_ms_sum=sum(kernel_ms))
        del model, occ
        torch.cuda.empty_cache()
    torch.save(frames, out)
    print(json.dumps(result), flush=True)
    return 0


def lanes_sweep(windows, card, label, rounds=(0, 3, 6)):
    """--lanes-sweep: a few window sets in place ((args, kwargs), as
    chip_smoke.frame_window_sets gives a frame's) at each lane count (the
    wrapper's window_lanes replaced), with and without the stage-A skip
    (chip_smoke.window_into_ms)."""
    import chip_smoke
    from mfnerf_tpu_torch.ops import ray_march
    choose = ray_march.window_lanes
    for i in rounds:
        if i >= len(windows):
            break
        args, kw = windows[i]
        rows = chip_smoke.window_rows(args)
        p = ray_march.window_params(rows[7], rows[8], rows[9], rows[6],
                                    rows[10], rows[13], rows[11], rows[12],
                                    kw["skip"])
        res = {}
        try:
            for skip in (kw["skip"], None):
                for lanes in (4, 8, 16, 32):
                    ray_march.window_lanes = lambda *_, k=lanes: k
                    res[f"{'skip' if skip else 'rungs'}_{lanes}"] = \
                        chip_smoke.window_into_ms(args, dict(skip=skip))[0]
        finally:
            ray_march.window_lanes = choose
        print(json.dumps({"lanes_sweep": label, "round": i, "ms": res,
                          "rays": int(rows[0].shape[0]),
                          "n_window": rows[11], "s_cap": rows[12],
                          "chosen": choose(rows[0].shape[0], rows[11], p),
                          "card": card}), flush=True)


def skip_walk(windows, card, label):
    """Every window set of a frame in place (chip_smoke.window_into_ms) with
    the loop's stage-A skip and with every rung walked, each at the lanes
    the wrapper chooses; the sums."""
    import chip_smoke
    skip_ms, walk_ms = [], []
    for args, kw in windows:
        skip_ms.append(chip_smoke.window_into_ms(args, kw)[0])
        walk_ms.append(chip_smoke.window_into_ms(args, dict(skip=None))[0])
    share = None
    if windows and windows[0][1]["skip"] is not None:
        share = float(windows[0][1]["skip"].stage_a.float().mean())
    print(json.dumps({"skip_walk": label, "rounds": len(windows),
                      "stage_a_share": share, "skip_ms": skip_ms,
                      "walk_ms": walk_ms, "skip_ms_sum": sum(skip_ms),
                      "walk_ms_sum": sum(walk_ms), "card": card}),
          flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--train-ab", type=int, default=0)
    ap.add_argument("--frame-ab", type=int, default=0)
    ap.add_argument("--parent-tree", default=None)
    ap.add_argument("--lanes-sweep", action="store_true")
    ap.add_argument("--share-sweep", default=None)
    ap.add_argument("--march-ab", type=int, default=0)
    ap.add_argument("--trees", default="")
    ap.add_argument("--serve-frames", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--time-marches", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--parent-train", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--tree", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("march_check: no CUDA device", file=sys.stderr)
        return 1
    if args.serve_frames:
        return serve_frames(args.serve_frames, os.path.abspath(args.tree),
                            args.out)
    if args.time_marches:
        return time_marches(args.time_marches, os.path.abspath(args.tree),
                            args.out)
    if args.parent_train:
        return parent_training(args.parent_train,
                               os.path.abspath(args.tree), args.out)
    if args.frame_ab and not args.parent_tree:
        ap.error("--frame-ab needs --parent-tree")
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
    t0 = time.perf_counter()
    build.load_library("raymarch")
    print(json.dumps({"build_seconds": time.perf_counter() - t0}),
          flush=True)
    if args.ptxas:
        print(json.dumps({"ptxas": build.ptxas_report("raymarch")}),
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
    windows = chip_smoke.frame_window_sets(system, rays, test_rcfg)
    chip_smoke.march_phase(
        "bench_untrained", train_sets, windows,
        window_edges=chip_smoke.window_edge_sets(
            system.model, system.occ, test_rcfg, rays,
            chip_smoke.SEED + 82), time_rounds=True,
        train_edges=chip_smoke.march_train_edge_sets(system,
                                                     chip_smoke.SEED + 84))
    skip_walk(windows, card, "bench_untrained")
    if args.lanes_sweep:
        lanes_sweep(windows, card, "bench_untrained")
    del system, windows
    torch.cuda.empty_cache()
    train_sets, windows = cascade_sets(dev, chip_smoke.SEED + 81)
    chip_smoke.march_phase("cascades_synthetic", train_sets, windows)
    if args.share_sweep:
        share_sweep([int(x) for x in args.share_sweep.split(",")], dev,
                    card)
    status = 0
    if args.march_ab:
        status = march_ab(args.march_ab, args.parent_tree, dev, card,
                          [t for t in args.trees.split(",") if t])
    if args.train_ab:
        status |= train_ab(args.train_ab, dev, card, args.parent_tree)
    if args.frame_ab:
        status |= frame_ab(args.frame_ab, args.parent_tree, dev, card,
                           args.lanes_sweep)
    return status


if __name__ == "__main__":
    sys.exit(main())
