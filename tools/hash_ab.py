"""A/B of the hash-grid kernels on one NVIDIA GPU: this tree's forward and
backward against an earlier version of them, built from that version's
source.

    python3 tools/hash_ab.py --parent-src OLD/mfnerf_tpu_torch/csrc/hashgrid.cu

OLD is an unpacked earlier commit whose ``hashgrid_fwd`` and
``hashgrid_bwd`` have this tree's C signatures, with the earlier backward's
block shape (``--parent-geometry pr5``, the default: ``256 // L`` samples x
L levels a block, at most 1,056 blocks; ``warp``: this tree's
``bwd_grid``).
Both are called through their C entries with preallocated outputs and
scratch, on the operand sets of ``chip_smoke.py`` phase 12 (2^19 uniform
points for the Hash and the MixedFeature grid; the MixedFeature rays and
degenerate sets; the generic path, F 4 and L 12, at 2^16) and, after
``--steps`` steps of the MixedFeature configuration (phase 14), on one
real step's x and g (phase 12b). On each
set the change's output must equal the parent's bit for bit (forward) and
its d_params the parent's bit for bit (backward, exact and sampled at one
corner); then each kernel is timed in turns parent, change, change, parent
by CUDA-graph replay (``benchmarking.graph_ms``, ``--iters`` calls).
Then, on the trained system, chunks of ``--chunk`` training steps run with
the parent's kernels and with the change's in the same turns, timed on the
host clock (the two give the same bits, so the run trains the same either
way). Prints the card's name and power limit, what ptxas reports of the
change's kernels, one JSON line a measurement and a summary line; exits
non-zero on a mismatch or without a CUDA device.
"""
import argparse
import contextlib
import ctypes
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (the phases' helpers and configuration)
from mfnerf_tpu_torch import build  # noqa: E402
from mfnerf_tpu_torch.benchmarking import card_name, graph_ms  # noqa: E402
from mfnerf_tpu_torch.ops import hashgrid  # noqa: E402

ORDER = ("parent", "change", "change", "parent")


def load_parent(src):
    """(fwd, bwd) ctypes entries of the earlier kernels, compiled with this
    tree's nvcc flags into the build directory."""
    code = open(src, "rb").read()
    digest = hashlib.sha256(code).hexdigest()[:16]
    out = build.BUILD_DIR / f"libhashgrid-parent-{digest}.so"
    if not out.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                        src], check=True)
    lib = ctypes.CDLL(str(out))
    fwd, bwd = hashgrid._kernels()    # this tree's, for the argument types
    pf, pb = lib.hashgrid_fwd, lib.hashgrid_bwd
    counted = b"n_valid" in code      # a source with the valid count
    pf.argtypes, pb.argtypes = (
        (t.argtypes if counted else t.argtypes[:-2] + t.argtypes[-1:])
        for t in (fwd, bwd))
    pf.restype = pb.restype = ctypes.c_int
    pf.counted = pb.counted = counted
    return pf, pb


def pr5_grid(n, levels):
    """PR 5's backward block shape: (samples a block, blocks)."""
    spb = max(1, 256 // levels)
    return spb, max(1, min(-(-n // spb), 1056))


def warp_grid(n, _levels, bwd_grid=hashgrid.bwd_grid):
    """This tree's backward block shape (its own, while Swap routes the
    wrappers to a parent)."""
    return bwd_grid(n)


GRIDS = {"pr5": pr5_grid, "warp": warp_grid}


def launchers(cfg, params, x, g, noise, kernels, grid):
    """{kernel: fn} of one version on the operands, and the outputs they
    write: the forward, the exact backward and the sampled one (m = 1),
    through the C entries with preallocated outputs and scratch."""
    fwd, bwd = kernels
    n, dev = x.shape[0], x.device
    table = hashgrid.level_table(cfg).ctypes.data
    out = torch.empty((n, cfg.out_dim), dtype=torch.float32, device=dev)
    d_params = {m: torch.empty((cfg.n_params, cfg.F), dtype=torch.float32,
                               device=dev) for m in (0, 1)}
    acc = torch.empty((cfg.n_params, cfg.F), dtype=torch.int64, device=dev)
    sums = torch.empty((hashgrid.PREP_BLOCKS + 1,), dtype=torch.float64,
                       device=dev)
    spb, blocks = grid(n, cfg.L)

    # this tree's entries and a counted parent's take the valid count (none)
    count = [None] if getattr(fwd, "counted", True) else []

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def run_fwd():
        rc = fwd(params.data_ptr(), x.data_ptr(), None, out.data_ptr(), n,
                 cfg.L, cfg.F, table, *count, stream())
        assert rc == 0, rc

    def run_bwd(m):
        rc = bwd(params.data_ptr(), x.data_ptr(), g.data_ptr(), None,
                 noise.data_ptr() if m else None, m, d_params[m].data_ptr(),
                 acc.data_ptr(), sums.data_ptr(), None, None, None, n,
                 cfg.n_params, cfg.L, cfg.F, spb, blocks,
                 hashgrid.PREP_BLOCKS, table, *count, stream())
        assert rc == 0, rc

    return ({"fwd": run_fwd, "bwd": lambda: run_bwd(0),
             "bwd_sampled": lambda: run_bwd(1)},
            {"fwd": out, "bwd": d_params[0], "bwd_sampled": d_params[1]})


def ab(label, cfg, params, x, g, parent, parent_grid, iters, card,
       timing_only=False):
    """Check the change against the parent bit for bit on one operand set,
    then time each kernel in turns. Returns the rows; raises on a
    mismatch."""
    n = x.shape[0]
    noise = torch.rand((n, 1), generator=torch.Generator(
        device=x.device).manual_seed(chip_smoke.SEED + 40), device=x.device)
    versions = {
        "parent": launchers(cfg, params, x, g, noise, parent, parent_grid),
        "change": launchers(cfg, params, x, g, noise, hashgrid._kernels(),
                            warp_grid)}
    for fns, _ in versions.values():
        for fn in fns.values():
            fn()
    torch.cuda.synchronize()
    equal = {k: bool(torch.equal(versions["parent"][1][k],
                                 versions["change"][1][k]))
             for k in versions["change"][1]}
    distinct = chip_smoke.hash_distinct_rows(x, cfg)
    atomics, _, merged = chip_smoke.hash_atomics(x, cfg)
    bounds = {"fwd": chip_smoke.hash_fwd_bound(n, cfg, distinct),
              "bwd": chip_smoke.hash_bwd_bound(n, cfg, distinct, False)}
    bounds["bwd_sampled"] = bounds["bwd"]
    rows = []
    for kernel in ("fwd", "bwd", "bwd_sampled"):
        times = {"parent": [], "change": []}
        for version in ORDER:
            times[version].append(graph_ms(versions[version][0][kernel],
                                           iters))
        parent_ms, change_ms = (float(np.mean(times[v]))
                                for v in ("parent", "change"))
        bound_ms, bound_by = bounds[kernel]
        row = dict(shape=label, grid=cfg.grid_type, n=n, kernel=kernel,
                   bitwise_equal_to_parent=equal[kernel],
                   parent_ms=times["parent"], change_ms=times["change"],
                   speedup=parent_ms / change_ms, bound_ms=bound_ms,
                   bound_by=bound_by,
                   parent_share_of_bound=bound_ms / parent_ms,
                   change_share_of_bound=bound_ms / change_ms,
                   atomics_per_update=atomics, atomics_merged=merged,
                   card=card)
        print(json.dumps(row), flush=True)
        rows.append(row)
    if not all(equal.values()) and not timing_only:
        raise RuntimeError(f"{label} {cfg.grid_type}: change vs parent "
                           f"bitwise {equal}")
    return rows


@dataclasses.dataclass
class Swap:
    """Route ``ops.hashgrid``'s wrappers to the parent's kernels and their
    block shape while it is entered."""
    parent: tuple
    grid: object
    levels: int

    def __enter__(self):
        self.saved = hashgrid._kernels, hashgrid.bwd_grid
        hashgrid._kernels = lambda: self.parent
        hashgrid.bwd_grid = lambda n: self.grid(n, self.levels)

    def __exit__(self, *exc):
        hashgrid._kernels, hashgrid.bwd_grid = self.saved


def train_ab(system, parent, parent_grid, chunk, card):
    """Chunks of ``chunk`` steps of ``system.fit``, in turns with the
    parent's kernels and the change's, on the host clock (synced)."""
    times = {"parent": [], "change": []}
    for version in ORDER:
        with Swap(parent, parent_grid, system.model.hash_cfg.L) \
                if version == "parent" \
                else contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            system.fit(chunk)
            torch.cuda.synchronize()
        times[version].append((time.perf_counter() - t0) * 1e3 / chunk)
    row = dict(part="train_mf_ab", steps_from=system.global_step - 4 * chunk,
               chunk=chunk, parent_ms_per_step=times["parent"],
               change_ms_per_step=times["change"],
               parent_mean=float(np.mean(times["parent"])),
               change_mean=float(np.mean(times["change"])), card=card)
    print(json.dumps(row), flush=True)
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent-src", required=True)
    ap.add_argument("--parent-geometry", choices=tuple(GRIDS), default="pr5")
    ap.add_argument("--timing-only", action="store_true",
                    help="time a parent that computes something else (a "
                         "diagnostic cut of the kernel): no bitwise gate")
    ap.add_argument("--steps", type=int, default=900,
                    help="MixedFeature training steps before the train-shape "
                         "A/B; 0 skips it")
    ap.add_argument("--chunk", type=int, default=100)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("hash_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name()
    print(f"card: {card}", flush=True)
    print(json.dumps({"ptxas": build.ptxas_report("hashgrid")}),
          flush=True)
    parent = load_parent(args.parent_src)
    parent_grid = GRIDS[args.parent_geometry]
    rows = []
    for label, cfg, operands, seed in chip_smoke.hash_operand_sets():
        rows += ab(label, cfg, *operands(cfg, seed), parent, parent_grid,
                   args.iters, card, args.timing_only)
        torch.cuda.empty_cache()
    train = None
    if args.steps > 0:
        from mfnerf_tpu_torch.datasets.memory import MemoryDataset
        from mfnerf_tpu_torch.utils.procedural import make_scene
        scene = make_scene(n_train=chip_smoke.N_TRAIN_VIEWS, n_test=1,
                           wh=chip_smoke.WH, seed=chip_smoke.SEED)
        system = chip_smoke.start_system(
            chip_smoke.MF_HP, (MemoryDataset.from_scene(scene, "train"),
                               MemoryDataset.from_scene(scene, "test")),
            torch.device("cuda"))
        system.fit(args.steps)
        params, x, cfg, g = chip_smoke.capture_bwd_operands(
            system, chip_smoke.SEED + 9, hashgrid)[0][:4]
        rows += ab("train", cfg, params, x, g, parent, parent_grid,
                   args.iters, card, args.timing_only)
        train = train_ab(system, parent, parent_grid, args.chunk, card)
    print(json.dumps({"summary": [
        {key: row[key] for key in ("shape", "grid", "kernel", "bound_ms",
                                   "speedup", "bitwise_equal_to_parent")}
        | {"parent_ms": float(np.mean(row["parent_ms"])),
           "change_ms": float(np.mean(row["change_ms"]))}
        for row in rows], "train_ms_per_step": train and {
            k: train[k] for k in ("parent_mean", "change_mean")},
        "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
