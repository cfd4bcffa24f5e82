"""A/B of the hat-CP backward kernel on one NVIDIA GPU: this tree's kernel
against an earlier version of it, built from that version's source.

    python3 tools/hat_bwd_ab.py --parent-src OLD/mfnerf_tpu_torch/csrc/hatmul.cu

OLD is an unpacked earlier commit whose ``hat_prod_bwd`` has the C
signature (u3, w, g, du, dw, n, k, r, stream): a scatter with float4
atomics into a zeroed dW, g contiguous. Its time here includes zeroing dW.
This tree's kernel (both stages) is called through its C entry with
preallocated scratch ("kernel") and through ``ops.hatmul.hat_prod_bwd``
("wrapper"). Two shapes, K = 257 and R = 128:

* uniform: N = 2^19 samples of uniform u, g N(0, 1) (chip_smoke.py phase 7);
* train: one LowRank frame's (u, W, g) of a real training step, after
  ``--steps`` steps of the bench configuration (chip_smoke.py phases 9 and
  7b), with g the column slice HatProd.backward receives.

Each is timed with and without du, in turns parent, change, change, parent
(CUDA events, mean of ``--iters`` launches); the forward kernel is timed on
the same u, alone and through ``hat_prod``. Prints the card's name and
power limit, then one JSON line a measurement, then a summary line.
"""
import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (the phases' helpers and configuration)
from mfnerf_tpu_torch import build  # noqa: E402
from mfnerf_tpu_torch.ops import hatmul  # noqa: E402


def load_parent(src):
    """ctypes entry of the earlier hat_prod_bwd, compiled with this tree's
    nvcc flags into the build directory."""
    code = open(src, "rb").read()
    digest = hashlib.sha256(code).hexdigest()[:16]
    out = build.BUILD_DIR / f"libhatmul-parent-{digest}.so"
    if not out.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                        src], check=True)
    fn = ctypes.CDLL(str(out)).hat_prod_bwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launchers(u3, w3, k, g, parent):
    """{(version, need_du): fn} on the same operands."""
    n, r = g.shape
    dev = u3.device
    stream = torch.cuda.current_stream().cuda_stream
    w_bf = w3.detach().to(torch.bfloat16).contiguous()
    g_rows, ldg = hatmul._g_in_place(g)
    g_dense = g.contiguous()
    dw = torch.empty((3, k, r), dtype=torch.float32, device=dev)
    du = torch.empty((n, 3), dtype=torch.float32, device=dev)
    chunk, chunks = hatmul.bwd_chunking(n, r)
    slabs = torch.empty((chunks, 3, k, r), dtype=torch.float32, device=dev)
    part = torch.empty((-(-r // hatmul.BWD_COLS), n, 3),
                       dtype=torch.float32, device=dev)
    new = hatmul._kernels()[1]

    def run_parent(need_du):
        dw.zero_()
        rc = parent(u3.data_ptr(), w_bf.data_ptr(), g_dense.data_ptr(),
                    du.data_ptr() if need_du else None, dw.data_ptr(), n, k,
                    r, stream)
        assert rc == 0, rc

    def run_kernel(need_du):
        rc = new(u3.data_ptr(), w_bf.data_ptr(), g_rows.data_ptr(), ldg,
                 du.data_ptr() if need_du else None, dw.data_ptr(),
                 slabs.data_ptr(), part.data_ptr() if need_du else None, n,
                 k, r, chunk, chunks, None, stream)
        assert rc == 0, rc

    fns = {}
    for need_du in (True, False):
        fns["parent", need_du] = lambda nd=need_du: run_parent(nd)
        fns["kernel", need_du] = lambda nd=need_du: run_kernel(nd)
        fns["wrapper", need_du] = lambda nd=need_du: hatmul.hat_prod_bwd(
            u3, w3, k, g, need_du=nd)
    return fns, dw


def ab(label, u3, w3, k, g, parent, iters, card):
    n, r = g.shape
    fns, dw = launchers(u3, w3, k, g, parent)
    _, dw_plain = hatmul.hat_prod_bwd_plain(u3, w3, k, g, need_du=False)
    scale = float(dw_plain.abs().max())
    errs = {}
    for version in ("parent", "kernel"):
        fns[version, True]()
        torch.cuda.synchronize()
        errs[version] = float((dw - dw_plain).abs().max()) / scale
    occupancy = build.load_library("hatmul").hat_prod_bwd_blocks_per_sm(k)
    rows = []
    for need_du in (True, False):
        bound_ms, bound_by = chip_smoke.bwd_bound(n, k, r, need_du)
        times = {"parent": [], "kernel": [], "wrapper": []}
        for version in ("parent", "kernel", "wrapper", "wrapper", "kernel",
                        "parent"):
            times[version].append(chip_smoke.cuda_ms(fns[version, need_du],
                                                     iters))
        row = dict(shape=label, n=n, k=k, r=r, need_du=need_du,
                   g_row_stride=g.stride(0), bound_ms=bound_ms,
                   bound_by=bound_by, card=card,
                   stage1_blocks_per_sm=occupancy,
                   chunking=hatmul.bwd_chunking(n, r),
                   dw_rel_err_parent=errs["parent"],
                   dw_rel_err_kernel=errs["kernel"])
        for version, ts in times.items():
            row[f"{version}_ms"] = ts
            row[f"{version}_share_of_bound"] = bound_ms / float(np.mean(ts))
        row["speedup_kernel_vs_parent"] = float(
            np.mean(times["parent"]) / np.mean(times["kernel"]))
        print(json.dumps(row), flush=True)
        rows.append(row)
    if not g.is_contiguous():
        copy_ms = chip_smoke.cuda_ms(lambda: g.contiguous(), iters)
        print(json.dumps({"shape": label, "g_contiguous_copy_ms": copy_ms,
                          "card": card}), flush=True)
    return rows


def forward(label, u3, w3, k, iters, card):
    """The forward kernel on the same u: its C entry alone with a
    preallocated output ("kernel"), and ``hat_prod`` ("wrapper")."""
    n, r = u3.shape[0], w3.shape[2]
    w_bf = w3.detach().to(torch.bfloat16).contiguous()
    out = torch.empty((n, r), dtype=torch.float32, device=u3.device)
    stream = torch.cuda.current_stream().cuda_stream
    fwd = hatmul._kernels()[0]

    def run_kernel():
        rc = fwd(u3.data_ptr(), w_bf.data_ptr(), out.data_ptr(), n, k, r,
                 None, stream)
        assert rc == 0, rc

    kernel_ms = chip_smoke.cuda_ms(run_kernel, iters)
    wrapper_ms = chip_smoke.cuda_ms(lambda: hatmul.hat_prod(u3, w3, k),
                                    iters)
    bound_ms, bound_by = chip_smoke.fwd_bound(n, k, r)
    row = dict(shape=label, kernel="hat_prod", n=n, k=k, r=r,
               kernel_ms=kernel_ms, wrapper_ms=wrapper_ms,
               bound_ms=bound_ms, bound_by=bound_by,
               kernel_share_of_bound=bound_ms / kernel_ms, card=card)
    print(json.dumps(row), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent-src", required=True)
    ap.add_argument("--steps", type=int, default=900)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("hat_bwd_ab: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    print(json.dumps({"ptxas": build.ptxas_report("hatmul")}),
          flush=True)
    parent = load_parent(args.parent_src)
    dev = torch.device("cuda", 0)

    from mfnerf_tpu_torch.datasets.memory import MemoryDataset
    from mfnerf_tpu_torch.models.ngp import NGP, NGPConfig
    from mfnerf_tpu_torch.ops.lowrank import fold_frame
    from mfnerf_tpu_torch.train import NeRFSystem
    from mfnerf_tpu_torch.utils.procedural import make_scene

    model = NGP(NGPConfig(lr_k_max=256, lr_fused=True),
                torch.Generator().manual_seed(chip_smoke.SEED), device=dev)
    lr = model.lowrank_cfg
    k = lr.levels[-1]
    w3 = fold_frame({"lines": model.lowrank.lines}, lr, 0).detach()
    rng = np.random.default_rng(chip_smoke.SEED)
    u = rng.random((chip_smoke.N_BWD, 3), dtype=np.float32)
    g = rng.standard_normal((chip_smoke.N_BWD, w3.shape[2]),
                            dtype=np.float32)
    rows = ab("uniform", torch.from_numpy(u).to(dev), w3, k,
              torch.from_numpy(g).to(dev), parent, args.iters, card)
    forward("uniform", torch.from_numpy(u).to(dev), w3, k, args.iters, card)
    del model, u, g

    scene = make_scene(n_train=chip_smoke.N_TRAIN_VIEWS, n_test=1,
                       wh=chip_smoke.WH, seed=chip_smoke.SEED)
    system = NeRFSystem(argparse.Namespace(**chip_smoke.BENCH_HP),
                        device=dev)
    system.setup(MemoryDataset.from_scene(scene, "train"))
    system.configure(chip_smoke.SEED)
    system.fit(args.steps)
    u3, w3_t, k_t, g_t = chip_smoke.capture_bwd_operands(
        system, chip_smoke.SEED + 4)[0]
    rows += ab("train", u3, w3_t, k_t, g_t, parent, args.iters, card)
    forward("train", u3, w3_t, k_t, args.iters, card)
    print(json.dumps({"summary": [
        {key: row[key] for key in ("shape", "n", "need_du", "bound_ms",
                                   "speedup_kernel_vs_parent")}
        | {"parent_ms": float(np.mean(row["parent_ms"])),
           "kernel_ms": float(np.mean(row["kernel_ms"]))}
        for row in rows], "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
