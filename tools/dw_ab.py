"""A/B of the hat-basis dW kernel (``hat_basis_dw``, ``csrc/linetable.cu``)
on one NVIDIA GPU: this tree's kernel against an earlier version of it,
built from that version's source.

    python3 tools/dw_ab.py --parent-src OLD/mfnerf_tpu_torch/csrc/linetable.cu

OLD is an unpacked earlier commit whose ``hat_basis_dw`` has this tree's C
signature; it is compiled with this tree's nvcc flags under a name that
carries a hash of its source. Both versions are called through their C
entries with preallocated dW and slabs and with this tree's
``dw_chunking`` (the C entry takes the chunking as arguments). The sets
are those of ``chip_smoke.py`` phase 17 (``probe_gather2.dw_operands``,
K 513, R 128): uniform u, the same u sorted, u on the knots, all at
N = 2^19, and uniform u at the ragged N = 65,573. On each set each
version's dW must be bitwise equal across three launches, the change's
within 1e-4 x max of the parent's and bit for bit equal to
``hat_basis_dw_order_plain``; then the two are timed in turns parent,
change, change, parent by CUDA-graph replay (``benchmarking.graph_ms``,
20 calls, as ``probe_gather2.dw_row``).

``--timing-only`` times a parent that computes something else (a
diagnostic cut of a kernel, kept out of the repo): the checks are printed
but do not fail the run.

Prints the card's name and power limit, what ptxas reports of this tree's
kernels (registers, shared memory, spills), one JSON line a set and a
summary line; exits non-zero on a mismatch or without a CUDA device.
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

import chip_smoke  # noqa: E402  (the phases' configuration)
from mfnerf_tpu_torch import build  # noqa: E402
from mfnerf_tpu_torch.benchmarking import (card_name, graph_ms,  # noqa: E402
                                           probe_gather2)
from mfnerf_tpu_torch.ops import linetable  # noqa: E402

ORDER = ("parent", "change", "change", "parent")
SETS = (("uniform", probe_gather2.N), ("sorted", probe_gather2.N),
        ("knots", probe_gather2.N), ("uniform", chip_smoke.N_RAGGED))


def load_parent(src):
    """ctypes entry of the earlier hat_basis_dw, compiled with this tree's
    nvcc flags into the build directory."""
    code = open(src, "rb").read()
    digest = hashlib.sha256(code).hexdigest()[:16]
    out = build.BUILD_DIR / f"liblinetable-parent-{digest}.so"
    if not out.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                        src], check=True)
    fn = ctypes.CDLL(str(out)).hat_basis_dw
    fn.argtypes = linetable._kernels()[1].argtypes
    fn.restype = ctypes.c_int
    return fn


def launcher(fn, u, g):
    """(launch, dW) of one version on (u, g), its scratch preallocated."""
    n, r = g.shape
    k = probe_gather2.K
    chunk, chunks = linetable.dw_chunking(n, r)
    dw = torch.empty((k, r), dtype=torch.float32, device=u.device)
    slabs = torch.empty((chunks, k, r), dtype=torch.float32, device=u.device)

    def launch():
        rc = fn(u.data_ptr(), g.data_ptr(), dw.data_ptr(), slabs.data_ptr(),
                n, k, r, chunk, chunks,
                torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc

    return launch, dw


def ab(kind, n, parent, card):
    """Check both versions on one set, then time them in turns. Returns
    the set's row."""
    u, g = probe_gather2.dw_operands(kind, n, chip_smoke.SEED + 2,
                                     torch.device("cuda"))
    versions = {"parent": launcher(parent, u, g),
                "change": launcher(linetable._kernels()[1], u, g)}
    bitwise = {}
    for name, (launch, dw) in versions.items():
        outs = []
        for _ in range(3):
            launch()
            outs.append(dw.clone())
        torch.cuda.synchronize()
        bitwise[name] = all(torch.equal(outs[0], o) for o in outs[1:])
    want = versions["parent"][1]
    got = versions["change"][1]
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    model = linetable.hat_basis_dw_order_plain(u, g, probe_gather2.K)
    times = {"parent": [], "change": []}
    for version in ORDER:
        times[version].append(graph_ms(versions[version][0], 20))
    parent_ms, change_ms = (float(np.mean(times[v])) for v in times)
    bound_ms, bound_by = probe_gather2.dw_bound(n)
    return dict(set=kind, n=n, k=probe_gather2.K, r=probe_gather2.R,
                bitwise_across_launches=bitwise,
                change_vs_parent_max_abs_err=err, parent_max_abs=scale,
                within_tol=err <= probe_gather2.DW_TOL * scale,
                change_equals_order_model=bool(torch.equal(got, model)),
                parent_ms=times["parent"], change_ms=times["change"],
                speedup=parent_ms / change_ms, bound_ms=bound_ms,
                bound_by=bound_by, parent_share_of_bound=bound_ms / parent_ms,
                change_share_of_bound=bound_ms / change_ms, card=card)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent-src", required=True)
    ap.add_argument("--timing-only", action="store_true",
                    help="time a parent that computes something else (a "
                         "diagnostic cut of the kernel): checks not enforced")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dw_ab: no CUDA device", file=sys.stderr)
        return 1
    card = card_name()
    print(f"card: {card}", flush=True)
    print(json.dumps({"ptxas": build.ptxas_report("linetable")}),
          flush=True)
    parent = load_parent(args.parent_src)
    rows, failed = [], []
    for kind, n in SETS:
        row = ab(kind, n, parent, card)
        print(json.dumps(row), flush=True)
        rows.append(row)
        for check in ("within_tol", "change_equals_order_model"):
            if not row[check]:
                failed.append(f"{kind} n={n}: {check}")
        failed += [f"{kind} n={n}: {v} differs between launches"
                   for v, ok in row["bitwise_across_launches"].items()
                   if not ok]
        torch.cuda.empty_cache()
    print(json.dumps({"summary": [
        {key: row[key] for key in ("set", "n", "bound_ms", "speedup")}
        | {"parent_ms": float(np.mean(row["parent_ms"])),
           "change_ms": float(np.mean(row["change_ms"]))} for row in rows],
        "failed": failed, "timing_only": args.timing_only,
        "parent_src": args.parent_src, "card": card}), flush=True)
    return 1 if failed and not args.timing_only else 0


if __name__ == "__main__":
    sys.exit(main())
