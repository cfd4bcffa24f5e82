"""Check and time the hash-grid kernels alone on the card.

    python3 tools/hashgrid_check.py [--n N] [--ptxas]

Builds ``mfnerf_tpu_torch/csrc/hashgrid.cu``, then runs ``chip_smoke.py``'s
phase 12 (``check_hashgrid``: the forward bit for bit against its plain
version, the backward's d_params bitwise across launches and to the
fixed-point model, exact, sampled and windowed, d_params, d_x and d_window
against the plain version, the atomics before and after the warps' merge,
the kernels' device times by CUDA-graph replay beside their bounds) on its
operand sets at N points (the CLI's default Hash grid and the MixedFeature
benchmark grid at uniform points; the MixedFeature grid along rays and at
the degenerate set), then the generic path (F 4, L 12) at 2^16 points.
``--ptxas`` first prints what ptxas said of each kernel in the build
(``build.ptxas_report``: registers, spills, shared memory). Prints one JSON
line a check; exits non-zero on a failed check or without a CUDA device.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 19)
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("hashgrid_check: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from mfnerf_tpu_torch import build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    build.load_library("hashgrid")
    print(json.dumps({"build_seconds": time.perf_counter() - t0}),
          flush=True)
    if args.ptxas:
        print(json.dumps({"ptxas": build.ptxas_report("hashgrid")}),
              flush=True)
    chip_smoke.N_HASH = args.n
    for label, cfg, operands, seed in chip_smoke.hash_operand_sets():
        fields = chip_smoke.check_hashgrid(label, cfg, *operands(cfg, seed),
                                           seed + 10)
        print(json.dumps({"phase": "kernel_hashgrid", **fields,
                          "card": card}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
