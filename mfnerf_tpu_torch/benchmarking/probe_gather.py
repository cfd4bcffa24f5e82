"""The line-table lerp probe on the card: port of
``benchmarking/probe_pallas_gather.py``.

    python3 -m mfnerf_tpu_torch.benchmarking.probe_gather

The JAX probe (line by line):

* ``:40`` shapes: RANK 8, K 128, N = 2^20; ``:44-46`` a N(0, 1) table
  (RANK, K), idx uniform in [0, K-2], frac uniform in [0, 1);
* ``:49-52`` ``ref``, the XLA gather: ``T[:, idx] (1 - f) + T[:, idx+1] f``;
* ``:60-91`` ``k_onehot`` / ``run_onehot``: the same lerp by two one-hot
  matmuls a tile of 512 samples;
* ``:105-131`` ``k_index`` / ``run_index``: the same by ``take_along_axis``
  on the table padded to 512 lanes;
* ``:93-140`` each checked against ``ref`` and timed, one line a
  formulation (ms and ns/sample).

Here the three formulations are one kernel, ``ops/linetable.py::
table_lerp`` in idx mode (``csrc/linetable.cu``), on the table in the
port's (K, R) layout. It is checked bit for bit against its plain torch
version and timed beside it and beside ``torch.nn.functional.grid_sample``,
the one PyTorch call that computes the same lerp.
"""
import sys

import numpy as np
import torch

from ..ops.linetable import table_lerp, table_lerp_plain
from . import card_device, card_name, lerp_row, probe_main

RANK, K, N = 8, 128, 1 << 20


def operands(n, seed, device):
    """(table (K, RANK), idx (n,) int32 in [0, K-2], frac (n,) in [0, 1]) on
    ``device``, with the edges idx 0 and K-2, frac 0 and 1 among the first
    samples."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((K, RANK), dtype=np.float32)
    idx = rng.integers(0, K - 1, n, dtype=np.int32)
    frac = rng.random(n, dtype=np.float32)
    idx[:8], idx[8:16] = 0, K - 2
    frac[:4], frac[4:8], frac[8:12], frac[12:16] = 0, 1, 0, 1
    return (torch.from_numpy(a).to(device) for a in (table, idx, frac))


def run(device="cuda", seed=0, n=None):
    """Kernels 3 and 4 at the probe's shape (or ``n`` samples): the kernel
    against its plain version (bit for bit) and grid_sample; times beside
    the bound. Returns {"card", "kernels": {"table_lerp": row}, "failed"}."""
    dev = card_device(device)
    n = N if n is None else n
    table, idx, frac = operands(n, seed, dev)
    failed = []
    row = lerp_row(
        table, idx.double() + frac.double(),
        lambda: table_lerp(table, idx, frac),
        lambda: table_lerp_plain(table, idx, frac),
        # read the table, idx and frac once, write the output; per (sample,
        # column) two products and a sum, per sample 1 - f
        4 * K * RANK + 8 * n + 4 * n * RANK, 3 * n * RANK + n, failed,
        "table_lerp (idx)")
    return {"card": card_name(), "kernels": {"table_lerp": dict(
        row, mode="idx")}, "failed": failed}


def main():
    return probe_main(run)


if __name__ == "__main__":
    sys.exit(main())
