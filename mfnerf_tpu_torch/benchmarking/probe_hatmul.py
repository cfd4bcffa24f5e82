"""The dense hat-basis CP product on the card: port of
``benchmarking/probe_pallas_hatmul.py``.

    python3 -m mfnerf_tpu_torch.benchmarking.probe_hatmul

The JAX probe (line by line):

* ``:58-62`` shapes: K 513 knots, R 128 columns, N = 2^19 (KP 640 and
  TN 256 are the TPU's padding and tile); ``:64-67`` u3 uniform (N, 3), a
  0.1 N(0, 1) W (3, KP, R) with rows >= K zero;
* ``:70-80`` ``xla_ref``: per axis the dense hat basis, ``bf16(basis) @
  bf16(W_d)`` in fp32, the product of the three;
* ``:89-117`` ``kernel`` / ``run_pallas``: the same function a tile of
  samples, the basis built in VMEM; its body is
  ``mfnerf_tpu/ops/hatmul.py::_fwd_kernel`` line for line.

So the port's kernel is the hat forward the LowRank encoder runs,
``ops/hatmul.py::hat_prod`` (``csrc/hatmul.cu``), here at the probe's K and
N. It is checked bit for bit against ``hat_prod_plain`` and timed beside
it. No single PyTorch call computes the product from u.
"""
import sys

import numpy as np
import torch

from ..ops.hatmul import hat_prod, hat_prod_plain
from . import bound, card_device, card_name, graph_ms, max_err, probe_main

K, R, N = 513, 128, 1 << 19


def operands(n, seed, device):
    """(u3 (n, 3), W (3, K, R)) on ``device``: u3 uniform in [0, 1) with
    u = 1, u = 0 and knots among the first samples; W 0.1 N(0, 1)."""
    rng = np.random.default_rng(seed)
    u3 = rng.random((n, 3), dtype=np.float32)
    u3[:64], u3[64:128] = 1.0, 0.0
    u3[128:1024] = np.round(u3[128:1024] * (K - 1)) / (K - 1)  # knots
    w = (0.1 * rng.standard_normal((3, K, R))).astype(np.float32)
    return (torch.from_numpy(a).to(device) for a in (u3, w))


def run(device="cuda", seed=0, n=None):
    """Kernel 7 through ``hat_prod`` at the probe's shape (or ``n``
    samples). Returns {"card", "kernels": {"hat_prod": row}, "failed"}."""
    dev = card_device(device)
    n = N if n is None else n
    u3, w = operands(n, seed, dev)
    got = hat_prod(u3, w, K)
    want = hat_prod_plain(u3, w, K)
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise RuntimeError(f"hat_prod output {tuple(got.shape)}")
    err, scale = max_err(got, want)
    bitwise = bool(torch.equal(got, want))
    failed = [] if bitwise else [f"hat_prod vs plain: max abs err {err}"]
    del got, want
    ms = graph_ms(lambda: hat_prod(u3, w, K), 20)
    # read u3 and the bf16 W once, write the output; per (sample, column)
    # three two-row lerps (3 operations each) and two products
    bound_ms, bound_by = bound(12 * n + 6 * K * R + 4 * n * R, 11 * n * R)
    row = dict(n=n, k=K, r=R, max_abs_err=err, max_abs=scale,
               bitwise_equal=bitwise, ms=ms,
               plain_ms=graph_ms(lambda: hat_prod_plain(u3, w, K), 3),
               library=None, library_ms=None, bound_ms=bound_ms,
               bound_by=bound_by, share_of_bound=bound_ms / ms)
    return {"card": card_name(), "kernels": {"hat_prod": row},
            "failed": failed}


def main():
    return probe_main(run)


if __name__ == "__main__":
    sys.exit(main())
