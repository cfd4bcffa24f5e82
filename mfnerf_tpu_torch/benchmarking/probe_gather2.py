"""The line-table gather and the hat-basis table gradient on the card: port
of ``benchmarking/probe_pallas_gather2.py``.

    python3 -m mfnerf_tpu_torch.benchmarking.probe_gather2

The JAX probe (line by line):

* ``:57-61`` shapes: K 513 knots, R 128 columns, N = 2^19 (KP 640 and
  TN 640 are the TPU's lane padding); ``:64-66`` u uniform in [0, 1), a
  0.1 N(0, 1) table W (KP, R) with rows >= K zero;
* ``:72-76`` ``ref``: ``pos = u (K-1)``, ``i = clip(int(pos), 0, K-2)``,
  ``f = pos - i``, ``W[i] (1 - f) + W[i+1] f``;
* ``:88-113`` probe A, ``k_gather`` / ``run_gather``: the same lerp, the
  index computed inside, by ``take_along_axis`` on the transposed table;
* ``:128-136`` ``ref_bwd``: ``dW = bf16(basis)^T @ bf16(g)`` in fp32, the
  dense hat basis of KP columns, g N(0, 1) (N, R);
* ``:143-173`` probe B, ``k_bwd`` / ``run_bwd``: the same product summed
  into one (KP, R) block over a sequential grid of 256-sample tiles.

Here probe A is ``ops/linetable.py::table_lerp`` in u mode and probe B is
``ops/linetable.py::hat_basis_dw`` (both ``csrc/linetable.cu``), on the
table's K rows. The lerp is checked bit for bit against its plain version
and timed beside grid_sample; dW is checked bitwise across three launches,
within DW_TOL of its plain version (the dense bf16 product in fp32) and bit
for bit against the model of its sums (``hat_basis_dw_order_plain``), by
:func:`dw_row`, which also takes the other sets of :func:`dw_operands`
(sorted u, u on the knots). No single PyTorch call computes dW from u.
"""
import sys

import numpy as np
import torch

from ..ops.linetable import (hat_basis_dw, hat_basis_dw_order_plain,
                             hat_basis_dw_plain, table_lerp,
                             table_lerp_plain)
from . import (bound, card_device, card_name, graph_ms, lerp_row, max_err,
               probe_main)

K, R, N = 513, 128, 1 << 19
# dW sums up to 2^19 bf16 products a row in another order than the plain
# matmul: fp32 rounding only
DW_TOL = 1e-4                  # x max |dW_plain|


def operands(n, seed, device):
    """(u (n,), W (K, R), g (n, R)) on ``device``: u uniform in [0, 1) with
    u = 1, u = 0 and knots among the first samples; W 0.1 N(0, 1); g
    N(0, 1)."""
    rng = np.random.default_rng(seed)
    u = rng.random(n, dtype=np.float32)
    u[:64], u[64:128] = 1.0, 0.0
    u[128:1024] = np.round(u[128:1024] * (K - 1)) / (K - 1)    # knots
    w = (0.1 * rng.standard_normal((K, R))).astype(np.float32)
    g = rng.standard_normal((n, R), dtype=np.float32)
    return (torch.from_numpy(a).to(device) for a in (u, w, g))


def dw_operands(kind, n, seed, device):
    """(u, g) of one set of hat_basis_dw's checks: :func:`operands`'s u and g
    ("uniform"), the same u sorted ("sorted": a chunk's samples on a few
    rows), or moved to its nearest knot ("knots": weights 1 and 0)."""
    u, _, g = operands(n, seed, device)
    if kind == "sorted":
        u = torch.sort(u).values
    elif kind == "knots":
        u = torch.round(u * (K - 1)) / (K - 1)
    elif kind != "uniform":
        raise ValueError(f"no dW set {kind!r}")
    return u, g


def dw_bound(n, r=R):
    """(ms, by) of hat_basis_dw's bound: read u and g once, write dW; per
    sample the rows and weights (8), per (sample, column) two products and
    two sums."""
    return bound(4 * n + 4 * n * r + 4 * K * r, 4 * n * r + 8 * n)


def dw_row(u, g, failed, label="hat_basis_dw"):
    """Check hat_basis_dw on (u, g): dW bitwise equal across three launches,
    within DW_TOL of the plain version and bit for bit equal to the model of
    its sums; then time it. Appends what failed to ``failed``; returns the
    kernel's row."""
    n = u.shape[0]
    runs = [hat_basis_dw(u, g, K) for _ in range(3)]
    want = hat_basis_dw_plain(u, g, K)
    model = hat_basis_dw_order_plain(u, g, K)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(runs[0], r) for r in runs[1:])
    spread = max(float((runs[0] - r).abs().max()) for r in runs[1:])
    err, scale = max_err(runs[0], want)
    model_equal = bool(torch.equal(runs[0], model))
    if not bitwise:
        failed.append(f"{label}: dW differs between launches by {spread}")
    if err > DW_TOL * scale:
        failed.append(f"{label} vs plain: {err} of {scale}")
    if not model_equal:
        failed.append(f"{label} vs hat_basis_dw_order_plain: max abs err "
                      f"{max_err(runs[0], model)[0]}")
    del runs, want, model
    ms = graph_ms(lambda: hat_basis_dw(u, g, K), 20)
    bound_ms, bound_by = dw_bound(n, g.shape[1])
    return dict(n=n, k=K, r=g.shape[1], dw_bitwise_equal=bitwise,
                dw_launch_spread=spread, order_model_equal=model_equal,
                max_abs_err=err, max_abs=scale, tol=DW_TOL, ms=ms,
                plain_ms=graph_ms(lambda: hat_basis_dw_plain(u, g, K), 3),
                library=None, library_ms=None, bound_ms=bound_ms,
                bound_by=bound_by, share_of_bound=bound_ms / ms)


def run(device="cuda", seed=0, n=None):
    """Kernel 5 (table_lerp, u mode) and kernel 6 (hat_basis_dw) at the
    probe's shape (or ``n`` samples). Returns {"card", "kernels":
    {"table_lerp": row, "hat_basis_dw": row}, "failed"}."""
    dev = card_device(device)
    n = N if n is None else n
    u, w, g = operands(n, seed, dev)
    failed = []
    lerp = lerp_row(
        w, u.double() * (K - 1),
        lambda: table_lerp(w, u=u, k=K),
        lambda: table_lerp_plain(w, u=u, k=K),
        # read u and the table once, write the output; per sample the row
        # and fraction (3) and 1 - f, per (sample, column) 3
        4 * n + 4 * K * R + 4 * n * R, 3 * n * R + 4 * n, failed,
        "table_lerp (u)")

    dw = dw_row(u, g, failed)
    return {"card": card_name(), "kernels": {
        "table_lerp": dict(lerp, mode="u"), "hat_basis_dw": dw},
        "failed": failed}


def main():
    return probe_main(run)


if __name__ == "__main__":
    sys.exit(main())
