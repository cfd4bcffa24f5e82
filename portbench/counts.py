"""The yardstick's arithmetic: the card's peaks, the least time of an
amount of work, and the operations and bytes of the field and its kernels.

Peaks: NVIDIA H100 SXM (data sheet, dense, at its 700 W limit): HBM at
3.35 TB/s, 67 TFLOP/s in float32 off the tensor cores (TF32 is off: the
configurations compute in IEEE float32).

The kernel counts are copies of ``chip_smoke.py``'s ``bwd_bound`` (the hat
product's backward) and ``hash_bwd_bound`` (the hash grid's), as of the
benchmark's first version: each input byte read once, each output byte
written once, the operations the algorithm needs.
"""
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12


def least_s(n_bytes, flops):
    """(least seconds, "bytes" or "operations"): bytes over HBM's rate or
    operations over the fp32 peak, whichever takes longer."""
    by_bytes, by_ops = n_bytes / HBM_BPS, flops / FP32_FLOPS
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                          "operations")


def hat_bwd(n, k, r, need_du=False, w_bytes=2):
    """(bytes, operations) of one hat-product backward over ``n`` samples,
    ``k`` knots and ``r`` columns: u, g and W read once (W ``w_bytes`` an
    element), dW (fp32) and du written; per (sample, column, axis) a lerp
    (3), g_d (2), two row sums (4), with du a difference and a product
    (2)."""
    n_bytes = 12 * n + 4 * n * r + 3 * w_bytes * k * r + 12 * k * r \
        + (12 * n if need_du else 0)
    return n_bytes, (11 if need_du else 9) * 3 * n * r


def hash_bwd(n, levels, f, n_params):
    """(bytes, operations) of one hash-grid backward over ``n`` samples
    without the positions' gradient: g and x read, the table's gradient
    written whole; per (sample, level) the cell (6) and per corner its
    weight (2) and the update of F features (3 each)."""
    n_bytes = 12 * n + 4 * n * levels * f + 4 * n_params * f
    return n_bytes, n * levels * (6 + 8 * (2 + 3 * f))


def field_flops(hp):
    """Operations of one sample's field forward, from the configuration's
    widths (2 a multiply-add): the encoder (LowRank: per frame and column
    three two-row lerps and two products, 11, then the projection; hash
    grids: per level the cell, 8 weights and 8 blends of F features), the
    sigma MLP (L*F -> 64 -> 16) and the rgb MLP (16 SH + 16 -> channels
    x layers -> 3). The backward is counted as twice the forward."""
    width = hp["L"] * hp["F"]
    if hp["grid"] == "LowRank":
        r = hp["lr_levels"] * hp["lr_rank"]
        enc = hp["lr_frames"] * (11 * r + 2 * r * width)
    else:
        enc = hp["L"] * (6 + 8 * (2 + 2 * hp["F"]))
    c = hp["rgb_channels"]
    return enc + 2 * (width * 64 + 64 * 16) \
        + 2 * (32 * c + (hp["rgb_layers"] - 1) * c * c + 3 * c)


def percentile(values, q):
    """The nearest-rank ``q``-th percentile (0 < q <= 100): the smallest
    value with at least q% of the values at or below it."""
    xs = sorted(values)
    rank = -(-len(xs) * q // 100)
    return xs[max(int(rank), 1) - 1]
