"""mfu.serve: the field's forward operations in the traced serving window
(the samples ``render_test`` evaluated, its ``total_samples``, times
``counts.field_flops``) over the window's seconds at the card's float32
peak, in %."""
from portbench.counts import FP32_FLOPS, field_flops


def read(rec):
    tr = rec["trace"]
    if rec["kind"] != "serve" or tr is None or not tr.device:
        return None
    flops = field_flops(rec["hp"]) * sum(f[2] for f in rec["frames"])
    return 100.0 * flops / (tr.window_s * FP32_FLOPS)
