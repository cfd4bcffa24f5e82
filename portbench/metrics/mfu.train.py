"""mfu.train: the field's operations in the traced training window over
the window's seconds at the card's float32 peak, in %: per step the
samples its field evaluates (the march's samples, at most the step's
buffer: ``rm_s`` times the batch from ``fit``), three times a sample's
forward (the backward counted as twice it; ``counts.field_flops``)."""
from portbench.counts import FP32_FLOPS, field_flops


def read(rec):
    tr = rec["trace"]
    if rec["kind"] != "train" or tr is None or not tr.device:
        return None
    flops = 3 * field_flops(rec["hp"]) * sum(rec["valid"])
    return 100.0 * flops / (tr.window_s * FP32_FLOPS)
