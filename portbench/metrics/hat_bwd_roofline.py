"""hat_bwd_roofline: the hat product's backward (``csrc/hatmul.cu``: its
slab and reduce kernels) in the traced training window, the least time
of its work over its device time, in %. The work a launch: the step's
valid samples (its buffer's count), the folded table's knots and columns
of one frame (``counts.hat_bwd``, no position gradient), one launch a
frame a step; the least time of each launch the larger of its bytes at
HBM's rate and its operations at the float32 peak."""
from portbench.counts import hat_bwd, least_s
from portbench.reference.field import lowrank_levels

KERNELS = ("hat_prod_bwd_slab_kernel", "hat_prod_bwd_reduce_kernel")


def read(rec):
    tr, hp = rec["trace"], rec["hp"]
    if rec["kind"] != "train" or tr is None or hp["grid"] != "LowRank":
        return None
    spent, launches = tr.kernel_s(KERNELS)
    if not launches:
        return None
    k = lowrank_levels(hp["lr_levels"], hp["lr_k_max"])[-1]
    r = hp["lr_levels"] * hp["lr_rank"]
    least = hp["lr_frames"] * sum(least_s(*hat_bwd(n, k, r))[0]
                                  for n in rec["valid"])
    return 100.0 * least / spent
