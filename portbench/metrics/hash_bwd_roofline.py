"""hash_bwd_roofline: the hash grid's backward (``csrc/hashgrid.cu``: its
prep, scatter and finish kernels) in the traced training window, the
least time of its work over its device time, in %. The work a step: the
step's valid samples and the table's rows (``counts.hash_bwd``, the exact
table gradient, no position gradient); the least time of each launch the
larger of its bytes at HBM's rate and its operations at the float32
peak."""
from portbench.counts import hash_bwd, least_s
from portbench.reference.field import hash_levels

KERNELS = ("hashgrid_bwd_prep_kernel", "hashgrid_bwd_scatter_kernel",
           "hashgrid_bwd_finish_kernel")


def read(rec):
    tr, hp = rec["trace"], rec["hp"]
    if rec["kind"] != "train" or tr is None or hp["grid"] == "LowRank":
        return None
    spent, launches = tr.kernel_s(KERNELS)
    if not launches:
        return None
    n_params = hash_levels(hp, hp["scale"])[1]
    least = sum(least_s(*hash_bwd(n, hp["L"], hp["F"], n_params))[0]
                for n in rec["valid"])
    return 100.0 * least / spent
