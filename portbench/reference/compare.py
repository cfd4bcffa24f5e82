"""The numbers that decide ``correct``, from the program's outputs and the
reference's.

Training (three steps from the same state): the worst step's loss gap, and
by the worst leaf (a parameter tensor) the gap between the program's norm
and the reference's of the first step's gradient and of the change over
the three steps, each as a share of the reference's norm of that leaf or
of the median leaf, whichever is larger. Leaves whose reference gradient is
below a thousandth of the median leaf's are left out: under Adam's eps of
1e-15 they move by round-off alone.

Serving (chosen pixels of served frames): mean absolute gaps of rgb (over
pixels and channels), opacity and depth.

A run is correct where every number compared is finite and at most its
limit (``verdict``).
"""
import math
import statistics

import torch

ROUNDING_SHARE = 1e-3   # of the median leaf's gradient norm


def adam_first_grads(m0, m1, beta1=0.9):
    """The gradient Adam got at a step, from its first moments before and
    after it: m1 = beta1 m0 + (1 - beta1) g."""
    return {k: (m1[k].double() - beta1 * m0[k].double()) / (1 - beta1)
            for k in m1}


def _norms(tensors):
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tensors.items()}


def _worst_gap(prog, ref, keep):
    """max over ``keep`` of |prog - ref| / max(ref, median ref)."""
    if not keep:
        return 0.0
    med = statistics.median(ref[k] for k in keep)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in keep)


def train_numbers(prog_losses, ref_losses, prog_grads, ref_grads,
                  prog_delta, ref_delta):
    """dict(loss_gap, grad_gap, step_gap, left_out: the leaves left out
    with their reference gradient's norm) of a training check: the
    program's and the reference's losses (one a step), first gradients
    and changes over the steps (by leaf)."""
    g_ref = _norms(ref_grads)
    med = statistics.median(g_ref.values())
    keep = [k for k in g_ref if g_ref[k] >= ROUNDING_SHARE * med]
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog_losses,
                                                        ref_losses))
    return {
        "loss_gap": loss_gap,
        "grad_gap": _worst_gap(_norms(prog_grads), g_ref, keep),
        "step_gap": _worst_gap(_norms(prog_delta), _norms(ref_delta), keep),
        "left_out": {k: g_ref[k] for k in g_ref if k not in keep}}


def frame_numbers(prog, ref):
    """dict(rgb_gap, opacity_gap, depth_gap) of served pixels: ``prog`` and
    ``ref`` dicts of rgb (N, 3), opacity, depth."""
    return {
        "rgb_gap": float((prog["rgb"].float()
                          - ref["rgb"].float()).abs().mean()),
        "opacity_gap": float((prog["opacity"].float()
                              - ref["opacity"].float()).abs().mean()),
        "depth_gap": float((prog["depth"].float()
                            - ref["depth"].float()).abs().mean())}


def verdict(numbers, limits):
    """({name: [value, limit]} of the numbers compared, correct): correct
    where each is finite and at most its limit."""
    check = {k: [numbers[k], lim] for k, lim in limits.items()}
    return check, all(math.isfinite(v) and v <= lim
                      for v, lim in check.values())
