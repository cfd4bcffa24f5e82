"""Training losses: per-ray MSE, opacity entropy, mip-NeRF-360 distortion.

Port of ``mfnerf_tpu/losses.py`` (the reference's ``losses.py:40-60``) on the
padded (N, S) sample rows; the distortion loss's prefix-scan closed form is
differentiated by autograd through ``cumsum``. The JAX package's flat-layout
variant is a TPU device and is not ported.
"""
import torch


def distortion_loss(ws, deltas, ts, mask):
    """Per-ray distortion loss (N,) over padded sample rows.

    L = sum_{i,j} w_i w_j |m_i - m_j| + (1/3) sum_i w_i^2 delta_i, with the
    pairwise term as 2 * sum_i w_i (m_i * csum_{j<i} w_j - csum_{j<i} w_j m_j)
    and the sample distances ``ts`` as the interval midpoints m.
    """
    w = torch.where(mask, ws, 0.0)
    wm = w * ts
    w_excl = torch.cumsum(w, dim=1) - w
    wm_excl = torch.cumsum(wm, dim=1) - wm
    pair = 2.0 * (w * (ts * w_excl - wm_excl)).sum(dim=1)
    uni = (w * w * deltas).sum(dim=1) / 3.0
    return pair + uni


class NeRFLoss:
    """Loss terms {rgb, opacity[, distortion]}, each per ray (or per ray and
    channel); the training loss is the sum of their means."""

    def __init__(self, lambda_opacity=1e-3, lambda_distortion=1e-3):
        self.lambda_opacity = lambda_opacity
        self.lambda_distortion = lambda_distortion

    def __call__(self, results, target):
        d = {"rgb": (results["rgb"] - target["rgb"]) ** 2}
        o = results["opacity"] + 1e-10
        # encourage opacity to be 0 or 1 to avoid floaters
        d["opacity"] = self.lambda_opacity * (-o * torch.log(o))
        if self.lambda_distortion > 0:
            d["distortion"] = self.lambda_distortion * distortion_loss(
                results["ws"], results["deltas"], results["ts"],
                results["mask"])
        return d
