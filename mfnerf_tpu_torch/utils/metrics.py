"""Image metrics: port of ``mfnerf_tpu/utils/metrics.py`` (mse, psnr, ssim).

SSIM is the Wang et al. formulation with an 11x11 Gaussian window (sigma
1.5), VALID windows, k1 0.01 and k2 0.03 on data_range 1, as the JAX
package (and torchmetrics) computes it. LPIPS is not ported.
"""
import numpy as np
import torch


def mse(image_pred, image_gt, valid_mask=None, reduction="mean"):
    value = (image_pred - image_gt) ** 2
    if valid_mask is not None:
        value = value[valid_mask]
    if reduction == "mean":
        return torch.mean(value)
    return value


def psnr(image_pred, image_gt, valid_mask=None, reduction="mean"):
    return -10.0 * torch.log10(mse(image_pred, image_gt, valid_mask,
                                   reduction))


SSIM_WINDOW, SSIM_SIGMA = 11, 1.5
SSIM_C1, SSIM_C2 = 0.01 ** 2, 0.03 ** 2     # (k * data_range) ** 2, range 1


def _gaussian_kernel():
    x = np.arange(SSIM_WINDOW, dtype=np.float64) - (SSIM_WINDOW - 1) / 2
    g = np.exp(-(x ** 2) / (2 * SSIM_SIGMA ** 2))
    g /= g.sum()
    return torch.from_numpy(np.outer(g, g).astype(np.float32))


def ssim(img_pred, img_gt):
    """Mean SSIM of two (H, W, C) float images in [0, 1] (a 0-d tensor)."""
    c1, c2 = SSIM_C1, SSIM_C2
    kern = _gaussian_kernel().to(img_pred.device)[None, None]

    def filt(x):  # (H, W, C) -> (C, H', W') local means over VALID windows
        x = x.to(torch.float32).permute(2, 0, 1)[:, None]
        return torch.nn.functional.conv2d(x, kern)[:, 0]

    mu_p, mu_g = filt(img_pred), filt(img_gt)
    mu_pp = filt(img_pred * img_pred)
    mu_gg = filt(img_gt * img_gt)
    mu_pg = filt(img_pred * img_gt)
    # fp32 cancellation on near-constant windows (a white background) can
    # drive E[x^2]-E[x]^2 slightly negative and SSIM above 1: clamp the
    # variances and project the covariance onto Cauchy-Schwarz
    var_p = torch.clamp_min(mu_pp - mu_p * mu_p, 0.0)
    var_g = torch.clamp_min(mu_gg - mu_g * mu_g, 0.0)
    bound = torch.sqrt(var_p * var_g)
    cov = torch.clamp(mu_pg - mu_p * mu_g, -bound, bound)
    num = (2 * mu_p * mu_g + c1) * (2 * cov + c2)
    den = (mu_p ** 2 + mu_g ** 2 + c1) * (var_p + var_g + c2)
    return torch.mean(num / den)
