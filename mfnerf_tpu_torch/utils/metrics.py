"""Image metrics: port of ``mfnerf_tpu/utils/metrics.py`` (mse, psnr)."""
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
