"""Image reading and colour-space helpers (numpy, torch on the CPU).

Port of ``mfnerf_tpu/datasets/color_utils.py``: uint8 to [0, 1], alpha
blended onto white (``blend_a=False`` onto black, as the COLMAP loader
wants), a bilinear resize, flattened to (H*W, 3).

The decoder is ``png.py`` (8-bit PNG only). It runs on the host, where the
loaders run; it stands in for no device kernel.
"""
import numpy as np
import torch

from .png import read_png

# uint8 -> [0, 1] as the JAX package's native loader scales (a product with
# the float32 reciprocal)
INV_255 = np.float32(1) / np.float32(255)


def srgb_to_linear(img):
    limit = 0.04045
    return np.where(img > limit, ((img + 0.055) / 1.055) ** 2.4, img / 12.92)


def linear_to_srgb(img):
    limit = 0.0031308
    img = np.where(img > limit, 1.055 * img ** (1 / 2.4) - 0.055, 12.92 * img)
    img[img > 1] = 1  # "clamp" tonemapper
    return img


def resize_bilinear(img, img_wh):
    """(H, W, C) float32 -> (h, w, C) with (w, h) = ``img_wh``: bilinear
    with half-pixel centres and no antialiasing (cv2 ``INTER_LINEAR``)."""
    x = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None]
    y = torch.nn.functional.interpolate(
        x, size=(img_wh[1], img_wh[0]), mode="bilinear", align_corners=False,
        antialias=False)
    return y[0].permute(1, 2, 0).numpy()


def read_image(img_path, img_wh, blend_a=True):
    """Read an image to a flattened (H*W, 3) float32 array in [0, 1], at
    ``img_wh`` = (W, H)."""
    img = read_png(img_path).astype(np.float32) * INV_255
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    if img.shape[2] == 2:      # gray + alpha
        img = np.concatenate([img[..., :1]] * 3 + [img[..., 1:]], -1)
    if img.shape[2] == 4:      # blend alpha to RGB
        if blend_a:
            img = img[..., :3] * img[..., -1:] + (1 - img[..., -1:])
        else:
            img = img[..., :3] * img[..., -1:]
    if (img.shape[1], img.shape[0]) != tuple(img_wh):
        img = resize_bilinear(img, img_wh)
    return img.reshape(-1, 3).astype(np.float32)
