"""LPIPS (Learned Perceptual Image Patch Similarity) with the VGG16
backbone: the port of ``mfnerf_tpu/utils/lpips.py``.

The reference reports torchmetrics' ``LearnedPerceptualImagePatchSimilarity
('vgg')`` as ``lpips(clip(2 pred - 1), clip(2 gt - 1))``. The metric (Zhang
et al., CVPR 2018):

    d(x, y) = sum_l  mean_hw || w_l * ( f^_l(x) - f^_l(y) ) ||^2

with f_l the VGG16 activations after relu1_2, relu2_2, relu3_3, relu4_3 and
relu5_3, f^ their unit normalisation over channels and w_l the learned
non-negative channel weights. Inputs are scaled to [-1, 1], then whitened by
the official shift and scale.

The pretrained VGG16 and LPIPS weights do not ship with the repository.
They load from the npz that the JAX package's
``misc/export_lpips_weights.py`` writes on a machine with ``torchvision`` and
``lpips`` (``--lpips_weights``): conv kernels OIHW, as torch keeps them.
The convolutions and pools are PyTorch's (``conv2d``, ``max_pool2d``), as
the JAX package leaves them to XLA, in float32 with TF32 off
(``device.no_tf32``).
"""
import numpy as np
import torch
import torch.nn.functional as F

# VGG16 "features": (out_channels, convs) a block, a 2x2 max pool between
# blocks; LPIPS taps each block's last ReLU
VGG_BLOCKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
N_CONVS = sum(n for _, n in VGG_BLOCKS)          # 13
N_TAPS = len(VGG_BLOCKS)                          # 5
TAP_CHANNELS = tuple(c for c, _ in VGG_BLOCKS)    # (64, 128, 256, 512, 512)
# the official input whitening (lpips' ScalingLayer)
SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def canonical_weight_shapes():
    """The npz's contents: ``conv{i}_w`` (O, I, 3, 3) and ``conv{i}_b`` (O,)
    for the 13 VGG16 convolutions in order, ``lin{k}_w`` (C_k,) for the 5
    LPIPS heads."""
    shapes = {}
    c_in, i = 3, 0
    for c_out, n in VGG_BLOCKS:
        for _ in range(n):
            shapes[f"conv{i}_w"] = (c_out, c_in, 3, 3)
            shapes[f"conv{i}_b"] = (c_out,)
            c_in = c_out
            i += 1
    for k, c in enumerate(TAP_CHANNELS):
        shapes[f"lin{k}_w"] = (c,)
    return shapes


def load_lpips_weights(path, device="cpu"):
    """The npz at ``path`` as float32 tensors on ``device``, each key and
    shape checked (a head stored as torch's (1, C, 1, 1) 1x1 conv is
    flattened). A missing key or a wrong shape raises ``ValueError``."""
    raw = np.load(path)
    shapes = canonical_weight_shapes()
    missing = sorted(set(shapes) - set(raw.files))
    if missing:
        raise ValueError(
            f"LPIPS weights file {path!r} is missing keys {missing[:4]}...: "
            f"write it with the JAX package's misc/export_lpips_weights.py")
    out = {}
    for key, shape in shapes.items():
        a = np.asarray(raw[key], np.float32)
        if key.startswith("lin") and a.ndim == 4:
            a = a.reshape(-1)
        if a.shape != shape:
            raise ValueError(f"LPIPS weight {key}: shape {a.shape} != "
                             f"{shape}")
        out[key] = torch.from_numpy(a).to(device)
    return out


def random_lpips_weights(generator):
    """Untrained weights of the right shapes, N(0, 0.05^2) from
    ``generator`` (the heads' absolute values: LPIPS keeps them
    non-negative). For tests only."""
    out = {}
    for key, shape in canonical_weight_shapes().items():
        a = 0.05 * torch.randn(shape, generator=generator)
        out[key] = a.abs() if key.startswith("lin") else a
    return out


def vgg16_taps(weights, x):
    """The VGG16 forward of a whitened (N, 3, H, W) batch: its 5 tapped
    post-ReLU activations."""
    taps, i = [], 0
    for bi, (_, n) in enumerate(VGG_BLOCKS):
        for _ in range(n):
            x = torch.relu(F.conv2d(x, weights[f"conv{i}_w"],
                                    weights[f"conv{i}_b"], padding=1))
            i += 1
        taps.append(x)
        if bi < N_TAPS - 1:
            x = F.max_pool2d(x, 2)
    return taps


def _unit_normalize(f, eps=1e-10):
    """Unit normalisation over channels (lpips' normalize_tensor)."""
    return f / (torch.sqrt(torch.sum(f * f, dim=1, keepdim=True)) + eps)


def lpips_from_weights(weights, img_pred, img_gt):
    """LPIPS distance of two (H, W, 3) images in [0, 1] under ``weights``
    (:func:`load_lpips_weights`), on the images' device: a 0-d tensor."""
    dev = img_pred.device
    shift = torch.from_numpy(SHIFT).to(dev)
    scale = torch.from_numpy(SCALE).to(dev)

    def prep(img):
        x = torch.clamp(img.to(torch.float32) * 2.0 - 1.0, -1.0, 1.0)
        return ((x - shift) / scale).permute(2, 0, 1)[None]   # (1, 3, H, W)

    with torch.no_grad():
        taps_p = vgg16_taps(weights, prep(img_pred))
        taps_g = vgg16_taps(weights, prep(img_gt))
        total = torch.zeros((), device=dev)
        for k in range(N_TAPS):
            d = _unit_normalize(taps_p[k]) - _unit_normalize(taps_g[k])
            wd = weights[f"lin{k}_w"][None, :, None, None] * (d * d)
            total = total + torch.mean(torch.sum(wd, dim=1))
    return total
