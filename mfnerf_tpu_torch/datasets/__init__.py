"""Datasets of the PyTorch port (mirrors mfnerf_tpu.datasets).

``dataset_dict`` maps ``--dataset_name`` to a loader, as the JAX package's
does.
"""
from .colmap import ColmapDataset
from .nerf import NeRFDataset
from .nerfpp import NeRFPPDataset
from .nsvf import NSVFDataset
from .rtmv import RTMVDataset

dataset_dict = {
    "nerf": NeRFDataset,
    "nsvf": NSVFDataset,
    "colmap": ColmapDataset,
    "nerfpp": NeRFPPDataset,
    "rtmv": RTMVDataset,
}
