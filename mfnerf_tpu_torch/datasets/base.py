"""Dataset base: the arrays an on-disk loader hands the trainer.

Port of ``mfnerf_tpu/datasets/base.py`` without its host-side ray sampler:
the port samples its ray batches on the device
(``train.NeRFSystem.sample_batch``), so a dataset only holds the arrays
that the trainer stages there and serves the test views one by one.
"""
import numpy as np


class BaseDataset:
    """Attributes (set by the loaders):
        poses: (N_img, 3, 4) float32 c2w in [right down front].
        rays: (N_img, H*W, 3) float32 pixel colours (empty for a split
            without images, such as ``test_traj``); HDR-NeRF's splits
            append each image's exposure as a 4th column.
        K: (3, 3) float32 intrinsics; directions: (H*W, 3) float32.
        img_wh: (W, H); split; root_dir.
    """

    def __init__(self, root_dir, split="train", downsample=1.0):
        self.root_dir = root_dir
        self.split = split
        self.downsample = downsample
        self.rays = np.zeros((0, 0, 3), np.float32)
        self.poses = np.zeros((0, 3, 4), np.float32)

    def read_intrinsics(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.poses)

    def __getitem__(self, idx):
        """One view: {"pose": (3, 4), "img_idxs": idx, "rgb": (H*W, 3) where
        the split has images, "exposure": the image's exposure (a scalar)
        where its rays carry one}."""
        sample = {"pose": self.poses[idx], "img_idxs": idx}
        if len(self.rays) > 0:
            sample.update(split_exposure(self.rays[idx]))
        return sample


def split_exposure(rays):
    """One image's rays (H*W, 3 or 4) -> {"rgb": (H*W, 3)[, "exposure": the
    4th column's value]}, as the JAX base's test split returns them."""
    sample = {"rgb": rays[:, :3]}
    if rays.shape[1] == 4:
        sample["exposure"] = rays[0, 3]
    return sample
