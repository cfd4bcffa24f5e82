"""In-memory dataset (procedural scenes, benchmarks, tests).

Port of ``mfnerf_tpu/datasets/memory.py``, numpy only. It holds the arrays
that the trainer stages on the device: the trainer samples its ray batches
there (``train.NeRFSystem``), so the JAX package's host-side batch sampler
is not ported.
"""
import numpy as np


class MemoryDataset:
    """Pre-rendered images with their cameras.

    Attributes:
        poses: (N_img, 3, 4) float32 c2w.
        rays: (N_img, H*W, 3) float32 pixel colours.
        K: (3, 3) float32 intrinsics; directions: (H*W, 3) float32.
        img_wh: (W, H).
    """

    def __init__(self, poses, images, K, directions, img_wh):
        self.poses = np.asarray(poses, np.float32)
        self.rays = np.asarray(images, np.float32)
        self.K = np.asarray(K, np.float32)
        self.directions = np.asarray(directions, np.float32)
        self.img_wh = tuple(img_wh)

    @staticmethod
    def from_scene(scene, split="train"):
        """A ``utils.procedural.make_scene`` dict's train or test views."""
        if split == "train":
            return MemoryDataset(scene["poses"], scene["images"], scene["K"],
                                 scene["directions"], scene["img_wh"])
        return MemoryDataset(scene["test_poses"], scene["test_images"],
                             scene["K"], scene["directions"],
                             scene["img_wh"])

    def __len__(self):
        return len(self.poses)

    def __getitem__(self, idx):
        """One view: {"pose": (3, 4), "rgb": (H*W, 3)}."""
        return {"pose": self.poses[idx], "rgb": self.rays[idx]}
