"""Datasets of the PyTorch port (mirrors mfnerf_tpu.datasets).

``dataset_dict`` maps ``--dataset_name`` to a loader, as the JAX package's
does. The ``colmap``, ``nerfpp`` and ``rtmv`` loaders are not ported yet
(ROADMAP, Queue 1): asking for one raises ``NotImplementedError``.
"""
from .nerf import NeRFDataset
from .nsvf import NSVFDataset


def _not_ported(name):
    def loader(*args, **kwargs):
        raise NotImplementedError(
            f"--dataset_name {name}: the {name} loader is not ported yet "
            f"(ROADMAP, Queue 1)")
    return loader


dataset_dict = {
    "nerf": NeRFDataset,
    "nsvf": NSVFDataset,
    **{name: _not_ported(name) for name in ("colmap", "nerfpp", "rtmv")},
}
