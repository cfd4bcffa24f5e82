"""Read checkpoints written by ``mfnerf_tpu.utils.ckpt.save_ckpt``.

The format is one ``.npz`` of flattened pytree leaves, keyed
``<section>::<path>`` (for example ``params::lowrank/lines/0/3/2``,
``params::sigma_mlp/1``, ``occ::density_bitfield``), plus a JSON manifest
under ``__manifest__``. Reading it needs numpy only.

:func:`params_from_numpy` is the weights bridge: it maps the JAX parameter
tree, as numpy arrays, onto the port's ``NGP`` state-dict names.
"""
import json

import numpy as np
import torch

from ..device import resolve_device
from ..models.ngp import OccupancyState


def load_ckpt(path):
    """{"step": int, <section>: {path: ndarray}} for every saved section."""
    with np.load(path, allow_pickle=False) as data:
        manifest = json.loads(bytes(data["__manifest__"]).decode())
        out = {"step": manifest["step"]}
        for name in manifest["sections"]:
            prefix = name + "::"
            out[name] = {k[len(prefix):]: data[k] for k in data.files
                         if k.startswith(prefix)}
    return out


def _flatten(tree, prefix=""):
    """Nested dicts / lists / tuples of arrays -> {"a/0/b": array}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def params_from_numpy(tree):
    """JAX NGP parameters as numpy -> the port's ``NGP`` state dict.

    Args:
        tree: the nested parameter pytree (``{"lowrank": {"lines": [[[...]]],
            "proj": ...}, "sigma_mlp": [...], "rgb_mlp": [...]}``) with numpy
            leaves, or the flat ``{"lowrank/lines/0/0/0": array}`` section a
            checkpoint holds.
    Returns:
        {"lowrank.lines.0.0.0": tensor, ...} for ``NGP.load_state_dict``.
    """
    flat = _flatten(tree)
    return {k.replace("/", "."): torch.from_numpy(np.array(v, np.float32))
            for k, v in flat.items()}


def occupancy_from_numpy(occ, cfg, device=None):
    """The ``occ`` section of a checkpoint -> ``OccupancyState`` on
    ``device`` (default: the CUDA device; raises without one). Slim
    checkpoints keep only the bitfield; their density grid reads as zeros."""
    device = resolve_device(device)
    grid = occ.get("density_grid")
    if grid is None:
        grid = np.zeros((cfg.cascades, cfg.n_cells), np.float32)
    return OccupancyState(
        density_grid=torch.from_numpy(np.asarray(grid, np.float32)).to(device),
        density_bitfield=torch.from_numpy(
            np.asarray(occ["density_bitfield"], np.uint8)).to(device))
