"""Checkpoints in the JAX package's format, read and written.

The format is ``mfnerf_tpu.utils.ckpt``'s: one ``.npz`` of flattened pytree
leaves keyed ``<section>::<path>`` (for example
``params::lowrank/lines/0/3/2``, ``params::sigma_mlp/1``,
``occ::density_bitfield``), plus a JSON manifest under ``__manifest__``
({"step", "sections", "<section>_keys"}). Reading and writing it needs
numpy only, so checkpoints cross backends both ways:

* ``params`` carries the NGP parameters under the JAX pytree's paths: the
  port's state-dict names with ``.`` for ``/`` (:func:`params_to_numpy`,
  :func:`params_from_numpy`).
* ``occ`` carries ``density_grid``, ``density_bitfield`` and
  ``count_grid`` under the JAX ``OccupancyState``'s attribute names; the
  JAX loader fills those and keeps its template's derived tables, which
  ``refresh_coarse`` rebuilds.
* ``opt_state`` carries the port's Adam state under its own keys
  (``exp_avg/<path>``, ``exp_avg_sq/<path>``, ``step/<path>``). The JAX
  loader leaves keys it does not know alone, and so does the port.

A slim checkpoint (:func:`slim_ckpt`) drops the optimiser state, the
density and count grids and the poses, and keeps the bitfield, which
serving needs.
"""
import json
import os

import numpy as np
import torch

from ..device import resolve_device
from ..models.ngp import OccupancyState

ADAM_KEYS = ("exp_avg", "exp_avg_sq", "step")


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


def _write(path, sections, step):
    """Write {section: {path: ndarray}} and its manifest to ``path``."""
    blobs = {}
    manifest = {"step": int(step), "sections": list(sections)}
    for name, leaves in sections.items():
        manifest[name + "_keys"] = sorted(leaves)
        for k, v in leaves.items():
            blobs[f"{name}::{k}"] = v
    blobs["__manifest__"] = np.frombuffer(json.dumps(manifest).encode(),
                                          dtype=np.uint8)
    np.savez(path, **blobs)


def save_ckpt(path, params, occ=None, opt_state=None, step=0):
    """Save a checkpoint. Each section is a flat {path: ndarray} dict
    (:func:`params_to_numpy`, :func:`occupancy_to_numpy`,
    :func:`adam_state_to_numpy`); None omits it."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    sections = {name: tree for name, tree in (
        ("params", params), ("occ", occ), ("opt_state", opt_state))
        if tree is not None}
    _write(path, sections, step)


def slim_ckpt(path, out_path):
    """Strip a full checkpoint for serving: drop the optimiser state, the
    density and count grids and the poses; keep the parameters and the
    density bitfield. As ``mfnerf_tpu.utils.ckpt``."""
    ck = load_ckpt(path)
    step = ck.pop("step")
    ck.pop("opt_state", None)
    ck.pop("poses", None)
    if "occ" in ck:
        ck["occ"] = {k: v for k, v in ck["occ"].items()
                     if "density_grid" not in k and "count_grid" not in k}
    _write(out_path, ck, step)


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


def params_to_numpy(model):
    """The inverse of :func:`params_from_numpy`: ``model``'s parameters as
    the flat ``{"lowrank/lines/0/0/0": ndarray}`` params section."""
    return {k.replace(".", "/"): v.detach().cpu().numpy().copy()
            for k, v in model.state_dict().items()}


def load_params(model, section):
    """Copy the params section's tensors into ``model`` where the names
    match (a partial load, as the JAX package's ``load_ckpt(like=...)``
    does for ``--weight_path``). Raises ``ValueError`` on a shape mismatch.
    """
    state = params_from_numpy(section)
    own = model.state_dict()
    with torch.no_grad():
        for name, value in state.items():
            if name not in own:
                continue
            if value.shape != own[name].shape:
                raise ValueError(
                    f"shape mismatch for params/{name.replace('.', '/')}: "
                    f"ckpt {tuple(value.shape)} vs model "
                    f"{tuple(own[name].shape)}")
            own[name].copy_(value)


def occupancy_to_numpy(occ):
    """The occ section: the grids under the JAX attribute names."""
    return {name: getattr(occ, name).cpu().numpy().copy() for name in (
        "density_grid", "density_bitfield", "count_grid")
        if getattr(occ, name) is not None}


def occupancy_from_numpy(occ, cfg, device=None):
    """The ``occ`` section of a checkpoint -> ``OccupancyState`` on
    ``device`` (default: the CUDA device; raises without one). Slim
    checkpoints keep only the bitfield; their density and count grids read
    as zeros."""
    device = resolve_device(device)
    zeros = np.zeros((cfg.cascades, cfg.n_cells), np.float32)

    def grid(name):
        return torch.from_numpy(np.asarray(occ.get(name, zeros),
                                           np.float32)).to(device)

    return OccupancyState(
        density_grid=grid("density_grid"),
        density_bitfield=torch.from_numpy(
            np.asarray(occ["density_bitfield"], np.uint8)).to(device),
        count_grid=grid("count_grid"))


def adam_state_to_numpy(optimizer, model):
    """``optimizer``'s per-parameter Adam state as the opt_state section:
    {"exp_avg/<path>", "exp_avg_sq/<path>", "step/<path>": ndarray}."""
    out = {}
    for name, p in model.named_parameters():
        state = optimizer.state.get(p, {})
        for key in ADAM_KEYS:
            if key in state:
                out[f"{key}/{name.replace('.', '/')}"] = \
                    state[key].detach().cpu().numpy().copy()
    return out


def adam_state_from_numpy(optimizer, model, section):
    """Restore the Adam state that :func:`adam_state_to_numpy` saved; a
    parameter whose state the section lacks keeps its own."""
    for name, p in model.named_parameters():
        path = name.replace(".", "/")
        if not all(f"{key}/{path}" in section for key in ADAM_KEYS):
            continue
        optimizer.state[p] = {
            key: torch.from_numpy(np.array(section[f"{key}/{path}"])).to(
                p.device if key != "step" else "cpu") for key in ADAM_KEYS}
