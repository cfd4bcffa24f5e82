"""Offline evaluation: port of the root ``eval.py`` (the reference
``test.ipynb`` protocol).

    python -m mfnerf_tpu_torch.eval --root_dir <dir> --dataset_name <name> \
        --ckpt_path <ckpt.npz> [--t_threshold 1e-2] [--mesh out.obj] ...

The flags are ``opt.py``'s and the root script's own: ``--mesh``,
``--mesh_resolution``, ``--sigma_threshold``, ``--t_threshold``. It restores
a checkpoint of either package (:meth:`train.NeRFSystem.restore`), renders
each test view with ``render_test`` at ``--t_threshold`` (1e-2, the
reference's offline protocol; training-time validation renders at 1e-4),
the host clock synchronised around each frame, and prints
``image i: N ms, psnr X``, then the mean PSNR and the mean FPS. On the
card ``render_test`` replays its CUDA graphs (``ServingRunner``): the
first frame of a size captures them (its time includes the captures), the
later frames of that size replay them. Unless
``--no_save_test`` it writes ``NNN.png`` and the depth map ``NNN_d.png``
under ``results/<dataset>/<exp>/eval``. With ``--mesh`` it exports the
density isosurface (``utils/mesh.py``). The root script's ``--guided`` and
``--wavefront`` renderers are not ported: they raise
``NotImplementedError``. Runs on the card; :func:`main` takes
``device="cpu"`` for tests.

With ``--num_gpus N > 1`` (or under ``torchrun``) each view is rendered
by ``render_test_sharded``: its rays split over N ranks, one a card (the
root script's ``render_test_sharded`` on the device mesh). Rank 0 times
the gathered frame, prints and writes.
"""
import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from .datasets import dataset_dict
from .datasets.png import write_png
from .datasets.ray_utils import get_rays
from .device import no_tf32
from .models.rendering import render_test, render_test_sharded
from .opt import get_opts
from .parallel import dist as pdist
from .train import NeRFSystem, depth2img
from .utils.metrics import psnr as psnr_fn


def main(argv=None, device=None, devices=None):
    """Evaluate as the root ``eval.py`` does on ``device`` (default: the
    card); with ``--num_gpus N > 1`` on N ranks (``devices``: a device a
    rank, for tests, as ``train.main`` takes it). Returns rank 0's
    dict(psnr: per view, ms: per view, mean_psnr, mean_fps[,
    mesh_vertices, mesh_seconds])."""
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--mesh", type=str, default=None)
    parser.add_argument("--mesh_resolution", type=int, default=256)
    parser.add_argument("--sigma_threshold", type=float, default=20.0)
    parser.add_argument("--guided", action="store_true",
                        help="depth-guided two-pass renderer (not ported)")
    parser.add_argument("--t_threshold", type=float, default=1e-2,
                        help="transmittance kill threshold: 1e-2 is the "
                             "reference's offline protocol, 1e-4 the "
                             "training-time validation's")
    parser.add_argument("--wavefront", type=str, default=None,
                        help="the persistent-pool wavefront renderer (not "
                             "ported)")
    extra, rest = parser.parse_known_args(argv)
    hparams = get_opts(rest)
    if not hparams.ckpt_path:
        raise SystemExit("--ckpt_path required")
    if extra.guided:
        raise NotImplementedError("--guided: the depth-guided renderer is "
                                  "not ported")
    if extra.wavefront:
        raise NotImplementedError("--wavefront: the wavefront renderer is "
                                  "not ported")
    no_tf32()
    if not pdist.in_group():
        joined = pdist.join_from_env()       # under torchrun
        if joined is not None:
            device = joined
        elif hparams.num_gpus > 1:
            return pdist.spawn(_evaluate_rank, pdist.rank_devices(
                hparams.num_gpus, device, devices), (hparams, extra))[0]
    return _evaluate(hparams, extra, device)


def _evaluate_rank(rank, device, hparams, extra):
    return _evaluate(hparams, extra, device)


def _evaluate(hparams, extra, device):
    """:func:`main`'s evaluation in one process (a rank, or alone)."""
    system = NeRFSystem(hparams, device=device)
    system.rcfg = dataclasses.replace(system.rcfg,
                                      T_threshold=extra.t_threshold)
    dataset = dataset_dict[hparams.dataset_name](
        root_dir=hparams.root_dir, split="test",
        downsample=hparams.downsample)
    system.test_dataset = dataset
    system.init_model(0)
    system.restore(hparams.ckpt_path, with_optimizer=False)

    sharded = pdist.in_group()
    lead = system.rank == 0
    save_dir = None
    if not hparams.no_save_test and lead:
        save_dir = f"results/{hparams.dataset_name}/{hparams.exp_name}/eval"
        os.makedirs(save_dir, exist_ok=True)

    dev = system.device
    w, h = dataset.img_wh
    directions = torch.from_numpy(dataset.directions).to(dev)
    psnrs, times = [], []
    for i in range(len(dataset)):
        view = dataset[i]
        rays_o, rays_d = get_rays(directions,
                                  torch.from_numpy(view["pose"]).to(dev))
        system.synchronize()
        t0 = time.perf_counter()
        render = render_test_sharded if sharded else render_test
        res = render(system.model, system.occ, rays_o, rays_d, system.rcfg)
        system.synchronize()
        times.append(time.perf_counter() - t0)
        line = f"image {i}: {times[-1] * 1e3:.0f} ms"
        if "rgb" in view:
            p = float(psnr_fn(res["rgb"], torch.from_numpy(view["rgb"]).to(
                dev)))
            psnrs.append(p)
            line += f", psnr {p:.2f}"
        if save_dir:
            rgb = res["rgb"].reshape(h, w, 3).cpu().numpy()
            write_png(os.path.join(save_dir, f"{i:03d}.png"),
                      (np.clip(rgb, 0, 1) * 255).astype(np.uint8))
            write_png(os.path.join(save_dir, f"{i:03d}_d.png"),
                      depth2img(res["depth"].reshape(h, w).cpu().numpy()))
        if lead:
            print(line, flush=True)

    out = {"psnr": psnrs, "ms": [t * 1e3 for t in times],
           "mean_fps": 1.0 / float(np.mean(times))}
    if psnrs:
        out["mean_psnr"] = float(np.mean(psnrs))
        if lead:
            print(f"mean PSNR: {out['mean_psnr']:.2f} dB")
    if lead:
        print(f"mean FPS: {out['mean_fps']:.2f}")

    if extra.mesh and lead:
        from .utils.mesh import extract_mesh
        system.synchronize()
        t0 = time.perf_counter()
        verts, _ = extract_mesh(
            system.model, resolution=extra.mesh_resolution,
            sigma_threshold=extra.sigma_threshold, out_path=extra.mesh)
        out["mesh_seconds"] = time.perf_counter() - t0
        out["mesh_vertices"] = len(verts)
        print(f"mesh: {len(verts)} vertices -> {extra.mesh}")
    return out


if __name__ == "__main__":
    main()
