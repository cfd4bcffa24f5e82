"""Train the reference (JAX) trainer on the cli phase's recipe from several
seeds on the CPU and print each seed's test PSNR: the witness for the
spread that ``tools/seed_sweep.py`` measures on the port.

    JAX_PLATFORMS=cpu python3 tools/seed_sweep_jax.py [--wh 200] \
        [--steps 600] [--seeds 1337 0 1 2] [--exact_march] \
        [--spread 5 --scale 4] [--colmap_root DIR] [--port_init S] \
        [--hdr] [--perturb 0.03] [--save_init DIR] [--extra --flag value ...]

The hyperparameters are the reference's ``get_opts`` of ``chip_smoke.py``'s
CLI_ARGS with ``--seed S`` last, as the command line gives them: the seed
draws the field and the ray batches, as the reference's ``main`` does
(``mfnerf_tpu/train.py:646-653``). The scene is the cli phase's
(``make_scene(n_train=16, n_test=2, seed=0)``) at ``--wh`` pixels a side;
the 800x800 scene is too large for a CPU run. ``--spread`` scales the
scene (``make_scene(spread=...)``: the spheres and the camera ring, on a
black background) and ``--scale`` is the command line's: at ``--scale 4``
the reference marches four cascades with exponential steps (its
``march_rays_train_cascades``). ``--colmap_root`` trains on a COLMAP
scene there instead (``--dataset_name colmap``: the eroding refresh), as
``tools/seed_sweep.py --data colmap`` writes it; write it with
``mfnerf_tpu_torch.utils.procedural.write_colmap_scene(DIR,
make_scene(n_train=16, n_test=3, wh=200, seed=0, spread=5), spread=5)``.
One JSON line a seed: the occupied fraction of the grid after training,
the train PSNR and samples a ray of the last step, and the test views'
PSNR and SSIM.

``--port_init S`` starts every seed from the port's initial weights of
seed S (``mfnerf_tpu_torch``'s ``NeRFSystem.configure(S)`` draws them
from a CPU generator, so the card's run of ``tools/seed_sweep.py`` starts
from the same ones), loaded by ``--weight_path``: the seed then draws
only the ray batches and the jitter.

``--hdr`` trains with ``--use_exposure`` on the scene written in
HDR-NeRF's synthetic layout (``write_hdr_scene`` under
``HDR-NeRF/syndata/luckycat``: 18 train poses at exposures 2, 0.5 and
0.125, 17 test poses at 1 and 0.25, ``--wh`` and ``--spread`` as above),
loaded by the COLMAP loader, and also prints each test exposure's mean
PSNR. ``--perturb SIGMA`` shifts the training poses (``perturb_poses``:
axis-angle and translation N(0, SIGMA^2)), trains with ``--optimize_ext``
and prints the gauge-corrected camera-centre error before and after
(``gauge_center_error``; the refined centre is the perturbed one plus
``dT``). ``--extra`` appends command-line flags (``--pose_lr 2e-3``,
``--batch_size 2048``) to every seed's. The port's counterparts are
``tools/seed_sweep.py --data hdr`` and ``--perturb``. ``--save_init DIR``
writes each seed's initial parameters to ``DIR/init_<seed>.npz`` and
trains nothing: ``tools/seed_sweep.py --extra --weight_path
DIR/init_<seed>.npz`` then starts the port from them (the counterpart of
``--port_init``).

``--exact_march`` marches every ray as the port does: the reference's
render module is told that no two-level or cascade stratum exists (so it
takes its exact ``march_rays_train``, and ``render_test`` its exact
march), and ``--s_flat 0`` keeps every marched sample. The package's
files are not changed. This script drives the JAX package only;
``tools/seed_sweep.py`` is its counterpart on the port.
"""
import argparse
import contextlib
import io
import json
import os
import re
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# chip_smoke.py's CLI_ARGS (chip_smoke.py imports torch)
CLI_ARGS = ("--dataset_name", "nsvf", "--exp_name", "cli", "--grid",
            "LowRank", "--lr_k_max", "256", "--num_epochs", "1",
            "--steps_per_epoch", "600", "--batch_size", "8192", "--lr", "1e-2")
N_TRAIN_VIEWS, N_TEST_VIEWS, SCENE_SEED = 16, 2, 0


def port_weights(argv, seed, path):
    """Write the port's initial weights of ``seed`` for ``argv`` to
    ``path`` (its ``NeRFSystem.configure``)."""
    import torch
    from mfnerf_tpu_torch.models.ngp import NGP
    from mfnerf_tpu_torch.opt import get_opts
    from mfnerf_tpu_torch.train import NeRFSystem
    from mfnerf_tpu_torch.utils.ckpt import params_to_numpy, save_ckpt
    cfg = NeRFSystem(get_opts(argv), device="cpu").model_cfg
    model = NGP(cfg, torch.Generator().manual_seed(seed), device="cpu")
    save_ckpt(path, params_to_numpy(model))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--wh", type=int, default=200)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1337, 0, 1, 2])
    ap.add_argument("--exact_march", action="store_true")
    ap.add_argument("--spread", type=float, default=1.0)
    ap.add_argument("--scale", type=float, default=0.5)
    ap.add_argument("--colmap_root", default=None)
    ap.add_argument("--port_init", type=int, default=None)
    ap.add_argument("--hdr", action="store_true")
    ap.add_argument("--perturb", type=float, default=None)
    ap.add_argument("--save_init", default=None)
    ap.add_argument("--extra", nargs=argparse.REMAINDER, default=[])
    args = ap.parse_args()
    import jax
    if args.exact_march:
        from mfnerf_tpu.models import rendering
        rendering.twolevel_stratum = lambda *a, **k: (0, 0)
        rendering.cascades_stratum = lambda *a, **k: (0, 0)
    from mfnerf_tpu.datasets.colmap import ColmapDataset
    from mfnerf_tpu.datasets.memory import MemoryDataset
    from mfnerf_tpu.opt import get_opts
    from mfnerf_tpu.train import NeRFSystem
    from mfnerf_tpu.utils.procedural import make_scene
    tmp = tempfile.TemporaryDirectory()
    if args.hdr:
        from mfnerf_tpu_torch.utils.procedural import (HDR_TEST, HDR_TRAIN,
                                                       write_hdr_scene)
        args.colmap_root = os.path.join(tmp.name, "HDR-NeRF", "syndata",
                                        "luckycat")
        write_hdr_scene(args.colmap_root, make_scene(
            n_train=HDR_TRAIN[0], n_test=HDR_TEST[0], wh=args.wh,
            seed=SCENE_SEED, spread=args.spread), spread=args.spread)
    if args.colmap_root:
        with contextlib.redirect_stdout(io.StringIO()):
            datasets = [ColmapDataset(args.colmap_root, split)
                        for split in ("train", "test")]
    else:
        scene = make_scene(n_train=N_TRAIN_VIEWS, n_test=N_TEST_VIEWS,
                           wh=args.wh, seed=SCENE_SEED, spread=args.spread)
        datasets = [MemoryDataset.from_scene(scene, split)
                    for split in ("train", "test")]
    if args.perturb is not None:
        from mfnerf_tpu_torch.utils.procedural import (gauge_center_error,
                                                       perturb_poses)
        true_centers = datasets[0].poses[:, :, 3].copy()
        datasets[0].poses = perturb_poses(datasets[0].poses, args.perturb)[0]
    flags = ([*CLI_ARGS, "--steps_per_epoch", str(args.steps), "--scale",
              str(args.scale), "--no_save_test"]
             + (["--s_flat", "0"] if args.exact_march else [])
             + (["--dataset_name", "colmap"] if args.colmap_root else [])
             + (["--use_exposure"] if args.hdr else [])
             + (["--optimize_ext"] if args.perturb is not None else [])
             + args.extra)
    if args.port_init is not None:
        path = os.path.join(tmp.name, "port_init.ckpt.npz")
        port_weights(["--root_dir", "<memory>", *flags], args.port_init,
                     path)
        flags += ["--weight_path", path]
    for seed in args.seeds:
        hp = get_opts(["--root_dir", "<memory>", *flags, "--seed",
                       str(seed)])
        system = NeRFSystem(hp)
        system.setup(*datasets)
        system.configure(jax.random.PRNGKey(seed))
        if args.save_init:
            from mfnerf_tpu.utils.ckpt import save_ckpt
            save_ckpt(os.path.join(args.save_init, f"init_{seed}.npz"),
                      system.params)
            continue
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            seconds = system.fit()
            val = system.validate()
        last = re.findall(r"^step .* psnr ([0-9.]+) rm_s ([0-9.]+) "
                          r"vr_s ([0-9.]+)", log.getvalue(), re.M)[-1]
        bits = np.asarray(jax.device_get(system.occ.density_bitfield))
        extra = {}
        if args.hdr:
            psnrs = [float(v) for v in re.findall(
                r"^val image .*psnr=([0-9.]+)", log.getvalue(), re.M)]
            exposures = [float(datasets[1][i]["exposure"])
                         for i in range(len(psnrs))]
            extra["psnr_by_exposure"] = {
                str(e): float(np.mean([p for p, e_ in zip(psnrs, exposures)
                                       if e_ == e]))
                for e in sorted(set(exposures), reverse=True)}
            extra["unit_exposure_rgb"] = np.asarray(
                system.model.log_radiance_to_rgb(
                    system.params, np.zeros((1, 3), np.float32),
                    exposure=np.ones((1, 1), np.float32)))[0].tolist()
        if args.perturb is not None:
            pert = datasets[0].poses[:, :, 3]
            extra["center_err_before"] = gauge_center_error(pert,
                                                            true_centers)
            extra["center_err_after"] = gauge_center_error(
                pert + np.asarray(system.params["dT"]), true_centers)
        print(json.dumps({
            "backend": "jax", "device": "cpu", "wh": args.wh,
            "seed": seed, "steps": args.steps,
            "exact_march": args.exact_march,
            "spread": args.spread, "scale": args.scale,
            "colmap_root": args.colmap_root, "port_init": args.port_init,
            "hdr": args.hdr, "perturb": args.perturb, "extra": args.extra,
            "occupied_end": float(np.unpackbits(bits).mean()),
            "train_psnr_last_step": float(last[0]), "rm_s": float(last[1]),
            "vr_s": float(last[2]),
            "test_psnr": float(val["test/psnr"]),
            "test_ssim": float(val["test/ssim"]),
            "fit_s": seconds, **extra}), flush=True)
    tmp.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
