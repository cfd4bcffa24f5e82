"""Train the JAX trainer or the port on a small multi-cascade COLMAP scene
on the CPU and render train views as well as the test views: whether the
gap between a training batch's PSNR and a rendered view's is the
reference's own.

    JAX_PLATFORMS=cpu python3 tools/colmap_gap_cpu.py --backend jax|torch \
        [--seeds 0 1 2] [--steps 300] [--train_views 3] [--init_from S] \
        [--extra --flag value ...]

The scene is ``chip_smoke.py``'s COLMAP scene at 64x64
(``make_scene(n_train=16, n_test=3, wh=64, seed=0, spread=5)`` written by
``write_colmap_scene``, black background), trained at ``--scale 8`` (five
cascades: the cascade march, the eroding refresh) with a small LowRank
field (4 levels, rank 8, K 64, grid 32, rgb 32), batch 2048, lr 1e-2;
``--extra`` appends command-line flags (``--random_bg``, another grid).
Each package loads the scene with its own COLMAP loader, trains through
``NeRFSystem.fit`` and renders through ``validate`` (T 1e-4): the test
views, then the first ``--train_views`` train views. One JSON line a
seed: the last step's batch PSNR, rm_s and vr_s, the test views' PSNR and
the train views' PSNR. The port runs on the CPU; neither needs a card.

``--init_from S`` starts the trainer from the other package's initial
weights of seed S (its ``NeRFSystem.configure``, written as a checkpoint
for ``--weight_path``); ``--seeds`` then draw only the ray batches and
the jitter. A seed that trains badly in both packages from the same
weights owes it to the draw of the weights, not to either trainer.
"""
import argparse
import contextlib
import io
import json
import os
import re
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ARGS = ("--dataset_name", "colmap", "--exp_name", "gap", "--scale", "8",
        "--grid", "LowRank", "--lr_levels", "4", "--lr_rank", "8",
        "--lr_k_max", "64", "--grid_size", "32", "--batch_size", "2048",
        "--lr", "1e-2", "--num_epochs", "1", "--rgb_channels", "32",
        "--no_save_test")


def init_ckpt(backend, root, seed, extra, path):
    """Write ``backend``'s initial weights of ``seed`` to ``path``."""
    argv = ["--root_dir", root, *ARGS, *extra]
    if backend == "jax":
        import jax
        from mfnerf_tpu.datasets import dataset_dict
        from mfnerf_tpu.opt import get_opts
        from mfnerf_tpu.train import NeRFSystem
        from mfnerf_tpu.utils.ckpt import save_ckpt
        system = NeRFSystem(get_opts(argv))
        key = jax.random.PRNGKey(seed)
    else:
        from mfnerf_tpu_torch.datasets import dataset_dict
        from mfnerf_tpu_torch.opt import get_opts
        from mfnerf_tpu_torch.train import NeRFSystem
        from mfnerf_tpu_torch.utils.ckpt import params_to_numpy, save_ckpt
        system = NeRFSystem(get_opts(argv), device="cpu")
        key = seed
    with contextlib.redirect_stdout(io.StringIO()):
        system.setup(*(dataset_dict["colmap"](root, split=split)
                       for split in ("train", "test")))
    system.configure(key)
    save_ckpt(path, system.params if backend == "jax"
              else params_to_numpy(system.model))


def run(backend, root, seed, steps, n_views, extra):
    argv = ["--root_dir", root, *ARGS, "--steps_per_epoch", str(steps),
            "--seed", str(seed), *extra]
    if backend == "jax":
        import jax
        from mfnerf_tpu.datasets import dataset_dict
        from mfnerf_tpu.opt import get_opts
        from mfnerf_tpu.train import NeRFSystem
        system = NeRFSystem(get_opts(argv))
        configure = (jax.random.PRNGKey(seed),)
    else:
        import torch
        from mfnerf_tpu_torch.datasets import dataset_dict
        from mfnerf_tpu_torch.opt import get_opts
        from mfnerf_tpu_torch.train import NeRFSystem
        torch.set_num_threads(4)
        system = NeRFSystem(get_opts(argv), device="cpu")
        configure = (seed,)
    with contextlib.redirect_stdout(io.StringIO()):
        train, test, views = (dataset_dict["colmap"](root, split=split)
                              for split in ("train", "test", "test"))
    views.poses, views.rays = train.poses[:n_views], train.rays[:n_views]
    system.setup(train, test)
    system.configure(*configure)
    log = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(log):
        metrics = system.fit()
        val = system.validate()
        system.test_dataset = views
        val_train = system.validate()
    if backend == "jax":    # its fit prints the step lines
        last = [float(v) for v in re.findall(
            r"^step .* psnr ([0-9.]+) rm_s ([0-9.]+) vr_s ([0-9.]+)",
            log.getvalue(), re.M)[-1]]
    else:                   # its fit returns each step's metrics
        last = [float(metrics[key][-1]) for key in ("psnr", "rm_s", "vr_s")]
    return dict(backend=backend, seed=seed, steps=steps, extra=extra,
                train_psnr_last_step=last[0], rm_s=last[1],
                vr_s=last[2], test_psnr=val["test/psnr"],
                train_view_psnr=val_train["test/psnr"], train_views=n_views,
                seconds=time.time() - t0)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("jax", "torch"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--train_views", type=int, default=3)
    ap.add_argument("--init_from", type=int, default=None)
    ap.add_argument("--extra", nargs=argparse.REMAINDER, default=[])
    args = ap.parse_args()
    from mfnerf_tpu_torch.utils.procedural import (make_scene,
                                                   write_colmap_scene)
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "spheres")
        write_colmap_scene(root, make_scene(n_train=16, n_test=3, wh=64,
                                            seed=0, spread=5.0), spread=5.0)
        extra = list(args.extra)
        if args.init_from is not None:
            path = os.path.join(tmp, "init.ckpt.npz")
            init_ckpt("torch" if args.backend == "jax" else "jax", root,
                      args.init_from, extra, path)
            extra += ["--weight_path", path]
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            for seed in args.seeds:
                row = run(args.backend, root, seed, args.steps,
                          args.train_views, extra)
                print(json.dumps(dict(row, init_from=args.init_from)),
                      flush=True)
        finally:
            os.chdir(cwd)
    return 0


if __name__ == "__main__":
    sys.exit(main())
