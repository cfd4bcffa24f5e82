"""Train the reference (JAX) trainer on the cli phase's recipe from several
seeds on the CPU and print each seed's test PSNR: the witness for the
spread that ``tools/seed_sweep.py`` measures on the port.

    JAX_PLATFORMS=cpu python3 tools/seed_sweep_jax.py [--wh 200] \
        [--steps 600] [--seeds 1337 0 1 2] [--exact_march]

The hyperparameters are the reference's ``get_opts`` of ``chip_smoke.py``'s
CLI_ARGS with ``--seed S`` last, as the command line gives them: the seed
draws the field and the ray batches, as the reference's ``main`` does
(``mfnerf_tpu/train.py:646-653``). The scene is the cli phase's
(``make_scene(n_train=16, n_test=2, seed=0)``) at ``--wh`` pixels a side;
the 800x800 scene is too large for a CPU run. One JSON line a seed: the
occupied fraction of the grid after training, the train PSNR and samples
a ray of the last step, and the test views' PSNR and SSIM.

``--exact_march`` marches every ray as the port does: the reference's
render module is told that no two-level stratum exists (so it takes its
exact ``march_rays_train``, and ``render_test`` its exact march), and
``--s_flat 0`` keeps every marched sample. The package's files are not
changed. This script drives the JAX package only; ``tools/seed_sweep.py``
is its counterpart on the port.
"""
import argparse
import contextlib
import io
import json
import os
import re
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# chip_smoke.py's CLI_ARGS (chip_smoke.py imports torch)
CLI_ARGS = ("--dataset_name", "nsvf", "--exp_name", "cli", "--grid",
            "LowRank", "--lr_k_max", "256", "--num_epochs", "1",
            "--steps_per_epoch", "600", "--batch_size", "8192", "--lr", "1e-2")
N_TRAIN_VIEWS, N_TEST_VIEWS, SCENE_SEED = 16, 2, 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--wh", type=int, default=200)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1337, 0, 1, 2])
    ap.add_argument("--exact_march", action="store_true")
    args = ap.parse_args()
    import jax
    if args.exact_march:
        from mfnerf_tpu.models import rendering
        rendering.twolevel_stratum = lambda *a, **k: (0, 0)
    from mfnerf_tpu.datasets.memory import MemoryDataset
    from mfnerf_tpu.opt import get_opts
    from mfnerf_tpu.train import NeRFSystem
    from mfnerf_tpu.utils.procedural import make_scene
    scene = make_scene(n_train=N_TRAIN_VIEWS, n_test=N_TEST_VIEWS,
                       wh=args.wh, seed=SCENE_SEED)
    for seed in args.seeds:
        hp = get_opts(["--root_dir", "<memory>", *CLI_ARGS,
                       "--steps_per_epoch", str(args.steps),
                       "--seed", str(seed), "--no_save_test"]
                      + (["--s_flat", "0"] if args.exact_march else []))
        system = NeRFSystem(hp)
        system.setup(MemoryDataset.from_scene(scene, "train"),
                     MemoryDataset.from_scene(scene, "test"))
        system.configure(jax.random.PRNGKey(seed))
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            seconds = system.fit()
            val = system.validate()
        last = re.findall(r"^step .* psnr ([0-9.]+) rm_s ([0-9.]+) "
                          r"vr_s ([0-9.]+)", log.getvalue(), re.M)[-1]
        bits = np.asarray(jax.device_get(system.occ.density_bitfield))
        print(json.dumps({
            "backend": "jax", "device": "cpu", "wh": args.wh,
            "seed": seed, "steps": args.steps,
            "exact_march": args.exact_march,
            "occupied_end": float(np.unpackbits(bits).mean()),
            "train_psnr_last_step": float(last[0]), "rm_s": float(last[1]),
            "vr_s": float(last[2]),
            "test_psnr": float(val["test/psnr"]),
            "test_ssim": float(val["test/ssim"]),
            "fit_s": seconds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
