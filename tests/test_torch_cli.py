"""The port's command line, checkpoints and SSIM against the JAX package, on
the CPU.

* ``get_opts``: the port's Namespace equals the JAX one (``vars()``) for
  the default argv, the flag sets of ``benchmarking/benchmark_*.sh`` and
  the README's command line.
* ``ssim``: within 1e-6 of the JAX ``ssim`` on textured images (the same
  float32 windows; the sums run in another order), 5e-5 where half the
  image is flat white (the variances cancel there; test_ssim_matches_jax).
* Checkpoints cross backends. A port checkpoint fills the JAX
  ``load_ckpt(like=...)`` templates, and the JAX ``render_test_dense`` of
  what it loaded gives the port's frame (the render oracle's tolerances,
  tests/test_torch_render.py: rgb and opacity 2e-4, well inside 2e-3). A
  JAX checkpoint drives the port's ``main(--val_only)`` to the PSNR of the
  JAX oracle's frame within 1e-4 dB. The JAX oracle runs op by op
  (``jax.disable_jit``, as in tests/test_torch_render.py), which is slow:
  these renders take 64 and 144 rays.
* ``--weight_path`` loads what matches and raises on a shape mismatch;
  ``--ckpt_path`` resumes the step, the learning rate and the Adam state.
* ``main`` on a 32x32 NSVF scene writes the checkpoints and the result
  PNGs and prints ``test/psnr`` and ``test/ssim``, for a LowRank and a
  Hash field; the flags the port has not ported raise.

Every ``main`` runs with ``device="cpu"`` in a temporary working directory
(``monkeypatch.chdir``): it writes ``ckpts/``, ``logs/`` and ``results/``
there.
"""
import dataclasses
import glob
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfnerf_tpu import opt as jopt
from mfnerf_tpu.datasets.nsvf import NSVFDataset as JNSVF
from mfnerf_tpu.datasets.ray_utils import get_rays as jget_rays
from mfnerf_tpu.models import ngp as jngp
from mfnerf_tpu.models import rendering as jrendering
from mfnerf_tpu.utils import ckpt as jckpt
from mfnerf_tpu.utils import metrics as jmetrics

from mfnerf_tpu_torch import opt as topt
from mfnerf_tpu_torch import train as ttrain
from mfnerf_tpu_torch.datasets.ray_utils import get_rays
from mfnerf_tpu_torch.models import ngp as tngp
from mfnerf_tpu_torch.models import rendering as trendering
from mfnerf_tpu_torch.utils import ckpt as tckpt
from mfnerf_tpu_torch.utils import metrics as tmetrics
from mfnerf_tpu_torch.utils.procedural import make_scene, write_nsvf_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE_DIR = os.path.join("Synthetic_NeRF_proc", "Spheres")
# a small LowRank model; the unfused encoder (fp32 hat matmuls) where the
# port is held to the JAX renderer's frame
SMALL = ["--lr_levels", "2", "--lr_rank", "8", "--lr_k_max", "32",
         "--grid_size", "16", "--max_samples", "128", "--s_max_train", "16",
         "--s_max_test", "32", "--rgb_channels", "16", "--rgb_layers", "1",
         "--batch_size", "256", "--downsample", "0.04"]
HASH = ["--grid", "Hash", "--L", "4", "--T", "10", "--N_max", "64"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_scene(root, n_train=4, n_test=2, wh=32, seed=0):
    """A wh x wh procedural scene in the NSVF layout, its focal stored for
    800x800 (Synthetic_* intrinsics are read at 800 x downsample, so
    ``--downsample wh/800`` gives back the scene's cameras)."""
    scene = make_scene(n_train=n_train, n_test=n_test, wh=wh, seed=seed)
    disk = dict(scene, K=scene["K"] * np.float32([[800 / wh], [800 / wh],
                                                  [1]]))
    write_nsvf_scene(root, disk)
    return scene


@pytest.fixture
def cli_dir(tmp_path, monkeypatch):
    """A working directory holding a 32x32 scene under SCENE_DIR."""
    _write_scene(str(tmp_path / SCENE_DIR))
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _argv(*extra):
    return ["--root_dir", SCENE_DIR, "--exp_name", "t", "--grid", "LowRank",
            "--num_epochs", "1", "--steps_per_epoch", "8", *SMALL, *extra]


def _main(argv):
    return ttrain.main(topt.get_opts(argv), device="cpu")


# ------------------------------------------------------------- get_opts
def _script_argvs():
    """{script: argv} of each benchmarking/benchmark_*.sh train.py command,
    its shell variables given fixed values."""
    subs = [('${SCALE[$SCENE]}', "4.0"), ('$(basename "$SCENE")', "Lego"),
            ("$ROOT_DIR", "/data"), ("${T}", "20"), ("$T", "20"),
            ("$SCENE", "Lego"), ('"$@"', "")]
    out = {}
    for path in sorted(glob.glob(os.path.join(REPO, "benchmarking",
                                              "benchmark_*.sh"))):
        text = open(path).read()
        m = re.search(r"python train\.py((?:.*\\\n)*.*)", text)
        if m is None:
            continue
        cmd = m.group(1).replace("\\\n", " ")
        for old, new in subs:
            cmd = cmd.replace(old, new)
        out[os.path.basename(path)] = cmd.replace('"', "").split()
    return out


SCRIPTS = _script_argvs()
OPT_CASES = {
    "default": ["--root_dir", "/data/Lego"],
    "readme": ["--root_dir", "/data/Lego", "--dataset_name", "nsvf",
               "--exp_name", "cli", "--grid", "LowRank", "--lr_k_max", "256",
               "--num_epochs", "1", "--steps_per_epoch", "600",
               "--batch_size", "8192", "--lr", "1e-2"],
    "tpu_flags": ["--root_dir", "x", "--no-refresh_half", "--s_flat", "0",
                  "--pool_a", "0", "--wavefront", "none", "--multihost",
                  "--lr_fused", "0", "--hash_grad_samples", "1"],
    **SCRIPTS}


def test_benchmark_scripts_were_found():
    assert len(SCRIPTS) >= 8, sorted(SCRIPTS)
    assert "benchmark_synthetic_nerf_mf.sh" in SCRIPTS


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_get_opts_matches_jax(case):
    argv = OPT_CASES[case]
    got, want = vars(topt.get_opts(argv)), vars(jopt.get_opts(argv))
    assert got == want
    assert len(got) == 52


# ------------------------------------------------------------------ ssim
@pytest.mark.parametrize("shape,noise,white,tol", [
    ((32, 32, 3), 0.1, False, 1e-6), ((40, 24, 3), 0.02, False, 1e-6),
    ((11, 11, 3), 0.3, False, 1e-6), ((64, 48, 3), 0.0, False, 1e-6),
    ((32, 32, 3), 0.1, True, 5e-5), ((64, 48, 3), 0.01, True, 5e-5),
    ((64, 48, 3), 0.001, True, 5e-5)])
def test_ssim_matches_jax(shape, noise, white, tol):
    """1e-6 on textured images. Where half the image is flat white, as a
    synthetic scene's background is, E[x^2] - E[x]^2 cancels in float32
    against c2 = 9e-4: both packages then lie 1e-5 to 4e-5 from a float64
    evaluation of the same formula, and the order of their 121-term window
    sums shows. 5e-5 there."""
    rng = np.random.default_rng(int(noise * 100) + shape[0])
    a = rng.random(shape, dtype=np.float32)
    if white:
        a[: shape[0] // 2] = 1.0
    b = np.clip(a + rng.normal(0, noise, shape), 0, 1).astype(np.float32)
    got = float(tmetrics.ssim(torch.from_numpy(a), torch.from_numpy(b)))
    want = float(jmetrics.ssim(jnp.asarray(a), jnp.asarray(b)))
    assert abs(got - want) <= tol, (got, want)
    assert got <= 1.0


# ---------------------------------------------------------- checkpoints
def _port_state(grid, seed=0):
    """A port field drawn from ``seed`` and an occupancy grid from one
    dense refresh, on the CPU, with its NGPConfig keyword arguments."""
    kw = (dict(grid="LowRank", lr_levels=2, lr_rank=8, lr_k_max=32,
               lr_fused=False) if grid == "LowRank" else
          dict(grid="Hash", L=4, log2_T=10, N_max=64))
    kw.update(grid_size=16, rgb_channels=16, rgb_layers=1)
    cfg = tngp.NGPConfig(**kw)
    g = torch.Generator().manual_seed(seed)
    model = tngp.NGP(cfg, g, device="cpu")
    occ = model.update_density_grid(
        tngp.OccupancyState.create(cfg, "cpu"), 0.5,
        torch.rand((cfg.cascades, cfg.n_cells, 3), generator=g) * 2 - 1)
    occ.count_grid = torch.rand(occ.density_grid.shape, generator=g)
    return model, occ, kw


def _save_port(tmp_path, grid):
    """A port field, its occupancy and one Adam step, saved as a full and a
    slim checkpoint; (model, occ, NGPConfig keywords, full path)."""
    model, occ, kw = _port_state(grid)
    path = str(tmp_path / "port.ckpt.npz")
    opt = torch.optim.Adam(model.parameters(), lr=1e-2, eps=1e-15)
    model.density(torch.rand(64, 3) - 0.5).sum().backward()
    opt.step()
    tckpt.save_ckpt(path, tckpt.params_to_numpy(model),
                    occ=tckpt.occupancy_to_numpy(occ),
                    opt_state=tckpt.adam_state_to_numpy(opt, model), step=5)
    tckpt.slim_ckpt(path, str(tmp_path / "slim.npz"))
    return model, occ, kw, path


def _jax_load(path, kw):
    """The JAX package's load of ``path`` into its own templates."""
    jcfg = jngp.NGPConfig(**kw)
    jmodel = jngp.NGP(jcfg)
    loaded = jckpt.load_ckpt(path, like={
        "params": jmodel.init(jax.random.PRNGKey(1)),
        "occ": jngp.OccupancyState.create(jcfg)})
    return jmodel, loaded["params"], loaded["occ"].refresh_coarse(jcfg), \
        loaded["step"]


@pytest.mark.parametrize("grid", ["LowRank", "Hash"])
def test_port_checkpoint_loads_in_jax(tmp_path, grid):
    model, occ, kw, path = _save_port(tmp_path, grid)
    _, params, jocc, step = _jax_load(path, kw)
    assert step == 5
    for k, v in tckpt.params_to_numpy(model).items():
        leaf = params
        for part in k.split("/"):
            leaf = leaf[int(part) if isinstance(leaf, list) else part]
        np.testing.assert_array_equal(np.asarray(leaf), v, err_msg=k)
    for name in ("density_grid", "density_bitfield", "count_grid"):
        np.testing.assert_array_equal(np.asarray(getattr(jocc, name)),
                                      getattr(occ, name).numpy())
    slim = jckpt.load_ckpt(str(tmp_path / "slim.npz"))
    assert sorted(slim["occ"]) == ["density_bitfield"]
    assert "opt_state" not in slim and slim["step"] == 5


def test_port_checkpoint_renders_the_same_in_jax(tmp_path):
    """64 rays through the JAX oracle (op by op) on what the JAX package
    loaded from a port checkpoint, against the port's frame."""
    model, occ, kw, path = _save_port(tmp_path, "LowRank")
    jmodel, params, jocc, _ = _jax_load(path, kw)
    rng = np.random.default_rng(2)
    n = 64
    rays_o = np.tile(np.float32([[0.0, 0.0, -1.4]]), (n, 1))
    d = rng.normal(size=(n, 3)).astype(np.float32) * np.float32(
        [0.3, 0.3, 0.0]) + np.float32([0.0, 0.0, 1.0])
    rays_d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(
        np.float32)
    rcfg = dict(T_threshold=1e-4, s_max_test=64, max_samples=64)
    with jax.disable_jit():
        want = jrendering.render_test_dense(
            jmodel, params, jocc, jnp.asarray(rays_o), jnp.asarray(rays_d),
            jrendering.RenderConfig(**rcfg))
    got = trendering.render_test_dense(
        model, occ, torch.from_numpy(rays_o), torch.from_numpy(rays_d),
        trendering.RenderConfig(**rcfg))
    assert float(np.asarray(want["opacity"]).max()) > 0.1
    for key in ("rgb", "opacity"):
        np.testing.assert_allclose(got[key].detach().numpy(),
                                   np.asarray(want[key]), atol=2e-4)


def test_jax_checkpoint_drives_val_only(tmp_path, monkeypatch, capsys):
    """A JAX field and occupancy grid, saved by the JAX package, validated
    by the port's main on a 12x12 scene's test view (144 rays: the JAX
    oracle runs op by op; SSIM's 11x11 windows need 11 pixels)."""
    _write_scene(str(tmp_path / SCENE_DIR), n_train=2, n_test=1, wh=12)
    monkeypatch.chdir(tmp_path)
    budget = ["--downsample", "0.015", "--s_max_test", "64", "--max_samples",
              "64", "--lr_fused", "0"]
    hp_argv = _argv(*budget)
    hp = jopt.get_opts(hp_argv)
    jcfg = jngp.NGPConfig(grid="LowRank", lr_levels=hp.lr_levels,
                          lr_rank=hp.lr_rank, lr_k_max=hp.lr_k_max,
                          lr_fused=False, grid_size=hp.grid_size,
                          rgb_channels=hp.rgb_channels,
                          rgb_layers=hp.rgb_layers)
    jmodel = jngp.NGP(jcfg)
    params = jmodel.init(jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)
    grid = rng.random((1, jcfg.n_cells), np.float32) * 10
    bits = rng.integers(0, 256, jcfg.n_cells // 8, dtype=np.uint8) & 0x77
    occ = dataclasses.replace(jngp.OccupancyState.create(jcfg),
                              density_grid=jnp.asarray(grid),
                              density_bitfield=jnp.asarray(bits))
    path = str(tmp_path / "jax.ckpt.npz")
    jckpt.save_ckpt(path, params, occ=occ, step=11)

    ds = JNSVF(SCENE_DIR, split="test", downsample=hp.downsample)
    assert ds.img_wh == (12, 12) and len(ds.poses) == 1
    ro, rd = jget_rays(jnp.asarray(ds.directions), jnp.asarray(ds.poses[0]))
    with jax.disable_jit():
        out = jrendering.render_test_dense(
            jmodel, params, occ, ro, rd, jrendering.RenderConfig(
                s_max_test=hp.s_max_test, max_samples=hp.max_samples))
    assert float(np.asarray(out["opacity"]).max()) > 0.1
    want = float(jmetrics.psnr(out["rgb"], jnp.asarray(ds.rays[0])))

    got = _main(hp_argv + ["--val_only", "--ckpt_path", path])
    assert abs(got["test/psnr"] - want) <= 1e-4, (got, want)
    assert "test/ssim" in got and "train/ms_per_step" not in got
    assert not os.path.exists(os.path.join("ckpts", "nsvf", "t",
                                           "epoch=0.ckpt.npz"))
    assert "val image 1/1: psnr=" in capsys.readouterr().out


def test_val_only_needs_a_checkpoint(cli_dir):
    with pytest.raises(ValueError, match="ckpt_path"):
        _main(_argv("--val_only"))


def _weights(tmp_path, **kw):
    """A checkpoint of a field of the SMALL configuration (changed by
    ``kw``), drawn from seed 7; its params section."""
    hp = topt.get_opts(_argv())
    cfg = dataclasses.replace(
        ttrain.NeRFSystem(hp, device="cpu").model_cfg, **kw)
    model = tngp.NGP(cfg, torch.Generator().manual_seed(7), device="cpu")
    path = str(tmp_path / f"w{len(kw)}.ckpt.npz")
    params = tckpt.params_to_numpy(model)
    tckpt.save_ckpt(path, params)
    return path, params


def test_weight_path_loads_what_matches(cli_dir, tmp_path):
    path, params = _weights(tmp_path)
    system = ttrain.NeRFSystem(topt.get_opts(_argv("--weight_path", path)),
                               device="cpu")
    system.setup()
    system.configure(0)
    for k, v in tckpt.params_to_numpy(system.model).items():
        np.testing.assert_array_equal(v, params[k], err_msg=k)
    # a checkpoint of the MLPs alone: the line tables keep their init
    part = str(tmp_path / "mlp.ckpt.npz")
    tckpt.save_ckpt(part, {k: v for k, v in params.items()
                           if k.startswith(("sigma_mlp", "rgb_mlp"))})
    fresh = ttrain.NeRFSystem(topt.get_opts(_argv()), device="cpu")
    fresh.setup()
    fresh.configure(0)
    warm = ttrain.NeRFSystem(topt.get_opts(_argv("--weight_path", part)),
                             device="cpu")
    warm.setup(fresh.train_dataset, fresh.test_dataset)
    warm.configure(0)
    for k, v in tckpt.params_to_numpy(warm.model).items():
        want = params[k] if k.startswith(("sigma_mlp", "rgb_mlp")) else \
            tckpt.params_to_numpy(fresh.model)[k]
        np.testing.assert_array_equal(v, want, err_msg=k)


def test_weight_path_shape_mismatch_raises(cli_dir, tmp_path):
    path, _ = _weights(tmp_path, rgb_channels=32)
    system = ttrain.NeRFSystem(topt.get_opts(_argv("--weight_path", path)),
                               device="cpu")
    system.setup()
    with pytest.raises(ValueError, match="shape mismatch for params/rgb_mlp"):
        system.configure(0)


def _lr_trace(monkeypatch):
    """Record every fit's learning rates and the system (by wrapping fit)."""
    seen = {"lr": []}
    fit = ttrain.NeRFSystem.fit

    def traced(self, n_steps=None):
        seen["system"] = self
        out = fit(self, n_steps)
        seen["lr"] += out["lr"].tolist()
        return out

    monkeypatch.setattr(ttrain.NeRFSystem, "fit", traced)
    return seen


def test_resume_continues_the_schedule(cli_dir, monkeypatch):
    """20 steps, then --ckpt_path and 20 more, give the learning rates and
    the global step of 40 straight (4 epochs of 10 steps: the staircase
    moves every 10), and the resumed run starts from the saved Adam
    state."""
    args = ["--steps_per_epoch", "10", "--no_save_test"]
    seen = _lr_trace(monkeypatch)
    _main(_argv(*args, "--num_epochs", "4", "--exp_name", "straight"))
    straight, seen["lr"] = seen["lr"], []
    assert seen["system"].global_step == 40 and len(straight) == 40

    _main(_argv(*args, "--num_epochs", "2", "--exp_name", "first"))
    first = seen["system"]
    saved = tckpt.load_ckpt(os.path.join("ckpts", "nsvf", "first",
                                         "epoch=1.ckpt.npz"))
    assert saved["step"] == 20
    seen["lr"] = []
    restored = {}
    restore = ttrain.NeRFSystem.restore

    def spy(self, path, with_optimizer=True):
        restore(self, path, with_optimizer)
        restored.update(tckpt.adam_state_to_numpy(self.optimizer,
                                                  self.model))

    monkeypatch.setattr(ttrain.NeRFSystem, "restore", spy)
    _main(_argv(*args, "--num_epochs", "4", "--exp_name", "resumed",
                "--ckpt_path", os.path.join("ckpts", "nsvf", "first",
                                            "epoch=1.ckpt.npz")))
    assert seen["system"].global_step == 40
    assert seen["lr"] == straight[20:]
    assert len(set(straight)) == 4               # the staircase moved
    want = tckpt.adam_state_to_numpy(first.optimizer, first.model)
    assert sorted(restored) == sorted(want) and len(want) > 0
    for k in want:
        np.testing.assert_array_equal(restored[k], want[k], err_msg=k)


@pytest.mark.parametrize("grid", ["LowRank", "Hash"])
def test_main_writes_checkpoints_and_results(cli_dir, capsys, grid):
    extra = HASH if grid == "Hash" else []
    metrics = _main(_argv(*extra, "--exp_name", grid))
    out = capsys.readouterr().out
    assert re.search(r"^test/psnr: [0-9.]+$", out, re.M)
    assert re.search(r"^test/ssim: [0-9.]+$", out, re.M)
    assert set(metrics) == {"test/psnr", "test/ssim", "train/ms_per_step"}
    assert all(np.isfinite(v) for v in metrics.values())
    ckpt_dir = os.path.join("ckpts", "nsvf", grid)
    assert sorted(os.listdir(ckpt_dir)) == ["epoch=0.ckpt.npz",
                                            "epoch=0_slim.ckpt.npz"]
    full = tckpt.load_ckpt(os.path.join(ckpt_dir, "epoch=0.ckpt.npz"))
    assert full["step"] == 8
    assert sorted(full["occ"]) == ["count_grid", "density_bitfield",
                                   "density_grid"]
    assert len(full["opt_state"]) == 3 * len(full["params"])
    assert sorted(os.listdir(os.path.join("results", "nsvf", grid))) == [
        "000.png", "000_d.png", "001.png", "001_d.png"]


@pytest.mark.parametrize("flag", [["--use_exposure"], ["--optimize_ext"],
                                  ["--bf16"], ["--num_gpus", "2"],
                                  ["--eval_lpips"], ["--profile"]])
def test_unported_flags_raise(cli_dir, flag):
    with pytest.raises(NotImplementedError, match="not ported"):
        _main(_argv(*flag))


def test_tpu_formulation_flags_are_ignored_with_a_line(cli_dir, capsys):
    _main(_argv("--s_flat", "0", "--pool_a", "0", "--wavefront", "none",
                "--multihost", "--no_save_test"))
    out = capsys.readouterr().out
    assert "--wavefront none: a TPU formulation flag" in out
    assert "--multihost True: a TPU formulation flag" in out
    # the sample budgets are honoured, not reported
    assert "--s_flat" not in out and "--pool_a" not in out
