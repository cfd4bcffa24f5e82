"""Data parallelism in the port (``mfnerf_tpu_torch/parallel/dist.py``,
``--num_gpus``) on the CPU: 2 or 3 ranks, each a process of its own
(``parallel.dist.spawn``: the ``spawn`` context, gloo on a free localhost
port), whose functions are tests/dp_workers.py's. Every spawn ends its
ranks and fails the test after SPAWN_TIMEOUT seconds, so that a hung
collective fails one test instead of stalling the suite.

Tolerances:

* W ranks against one (tests/test_multichip.py's system and rule, the
  JAX package's 8-device mesh against one device): the last step's loss
  rtol 1e-4; the first step's averaged gradients rtol 1e-4 with atol
  1e-5 of the largest value; the runs part at the first step whose
  gradients leave that bound (a ReLU or a refresh's threshold meets a
  last-bit difference of the reduction: ``_check_against_one``), and at
  the step before it of each parameter over 95% of the elements within
  1e-4 + 5e-4 |a| and all within 5e-3. The ranks' parameters and
  bitfields are bitwise equal to each other.
* One step of two ranks against the JAX trainer's step on the whole batch
  (tests/test_torch_train.py's machinery and tolerances: loss 1e-5
  relative, gradients rtol 1e-4 with atol 1e-5 of the largest value),
  before and after ``FLAT_AFTER``; after it the flat budget's cut falls
  inside rank 0, so rank 1 keeps no sample.
* ``render_test_sharded`` against ``render_test``: rgb and opacity 2e-4,
  depth 2e-3 (tests/test_multichip.py; the two group the alive rays'
  rounds differently).
"""
import dataclasses
import os
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfnerf_tpu import train as jtrain
from mfnerf_tpu.models import ngp as jngp
from mfnerf_tpu.models import rendering as jrendering

from mfnerf_tpu_torch import device as tdevice
from mfnerf_tpu_torch import eval as teval
from mfnerf_tpu_torch import train as ttrain
from mfnerf_tpu_torch.datasets.memory import MemoryDataset
from mfnerf_tpu_torch.models import rendering as trendering
from mfnerf_tpu_torch.opt import get_opts
from mfnerf_tpu_torch.parallel import dist as pdist
from mfnerf_tpu_torch.utils.ckpt import params_from_numpy
from mfnerf_tpu_torch.utils.procedural import make_scene, write_nsvf_scene

import dp_workers
from test_torch_train import (SMALL, _JitField, _clear_relu_rays, _close,
                              _jax_pose_step, _jax_trainer_grads,
                              _trainer_batch, _trainer_system)

SPAWN_TIMEOUT = 120         # seconds
N_STEPS = 48                # crosses three occupancy refreshes


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread (the suite runs in several worker processes;
    the ranks set their own)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spawn(fn, world, *args):
    return pdist.spawn(fn, ["cpu"] * world, args, timeout=SPAWN_TIMEOUT)


def _multichip_close(got, want):
    """tests/test_multichip.py:80-95's rule for one parameter."""
    err = np.abs(got - want)
    bad = err > (1e-4 + 5e-4 * np.abs(want))
    assert bad.mean() < 0.05, (bad.mean(), err.max())
    assert err.max() < 5e-3, err.max()


def _grads_close(got, want):
    """One step's averaged gradients against one process's: the trainer
    step's tolerance (rtol 1e-4, atol 1e-5 of the largest value); False
    where a parameter leaves it."""
    return set(got) == set(want) and all(
        np.allclose(g, want[k], rtol=1e-4,
                    atol=1e-5 * float(np.abs(want[k]).max()))
        for k, g in got.items())


def _marginal_flips(got, want):
    """Whether two refreshes' bitfields differ only in cells whose density
    lies within 1e-4 (relative) of its run's threshold, the bitfield's
    min(mean positive density, training threshold)."""
    (dens_g, bits_g), (dens_w, bits_w) = got, want
    differ = np.unpackbits(bits_g, bitorder="little") \
        != np.unpackbits(bits_w, bitorder="little")
    for dens in (dens_g, dens_w):
        d = dens.reshape(-1).astype(np.float64)
        thr = min(d[d > 0].mean(), 0.01 * 1024 / np.sqrt(3))
        if not np.all(np.abs(d[differ] - thr) <= 1e-4 * thr):
            return False
    return True


def _check_against_one(got, one):
    """Rank 0's trace against one process's, step by step.

    The runs part where a last-bit difference of the sharded reduction
    meets a step function: a pre-activation within rounding of zero takes
    the other side of a ReLU (at step 28 of the three-rank LowRank run on
    the CPU: 1.5e-8 in one process, -3.8e-8 on the ranks), or a density
    within rounding of the threshold takes the other side of the refresh's
    packbits. Adam's eps of 1e-15 then turns the differing gradient into
    steps of O(lr), and the parameters drift apart by more than the
    multichip rule allows. So: the first step's averaged gradients are
    held tightly to one process's (a reduction over the wrong count, or a
    rank on the wrong rays, fails here: Adam is nearly scale-free, so a
    wrong count hardly shows in the parameters); the runs part at the
    first step whose gradients leave that tolerance; every refresh up to
    that step leaves the same bitfield but for marginal cells; and the
    parameters after the step before it keep the multichip rule."""
    g, w = got["trace"], one["trace"]
    assert _grads_close(g["grads"][0], w["grads"][0]), \
        "the first step's averaged gradients differ from one process's"
    part = next((s for s in range(len(w["grads"]))
                 if not _grads_close(g["grads"][s], w["grads"][s])),
                len(w["grads"]))
    for step, refresh in w["refresh"].items():
        if step <= part:
            assert _marginal_flips(g["refresh"][step], refresh), step
    assert set(g["params"][part - 1]) == set(w["params"][part - 1])
    for k, v in g["params"][part - 1].items():
        _multichip_close(v, w["params"][part - 1][k])
    return part


@pytest.mark.parametrize("world,grid,batch", [
    pytest.param(2, "LowRank", 256, id="2-LowRank"),
    pytest.param(3, "LowRank", 258, id="3-LowRank"),
    pytest.param(2, "Hash", 256, id="2-Hash-sampled")])
def test_fit_on_ranks_matches_one_rank(world, grid, batch):
    """48 steps of test_multichip's system (LowRank; and the Hash grid with
    hash_grad_samples 2, whose noise rows the ranks draw for the global
    batch) on ``world`` ranks against the same steps in one process: the
    ranks bitwise equal to each other (the parameters and the occupancy
    bitfields that their refreshes left), every rank's metrics and
    validation equal; against one process the last step's loss, the
    marched samples and the validation, and step by step
    :func:`_check_against_one`."""
    kw = {} if grid == "LowRank" else dict(grid="Hash", hash_grad_samples=2)
    hp = dp_workers.multichip_hparams(batch_size=batch, **kw)
    one = dp_workers.fit(0, "cpu", hp, N_STEPS)
    ranks = _spawn(dp_workers.fit, world, hp, N_STEPS)
    assert one["shard"] is None and one["refreshes"] == 3
    assert [r["shard"] for r in ranks] == [
        (i * batch // world, (i + 1) * batch // world) for i in range(world)]
    for r in ranks[1:]:
        for k, v in r["params"].items():
            np.testing.assert_array_equal(v, ranks[0]["params"][k], err_msg=k)
        np.testing.assert_array_equal(r["bitfield"], ranks[0]["bitfield"])
        for k, v in r["metrics"].items():
            np.testing.assert_array_equal(v, ranks[0]["metrics"][k])
        assert r["validate"] == ranks[0]["validate"]
    got = ranks[0]
    np.testing.assert_allclose(got["metrics"]["loss"][-1],
                               one["metrics"]["loss"][-1], rtol=1e-4)
    np.testing.assert_allclose(got["metrics"]["rm_s"],
                               one["metrics"]["rm_s"], rtol=1e-2)
    _check_against_one(got, one)
    for k, v in got["validate"].items():
        np.testing.assert_allclose(v, one["validate"][k], rtol=1e-3)


def test_fit_on_ranks_fails_a_wrong_reduction():
    """The three ranks of test_fit_on_ranks_matches_one_rank[3-LowRank]
    averaging their gradients over two ranks instead of three: the
    step-by-step comparison fails at the first step's gradients."""
    hp = dp_workers.multichip_hparams(batch_size=258)
    one = dp_workers.fit(0, "cpu", hp, 2)
    got = _spawn(dp_workers.fit, 3, hp, 2, 2)[0]
    with pytest.raises(AssertionError, match="first step's averaged"):
        _check_against_one(got, one)


@pytest.mark.parametrize("flat", [False, True], ids=["padded", "flat"])
def test_two_rank_step_matches_jax_step(flat):
    """One step of two ranks, each on its half of the batch, against the
    JAX trainer's step on the whole batch, from the same weights, rays and
    jitter: before FLAT_AFTER (the padded step), and after it with s_flat
    chosen so that the flat budget's cut, the batch's first N * s_flat
    samples in ray order, falls inside rank 0. A rank that cut its own
    shard at (N / 2) * s_flat, or counted from its own first sample, would
    keep other samples and take other gradients. On the same gradients the
    ranks' capture-safe all-reduce (``average_gradients`` given the set the
    flags found) equals the one that reads the flags bit for bit
    (``dp_workers.capture_safe_average``)."""
    bits, poses, dirs, images, img, pix, noise = _trainer_batch()
    flags = "flat" if flat else ""
    cfg = dict(SMALL, grid="LowRank", lr_fused=False, max_samples=256)
    jmodel = jngp.NGP(jngp.NGPConfig(**cfg))
    params = jmodel.init(jax.random.PRNGKey(5))
    jfield = _JitField(jmodel)
    train = MemoryDataset(poses, images, np.eye(3), dirs, (len(dirs), 1))
    system = _trainer_system("LowRank", False, 8, "", params, train)
    system.occ = dataclasses.replace(
        system.occ, density_bitfield=torch.from_numpy(bits)).refresh_coarse(
            system.model_cfg)
    if not flat:
        keep = _clear_relu_rays(system, img, pix, noise)
        assert keep.mean() > 0.9, keep.mean()
        img, pix, noise = img[keep], pix[keep], noise[keep]
    n = len(img) - len(img) % 2
    img, pix = img[:n], pix[:n]
    batch = {"img_idxs": jnp.asarray(img), "pix_idxs": jnp.asarray(pix),
             "rgb": jnp.asarray(images[img, pix, :3])}
    rcfg_t = system.rcfg
    s_flat = 0
    if flat:
        key = jax.random.PRNGKey(3)
        noise = np.asarray(jax.random.uniform(jax.random.split(key, 3)[0],
                                              (n,)))
        with torch.no_grad():       # the samples of each half, unbudgeted
            _, res, _ = system.step_loss(*(torch.from_numpy(np.array(a))
                                           for a in (img, pix, noise)))
        per_ray = res["mask"].sum(dim=1).numpy()
        rank0 = int(per_ray[:n // 2].sum())
        s_flat = (rank0 - 1) // n
        assert s_flat >= 1 and n * s_flat < rank0, (rank0, n)
        rcfg_t = dataclasses.replace(rcfg_t, s_flat=s_flat)
        rcfg_j = _jax_rcfg(rcfg_t)
        occ_j = dataclasses.replace(
            jngp.OccupancyState.create(jmodel.cfg),
            density_bitfield=jnp.asarray(bits)).refresh_coarse(jmodel.cfg)
        loss_j, grads_j = _jax_trainer_grads(
            jfield, params, occ_j, rcfg_j, batch, poses, dirs, key, flags,
            None)
        step = ttrain.FLAT_AFTER
    else:
        noise = noise[:n]
        rcfg_j = _jax_rcfg(rcfg_t)
        loss_j, grads_j, _ = _jax_pose_step(jfield, params, bits, poses, dirs,
                                            batch, noise, rcfg_j, "", None)
        step = 0
    hp = system.hparams
    hp.s_flat, hp.batch_size = s_flat, n      # the shards split this batch
    state = {k: v.numpy() for k, v in params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params)).items()}
    arrays = (poses, images, np.eye(3, dtype=np.float32), dirs,
              (len(dirs), 1))
    ranks = _spawn(dp_workers.trainer_step, 2, hp, state, bits, arrays,
                   np.asarray(img), np.asarray(pix),
                   np.asarray(noise, np.float32), step)
    (loss0, grads0, marched0, kept0, safe0), \
        (loss1, grads1, marched1, kept1, safe1) = ranks
    assert loss0 == loss1
    # the capture-safe all-reduce: every field parameter carries a gradient
    # on both ranks (rank 1 with no kept sample too), one with none on any
    # rank keeps none, bit for bit the call that reads the flags; a
    # gradient on rank 0 alone is averaged, and no set is agreed
    n_params = len(grads0)
    for found, equal, half_set, half_grad in (safe0, safe1):
        assert found == (True,) * n_params + (False,) and equal
        assert half_set is None
        np.testing.assert_array_equal(half_grad, [1.0, -2.0])
    for k in grads0:
        np.testing.assert_array_equal(grads0[k], grads1[k], err_msg=k)
    if flat:   # the cut inside rank 0: rank 1 keeps nothing
        assert marched0 == rank0 and kept0 == n * s_flat and kept1 == 0
        assert marched1 > 0
    else:
        assert kept0 == marched0 and kept1 == marched1 and kept0 + kept1 > 400
    np.testing.assert_allclose(loss0, loss_j, rtol=1e-5)
    want = params_from_numpy(jax.tree_util.tree_map(np.asarray, grads_j))
    assert set(want) == set(grads0)
    for name, g in grads0.items():
        assert np.abs(g).max() > 0 and np.isfinite(g).all(), name
        _close(g, want[name].numpy(), rtol=1e-4, rel_atol=1e-5)


def _jax_rcfg(rcfg_t):
    """The JAX RenderConfig of the port's."""
    return jrendering.RenderConfig(**{
        f.name: getattr(rcfg_t, f.name)
        for f in dataclasses.fields(trendering.RenderConfig)})


def test_fused_runner_on_two_ranks_matches_eager():
    """The fused runner's control flow with its collectives on two gloo
    ranks (its rule monkeypatched to serve: gloo cannot be captured, so
    CUDA graphs are replaced by stand-ins that run the captured step again
    on each replay, as inside a capture: the gradients' all-reduce given
    the set of parameters the warm-up steps found on both ranks), from
    step 0 and across FLAT_AFTER (the flat budget's prefix across ranks):
    on each rank bit for bit the same steps run eagerly, in metrics,
    parameters, Adam state and bitfield; five replays took the set."""
    hp = dp_workers.multichip_hparams(s_flat=4)
    for differ, given, kinds in _spawn(dp_workers.runner_against_eager, 2,
                                       hp):
        assert differ == []
        assert given == 5 and kinds == ["padded", "flat"]


def test_average_gradients_refuses_another_set():
    """The capture-safe all-reduce raises where this rank's gradients are
    not the set it was given (before any collective: no process group
    here)."""
    p = torch.nn.Parameter(torch.zeros(2))
    p.grad = torch.ones(2)
    with pytest.raises(ValueError, match="not the set"):
        pdist.average_gradients([p], (False,))


def test_allgather_ragged_on_three_ranks():
    """tests/test_multichip.py:155's values on three real ranks: ragged
    lists (7 images round-robin: 3, 2 and 2), NaN padding, a negative SSIM
    kept, the ranks in order, every rank the same list; one rank alone
    is its own list (no process group)."""
    lists = [[30.0, -0.5, 28.1], [31.2, 29.9], [27.5, 30.3]]
    got = _spawn(dp_workers.ragged, 3, lists, 7)
    assert got == [sum(lists, [])] * 3
    assert pdist.allgather_ragged([1.5, 2.5], 4) == [1.5, 2.5]


@pytest.mark.parametrize("n", [512, 509])
def test_render_test_sharded_matches_render_test(n):
    """render_test_sharded on two ranks against render_test in one
    process, on an even split (512 rays) and on a ragged one (509: a
    padding ray that marches nothing); every rank gets the whole frame."""
    ref = dp_workers.render_whole(n)
    ranks = _spawn(dp_workers.render, 2, n)
    for key in ("rgb", "opacity", "depth"):
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key])
    out = ranks[0]
    assert out["rgb"].shape == (n, 3) and out["depth"].shape == (n,)
    np.testing.assert_allclose(out["rgb"], ref["rgb"], atol=2e-4)
    np.testing.assert_allclose(out["opacity"], ref["opacity"], atol=2e-4)
    np.testing.assert_allclose(out["depth"], ref["depth"], atol=2e-3)
    assert out["total_samples"] == ranks[1]["total_samples"] > 0
    assert abs(out["total_samples"] - ref["total_samples"]) \
        <= 0.01 * ref["total_samples"]


def _cli_scene(root):
    scene = make_scene(n_train=4, n_test=2, wh=16, seed=0)
    scene["K"] = scene["K"] * np.float32([[50], [50], [1]])  # 800 x 0.02
    write_nsvf_scene(root, scene)


CLI_FLAGS = [
    "--root_dir", "Synthetic_NeRF_proc/Spheres", "--grid", "LowRank",
    "--downsample", "0.02", "--num_epochs", "1", "--steps_per_epoch", "24",
    "--batch_size", "64", "--grid_size", "16", "--lr_levels", "2",
    "--lr_rank", "8", "--lr_k_max", "32", "--max_samples", "128",
    "--s_max_train", "16", "--s_max_test", "32", "--rgb_channels", "16",
    "--rgb_layers", "1", "--exp_name", "dp"]


def test_main_on_two_cpu_ranks(tmp_path, monkeypatch):
    """``main --num_gpus 2`` with ``device="cpu"`` on a procedural NSVF
    scene: two CPU ranks train (main starts them), rank 0 alone writes one
    checkpoint and the results, each rank validates its view and both
    return the same metrics (the ranks of main in a group made here); then
    eval with --num_gpus 2 renders each view split over two ranks, within
    1e-3 dB of one rank."""
    monkeypatch.chdir(tmp_path)
    _cli_scene("Synthetic_NeRF_proc/Spheres")
    argv = CLI_FLAGS + ["--num_gpus", "2"]
    metrics = ttrain.main(get_opts(argv), device="cpu")
    assert np.isfinite(metrics["test/psnr"]) and metrics["test/ssim"] > 0
    assert sorted(os.listdir("ckpts/nsvf/dp")) == [
        "epoch=0.ckpt.npz", "epoch=0_slim.ckpt.npz"]
    assert sorted(os.listdir("results/nsvf/dp")) == [
        "000.png", "000_d.png", "001.png", "001_d.png"]
    both = _spawn(dp_workers.main_rank, 2, argv + [
        "--val_only", "--ckpt_path", "ckpts/nsvf/dp/epoch=0.ckpt.npz",
        "--no_save_test"])
    assert both[0] == both[1]
    np.testing.assert_allclose(both[0]["test/psnr"], metrics["test/psnr"],
                               atol=1e-6)
    served = CLI_FLAGS + ["--ckpt_path", "ckpts/nsvf/dp/epoch=0.ckpt.npz",
                          "--no_save_test"]
    split = teval.main(served + ["--num_gpus", "2"], device="cpu")
    whole = teval.main(served, device="cpu")
    np.testing.assert_allclose(split["mean_psnr"], whole["mean_psnr"],
                               atol=1e-3)


@pytest.mark.parametrize("entry", ["train", "eval"])
def test_entry_points_turn_tf32_off(monkeypatch, entry):
    """``train.main`` and ``eval.main`` leave TF32 off for cuBLAS and
    cuDNN, whatever it was (PyTorch's default keeps cuDNN's convolutions
    in TF32), before they build anything."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert not tdevice.tf32_off()
    if entry == "train":
        monkeypatch.setattr(ttrain, "_run", lambda hparams, device: {})
        ttrain.main(get_opts(CLI_FLAGS), device="cpu")
    else:
        monkeypatch.setattr(teval, "_evaluate",
                            lambda hparams, extra, device: {})
        teval.main(CLI_FLAGS + ["--ckpt_path", "x.npz"], device="cpu")
    assert tdevice.tf32_off()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_rank_devices_never_share_or_fall_back(monkeypatch):
    """More cards than the machine has raise the JAX make_mesh message;
    CPU ranks for device="cpu"; a test's device list as given; the
    backend: NCCL for distinct cards, gloo for CPU ranks or a shared
    card; a batch that does not split into equal shards raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="requested 4 devices, have 2"):
        pdist.rank_devices(4)
    assert pdist.rank_devices(2) == [torch.device("cuda", 0),
                                     torch.device("cuda", 1)]
    assert pdist.rank_devices(3, "cpu") == [torch.device("cpu")] * 3
    shared = pdist.rank_devices(2, devices=["cuda:0", "cuda:0"])
    assert pdist.backend_for(shared) == "gloo"
    assert pdist.backend_for(pdist.rank_devices(2)) == "nccl"
    assert pdist.backend_for(["cpu", "cpu"]) == "gloo"
    with mock.patch.object(pdist, "world", lambda group=None: (2, 3)):
        shard = pdist.Shard.of(258, "cpu")
        assert (shard.lo, shard.hi) == (172, 258)
        with pytest.raises(ValueError, match="equal shards"):
            pdist.Shard.of(256, "cpu")
