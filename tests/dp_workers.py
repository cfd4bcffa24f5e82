"""The ranks of tests/test_torch_dp.py: functions that
``mfnerf_tpu_torch.parallel.dist.spawn`` runs in processes of their own,
one a rank, joined in a gloo group on the CPU. This module imports torch,
numpy and the port only, so that a rank starts without JAX."""
import argparse
import contextlib
import dataclasses

import numpy as np
import torch

from mfnerf_tpu_torch import train as ttrain
from mfnerf_tpu_torch.datasets.memory import MemoryDataset
from mfnerf_tpu_torch.datasets.ray_utils import get_rays
from mfnerf_tpu_torch.models.ngp import NGP, NGPConfig, OccupancyState
from mfnerf_tpu_torch.models.rendering import (RenderConfig, render_test,
                                               render_test_sharded)
from mfnerf_tpu_torch.opt import get_opts
from mfnerf_tpu_torch.parallel import dist as pdist
from mfnerf_tpu_torch.utils.procedural import make_scene


def multichip_hparams(batch_size=256, **kw):
    """tests/test_multichip.py's system (``_make_system``): the LowRank
    field at grid 32, batch 256, one epoch of 64 steps."""
    d = dict(
        root_dir="<memory>", dataset_name="nsvf", split="train",
        downsample=1.0, scale=0.5, use_exposure=False, distortion_loss_w=0.0,
        batch_size=batch_size, ray_sampling_strategy="all_images",
        num_epochs=1, num_gpus=1, lr=1e-2, optimize_ext=False,
        random_bg=False, eval_lpips=False, val_only=False, no_save_test=True,
        exp_name="mc", ckpt_path=None, weight_path=None, grid="LowRank",
        L=8, F=2, T=14, N_min=16, N_max=128, N_tables=1, rgb_channels=16,
        rgb_layers=1, seed=7, s_max_train=16, s_max_test=16, test_chunk=1024,
        lpips_weights=None, profile=False, steps_per_epoch=64,
        grid_size=32, max_samples=128, lr_levels=2, lr_rank=8, lr_frames=1,
        lr_k_max=64, s_flat=0)
    d.update(kw)
    return argparse.Namespace(**d)


def multichip_system(hp, device="cpu"):
    """A NeRFSystem of ``hp`` on test_multichip's 64x64 scene (4 train
    views; 3 test views, so that two ranks each render one), its field
    drawn from seed 3."""
    scene = make_scene(n_train=4, n_test=3, wh=64, seed=0)
    system = ttrain.NeRFSystem(hp, device=device)
    system.setup(MemoryDataset.from_scene(scene, "train"),
                 MemoryDataset.from_scene(scene, "test"))
    system.configure(3)
    return system


def fit(rank, device, hp, n_steps, reduce_count=None):
    """``n_steps`` of ``fit`` from step 0, then ``validate``: the
    parameters, the bitfield, every step's metrics and the validation; and
    the trace that tests/test_torch_dp.py compares step by step: each
    step's gradients as the optimiser took them (averaged over the ranks)
    and its parameters after the step, and each refresh's density grid and
    bitfield (rank 0's alone). ``reduce_count``: average the gradients over that many ranks
    instead of the world size (a deliberately wrong reduction)."""
    torch.set_num_threads(1)
    system = multichip_system(hp, device)
    if reduce_count is not None:
        right = system.average_gradients

        def wrong():
            right()
            for p in system.model.parameters():
                if p.grad is not None:
                    p.grad.mul_(system.world / reduce_count)
        system.average_gradients = wrong
    names = [n for n, _ in system.model.named_parameters()]
    trace = {"grads": [], "params": [], "refresh": {}}
    system.optimizer.register_step_pre_hook(
        lambda opt, args, kwargs: trace["grads"].append({
            n: p.grad.detach().cpu().numpy().copy() for n, p in zip(
                names, system.model.parameters()) if p.grad is not None}))
    metrics = []
    for _ in range(n_steps):
        step = system.global_step
        metrics.append(system.fit(1))
        if step % ttrain.UPDATE_INTERVAL == 0:
            trace["refresh"][step] = (
                system.occ.density_grid.cpu().numpy().copy(),
                system.occ.density_bitfield.cpu().numpy().copy())
        trace["params"].append({k: v.detach().cpu().numpy().copy()
                                for k, v in system.model.state_dict().items()})
    return {"params": trace["params"][-1],
            "bitfield": system.occ.density_bitfield.cpu().numpy(),
            "metrics": {k: torch.cat([m[k] for m in metrics]).numpy()
                        for k in metrics[0]},
            "refreshes": system.n_refresh, "validate": system.validate(),
            "shard": (system.shard.lo, system.shard.hi)
            if system.shard is not None else None,
            "trace": trace if rank == 0 else None}


def trainer_step(rank, device, hp, state, bits, train, img, pix, noise,
                 step):
    """One step of the trainer at ``step`` on this rank's shard of the
    batch (``img``, ``pix``, ``noise``), the field's weights ``state`` and
    the occupancy ``bits`` given, the gradients averaged over the ranks:
    (the ranks' mean loss, the averaged gradients, this rank's marched
    samples, the samples it kept)."""
    torch.set_num_threads(1)
    system = ttrain.NeRFSystem(hp, device=device)
    system.setup(MemoryDataset(*train))
    system.configure(0)
    system.rcfg = dataclasses.replace(system.rcfg, s_strata=32)
    system.model.load_state_dict({k: torch.from_numpy(v)
                                  for k, v in state.items()})
    system.occ = dataclasses.replace(
        system.occ, density_bitfield=torch.from_numpy(bits)
    ).refresh_coarse(system.model_cfg)
    system.global_step = step
    sh = system.shard
    loss, res, _ = system.step_loss(
        *(sh.take(torch.from_numpy(a)) for a in (img, pix, noise)))
    system.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    local = [p.grad.clone() for p in system.model.parameters()]
    system.average_gradients()
    mean = pdist.all_sum(loss.detach().double()) / sh.world
    return (float(mean), {k: p.grad.numpy() for k, p
                          in system.model.named_parameters()},
            int(res["rm_samples"]), int(res["mask"].sum()),
            capture_safe_average(rank, list(system.model.parameters()),
                                 local))


def capture_safe_average(rank, params, local):
    """``average_gradients`` given ``present`` (the capture-safe call)
    against the call that reads the flags, from the same local gradients
    ``local`` of ``params`` and a parameter with no gradient on any rank:
    (the set the flags gave, whether the two calls' gradients are equal
    bit for bit and the gradient-free parameter kept none in both, what a
    parameter with a gradient on rank 0 alone gave: the flags' set and its
    gradient on this rank)."""
    none = torch.nn.Parameter(torch.zeros(3))

    def averaged(present=None):
        for p, g in zip(params, local):
            p.grad = g.clone()
        found = pdist.average_gradients(params + [none], present)
        return found, [p.grad.clone() for p in params]

    found, eager = averaged()
    again, safe = averaged(found)
    equal = again == found and none.grad is None and all(
        torch.equal(a, b) for a, b in zip(eager, safe))
    half = torch.nn.Parameter(torch.zeros(2))
    if rank == 0:
        half.grad = torch.tensor([2.0, -4.0])
    half_set = pdist.average_gradients([half])
    return found, equal, half_set, half.grad.numpy()


class StandInGraph:
    """A CUDA graph's stand-in on the CPU: the capture records the
    function and runs nothing; each replay runs it as inside a capture
    (``train._capturing`` answering yes, so the gradients' all-reduce takes
    the set that the warm-up steps found) and writes its output into the
    static output the capture returned."""

    def __init__(self, fn, capturing):
        self.fn, self.capturing = fn, capturing
        self.out = torch.empty(len(ttrain.METRICS))

    def replay(self):
        self.capturing[0] = True
        try:
            out = self.fn()
        finally:
            self.capturing[0] = False
        if out is not None:
            self.out.copy_(out)

    def reset(self):
        self.fn = None


def runner_against_eager(rank, device, hp):
    """The trainer of ``hp`` (``--s_flat`` > 0) from step 0, two steps,
    then eleven from FLAT_AFTER - 5 (each step kind's warm-up, capture and
    replays), eagerly and through the fused runner with
    :class:`StandInGraph` graphs (its rule answering yes, the side stream
    a no-op), on this rank: (the names of what differs between the two,
    metrics, parameters, Adam state and bitfield; the all-reduces given a
    set; the step kinds the runner captured)."""
    torch.set_num_threads(1)

    def history(system):
        out = [system.fit(2)]
        system.set_step(ttrain.FLAT_AFTER - 5)
        return out + [system.fit(11)]

    eager = multichip_system(hp, device)
    want = history(eager)
    capturing, kinds, given = [False], [], []
    average = pdist.average_gradients

    def counted(params, present=None):
        given.append(present is not None)
        return average(params, present)

    def capture(runner, fn):
        if getattr(fn, "__func__", None) is ttrain.NeRFSystem._device_step:
            kinds.append(runner.kind)
        graph = StandInGraph(fn, capturing)
        runner.launches[graph] = {}
        return graph, graph.out

    stream = type("Stream", (), {"wait_stream": lambda self, other: None})()
    patches = [(torch.cuda, "Stream", lambda device=None: stream),
               (torch.cuda, "current_stream", lambda device=None: stream),
               (torch.cuda, "stream", lambda s: contextlib.nullcontext()),
               (ttrain.FusedRunner, "_capture", capture),
               (ttrain.NeRFSystem, "fused_ok", lambda self: True),
               (ttrain, "_capturing", lambda device: capturing[0]),
               (pdist, "average_gradients", counted)]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, value in patches:
        setattr(obj, name, value)
    try:
        system = multichip_system(hp, device)
        got = history(system)
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)
    differ = [f"metric/{k}" for w, g in zip(want, got) for k in w
              if not torch.equal(w[k], g[k])]
    differ += [k for (k, a), b in zip(eager.model.state_dict().items(),
                                      system.model.state_dict().values())
               if not torch.equal(a, b)]
    for pa, pb in zip(eager.model.parameters(), system.model.parameters()):
        differ += [f"adam/{k}" for k, v in eager.optimizer.state[pa].items()
                   if not torch.equal(v, system.optimizer.state[pb][k])]
    if not torch.equal(eager.occ.density_bitfield,
                       system.occ.density_bitfield):
        differ.append("density_bitfield")
    return differ, sum(given), kinds


def ragged(rank, device, lists, n_max):
    """``allgather_ragged`` of rank r's list ``lists[r]``."""
    return pdist.allgather_ragged(lists[rank], n_max)


def render_setup(seed=0):
    """A small LowRank field, its occupancy after one dense refresh, and
    the 24x24 rays of a test view of the procedural scene."""
    g = torch.Generator().manual_seed(seed)
    cfg = NGPConfig(lr_k_max=64, lr_levels=2, lr_rank=8, lr_fused=True,
                    grid_size=32, rgb_channels=16, rgb_layers=1)
    model = NGP(cfg, g, device="cpu")
    occ = model.update_density_grid(
        OccupancyState.create(cfg, "cpu"), 0.5,
        torch.rand((1, cfg.n_cells, 3), generator=g) * 2 - 1)
    scene = make_scene(n_train=1, n_test=1, wh=24, seed=0)
    rays = get_rays(torch.from_numpy(scene["directions"]),
                    torch.from_numpy(scene["test_poses"][0]))
    return model, occ, rays


RENDER_CFG = RenderConfig(max_samples=128, s_max_test=256, test_chunk=512)


def render(rank, device, n):
    """``render_test_sharded`` of the first ``n`` rays of
    :func:`render_setup`'s view, as numpy arrays."""
    torch.set_num_threads(1)
    model, occ, (ro, rd) = render_setup()
    out = render_test_sharded(model, occ, ro[:n], rd[:n], RENDER_CFG)
    return {k: (v.numpy() if torch.is_tensor(v) else v)
            for k, v in out.items()}


def render_whole(n):
    """``render_test`` of the same rays in one process."""
    model, occ, (ro, rd) = render_setup()
    out = render_test(model, occ, ro[:n], rd[:n], RENDER_CFG)
    return {k: (v.numpy() if torch.is_tensor(v) else v)
            for k, v in out.items()}


def main_rank(rank, device, argv):
    """The command line's ``main`` as this rank of the group."""
    torch.set_num_threads(1)
    return ttrain.main(get_opts(argv), device=device)
