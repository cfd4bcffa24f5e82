"""The system under test: ``mfnerf_tpu_torch``'s trainer on the benchmark's
scene, and what the checks read of its state.

Everything the harness takes from the program goes through here: the
trainer (``train.NeRFSystem``: ``setup``, ``configure``, ``fit``), the
in-memory dataset it reads (``datasets.memory.MemoryDataset``), the serving
entry (``models.rendering.render_test``) and the state a check starts
the reference from (parameters, Adam's moments, the occupancy bitfield,
the generator). The program prints to standard output; its lines go to
standard error here, so that the result stays the last line there.
"""
import argparse
import contextlib
import sys
import time

import numpy as np
import torch


def quiet():
    """The program's prints sent to standard error."""
    return contextlib.redirect_stdout(sys.stderr)


class Laps:
    """Host seconds of a set-up's phases, by name."""

    def __init__(self):
        self.t = time.perf_counter()
        self.laps = {}

    def __call__(self, name, device=None):
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        self.laps[name] = self.laps.get(name, 0.0) + now - self.t
        self.t = now


def seeds(seed):
    """(spare, field, batches, viewer) seeds, all drawn from ``seed``."""
    return [int(s) for s in np.random.SeedSequence(seed).generate_state(4)]


def host_images(images):
    """The scene's images copied once to page-locked host memory (the
    program's dataset and the reference both read this copy); on the card
    the device's peak of memory starts again from here, so that it is the
    program's and not the scene's making."""
    host = torch.empty(images.shape, dtype=images.dtype,
                       pin_memory=images.is_cuda)
    host.copy_(images)
    if images.is_cuda:
        dev = images.device
        del images
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    return host


def start(config, scene, images, field_seed, batch_seed, device, lap):
    """A ``NeRFSystem`` of the configuration's hyperparameters on the
    scene's training views (``images``: their pixels on the host; the test
    poses as its test split), configured with the field drawn from
    ``field_seed`` and the batches from ``batch_seed``."""
    from mfnerf_tpu_torch.datasets.memory import MemoryDataset
    from mfnerf_tpu_torch.train import NeRFSystem
    dirs = scene["directions"].cpu().numpy()
    train = MemoryDataset(scene["poses"], images.numpy(), scene["K"], dirs,
                          scene["img_wh"])
    test = MemoryDataset(scene["test_poses"],
                         np.zeros((len(scene["test_poses"]), 0, 3),
                                  np.float32), scene["K"], dirs,
                         scene["img_wh"])
    hp = argparse.Namespace(**config["hparams"], seed=batch_seed)
    with quiet():
        system = NeRFSystem(hp, device=device)
        lap("trainer", device)
        system.setup(train, test)
        lap("trainer.setup", device)
        system.configure(field_seed)
        lap("trainer.configure", device)
    return system


def fit(system, n):
    """``system.fit(n)``: n training steps; their metrics on the host."""
    with quiet():
        return system.fit(n)


def params(system):
    """The field's parameters by name, copied to the host."""
    return {k: v.detach().to("cpu", copy=True)
            for k, v in system.model.named_parameters()}


def snapshot(system):
    """What a training check starts the reference from: the parameters,
    Adam's moments and step count a parameter, the occupancy bitfield,
    the generator's state and the global step, on the host."""
    adam = {}
    for k, p in system.model.named_parameters():
        st = system.optimizer.state.get(p, {})
        adam[k] = {m: _moment(st, m, p) for m in ("exp_avg", "exp_avg_sq")}
        adam[k]["step"] = float(st.get("step", 0.0))
    return {"params": params(system), "adam": adam,
            "bitfield": system.occ.density_bitfield.to("cpu", copy=True),
            "generator": system.generator.get_state(),
            "step": system.global_step}


def _moment(state, name, p):
    """Adam's moment ``name`` of a parameter on the host; zeros where Adam
    holds none (before its first step)."""
    m = state.get(name)
    return torch.zeros(p.shape) if m is None else m.to("cpu", copy=True)


def first_moments(system):
    """Adam's first moments by parameter name, on the host."""
    return {k: _moment(system.optimizer.state.get(p, {}), "exp_avg", p)
            for k, p in system.model.named_parameters()}


def serve(system, rays_o, rays_d, t_threshold):
    """One served frame (``render_test`` at ``t_threshold``)."""
    import dataclasses

    from mfnerf_tpu_torch.models.rendering import render_test
    rcfg = dataclasses.replace(system.rcfg, T_threshold=t_threshold)
    return render_test(system.model, system.occ, rays_o, rays_d, rcfg)
