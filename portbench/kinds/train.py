"""Training traffic: ``NeRFSystem.fit`` in blocks of steps on the
benchmark's scene, after a set-up that trains ``warm_steps`` steps.

Traffic parameters (the mix's file): ``warm_steps`` (set-up training: the
padded steps, then the flat step's capture past step 512), ``block_steps``
(steps a ``fit`` call in the window; each call reads its metrics back
once), ``trace_steps`` (steps of the traced window, whole blocks: a
multiple of ``block_steps``), ``check_steps`` (the steps the reference
follows).

Set-up trains ``warm_steps`` (moved on past any step that would put an
occupancy refresh among the checked ones), snapshots the trainer's state,
then runs the checked steps through ``fit(1)`` each, the window's own
call: the trainer that the window drives is this one. The check, after
the window, runs the reference's steps from the snapshot and compares the
losses, the first gradient (from Adam's first moments before and after
it) and the parameters' change.
"""
import time

import torch

from portbench import program, scene
from portbench.reference import compare, train_step

REFRESH_EVERY = 16       # the trainer's occupancy refresh interval


class Run:
    def __init__(self, config, traffic, seed, device):
        self.hp, self.traffic, self.device = config["hparams"], traffic, device
        self.config = config
        self.seeds = program.seeds(seed)

    def setup(self):
        t, dev = self.traffic, self.device
        self.laps = lap = program.Laps()
        sc = scene.make(device=dev, **self.config["scene"])
        lap("scene", dev)
        images = program.host_images(sc.pop("images"))
        lap("scene to host", dev)
        self.system = program.start(self.config, sc, images, self.seeds[1],
                                    self.seeds[2], dev, lap)
        self.data = {"images": images,
                     "poses": torch.from_numpy(sc["poses"]),
                     "directions": sc["directions"].cpu()}
        del sc
        n_check = t["check_steps"]
        warm = t["warm_steps"]
        while any((warm + i) % REFRESH_EVERY == 0 for i in range(n_check)):
            warm += 1
        program.fit(self.system, warm)
        lap("train", dev)
        self.snap = program.snapshot(self.system)
        self.prog_losses, self.m1 = [], None
        for _ in range(n_check):
            self.prog_losses.append(float(program.fit(self.system, 1)
                                          ["loss"][0]))
            if self.m1 is None:
                self.m1 = program.first_moments(self.system)
        self.p_end = program.params(self.system)
        lap("checked steps", dev)

    def _blocks(self, more):
        """Run ``fit`` blocks while ``more(steps)``; (steps, valid samples
        of each step)."""
        hp, s = self.hp, self.system
        b = hp["batch_size"]
        block = self.traffic["block_steps"]
        steps, valid = 0, []
        while more(steps):
            flat = bool(hp.get("s_flat")) and s.step_kind() == "flat"
            cap = b * (hp["s_flat"] if flat else hp["s_max_train"])
            out = program.fit(s, block)
            valid += [min(round(float(r) * b), cap) for r in out["rm_s"]]
            steps += block
        return steps, valid

    def window(self, seconds):
        t0 = time.perf_counter()
        work = self._blocks(
            lambda n: n == 0 or time.perf_counter() - t0 < seconds)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self.record(work, time.perf_counter() - t0)

    def traced_work(self):
        n = self.traffic["trace_steps"]
        return self._blocks(lambda k: k < n)

    def record(self, work, window_s):
        """What the metrics read of a window's ``work`` (steps, valid
        samples a step) over ``window_s`` host seconds."""
        steps, valid = work
        return {"kind": "train", "hp": self.hp, "steps": steps,
                "attempted": steps,
                "batch": self.hp["batch_size"], "valid": valid,
                "window_s": window_s}

    def release(self):
        """Free the program's state (its graphs, parameters, buffers)."""
        del self.system

    def _reference(self, **variant):
        dev = self.device
        data = {k: v.to(dev) for k, v in self.data.items()}
        ref = train_step.run_steps(self.hp, self.snap, data,
                                   len(self.prog_losses), **variant)
        p0 = self.snap["params"]
        return (ref["losses"], {k: v.cpu() for k, v in ref["grads"].items()},
                {k: ref["params"][k].cpu() - p0[k] for k in p0})

    def check(self):
        """The program's checked steps against the reference's."""
        p0 = self.snap["params"]
        m0 = {k: v["exp_avg"] for k, v in self.snap["adam"].items()}
        prog = (self.prog_losses, compare.adam_first_grads(m0, self.m1),
                {k: self.p_end[k] - p0[k] for k in p0})
        ref = self._reference()
        return compare.train_numbers(*(x for pair in zip(prog, ref)
                                       for x in pair))

    def control(self, variant):
        """The reference in the program's place against itself: computed
        in TF32 (``variant`` "tf32", the control) or with half of each
        batch left out and the mean taken over the rest ("half_batch", a
        fault)."""
        ref = self._reference()
        alt = self._reference(**{"tf32": {"tf32": True},
                                 "half_batch": {"half": True}}[variant])
        return compare.train_numbers(*(x for pair in zip(alt, ref)
                                       for x in pair))
