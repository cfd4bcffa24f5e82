"""Serving traffic: one viewer in a closed loop, each frame a test pose
of the orbit through ``render_test``, after a set-up that trains the
field.

Traffic parameters (the mix's file): ``train_steps`` (set-up training),
``train_seed`` (the served field's weights and training batches),
``T_threshold`` (the transmittance at which a ray stops), ``warm_frames``
(poses spread evenly over the orbit, served once in set-up: the serving
rounds' CUDA graphs are captured at every tier they reach), ``trace_frames``
(frames of the traced window), ``stride`` (poses the viewer moves on a
frame: coprime with the orbit's length, about its golden section, so that
any run of frames spreads evenly over the orbit, whatever the offset),
``check_frames`` and ``check_pixels``
(served frames kept for the check, drawn uniformly over the window's
frames, and pixels of each compared).

The served field is one trained field, as a deployment serves one: its
weights and training batches are drawn from the mix's ``train_seed``, so
that every run serves the same work (fields trained from different seeds
march different samples: on an H100, MixedFeature runs of six seeds
spread 5-6% in frames per second, runs of one seed about 1%). ``--seed`` draws the viewer's offset
on the orbit and the pixels the check compares.

A frame's latency runs on the host clock from the ``render_test`` call to
the synchronised frame; its rays are made before the call. The check,
after the window, renders the kept frames' chosen pixels with the plain
reference from the trained state and compares rgb, opacity and depth.
"""
import time

import numpy as np
import torch

from portbench import program, scene
from portbench.reference import compare, march, render


class Run:
    def __init__(self, config, traffic, seed, device):
        self.hp, self.traffic, self.device = config["hparams"], traffic, device
        self.config = config
        self.seeds = program.seeds(seed)
        self.field_seeds = program.seeds(traffic["train_seed"])

    def setup(self):
        t, dev = self.traffic, self.device
        self.laps = lap = program.Laps()
        sc = scene.make(device=dev, **self.config["scene"])
        lap("scene", dev)
        images = program.host_images(sc.pop("images"))
        lap("scene to host", dev)
        self.system = program.start(self.config, sc, images,
                                    self.field_seeds[1],
                                    self.field_seeds[2], dev, lap)
        self.dirs = sc["directions"]
        self.poses = torch.from_numpy(sc["test_poses"]).to(self.device)
        del sc
        program.fit(self.system, t["train_steps"])
        lap("train", dev)
        self.state = (program.params(self.system),
                      self.system.occ.density_bitfield.to("cpu", copy=True))
        self.rng = np.random.default_rng(self.seeds[3])
        n = len(self.poses)
        self.offset = int(self.rng.integers(n))
        for k in range(t["warm_frames"]):
            self._frame((self.offset + k * n // t["warm_frames"]) % n)
        lap("warm frames", dev)

    def _rays(self, i):
        return march.get_rays(self.dirs, self.poses[i])

    def _frame(self, i):
        rays_o, rays_d = self._rays(i)
        t0 = time.perf_counter()
        out = program.serve(self.system, rays_o, rays_d,
                            self.traffic["T_threshold"])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out, time.perf_counter() - t0

    def _frames(self, more):
        """Serve the orbit from the offset while ``more(frames)``; each
        frame's (latency s, rounds, samples); a uniform sample of
        ``check_frames`` of them kept (reservoir)."""
        n, keep = len(self.poses), self.traffic["check_frames"]
        self.kept, frames = [], []
        while more(len(frames)):
            i = (self.offset + len(frames) * self.traffic["stride"]) % n
            out, lat = self._frame(i)
            k = len(frames)
            frames.append((lat, out["rounds"], out["total_samples"]))
            if k < keep:
                self.kept.append((i, out))
            else:
                j = int(self.rng.integers(k + 1))
                if j < keep:
                    self.kept[j] = (i, out)
        return frames

    def window(self, seconds):
        t0 = time.perf_counter()
        work = self._frames(
            lambda k: k == 0 or time.perf_counter() - t0 < seconds)
        return self.record(work, time.perf_counter() - t0)

    def traced_work(self):
        n = self.traffic["trace_frames"]
        return self._frames(lambda k: k < n)

    def record(self, work, window_s):
        """What the metrics read of a window's frames over ``window_s``
        host seconds."""
        return {"kind": "serve", "hp": self.hp, "frames": work,
                "attempted": len(work),
                "pixels": self.dirs.shape[0], "window_s": window_s}

    def release(self):
        """Keep the kept frames' chosen pixels, free the program's state."""
        hw = self.dirs.shape[0]
        gen = torch.Generator().manual_seed(self.seeds[3])
        self.picked = []
        for i, out in getattr(self, "kept", ()):
            pix = torch.randperm(hw, generator=gen)[
                :self.traffic["check_pixels"]].to(self.device)
            self.picked.append((i, pix, {k: out[k][pix].cpu() for k in
                                         ("rgb", "opacity", "depth")}))
        self.kept = []
        del self.system

    def _reference(self, tf32=False):
        params, bits = self.state
        dev = self.device
        params = {k: v.to(dev) for k, v in params.items()}
        outs = []
        for i, pix, _ in self.picked:
            rays_o, rays_d = self._rays(i)
            outs.append(render.render_rays(
                self.hp, params, bits.to(dev), rays_o[pix], rays_d[pix],
                self.traffic["T_threshold"], tf32=tf32))
        return _cat(outs)

    def check(self):
        """The kept pixels against the reference's."""
        return compare.frame_numbers(_cat([p for _, _, p in self.picked]),
                                     self._reference())

    def control(self, variant):
        """The reference in the program's place against itself, computed
        in TF32 (``variant`` "tf32")."""
        if variant != "tf32":
            raise ValueError(variant)
        return compare.frame_numbers(self._reference(tf32=True),
                                     self._reference())


def _cat(outs):
    return {k: torch.cat([o[k].cpu() for o in outs]) for k in
            ("rgb", "opacity", "depth")}
