"""Where a training step's time goes, stage by stage, on the card.

    python3 tools/step_split.py [--config mf|bench|mf360|mf360_black|lr360] \
        [--warm 600] [--steps 64] [--bf16] [--fused]

Trains ``chip_smoke.py``'s configuration (``mf``: MF_HP, the MixedFeature
benchmark grid; ``bench``: BENCH_HP, the LowRank bench model, both with
bench.py's ``--s_flat 16 --pool_a 4``; on their 16
procedural 800x800 views) or one of its multi-cascade recipes (``mf360``:
MF360_ARGS, the MixedFeature mip-NeRF 360 recipe at --scale 8;
``mf360_black``: the same without --random_bg; ``lr360``: LR360_ARGS, the
LowRank model there; on the COLMAP scene of its phase 20,
written to a temporary directory), with ``--bf16`` under that flag
(bf16 operands in the MLPs and the LowRank projection), for ``--warm``
steps through
``NeRFSystem.fit``, then runs ``--steps`` more steps of
``NeRFSystem.train_step``'s body (the march with ``render_train``'s strata
budget, the scene's background; the step kind's buffer,
``NeRFSystem.step_kind``: from FLAT_AFTER with ``--s_flat`` the flat
budget's cut and its N * s_flat slots, else the padded step's N * S
slots) with ``torch.cuda.synchronize()`` between the stages and times each
on the host clock:

  ray sampling + get_rays, the march (and the flat cut), the field forward
  (``_eval_capacity`` on the step kind's buffer), composite + loss
  forward, composite + loss backward (to the field's outputs), the field
  backward, Adam + LambdaLR, and the occupancy refresh every 16 steps
  (amortised);

and, inside the field stages, the encoder kernels' wrappers with CUDA
events (host gaps included), and so the composite kernels' launches
inside the composite stages. Then ``--steps`` eager steps of ``fit``
unsynced and ``torch.profiler`` over 16 more give the kernels launched a
step and the device's busy time; with ``--fused`` then ``--steps`` steps of
``fit`` through the fused runner's CUDA graphs (synced around the run) and
16 more under the profiler, where ``NeRFSystem.fused_ok`` serves them
(else the line says so; the multi-cascade recipes, which have no flat
budget, are served the padded step's graph). Prints one JSON line per part
and the card's name and power limit; exits non-zero without a CUDA
device.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


class KernelClock:
    """Device time between CUDA events around every call of a wrapper."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.inner = getattr(module, name)
        self.pairs = []

    def __call__(self, *args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.inner(*args, **kw)
        end.record()
        self.pairs.append((start, end))
        return out

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.inner)

    def take_ms(self):
        torch.cuda.synchronize()
        ms = sum(s.elapsed_time(e) for s, e in self.pairs)
        n = len(self.pairs)
        self.pairs = []
        return ms, n


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="mf", choices=(
        "mf", "bench", "mf360", "mf360_black", "lr360"))
    ap.add_argument("--warm", type=int, default=600)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--fused", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("step_split: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke
    from mfnerf_tpu_torch.datasets.memory import MemoryDataset
    from mfnerf_tpu_torch.datasets.ray_utils import get_rays
    from mfnerf_tpu_torch.models import rendering
    from mfnerf_tpu_torch.opt import get_opts
    from mfnerf_tpu_torch.ops import composite, hashgrid, hatmul
    from mfnerf_tpu_torch.train import UPDATE_INTERVAL
    from mfnerf_tpu_torch.utils.procedural import make_scene

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    if args.config in ("mf", "bench"):
        hp = chip_smoke.MF_HP if args.config == "mf" else chip_smoke.BENCH_HP
        scene = make_scene(n_train=chip_smoke.N_TRAIN_VIEWS, n_test=1,
                           wh=chip_smoke.WH, seed=chip_smoke.SEED)
        datasets = (MemoryDataset.from_scene(scene, "train"),
                    MemoryDataset.from_scene(scene, "test"))
    else:
        argv = {"mf360": chip_smoke.MF360_ARGS,
                "mf360_black": chip_smoke.MF360_BLACK_ARGS,
                "lr360": chip_smoke.LR360_ARGS}[args.config]
        hp = vars(get_opts(["--root_dir", "", *argv]))
        with tempfile.TemporaryDirectory() as tmp:
            datasets = chip_smoke.colmap_views(
                os.path.join(tmp, chip_smoke.COLMAP_ROOT))[:2]
    system = chip_smoke.start_system(dict(hp, bf16=args.bf16), datasets,
                                     torch.device("cuda"))
    system.fit(args.warm)
    torch.cuda.synchronize()

    stages = ("sampling", "march", "field_fwd", "composite_loss_fwd",
              "composite_loss_bwd", "field_bwd", "adam", "refresh")
    total = dict.fromkeys(stages, 0.0)
    kernel = {f"{key}_{x}": 0 for key in ("fwd", "bwd", "comp_fwd",
                                          "comp_bwd")
              for x in ("ms", "calls")}
    samples = 0
    mod = hashgrid if system.model_cfg.grid != "LowRank" else hatmul
    fwd_name = "_launch_fwd" if mod is hashgrid else "_launch"
    rcfg, b, dev = system.rcfg, hp["batch_size"], system.device
    with KernelClock(mod, fwd_name) as kf, \
            KernelClock(mod, "_launch_bwd") as kb, \
            KernelClock(composite, "_launch_train_fwd") as cf, \
            KernelClock(composite, "_launch_train_bwd") as cb:
        for _ in range(args.steps):
            t = [time.perf_counter()]

            def mark():
                torch.cuda.synchronize()
                t.append(time.perf_counter())

            if system.global_step % UPDATE_INTERVAL == 0:
                system.update_grid()
            mark()
            kf.take_ms()               # the refresh's launches: not a step's
            n_img, hw = system.rays.shape[:2]
            img = torch.randint(n_img, (b,), generator=system.generator,
                                device=dev)
            pix = torch.randint(hw, (b,), generator=system.generator,
                                device=dev)
            rays_o, rays_d = get_rays(system.directions[pix],
                                      system.poses[img])
            noise = system._rand(b)
            bg = (1.0 if rcfg.exp_step_factor == 0      # as render_train
                  else system._rand(3) if rcfg.random_bg else 0.0)
            mark()
            cfg = system.model_cfg
            mr = rendering.march_rays_train(
                rays_o, rays_d, rendering._scene_hits(system.model, rays_o,
                                                      rays_d),
                system.occ.density_bitfield, cfg.cascades, cfg.scale,
                rcfg.exp_step_factor, cfg.grid_size, rcfg.max_samples,
                noise, rcfg.n_rungs(cfg.scale, cfg.grid_size),
                rcfg.s_max_train,
                strata=rendering.train_strata(cfg, system.occ, rcfg))
            kind = system.step_kind()
            flat = kind == "flat"
            if flat:
                cut = rendering.flat_budget(mr, rcfg)
                mask, ts, deltas = cut.mask, cut.ts, cut.deltas
            else:
                mask, ts, deltas = mr.mask, mr.ts, mr.deltas
            mark()
            if flat:
                sigmas, rgbs = rendering._eval_capacity(
                    system.model, mr.xyzs, rays_d, mask, cut.cap)
            elif kind == "padded":
                sigmas, rgbs = rendering._eval_capacity(
                    system.model, mr.xyzs, rays_d, mask, mask.numel(),
                    by_entry=True)
            else:
                sigmas, rgbs = rendering._eval_valid(system.model, mr.xyzs,
                                                     rays_d, mask)
            mark()
            comp = rendering.composite_train(sigmas, rgbs, deltas, ts,
                                             mask, rcfg.T_threshold)
            results = {"rgb": comp.rgb + bg * (1.0 - comp.opacity)[:, None],
                       "opacity": comp.opacity, "ws": comp.ws,
                       "deltas": deltas, "ts": ts, "mask": mask}
            loss = sum(v.mean() for v in system.loss(
                results, {"rgb": system.rays[img, pix]}).values())
            mark()
            d_sig, d_rgb = torch.autograd.grad(loss, [sigmas, rgbs])
            mark()
            system.optimizer.zero_grad(set_to_none=True)
            torch.autograd.backward([sigmas, rgbs], [d_sig, d_rgb])
            mark()
            system.optimizer.step()
            system._next_lr()
            system.global_step += 1
            mark()
            samples += int(mask.sum())
            order = ("refresh", "sampling", "march", "field_fwd",
                     "composite_loss_fwd", "composite_loss_bwd",
                     "field_bwd", "adam")
            for name, t0, t1 in zip(order, t[:-1], t[1:]):
                total[name] += (t1 - t0) * 1e3
            for key, clock in (("fwd", kf), ("bwd", kb), ("comp_fwd", cf),
                               ("comp_bwd", cb)):
                ms, calls = clock.take_ms()
                kernel[f"{key}_ms"] += ms
                kernel[f"{key}_calls"] += calls
    # the last step's autograd graph, made on the default stream, would
    # keep its gradient accumulators alive, and a capture below (a step
    # kind the runner has not captured yet) would wait on that stream
    del loss, sigmas, rgbs, comp, results
    per_step = {k: v / args.steps for k, v in total.items()}
    print(json.dumps({
        "part": "stages", "config": args.config, "bf16": args.bf16,
        "grid": hp["grid"],
        "steps_from": args.warm, "steps": args.steps,
        "samples_per_step": samples / args.steps,
        "ms_per_step": per_step, "total_ms": sum(per_step.values()),
        "kernel_fwd_ms_per_step": kernel["fwd_ms"] / args.steps,
        "kernel_fwd_calls_per_step": kernel["fwd_calls"] / args.steps,
        "kernel_bwd_ms_per_step": kernel["bwd_ms"] / args.steps,
        "kernel_bwd_calls_per_step": kernel["bwd_calls"] / args.steps,
        "composite_fwd_ms_per_step": kernel["comp_fwd_ms"] / args.steps,
        "composite_fwd_calls_per_step": kernel["comp_fwd_calls"]
        / args.steps,
        "composite_bwd_ms_per_step": kernel["comp_bwd_ms"] / args.steps,
        "composite_bwd_calls_per_step": kernel["comp_bwd_calls"]
        / args.steps,
        "card": card}), flush=True)

    # eager steps unsynced, then the same under the profiler; with --fused
    # the fused runner's graphed steps likewise
    kinds = [("eager", chip_smoke.eager_fit)]
    if args.fused:
        kinds.append(("graphed", lambda s, n: s.fit(n)))
    for kind, fit in kinds:
        if kind == "graphed" and not system.fused_ok():
            print(json.dumps({
                "part": "profile", "config": args.config, "kind": kind,
                "served": False, "why": "NeRFSystem.fused_ok: no (its log "
                "line above says why)",
                "card": card}), flush=True)
            continue
        fit(system, UPDATE_INTERVAL)       # a graphed run's captures
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit(system, args.steps)
        torch.cuda.synchronize()
        run_ms = (time.perf_counter() - t0) * 1e3 / args.steps
        from torch.profiler import ProfilerActivity, profile
        n_prof = 16
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fit(system, n_prof)
            torch.cuda.synchronize()
            span_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
        top = sorted(prof.key_averages(),
                     key=lambda e: -getattr(e, "device_time_total", 0.0))
        print(json.dumps({
            "part": "profile", "config": args.config, "kind": kind,
            "bf16": args.bf16, "served": True,
            "step_kind": system.step_kind(), "from_step":
            system.global_step - args.steps - n_prof,
            "unsynced_ms_per_step": run_ms, "profiled_steps": n_prof,
            "profiled_ms_per_step": span_ms / n_prof,
            "device_kernels_per_step": len(events) / n_prof,
            "device_busy_ms_per_step": busy_ms / n_prof,
            "device_idle_share": (1 - busy_ms / span_ms) if events
            else None,
            "top_kernels_ms_per_step": [
                (e.key[:80],
                 getattr(e, "device_time_total", 0.0) / 1e3 / n_prof)
                for e in top[:12]],
            "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
