"""The benchmark of ``mfnerf_tpu_torch``: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout holding ``BENCHMARK.json``. The cell names a
configuration and a traffic mix (``portbench/spec.py`` finds their files);
the mix's kind (``portbench/kinds/``) builds the scene on the card from
the seed, trains and warms up what the mix uses (set-up, ``setup_s`` from
process start), then measures for ``--seconds`` (``--trace 0``: the cell's
end-to-end metrics) or runs a short traced window under ``torch.profiler``
(``--trace 1``: its per-layer metrics, the device's busy and window
seconds, the breakdown). After the window: the peak of device memory, the
check that no JAX module was loaded, the program freed, the reference's
check (``correct``), each compared number beside its limit on standard
error's last lines and last in the result, and the result as standard
output's last line. Exits 2, with no result, without as many CUDA devices
as the cell asks for; 3 if a JAX module was loaded.

The program's kernels build into ``mfnerf_tpu_torch/_build/`` inside the
checkout, at first use: only a checkout's first run compiles.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import spec as spec_mod  # noqa: E402
from portbench import trace as trace_mod  # noqa: E402
from portbench.reference import compare  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_line():
    """nvidia-smi's name and power limit of the card, or None."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return None


def main(argv=None, root=ROOT, device=None, t0=T0):
    """One run; returns the exit code. ``device`` None: the card (the
    tests pass the CPU, which skips the look for a card)."""
    args = parse(argv)
    import torch
    layout = spec_mod.Layout(root)
    cell = layout.cell(args.workload)
    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell["chips"]:
            print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                  f"this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"
    # the configurations compute in IEEE float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    traffic = layout.traffic(cell["traffic"])
    run = layout.kind(traffic["kind"]).Run(
        layout.config(cell["config"]), traffic, args.seed, device)
    limits = layout.limits(args.workload)["limits"]

    run.setup()
    if on_card:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    tr = None
    if args.trace:
        work, tr = trace_mod.traced(run.traced_work, device)
        rec = run.record(work, tr.window_s)
    else:
        rec = run.window(args.seconds)
    rec.update(setup_s=setup_s, trace=tr)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    found = spec_mod.forbidden_modules(sys.modules)
    if found:
        print(f"modules of JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 3

    run.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = run.check()
    check, correct = compare.verdict(numbers, limits)

    metrics = {}
    for m in layout.metrics_of(args.workload, args.trace):
        value = layout.metric(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card
           else device.type, "count": cell["chips"],
           "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": rec["attempted"], "failed": 0,
              "metrics": metrics, "device": dev}
    if tr is not None:
        dev.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["check"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in check.items()}
    if on_card:
        print(f"card: {card_line()}", file=sys.stderr)
    print(f"set-up phases (s): {json.dumps(run.laps.laps)}", file=sys.stderr)
    extra = {k: v for k, v in numbers.items() if k not in check}
    print(f"check, not compared: {json.dumps(extra)}", file=sys.stderr)
    for k, (v, lim) in check.items():
        print(f"check {k}: {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
