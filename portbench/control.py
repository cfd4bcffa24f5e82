"""The check's readings over many seeds in one process: the program
against the reference (the sound runs' readings, from which each limit's
lower end is set), the control (the reference computed in TF32, put in the
program's place) and the faults the reference can carry (``half_batch``:
half of each batch left out, the mean taken over the rest), each against
the reference, at the cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        [--variants tf32,half_batch] [--frames 20]

One JSON line a seed: the seed, and the numbers of the program and of
each variant, each with ``correct`` as a run decides it
(``compare.verdict`` against ``portbench/limits/<cell>.json``). Exits 1
where the program reads not correct or a variant reads correct on any
seed. A serving cell serves ``--frames`` frames of its traffic first, so
that the check has frames to keep. The benchmark's runs do not run this;
it needs the card, as they do.
"""
import argparse
import gc
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import spec as spec_mod  # noqa: E402
from portbench.reference import compare  # noqa: E402


def main(argv=None, root=ROOT, device=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--variants", default="tf32")
    p.add_argument("--frames", type=int, default=20)
    args = p.parse_args(argv)
    import torch
    if device is None:
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 2
        device = "cuda"
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    layout = spec_mod.Layout(root)
    cell = layout.cell(args.workload)
    traffic = layout.traffic(cell["traffic"])
    config = layout.config(cell["config"])
    kind = layout.kind(traffic["kind"])
    limits = layout.limits(args.workload)["limits"]

    def judged(numbers):
        return dict(numbers, correct=compare.verdict(numbers, limits)[1])

    rc = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = kind.Run(config, traffic, seed, device)
        run.setup()
        if traffic["kind"] == "serve":
            run._frames(lambda k: k < args.frames)
        run.release()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        line = {"workload": args.workload, "seed": seed,
                "program": judged(run.check())}
        rc |= not line["program"]["correct"]
        for v in filter(None, args.variants.split(",")):
            line[v] = judged(run.control(v))
            rc |= line[v]["correct"]
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del run
        gc.collect()
    return int(rc)


if __name__ == "__main__":
    sys.exit(main())
