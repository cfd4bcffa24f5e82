"""What an NCCL all-reduce needs to be captured in a CUDA graph with this
build of PyTorch: a one-rank NCCL process group on card 0, each case in a
process of its own (a failed capture may leave the process unusable).

    python3 tools/nccl_capture_probe.py [--captures 8] [--sleep 0.3]

Cases, one JSON line each (the captures that replayed right, those that
failed and their errors, the versions of torch, CUDA and NCCL):

* "global" and "thread_local": ``torch.cuda.graph`` in that capture error
  mode, right after three eager all-reduces on the capturing stream (they
  create the communicator, and the process group's watchdog thread then
  polls them), with ``--sleep`` seconds on the host inside each capture,
  so that the watchdog polls while the capture runs;
* "no_communicator": one capture in the default mode with no collective
  before it, so that the communicator is made inside the capture.

The fused training runner (mfnerf_tpu_torch/train.py::FusedRunner) relies
on what the first two show and avoids what the third shows. Exits non-zero
without a CUDA device.
"""
import argparse
import json
import socket
import subprocess
import sys
import time


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_case(case, captures, sleep_s):
    """One case in this process: its JSON line."""
    import torch
    import torch.distributed as dist
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
        world_size=1)
    x = torch.ones(1 << 20, device=dev)
    side = torch.cuda.Stream()
    eager = case != "no_communicator"
    mode = "thread_local" if case == "thread_local" else "global"
    out = dict(case=case, capture_error_mode=mode, torch=torch.__version__,
               cuda=torch.version.cuda,
               nccl=".".join(map(str, torch.cuda.nccl.version())),
               captures=0, replayed_right=0, failed=0, errors=[])
    try:
        for _ in range(captures if eager else 1):
            if eager:
                with torch.cuda.stream(side):
                    for _ in range(3):
                        dist.all_reduce(x)
            graph = torch.cuda.CUDAGraph()
            out["captures"] += 1
            try:
                with torch.cuda.graph(graph, stream=side,
                                      capture_error_mode=mode):
                    y = x * 2
                    time.sleep(sleep_s)
                    dist.all_reduce(y)
                    z = y + 1
                graph.replay()
                torch.cuda.synchronize()
                out["replayed_right"] += int(bool((z == 3).all()))
            except (RuntimeError, getattr(torch, "AcceleratorError",
                                          RuntimeError)) as e:
                # a failed capture: recorded
                out["failed"] += 1
                out["errors"].append(str(e).splitlines()[0][:300])
            del graph
    finally:
        print(json.dumps(out), flush=True)
        if eager:
            dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--captures", type=int, default=8)
    ap.add_argument("--sleep", type=float, default=0.3)
    ap.add_argument("--case", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("nccl_capture_probe: no CUDA device", file=sys.stderr)
        return 1
    if args.case is not None:
        run_case(args.case, args.captures, args.sleep)
        return 0
    for case in ("global", "thread_local", "no_communicator"):
        r = subprocess.run(
            [sys.executable, __file__, "--case", case, "--captures",
             str(args.captures), "--sleep", str(args.sleep)],
            capture_output=True, text=True, timeout=300)
        lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
        print(lines[-1] if lines else json.dumps(dict(
            case=case, rc=r.returncode, stderr=r.stderr[-1000:])),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
