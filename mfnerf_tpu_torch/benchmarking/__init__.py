"""The encoder formulation probes on the card: ports of
``benchmarking/probe_pallas_gather.py``, ``probe_pallas_gather2.py`` and
``probe_pallas_hatmul.py``.

Each probe module has ``run(device="cuda", seed=0, n=None)``, which builds
the JAX probe's operands from a numpy seed at its shape, checks the port's
kernel against its plain torch version, and returns the kernel's, the plain
version's and the library call's device times (:func:`graph_ms`) beside the
kernel's bound, and a
``main()`` that prints one line a formulation and exits non-zero on a
mismatch or without a CUDA device::

    python3 -m mfnerf_tpu_torch.benchmarking.probe_gather2

They run on the card only: ``run`` raises for any other device. The TPU
probes' tile, lane and padding sizes are the TPU's and are not ported.
"""
import subprocess
import sys

import torch

from ..device import resolve_device

# NVIDIA H100 SXM peaks (data sheet): HBM bytes/s, fp32 FLOP/s off the
# tensor cores
HBM_BPS, FP32_FLOPS = 3.35e12, 67e12


def card_device(device):
    """``device`` as a CUDA device; raises for the CPU or without a card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"the probes time the card, not {dev}")
    return dev


def card_name():
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters):
    """Mean device milliseconds per call, timed with CUDA events after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters):
    """Mean device milliseconds per call of ``fn``: ``iters`` calls captured
    in one CUDA graph and replayed between two CUDA events, so that the
    host's time per call (a wrapper's checks and launch, ~20-40 us) leaves
    no gap on the device. A kernel of ~20 us timed call by call times the
    host instead. ``fn`` must run on the current stream only."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # capture wants a warm-up off the
        fn()                            # default stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes, flops):
    """(least ms, "bytes" or "operations"): the bytes over HBM's rate or the
    fp32 operations over the peak, whichever takes longer."""
    by_bytes, by_ops = n_bytes / HBM_BPS * 1e3, flops / FP32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                          "operations")


def max_err(got, want):
    """(max |got - want|, max |want|) as floats."""
    return float((got - want).abs().max()), float(want.abs().max())


# grid_sample moves a position by a few ulps on its way through the
# normalised grid coordinate x = 2 pos / (K-1) - 1 (~1.5e-5 at K = 128,
# ~8e-5 at K = 513), times the largest difference of two rows
LIBRARY_TOL = 1e-3             # x max |plain|


def lerp_row(table, pos, launch, plain, n_bytes, flops, failed, label):
    """Check and time one mode of the table lerp: ``launch()`` (the kernel)
    must equal ``plain()`` bit for bit, and grid_sample (the library call
    that computes the same lerp from positions ``pos``, float64) must agree
    within LIBRARY_TOL. Appends what failed to ``failed``; returns the
    kernel's row."""
    k, r = table.shape
    got, want = launch(), plain()
    # the table as a (1, R, 1, K) image; x in [-1, 1] along its K pixels
    image = table.T.contiguous()[None, :, None, :]
    x = (2 * pos / (k - 1) - 1).to(torch.float32)
    grid = torch.stack([x, torch.zeros_like(x)], dim=1)[None, None]

    def library():
        return torch.nn.functional.grid_sample(
            image, grid, mode="bilinear", padding_mode="zeros",
            align_corners=True)

    lib = library()[0, :, 0, :].T
    torch.cuda.synchronize()
    n = want.shape[0]
    if got.shape != want.shape or got.dtype != want.dtype:
        raise RuntimeError(f"{label}: kernel output {tuple(got.shape)} "
                           f"{got.dtype}, plain {tuple(want.shape)}")
    err, scale = max_err(got, want)
    lib_err = max_err(lib, want)[0]
    bitwise = bool(torch.equal(got, want))
    if not bitwise:
        failed.append(f"{label}: kernel vs plain, max abs err {err}")
    if lib_err > LIBRARY_TOL * scale:
        failed.append(f"{label}: grid_sample vs plain, {lib_err} of {scale}")
    ms = graph_ms(launch, 20)
    bound_ms, bound_by = bound(n_bytes, flops)
    return dict(n=n, k=k, r=r, max_abs_err=err, max_abs=scale,
                bitwise_equal=bitwise, ms=ms, plain_ms=graph_ms(plain, 3),
                library="grid_sample", library_ms=graph_ms(library, 20),
                library_max_abs_err=lib_err, library_tol=LIBRARY_TOL,
                bound_ms=bound_ms, bound_by=bound_by,
                share_of_bound=bound_ms / ms)


def probe_main(run):
    """Run a probe and print its formulations, one line each (ms and
    ns/sample, as the JAX probes print); 0 if every check passed."""
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    res = run()
    print(f"device: {res['card']}", file=sys.stderr)
    for name, row in res["kernels"].items():
        n = row["n"]
        lines = [(f"cuda {name}", row["ms"]),
                 (f"plain torch {name}", row["plain_ms"])]
        if row["library"] is not None:
            lines.append((row["library"], row["library_ms"]))
        for label, ms in lines:
            print(f"{label}: {ms:.4f} ms = {ms * 1e6 / n:.3f} ns/sample")
        print(f"  bound {row['bound_ms']:.4f} ms ({row['bound_by']}), max "
              f"abs err vs plain {row['max_abs_err']}")
    for what in res["failed"]:
        print(f"FAILED: {what}")
    return 0 if not res["failed"] else 1
