"""What bounds the hat-CP backward kernel: this tree's kernel timed beside
copies of it with one part switched off, on one NVIDIA GPU.

    python3 tools/hat_bwd_variants.py

Each variant is csrc/hatmul.cu with one edit, compiled with the build's
nvcc flags into the build directory:

* base: the kernel as it is;
* fixed: no sample steps (the slab's zeroing and write-out, and stage 2);
* nowalk: the walkers take each step from the ring but do not walk it, so
  the producers alone set the pace;
* noflush: the walk never writes the slab (the run-length sums only).

The variants' results are wrong by design; only their times mean anything.
Two shapes, K = 257 and R = 128: N = 2^19 of uniform u (rows change every
sample) and 8,192 rays of 14 samples 1.5 knot steps apart (ray-major rows,
as training hands them over). Times with and without du, CUDA events, mean
of 10 launches; one JSON line a shape, the card's name and power limit
first.
"""
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from mfnerf_tpu_torch import build  # noqa: E402
from mfnerf_tpu_torch.ops import hatmul  # noqa: E402

VARIANTS = {
    "base": [],
    "fixed": [("  const int steps = end > begin",
               "  const int steps = 0 && end > begin")],
    "nowalk": [("    for (int t = 0; t < kBwdStage; ++t) {\n"
                "      const int i = rows[t];",
                "    for (int t = 0; t < 0; ++t) {\n"
                "      const int i = rows[t];")],
    "noflush": [("      if (i != cur) {\n",
                 "      if (false && i != cur) {\n")],
}


def load_variant(name, edits):
    src = (build.CSRC / "hatmul.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: the edit's target is gone")
        src = src.replace(old, new)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = build.BUILD_DIR / f"hatmul-variant-{name}.cu"
    lib = build.BUILD_DIR / f"libhatmul-variant-{name}.so"
    cu.write_text(src)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(cu)], check=True)
    fn = ctypes.CDLL(str(lib)).hat_prod_bwd
    fn.argtypes = hatmul._kernels()[1].argtypes
    fn.restype = ctypes.c_int
    return fn


def shapes(rng):
    yield "uniform", rng.random((1 << 19, 3), dtype=np.float32)
    rays, per_ray, k = 8192, 14, 257
    origin = rng.random((rays, 1, 3), dtype=np.float32) * 0.6 + 0.2
    d = rng.normal(size=(rays, 1, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=2, keepdims=True)
    t = np.arange(per_ray, dtype=np.float32)[None, :, None] * 1.5 / (k - 1)
    yield "rays", np.clip(origin + d * t, 0, 1).reshape(-1, 3).astype(
        np.float32)


def main():
    if not torch.cuda.is_available():
        print("hat_bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    fns = {name: load_variant(name, edits)
           for name, edits in VARIANTS.items()}
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    k, r = 257, 128
    w_bf = torch.from_numpy((1 + 0.3 * rng.normal(size=(3, k, r))).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    for label, u in shapes(rng):
        n = u.shape[0]
        u3 = torch.from_numpy(u).to(dev)
        g = torch.randn((n, r), device=dev)
        chunk, chunks = hatmul.bwd_chunking(n, r)
        dw = torch.empty((3, k, r), device=dev)
        du = torch.empty((n, 3), device=dev)
        slabs = torch.empty((chunks, 3, k, r), device=dev)
        part = torch.empty((-(-r // hatmul.BWD_COLS), n, 3), device=dev)
        row = {"shape": label, "n": n, "card": card}
        for name, fn in fns.items():
            for need_du in (True, False):
                def launch(fn=fn, need_du=need_du):
                    rc = fn(u3.data_ptr(), w_bf.data_ptr(), g.data_ptr(), r,
                            du.data_ptr() if need_du else None,
                            dw.data_ptr(), slabs.data_ptr(),
                            part.data_ptr() if need_du else None, n, k, r,
                            chunk, chunks, None, stream)
                    assert rc == 0, rc
                key = f"{name}_ms" + ("" if need_du else "_no_du")
                row[key] = chip_smoke.cuda_ms(launch, 10)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
