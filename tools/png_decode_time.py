"""Time ``datasets/png.py``'s decoder on one 800x800 RGBA file a row filter.

    python3 tools/png_decode_time.py [--wh 800] [--repeats 3]

For each of the five PNG row filters, writes a smooth noisy 8-bit RGBA
image whose rows all use that filter (filtered here, vectorised, by the PNG
specification's definition), decodes it ``--repeats`` times with
``read_png``, checks the pixels and prints the times in seconds with the
CPU's model name. Runs on the host; no device.
"""
import argparse
import json
import os
import platform
import struct
import sys
import tempfile
import time
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from mfnerf_tpu_torch.datasets import png  # noqa: E402


def filtered_rows(img, kind):
    """(H, 1 + W*C) uint8: each row of ``img`` (H, W, C) filtered by
    ``kind``, with its filter byte first."""
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int64)
    a = np.pad(x, ((0, 0), (c, 0)))[:, :-c]            # the byte to the left
    b = np.pad(x, ((1, 0), (0, 0)))[:-1]               # the byte above
    cc = np.pad(b, ((0, 0), (c, 0)))[:, :-c]           # above and left
    if kind == 4:
        p = a + b - cc
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
    else:
        pred = (0, a, b, (a + b) // 2)[kind]
    body = ((x - pred) % 256).astype(np.uint8)
    return np.concatenate([np.full((h, 1), kind, np.uint8), body], 1)


def write(path, img, kind):
    h, w, _ = img.shape

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload)))

    header = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(png.SIGNATURE + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(
                    filtered_rows(img, kind).tobytes()))
                + chunk(b"IEND", b""))


def cpu_name():
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--wh", type=int, default=800)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    rng = np.random.default_rng(0)
    i = np.arange(args.wh)
    smooth = 128 + 60 * np.sin(i[None, :, None] / 30) * np.cos(
        i[:, None, None] / 40)
    img = (smooth + rng.normal(0, 3, (args.wh, args.wh, 4))).clip(
        0, 255).astype(np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        for kind, name in enumerate(("None", "Sub", "Up", "Average",
                                     "Paeth")):
            path = os.path.join(tmp, f"{name}.png")
            write(path, img, kind)
            times = []
            for _ in range(args.repeats):
                t0 = time.perf_counter()
                out = png.read_png(path)
                times.append(time.perf_counter() - t0)
            if not np.array_equal(out, img):
                raise RuntimeError(f"{name}: decoded pixels differ")
            print(json.dumps({"filter": name, "wh": args.wh,
                              "channels": 4, "seconds": times,
                              "cpu": cpu_name()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
