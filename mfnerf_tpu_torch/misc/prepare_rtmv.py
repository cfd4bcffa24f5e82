"""Convert an RTMV scene's OpenEXR frames to the PNGs its loader reads.

Port of ``misc/prepare_rtmv.py``: every ``*.exr`` in the scene's root, in
sorted order, becomes ``images/<name>.png``: its R, G and B clipped to
[0, 1] in float32, ``linear_to_srgb``, then ``(img * 255).astype(uint8)``
(truncation, as the JAX script does). ``datasets/exr.py`` decodes and
``datasets/png.py`` encodes, so no imageio plugin is needed.

    python -m mfnerf_tpu_torch.misc.prepare_rtmv <root_dir>
"""
import argparse
import glob
import os

import numpy as np

from ..datasets.color_utils import linear_to_srgb
from ..datasets.exr import read_exr
from ..datasets.png import write_png


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("root_dir", help="RTMV scene dir containing *.exr")
    args = ap.parse_args(argv)

    exrs = sorted(glob.glob(os.path.join(args.root_dir, "*.exr")))
    if not exrs:
        raise SystemExit(f"no .exr files under {args.root_dir}")
    out_dir = os.path.join(args.root_dir, "images")
    os.makedirs(out_dir, exist_ok=True)
    for p in exrs:
        img = read_exr(p)
        img = np.clip(img[..., :3].astype(np.float32), 0, 1)
        img = linear_to_srgb(img)
        name = os.path.splitext(os.path.basename(p))[0] + ".png"
        write_png(os.path.join(out_dir, name), (img * 255).astype(np.uint8))
        print(name, flush=True)


if __name__ == "__main__":
    main()
