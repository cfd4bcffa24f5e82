"""PFM depth-map reading (numpy): port of
``mfnerf_tpu/datasets/depth_utils.py``, which no loader's main path calls
either."""
import re

import numpy as np


def read_pfm(path):
    """Read a .pfm file -> (data, scale): (H, W) for ``Pf``, (H, W, 3) for
    ``PF``, rows flipped to top-first; little-endian when the scale is
    negative."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError(f"{path}: not a PFM file")
        dims = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        if not dims:
            raise ValueError(f"{path}: malformed PFM header")
        width, height = map(int, dims.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)
        data = np.fromfile(f, endian + "f")
        shape = (height, width, 3) if color else (height, width)
        return np.flipud(data.reshape(shape)), scale
