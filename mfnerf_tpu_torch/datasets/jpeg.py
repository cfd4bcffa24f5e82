"""JPEG reader: ``csrc/jpeg.cpp`` through ``ctypes``.

The machine that runs the port has no imageio, PIL or cv2. This module is
the port's JPEG decoder: ``color_utils.read_image`` reads through it. The
library is host C++ with no dependency, built by ``build.py`` with the host
compiler at first use (``_build/``), so the CPU tests run the decoder that
the card machine runs.

:func:`read_jpeg` returns libjpeg's default decode bit for bit (ISLOW IDCT,
fancy upsampling, the fixed-point YCbCr tables): what the JAX package's
native loader and PIL return. Baseline, extended-sequential and progressive
Huffman files with one or three components, any integral sampling ratio and
restart intervals are read; arithmetic coding, lossless, hierarchical,
12-bit and CMYK/YCCK files raise ``ValueError`` naming the file and the
feature.
"""
import ctypes
import functools

import numpy as np

from .. import build

SIGNATURE = b"\xff\xd8\xff"
_ERR_LEN = 256


@functools.cache
def _library():
    lib = build.load_library("jpeg")
    lib.mfj_info.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                             ctypes.POINTER(ctypes.c_int), ctypes.c_char_p,
                             ctypes.c_int]
    lib.mfj_info.restype = ctypes.c_int
    lib.mfj_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                               ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.mfj_decode.restype = ctypes.c_int
    return lib


def decode_jpeg(data, name="<bytes>"):
    """The JPEG file ``data`` (bytes) as uint8 (H, W, C), C 1 or 3."""
    lib = _library()
    dims = (ctypes.c_int * 3)()
    err = ctypes.create_string_buffer(_ERR_LEN)
    if lib.mfj_info(data, len(data), dims, err, _ERR_LEN):
        raise ValueError(f"{name}: JPEG not decoded: {err.value.decode()}")
    h, w, c = dims
    out = np.empty((h, w, c), np.uint8)
    if lib.mfj_decode(data, len(data), out.ctypes.data, err, _ERR_LEN):
        raise ValueError(f"{name}: JPEG not decoded: {err.value.decode()}")
    return out


def read_jpeg(path):
    """Decode the JPEG at ``path`` to uint8 (H, W, C), C 1 or 3."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_jpeg(data, str(path))
