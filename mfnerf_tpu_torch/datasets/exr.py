"""OpenEXR reader: ``csrc/exr.cpp`` through ``ctypes``.

RTMV publishes its frames as OpenEXR, linear light in half floats.
``misc/prepare_rtmv.py`` turns them into the PNGs that the RTMV loader
reads; this module is its decoder (``color_utils.read_image`` itself reads
only PNG and JPEG). The library is host C++ with no dependency, built by
``build.py`` with the host compiler at first use (``_build/``), so the CPU
tests run the decoder that the card machine runs.

:func:`read_exr` reads single-part scanline files compressed with NONE,
RLE, ZIPS, ZIP or PIZ, with HALF (converted to float32 exactly) or FLOAT
channels. PXR24, B44, B44A, DWAA and DWAB, UINT and subsampled channels,
tiled, deep and multi-part files, a data window other than the display
window and a file without R, G and B raise ``ValueError`` naming the file
and the feature.
"""
import ctypes
import functools

import numpy as np

from .. import build

SIGNATURE = b"v/1\x01"
_ERR_LEN = 256


@functools.cache
def _library():
    lib = build.load_library("exr")
    lib.mfx_info.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                             ctypes.POINTER(ctypes.c_int), ctypes.c_char_p,
                             ctypes.c_int]
    lib.mfx_info.restype = ctypes.c_int
    lib.mfx_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                               ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.mfx_decode.restype = ctypes.c_int
    return lib


def decode_exr(data, name="<bytes>"):
    """The OpenEXR file ``data`` (bytes) as float32 (H, W, C): R, G, B and,
    where the file has it, A."""
    lib = _library()
    dims = (ctypes.c_int * 3)()
    err = ctypes.create_string_buffer(_ERR_LEN)
    if lib.mfx_info(data, len(data), dims, err, _ERR_LEN):
        raise ValueError(f"{name}: OpenEXR not decoded: "
                         f"{err.value.decode()}")
    h, w, c = dims
    out = np.empty((h, w, c), np.float32)
    if lib.mfx_decode(data, len(data), out.ctypes.data, err, _ERR_LEN):
        raise ValueError(f"{name}: OpenEXR not decoded: "
                         f"{err.value.decode()}")
    return out


def read_exr(path):
    """Decode the OpenEXR file at ``path`` to float32 (H, W, C), C 3 or 4."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_exr(data, str(path))
