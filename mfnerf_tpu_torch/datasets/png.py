"""PNG reader and writer in plain Python, ``zlib`` and numpy.

The machine that runs the port has no imageio, PIL or cv2. This module is
the port's image decoder: ``color_utils.read_image`` reads through it.

:func:`read_png` decodes 8-bit gray, gray+alpha, RGB and RGBA files, not
interlaced, with any of the five row filters. A file of None, Sub (a
cumulative sum mod 256 along the row) and Up rows is decoded a row at a
time. Average and Paeth need the decoded pixel to their left, so a file
that uses them (as Blender writes them) is decoded an anti-diagonal of
pixels at a time: a pixel depends only on its left, upper and upper-left
neighbours, which lie on the two diagonals before its own. It raises
``ValueError``, naming the file, on 16-bit, palette and interlaced files.

:func:`png_size` reads a file's width and height from its header.
:func:`write_png` writes 8-bit files with filter type 0 or 1 on every row.
"""
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}    # colour type -> samples a pixel
COLOR_TYPE = {c: t for t, c in CHANNELS.items()}


def _chunks(data, path):
    """(type, payload) of each chunk after the signature, CRC checked."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if pos + 12 + length > len(data):
            break
        payload = data[pos + 8:pos + 8 + length]
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"{path}: bad CRC in the {kind!r} chunk")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: truncated PNG (no IEND chunk)")


def _unfilter_rows(filters, out, w, c):
    """None, Sub and Up rows of ``out`` ((H, W*C) uint8) in place."""
    prev = np.zeros(w * c, np.uint8)
    for kind, row in zip(filters, out):
        if kind == 1:
            row[:] = np.cumsum(row.reshape(w, c), 0, dtype=np.uint8).ravel()
        elif kind == 2:
            row += prev
        prev = row


def _unfilter_diagonals(filters, out, w, c):
    """Rows of any filter in ``out`` ((H, W*C) uint8) in place, the pixels
    of each anti-diagonal y + x = d together."""
    h = len(filters)
    # skewed: pixel (y, x) at [y + x + 2, y + 1], so a diagonal is a row
    # and its left, upper and upper-left neighbours are slices of the two
    # rows before it; the untouched entries stand for the zero bytes left
    # of and above the image
    px = np.zeros((h + w + 1, h + 1, c), np.int32)
    raw = np.zeros((h + w - 1, h, c), np.int32)
    rows = out.reshape(h, w, c)
    for y in range(h):
        raw[y:y + w, y] = rows[y]
    kinds = filters.astype(np.int32)[:, None]
    for d in range(h + w - 1):
        y0, y1 = max(0, d - w + 1), min(h, d + 1)
        a, b = px[d + 1, y0 + 1:y1 + 1], px[d + 1, y0:y1]
        ul, k = px[d, y0:y1], kinds[y0:y1]
        # Paeth: the neighbour nearest a + b - ul, ties to a, then b
        pa, pb, pc = np.abs(b - ul), np.abs(a - ul), np.abs(a + b - 2 * ul)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, ul))
        pred = np.select([k == 1, k == 2, k == 3, k == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        px[d + 2, y0 + 1:y1 + 1] = (raw[d, y0:y1] + pred) & 0xFF
    for y in range(h):
        rows[y] = px[y + 2:y + 2 + w, y + 1]


def png_size(path):
    """(W, H) of a PNG from its IHDR chunk, without decoding the pixels."""
    with open(path, "rb") as f:
        data = f.read(33)
    if data[:8] != SIGNATURE or data[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    return struct.unpack(">II", data[16:24])


def read_png(path):
    """uint8 pixels of an 8-bit PNG: (H, W) for gray, else (H, W, C) with C
    2 (gray+alpha), 3 (RGB) or 4 (RGBA), as imageio returns them."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, payload in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNG; only 8-bit is read")
    if color not in CHANNELS:
        raise ValueError(f"{path}: colour type {color} is not read (palette "
                         f"or unknown)")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not read")
    c = CHANNELS[color]
    stride = w * c
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: {raw.size} bytes of pixel data, expected "
                         f"{h * (stride + 1)}")
    rows = raw.reshape(h, stride + 1)
    filters, out = rows[:, 0], rows[:, 1:].copy()
    if filters.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown row filter {filters.max()}")
    if filters.max(initial=0) > 2:
        _unfilter_diagonals(filters, out, w, c)
    else:
        _unfilter_rows(filters, out, w, c)
    return out.reshape(h, w) if c == 1 else out.reshape(h, w, c)


def write_png(path, img, filter_type=1):
    """Write uint8 ``img`` ((H, W) gray or (H, W, C), C in 1-4) as an 8-bit
    PNG whose rows all use ``filter_type``: 0 (None) or 1 (Sub)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 pixels, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if filter_type == 1:
        # each byte minus the same channel's byte one pixel to the left
        img = np.diff(img, axis=1, prepend=np.zeros((h, 1, c), np.uint8))
    elif filter_type != 0:
        raise ValueError(f"filter_type {filter_type}: write_png writes 0 or 1")
    rows = np.concatenate([np.full((h, 1), filter_type, np.uint8),
                           img.reshape(h, w * c)], 1)
    header = struct.pack(">IIBBBBB", w, h, 8, COLOR_TYPE[c], 0, 0, 0)

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    with open(path, "wb") as f:
        f.write(SIGNATURE + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))
