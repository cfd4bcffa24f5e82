"""The port's image I/O against imageio and the JAX package, on the CPU.

* ``datasets/png.py`` decodes what imageio (PIL's adaptive row filters)
  writes, and files whose rows the test filters itself with each of the
  five PNG filters, one filter a file or a random one a row, bit for bit
  as imageio reads them; imageio reads what ``png.py`` writes bit for bit.
* ``read_image`` against the JAX ``read_image``: 1e-6 at the file's size,
  2e-3 resized (cv2's ``INTER_LINEAR`` on float32 and a bilinear torch
  resize agree to about 1e-3; tests/test_native.py allows the JAX native
  loader 2e-3 against cv2).
* ``depth2img`` against the JAX ``depth2img`` (cv2's TURBO), bit for bit.
"""
import struct
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest
import torch
from PIL import Image

from mfnerf_tpu import train as jtrain
from mfnerf_tpu.datasets import color_utils as jcolor

from mfnerf_tpu_torch import train as ttrain
from mfnerf_tpu_torch.datasets import color_utils as tcolor
from mfnerf_tpu_torch.datasets import png

RESIZE_TOL = 2e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pattern(h, w, c, seed=0):
    """uint8 (h, w, c) rows that PIL's adaptive filter encodes with None
    (flat rows), Sub (ramps), Up (repeats) and Paeth (noise)."""
    rng = np.random.default_rng(seed)
    img = np.empty((h, w, c), np.uint8)
    ramp = np.arange(w)[:, None] * rng.integers(1, 50, c)[None]
    for y in range(h):
        kind = y % 4
        if kind == 0:
            img[y] = 0
        elif kind == 1:
            img[y] = (ramp + rng.integers(0, 256, c)) % 256
        elif kind == 2:
            img[y] = img[y - 1]
        else:
            img[y] = rng.integers(0, 256, (w, c))
    return img


def _squeeze(img):
    return img[..., 0] if img.shape[-1] == 1 else img


def _row_filters(path):
    """The filter byte of each row of an 8-bit PNG file."""
    data = open(path, "rb").read()
    pos, idat, header = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data[pos + 8:pos + 8 + n])
        elif kind == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    w, h, _, color = header[:4]
    stride = w * png.CHANNELS[color] + 1
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return set(raw.reshape(h, stride)[:, 0].tolist())


def _predict(kind, a, b, c):
    if kind == 0:
        return 0
    if kind == 1:
        return a
    if kind == 2:
        return b
    if kind == 3:
        return (a + b) // 2
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _write_filtered(path, img, kinds):
    """An 8-bit PNG of ``img`` ((h, w, c) uint8) whose row y uses filter
    ``kinds[y]``, filtered here by the PNG specification's definition."""
    h, w, c = img.shape
    flat = img.reshape(h, w * c).astype(np.int64)
    rows = []
    for y, kind in enumerate(kinds):
        up = flat[y - 1] if y else np.zeros(w * c, np.int64)
        out = [kind]
        for x in range(w * c):
            a = flat[y, x - c] if x >= c else 0
            cc = up[x - c] if x >= c else 0
            out.append((flat[y, x] - _predict(kind, a, up[x], cc)) % 256)
        rows.append(bytes(out))

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload)))

    header = struct.pack(">IIBBBBB", w, h, 8, png.COLOR_TYPE[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(png.SIGNATURE + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(b"".join(rows)))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_reads_what_imageio_writes(tmp_path, channels):
    img = _squeeze(_pattern(24, 20, channels, seed=channels))
    path = str(tmp_path / "a.png")
    imageio.imwrite(path, img)
    assert len(_row_filters(path)) >= 3     # PIL's adaptive choice
    got = png.read_png(path)
    want = imageio.imread(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("channels", [1, 4])
def test_png_reads_every_row_filter(tmp_path, kind, channels):
    img = np.random.default_rng(kind).integers(0, 256, (9, 7, channels),
                                               dtype=np.uint8)
    img[3:6] //= 4                 # smooth rows: carries below and above
    path = str(tmp_path / "f.png")
    _write_filtered(path, img, [kind] * len(img))
    assert _row_filters(path) == {kind}
    np.testing.assert_array_equal(png.read_png(path), imageio.imread(path))
    np.testing.assert_array_equal(png.read_png(path), _squeeze(img))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("hw", [(17, 6), (5, 23)])
def test_png_reads_mixed_row_filters(tmp_path, channels, hw):
    """A random filter a row, in images taller and wider than square: the
    anti-diagonal decode, rows of Average and Paeth among the others."""
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (*hw, channels), dtype=np.uint8)
    img[1::3] //= 8                # smooth rows: carries below and above
    kinds = rng.integers(0, 5, hw[0])
    kinds[:5] = [0, 1, 2, 3, 4]
    path = str(tmp_path / "m.png")
    _write_filtered(path, img, kinds)
    assert _row_filters(path) == {0, 1, 2, 3, 4}
    np.testing.assert_array_equal(png.read_png(path), imageio.imread(path))
    np.testing.assert_array_equal(png.read_png(path), _squeeze(img))


@pytest.mark.parametrize("filter_type", [0, 1])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_imageio_reads_what_png_writes(tmp_path, filter_type, channels):
    img = _squeeze(_pattern(13, 11, channels, seed=5))
    path = str(tmp_path / "w.png")
    png.write_png(path, img, filter_type)
    assert _row_filters(path) == {filter_type}
    np.testing.assert_array_equal(imageio.imread(path), img)


def _interlaced(tmp_path):
    """A valid file with the interlace byte of its header set."""
    path = str(tmp_path / "i.png")
    png.write_png(path, np.zeros((4, 4, 3), np.uint8))
    data = bytearray(open(path, "rb").read())
    data[28] = 1                                   # IHDR's interlace method
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    open(path, "wb").write(bytes(data))
    return path


@pytest.mark.parametrize("kind,match", [("16-bit", "16-bit"),
                                        ("palette", "palette"),
                                        ("interlaced", "interlaced")])
def test_png_refuses_what_it_does_not_read(tmp_path, kind, match):
    if kind == "16-bit":
        path = str(tmp_path / "d.png")
        imageio.imwrite(path, np.arange(64, dtype=np.uint16).reshape(8, 8)
                        * 1000)
    elif kind == "palette":
        path = str(tmp_path / "p.png")
        Image.fromarray(_pattern(8, 8, 3)).convert("P").save(path)
    else:
        path = _interlaced(tmp_path)
    with pytest.raises(ValueError, match=match) as info:
        png.read_png(path)
    assert path in str(info.value)


def _rgba_image(h=20, w=24, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    img[:5, :, 3] = 0                              # transparent rows
    img[5:10, :, 3] = 255                          # opaque rows
    return img


@pytest.mark.parametrize("blend_a", [True, False])
@pytest.mark.parametrize("wh,tol", [((24, 20), 1e-6), ((13, 9), RESIZE_TOL),
                                    ((40, 36), RESIZE_TOL)])
def test_read_image_matches_jax(tmp_path, blend_a, wh, tol):
    for name, img in (("rgba", _rgba_image(seed=1)),
                      ("rgb", _rgba_image(seed=2)[..., :3]),
                      ("gray", _rgba_image(seed=3)[..., 0])):
        path = str(tmp_path / f"{name}.png")
        imageio.imwrite(path, img)
        got = tcolor.read_image(path, wh, blend_a)
        want = jcolor.read_image(path, wh, blend_a)
        assert got.shape == want.shape == (wh[0] * wh[1], 3), name
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=name)


def test_srgb_conversions_match_jax():
    x = np.linspace(0, 1.2, 101, dtype=np.float32)
    np.testing.assert_array_equal(tcolor.srgb_to_linear(x),
                                  jcolor.srgb_to_linear(x))
    np.testing.assert_array_equal(tcolor.linear_to_srgb(x.copy()),
                                  jcolor.linear_to_srgb(x.copy()))


@pytest.mark.parametrize("seed", [0, 1])
def test_depth2img_matches_jax(seed):
    rng = np.random.default_rng(seed)
    depth = (rng.random((17, 23)) * rng.uniform(0.1, 5)).astype(np.float32)
    depth[0, 0] = 0.0
    got = ttrain.depth2img(depth)
    want = jtrain.depth2img(depth)
    assert got.dtype == np.uint8 and got.shape == (17, 23, 3)
    np.testing.assert_array_equal(got, want)
    # a ramp across the whole table
    ramp = np.arange(256, dtype=np.float32).reshape(16, 16)
    np.testing.assert_array_equal(ttrain.depth2img(ramp),
                                  jtrain.depth2img(ramp))
