"""The port's OpenEXR decoder (``csrc/exr.cpp`` through ``datasets/exr.py``),
the OpenEXR writer of ``utils/procedural.py`` and the RTMV preparation
(``misc/prepare_rtmv.py``) against the JAX package's script, on the CPU.

No OpenEXR library or file is at hand, so the decoder is held to:

* a file built here byte by byte from the OpenEXR File Layout document
  (magic, version, header attributes, offset table, chunks), independent
  of ``encode_exr``: 3x2 HALF RGB under NONE, and under ZIPS with the
  byte predictor and the interleave written out here;
* round trips through ``encode_exr`` under NONE, RLE, ZIPS, ZIP and PIZ:
  every HALF bit pattern (signed zeros, subnormals, infinities, NaN
  payloads), FLOAT, sizes that are not multiples of the 16- and 32-line
  chunks, decreasing y and an A channel; bit for bit. PIZ is held only by
  its round trip (both sides follow the OpenEXR library's ImfHuf and
  ImfWav);
* its refusals, by their messages.

``prepare_rtmv`` writes the PNGs that ``misc/prepare_rtmv.py`` writes, with
imageio's ``imread`` standing in as ``read_exr`` (no EXR plugin here), and
the RTMV loaders read the two scenes' PNGs to equal rays and poses.
"""
import contextlib
import importlib.util
import io
import os
import re
import shutil
import struct
import subprocess
import sys
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from mfnerf_tpu.datasets.rtmv import RTMVDataset as JRTMV

from mfnerf_tpu_torch import build
from mfnerf_tpu_torch.datasets.exr import decode_exr, read_exr
from mfnerf_tpu_torch.datasets.png import read_png
from mfnerf_tpu_torch.datasets.rtmv import RTMVDataset as TRTMV
from mfnerf_tpu_torch.misc import prepare_rtmv
from mfnerf_tpu_torch.utils import procedural
from mfnerf_tpu_torch.utils.procedural import (encode_exr, make_scene,
                                               write_exr, write_rtmv_scene)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODECS = ["none", "rle", "zips", "zip", "piz"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _half_bits_to_float_bits(bits):
    """float32 bit patterns of HALF ``bits``, exactly: subnormals scaled,
    infinities kept, NaN payloads shifted into the float's significand."""
    bits = np.asarray(bits, np.uint32)
    sign, exp, man = (bits & 0x8000) << 16, (bits >> 10) & 31, bits & 0x3FF
    normal = sign | (exp + 112) << 23 | man << 13
    special = sign | 0x7F800000 | man << 13
    tiny = (man * np.float64(2.0 ** -24)).astype(np.float32).view(np.uint32)
    return np.where(exp == 31, special,
                    np.where(exp == 0, sign | tiny, normal)).astype(np.uint32)


# --------------------------------------------- a file from the specification
def _attr(name, kind, payload):
    return (name.encode() + b"\0" + kind.encode() + b"\0"
            + struct.pack("<i", len(payload)) + payload)


def _spec_file(chunks, w, h, channels=(("B", 1), ("G", 1), ("R", 1)),
               compression=0, version=2, sampling=(1, 1), data_window=None,
               display_window=None):
    """An OpenEXR file as the File Layout document lays it out: magic
    76 2f 31 01, the version field, the attributes (name, type, size,
    value), a null byte, one 64-bit offset a chunk, and each chunk's y,
    size and bytes. ``chunks``: [(y, bytes)]; channels [(name, pixel type
    0 UINT, 1 HALF, 2 FLOAT)]."""
    chlist = b"".join(name.encode() + b"\0" + struct.pack("<i", kind)
                      + b"\0\0\0\0" + struct.pack("<ii", *sampling)
                      for name, kind in channels) + b"\0"
    data_window = data_window or (0, 0, w - 1, h - 1)
    display_window = display_window or data_window
    header = b"".join([
        bytes([0x76, 0x2F, 0x31, 0x01]), struct.pack("<I", version),
        _attr("channels", "chlist", chlist),
        _attr("compression", "compression", bytes([compression])),
        _attr("dataWindow", "box2i", struct.pack("<4i", *data_window)),
        _attr("displayWindow", "box2i", struct.pack("<4i", *display_window)),
        _attr("lineOrder", "lineOrder", b"\0"),
        _attr("pixelAspectRatio", "float", struct.pack("<f", 1)),
        _attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0)),
        _attr("screenWindowWidth", "float", struct.pack("<f", 1)),
        b"\0"])
    blobs = [struct.pack("<ii", y, len(b)) + b for y, b in chunks]
    at, offsets = len(header) + 8 * len(blobs), []
    for blob in blobs:
        offsets.append(at)
        at += len(blob)
    return header + struct.pack(f"<{len(blobs)}Q", *offsets) + b"".join(blobs)


def _spec_pixels():
    """3x2 HALF RGB: in each line the nine values B0 B1 B2 G0 G1 G2 R0 R1
    R2 are consecutive bit patterns (so ZIPS shrinks a line)."""
    bits = np.empty((2, 3, 3), np.uint16)            # (y, channel BGR, x)
    for y, base in enumerate((0x3C00, 0xB801)):      # 1.0, -0.500...
        bits[y] = (base + np.arange(9)).reshape(3, 3)
    return bits


def _zips_chunk(raw):
    """ImfZip written out: even bytes then odd bytes, each byte minus its
    predecessor plus 128 (mod 256), then zlib."""
    t = raw[0::2] + raw[1::2]
    d = bytes([t[0]]) + bytes((t[i] - t[i - 1] + 128) % 256
                              for i in range(1, len(t)))
    return zlib.compress(d, 9)


@pytest.mark.parametrize("compression", ["NONE", "ZIPS"])
def test_a_file_built_from_the_specification(tmp_path, compression):
    bits = _spec_pixels()
    chunks = []
    for y in range(2):
        raw = bits[y].astype("<u2").tobytes()       # B, G, R lines of 3
        if compression == "ZIPS":
            packed = _zips_chunk(raw)
            assert len(packed) < len(raw)   # decompressed, not stored raw
            chunks.append((y, packed))
        else:
            chunks.append((y, raw))
    path = tmp_path / "spec.exr"
    path.write_bytes(_spec_file(chunks, 3, 2, compression={
        "NONE": 0, "ZIPS": 2}[compression]))
    got = read_exr(path)
    assert got.shape == (2, 3, 3) and got.dtype == np.float32
    want = _half_bits_to_float_bits(bits[:, ::-1].transpose(0, 2, 1))
    np.testing.assert_array_equal(got.view(np.uint32), want)
    assert got[0, 0, 2] == 1.0 and got[1, 0, 2] == np.float32(
        np.uint16(0xB801).view(np.float16))


def test_a_zip_chunk_with_a_stored_deflate_block(tmp_path):
    """ZIP (16 lines a chunk) whose zlib stream opens with a stored block
    (its first 100 bytes as they are) and goes on with zlib's compressed
    blocks: every deflate block type, byte alignment and the Adler-32 over
    both."""
    img = np.linspace(-2, 2, 16 * 9 * 3, dtype=np.float32).reshape(16, 9, 3)
    lines = img.astype("<f2")[..., ::-1].transpose(0, 2, 1).tobytes()
    t = lines[0::2] + lines[1::2]
    d = bytes([t[0]]) + bytes((t[i] - t[i - 1] + 128) % 256
                              for i in range(1, len(t)))
    head, rest = d[:100], d[100:]
    deflate = zlib.compressobj(9, zlib.DEFLATED, -15)
    stream = (b"\x78\x9c" + b"\x00" + struct.pack("<HH", 100, 0xFFFF - 100)
              + head + deflate.compress(rest) + deflate.flush()
              + struct.pack(">I", zlib.adler32(d)))
    assert zlib.decompress(stream) == d and len(stream) < len(lines)
    path = tmp_path / "stored.exr"
    path.write_bytes(_spec_file([(0, stream)], 9, 16, compression=3))
    np.testing.assert_array_equal(read_exr(path),
                                  img.astype(np.float16).astype(np.float32))


# ----------------------------------------------------------- round trips
def _all_halves():
    """256x256 RGB holding every HALF bit pattern in each channel, in runs
    along x (so every codec shrinks its chunks): R in order, G reversed, B
    a stride-7 walk through all 65,536."""
    b = np.arange(1 << 16, dtype=np.uint16).reshape(256, 256)
    return np.stack([b, b[::-1, ::-1],
                     (b.astype(np.int64) * 7 % (1 << 16)).astype(np.uint16)],
                    -1)


def _round_trip_case(case):
    """(image, pixel type, line order, whether each chunk should shrink)."""
    rng = np.random.default_rng(0)
    if case == "half_all":
        return _all_halves().view(np.float16), "half", "increasing", True
    if case == "half_shuffled":     # noise: chunks that do not shrink
        return (rng.permutation(_all_halves().reshape(-1)).reshape(
            256, 256, 3).view(np.float16), "half", "increasing", False)
    yy, xx = np.mgrid[0:45, 0:70].astype(np.float32)
    smooth = np.stack([xx / 70, yy / 45, np.sin(xx / 5) * np.cos(yy / 7) * 3,
                       (xx * yy) % 7 / 7], -1)
    if case == "rgba_decreasing":   # 45 lines: 16- and 32-line chunks cut
        return smooth.astype(np.float16), "half", "decreasing", True
    # FLOAT at 37 x 53 with its special values, beside a field of steps
    img = np.floor(smooth[:37, :53, :3] * 8) * 125
    img[0, :8, 0] = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-40,
                     3.4e38]
    img[1, :4, 1] = np.uint32([0x7FC00001, 0xFFBFFFFF, 0x7F800001,
                               0x00000001]).view(np.float32)   # NaNs
    return img.astype(np.float32), "float", "increasing", True


@pytest.mark.parametrize("case", ["half_all", "half_shuffled",
                                  "rgba_decreasing", "float"])
@pytest.mark.parametrize("compression", CODECS)
def test_encode_exr_round_trips_bit_for_bit(case, compression):
    img, pixel_type, order, shrinks = _round_trip_case(case)
    data = encode_exr(img, compression, pixel_type, order)
    got = decode_exr(data, case)
    h, w, c = img.shape
    assert got.shape == (h, w, c) and got.dtype == np.float32
    if pixel_type == "half":
        want = _half_bits_to_float_bits(img.view(np.uint16))
    else:
        want = img.view(np.uint32)
    np.testing.assert_array_equal(got.view(np.uint32), want)
    raw = img.nbytes
    if compression == "none" or not shrinks:
        assert len(data) > raw          # every chunk stored raw
    else:
        assert len(data) < raw          # the codec's path was decoded
    if compression == "piz" and case == "half_all":
        # more than 2^14 values in use in a chunk: the 16-bit wavelet
        assert len(np.unique(img.view(np.uint16)[:32])) > 1 << 14


def test_write_exr_and_the_rtmv_frames(tmp_path):
    """``write_rtmv_scene(image_format="exr")``: NNNNN.exr beside the
    jsons, RGBA HALF, linear light of the PNG's pixels with alpha 1."""
    scene = make_scene(n_train=3, n_test=1, wh=12, seed=1)
    write_rtmv_scene(str(tmp_path / "s"), scene, n_frames=4,
                     image_format="exr", compression="piz")
    names = sorted(os.listdir(tmp_path / "s"))
    assert names == [f"{i:05d}.{e}" for i in range(4) for e in ("exr",
                                                                 "json")]
    img = read_exr(tmp_path / "s" / "00003.exr")
    pixels = (scene["images"][0].reshape(12, 12, 3) * 255).astype(np.uint8)
    linear = procedural.srgb_to_linear(pixels.astype(np.float32) / 255)
    np.testing.assert_array_equal(img[..., :3],
                                  linear.astype(np.float16).astype(np.float32))
    assert (img[..., 3] == 1).all()
    write_exr(tmp_path / "f.exr", linear, "zip", "float")
    np.testing.assert_array_equal(read_exr(tmp_path / "f.exr"), linear)
    with pytest.raises(ValueError, match="image_format 'jpg'"):
        write_rtmv_scene(str(tmp_path / "t"), scene, image_format="jpg")


# ----------------------------------------------------------- refusals
REFUSALS = {
    "PXR24": (dict(compression=5), "PXR24 compression is not supported"),
    "B44": (dict(compression=6), "B44 compression is not supported"),
    "B44A": (dict(compression=7), "B44A compression is not supported"),
    "DWAA": (dict(compression=8), "DWAA compression is not supported"),
    "DWAB": (dict(compression=9), "DWAB compression is not supported"),
    "tiled": (dict(version=2 | 0x200), "tiled files are not supported"),
    "deep": (dict(version=2 | 0x800), "deep .* files are not supported"),
    "multi-part": (dict(version=2 | 0x1000),
                   "multi-part files are not supported"),
    "UINT": (dict(channels=(("B", 1), ("G", 1), ("R", 0))),
             "UINT channel R is not supported"),
    "subsampled": (dict(sampling=(2, 2)),
                   r"subsampled channel B \(x 2, y 2\) is not supported"),
    "window": (dict(display_window=(0, 0, 3, 1)),
               r"the data window \(0, 0\) - \(2, 1\) differs from the "
               r"display window \(0, 0\) - \(3, 1\)"),
    "no RGB": (dict(channels=(("Y", 1), ("Z", 2))),
               r"no R, G and B channels \(the file has: Y Z\)"),
    "too large": (dict(data_window=(0, 0, 19999, 19999)),
                  "a data window of 20000 x 20000 pixels is too large"),
}


@pytest.mark.parametrize("feature", list(REFUSALS))
def test_read_exr_refuses_by_name(tmp_path, feature):
    kwargs, message = REFUSALS[feature]
    raw = _spec_pixels()[0].astype("<u2").tobytes()
    path = tmp_path / f"{feature}.exr"
    path.write_bytes(_spec_file([(0, raw), (1, raw)], 3, 2, **kwargs))
    with pytest.raises(ValueError,
                       match=re.escape(str(path)) + ": OpenEXR not decoded: "
                       + message):
        read_exr(path)


def test_read_exr_refuses_a_broken_chunk(tmp_path):
    """A ZIP chunk whose stream is cut, and one whose Adler-32 is wrong."""
    img = np.linspace(0, 1, 20 * 9 * 3, dtype=np.float32).reshape(20, 9, 3)
    data = bytearray(encode_exr(img, "zip"))
    last = len(data) - 1
    with pytest.raises(ValueError, match="Adler-32"):
        decode_exr(bytes(data[:last]) + bytes([data[last] ^ 1]))
    with pytest.raises(ValueError, match="runs past the end of the file"):
        decode_exr(bytes(data[:-10]))


def test_the_decoder_links_no_codec_library():
    """The built library needs the C (and C++) runtime only."""
    lib = str(build.build("exr"))
    with open(lib, "rb") as f:
        blob = f.read()
    assert not any(name in blob for name in (b"libz.", b"libOpenEXR",
                                             b"libIlmImf", b"libImath"))
    if shutil.which("ldd"):
        linked = subprocess.run(["ldd", lib], capture_output=True, text=True,
                                check=True).stdout
        assert "libc.so" in linked
        assert not re.search(r"libz|OpenEXR|IlmImf|Imath", linked)


# ----------------------------------------------------- prepare_rtmv
def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_prepare_rtmv", os.path.join(REPO, "misc", "prepare_rtmv.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_jax_script(monkeypatch, root, imsave=None):
    """misc/prepare_rtmv.py's main() on ``root``, imageio's imread reading
    with ``read_exr`` and, unless ``imsave`` is None, its imsave replaced.
    Returns the names it printed."""
    monkeypatch.setattr(imageio, "imread", read_exr)
    if imsave is not None:
        monkeypatch.setattr(imageio, "imsave", imsave)
    monkeypatch.setattr(sys, "argv", ["prepare_rtmv.py", str(root)])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _jax_script().main()
    monkeypatch.undo()
    return out.getvalue().split()


def test_prepare_rtmv_writes_the_jax_scripts_pngs(tmp_path, monkeypatch):
    """Values above 1, below 0 and at sRGB's 0.0031308 knee (and its
    neighbouring floats), in HALF RGBA and FLOAT RGB frames: the port's
    PNGs hold exactly what the JAX script hands imsave, under the same
    names, printed in the same order."""
    rng = np.random.default_rng(3)
    knee = np.float32(0.0031308)
    frames = {
        "00000": (rng.uniform(-0.5, 1.5, (6, 8, 4)), "half", "piz"),
        "00001": (rng.uniform(0, 0.01, (6, 8, 3)), "float", "zip"),
        "frame_b": (rng.uniform(0, 1, (5, 7, 3)), "half", "rle"),
    }
    frames["00001"][0][0, :3, 0] = [np.nextafter(knee, np.float32(0)), knee,
                                    np.nextafter(knee, np.float32(1))]
    for name, (img, pixel_type, codec) in frames.items():
        write_exr(tmp_path / f"{name}.exr", img.astype(np.float32), codec,
                  pixel_type)
    saved = {}
    names = _run_jax_script(monkeypatch, tmp_path, lambda path, arr:
                            saved.__setitem__(os.path.basename(path), arr))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        prepare_rtmv.main([str(tmp_path)])
    assert out.getvalue().split() == names == sorted(saved)
    assert sorted(os.listdir(tmp_path / "images")) == sorted(saved)
    assert names == ["00000.png", "00001.png", "frame_b.png"]
    for name, want in saved.items():
        got = read_png(tmp_path / "images" / name)
        assert want.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    low = saved["00001.png"][0, :3, 0]
    assert low.tolist() == [10, 10, 10]     # 12.92 x the knee, truncated
    # 1 and above: linear_to_srgb(1) is 0.99999994 in float32, so 254
    assert saved["00000.png"].min() == 0 and saved["00000.png"].max() == 254


def test_prepare_rtmv_without_frames_exits_as_the_jax_script(tmp_path,
                                                             monkeypatch):
    with pytest.raises(SystemExit) as port:
        prepare_rtmv.main([str(tmp_path)])
    with pytest.raises(SystemExit) as jax_script:
        _run_jax_script(monkeypatch, tmp_path, lambda path, arr: None)
    assert str(port.value) == str(jax_script.value) == \
        f"no .exr files under {tmp_path}"


@pytest.fixture(scope="module")
def rtmv_exr_scenes(tmp_path_factory):
    """An RTMV scene written in EXR (ZIP; 110 frames: train 0-100, test
    105-110), prepared by the port (``python -m``) in one copy and by the
    JAX script, whose PNGs imageio writes, in another."""
    base = tmp_path_factory.mktemp("rtmv_exr")
    scene = make_scene(n_train=6, n_test=1, wh=16, seed=5, spread=5.0)
    port, jax_root = str(base / "port"), str(base / "jax")
    write_rtmv_scene(port, scene, image_format="exr", compression="zip")
    shutil.copytree(port, jax_root)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m",
                           "mfnerf_tpu_torch.misc.prepare_rtmv", port],
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == [f"{i:05d}.png" for i in range(110)]
    with pytest.MonkeyPatch.context() as monkeypatch:
        names = _run_jax_script(monkeypatch, jax_root)
    assert names == proc.stdout.split()
    return {"port": port, "jax": jax_root, "scene": scene}


@pytest.mark.parametrize("split", ["train", "test"])
def test_rtmv_from_exr_loads_as_the_jax_loader_loads_it(rtmv_exr_scenes,
                                                        split):
    """The port's RTMVDataset on the port's PNGs against the JAX one on
    the PNGs the JAX script wrote: rays and poses equal."""
    with contextlib.redirect_stdout(io.StringIO()):
        got = TRTMV(rtmv_exr_scenes["port"], split=split)
        want = JRTMV(rtmv_exr_scenes["jax"], split=split)
    assert got.rays.shape == want.rays.shape == (
        {"train": 100, "test": 5}[split], 16 * 16, 3)
    np.testing.assert_array_equal(got.rays, want.rays)
    np.testing.assert_array_equal(got.poses, want.poses)
    np.testing.assert_array_equal(got.K, want.K)
    # the half round trip and the truncation move a byte by at most one
    images = np.stack([rtmv_exr_scenes["scene"]["images"][i % 6]
                       for i in range(*{"train": (0, 100),
                                        "test": (105, 110)}[split])])
    pixels = (images * 255).astype(np.uint8).astype(np.float32)
    assert np.abs(got.rays * 255 - pixels).max() <= 1 + 1e-3
