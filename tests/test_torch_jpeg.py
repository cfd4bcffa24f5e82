"""The port's JPEG decoder (``csrc/jpeg.cpp`` through ``datasets/jpeg.py``)
against the JAX package's ``read_image`` (its native libjpeg loader) and
PIL (libjpeg-turbo), on the CPU, and the JPEG writer of
``utils/procedural.py``.

The files are written here by PIL: baseline and progressive, 4:4:4, 4:2:2
and 4:2:0, quality 50-100, optimized Huffman tables, restart intervals,
grayscale, RGB stored without the colour transform, odd sizes and an EXIF
segment. The decode must equal both
references byte for byte (libjpeg's ISLOW IDCT, fancy upsampling and
fixed-point colour tables); ``read_image`` after it equals the JAX one
exactly at the file's size, and to RESIZE_TOL resized (the bilinear resize
of the PNG path, tests/test_torch_io.py). A COLMAP scene whose views PIL
re-saved as JPEG loads to the JAX loader's rays and poses and trains.
"""
import io
import os
import shutil
import struct
import subprocess

import numpy as np
import pytest
import torch
from PIL import Image

from mfnerf_tpu.datasets import color_utils as jcolor
from mfnerf_tpu.datasets.colmap import ColmapDataset as JColmap

from mfnerf_tpu_torch import build
from mfnerf_tpu_torch import opt as topt
from mfnerf_tpu_torch import train as ttrain
from mfnerf_tpu_torch.datasets import color_utils as tcolor
from mfnerf_tpu_torch.datasets.colmap import ColmapDataset as TColmap
from mfnerf_tpu_torch.datasets.jpeg import decode_jpeg, read_jpeg
from mfnerf_tpu_torch.datasets.png import read_png
from mfnerf_tpu_torch.utils import procedural

RESIZE_TOL = 2e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _picture(w, h, seed=0, gray=False):
    """A smooth pattern with noise and hard edges: every IDCT coefficient
    and the upsampling filters' edges carry weight."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([np.sin(xx / 7.0) * 100 + 128,
                    np.cos(yy / 5.0) * 100 + 128,
                    ((xx + yy) * 3) % 256], -1)
    img[(xx // 16 + yy // 16) % 2 == 0] *= 0.5
    img += rng.normal(0, 12, img.shape)
    img = np.clip(img, 0, 255).astype(np.uint8)
    return Image.fromarray(img[..., 0] if gray else img)


def _exif():
    exif = Image.Exif()
    exif[0x0112] = 6            # orientation: libjpeg does not apply it
    exif[0x010F] = "mfnerf"
    return exif.tobytes()


# (width, height, PIL save options, gray)
CASES = {
    **{f"{s}-q{q}-{p}": (131, 97, dict(subsampling=s, quality=q,
                                       progressive=p == "prog"), False)
       for s in ("4:4:4", "4:2:2", "4:2:0") for q in (50, 75, 95, 100)
       for p in ("base", "prog")},
    "optimize": (131, 97, dict(quality=90, optimize=True), False),
    "optimize-prog-444": (131, 97, dict(quality=90, optimize=True,
                                        progressive=True, subsampling=0),
                          False),
    "restart-420": (131, 97, dict(quality=85, restart_marker_blocks=3),
                    False),
    "restart-prog-420": (131, 97, dict(quality=85, progressive=True,
                                       restart_marker_blocks=2), False),
    "restart-rows-422": (131, 97, dict(quality=85, subsampling=1,
                                       restart_marker_rows=1), False),
    "gray": (131, 97, dict(quality=90), True),
    "gray-prog-restart": (131, 97, dict(quality=90, progressive=True,
                                        restart_marker_blocks=5), True),
    "1x1": (1, 1, dict(quality=95), False),
    "1x1-gray": (1, 1, dict(quality=95), True),
    "7x9-420": (7, 9, dict(quality=95), False),
    "7x9-422-prog": (7, 9, dict(quality=95, subsampling=1,
                                progressive=True), False),
    "2x3-420": (2, 3, dict(quality=95), False),
    "800x600-420": (800, 600, dict(quality=95), False),
    "800x600-prog-restart": (800, 600, dict(quality=90, progressive=True,
                                            restart_marker_blocks=7), False),
    "800x600-444-opt": (800, 600, dict(quality=90, subsampling=0,
                                       optimize=True), False),
    "exif": (131, 97, dict(quality=90, exif=_exif()), False),
    # stored as RGB (Adobe APP14 transform 0): no colour conversion
    "keep-rgb": (131, 97, dict(quality=90, subsampling=0, keep_rgb=True),
                 False),
}


def _write(tmp_path, name, w, h, options, gray, seed=0):
    path = str(tmp_path / f"{name}.jpg")
    _picture(w, h, seed, gray).save(path, "JPEG", **options)
    return path


@pytest.mark.parametrize("name", list(CASES))
def test_read_jpeg_matches_pil_and_jax(tmp_path, name):
    w, h, options, gray = CASES[name]
    path = _write(tmp_path, name, w, h, options, gray)
    got = read_jpeg(path)
    with Image.open(path) as im:
        want = np.asarray(im)
    assert got.shape == (h, w, 1 if gray else 3)
    np.testing.assert_array_equal(got[..., 0] if gray else got, want)
    # the JAX read_image (native libjpeg, rgb out) scaled back to bytes
    jax_rgb = np.rint(jcolor.read_image(path, (w, h)) * 255).astype(np.uint8)
    np.testing.assert_array_equal(
        np.broadcast_to(got, (h, w, 3)).reshape(-1, 3), jax_rgb)


@pytest.mark.parametrize("name", ["prog_420_restart", "base_422_odd",
                                  "gray"])
def test_committed_fixtures_decode_to_their_png(name):
    """The card run's fixtures (tests/data/jpeg): PIL wrote each JPEG and
    its decode as the PNG beside it."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "jpeg", name)
    got, want = read_jpeg(path + ".jpg"), read_png(path + ".png")
    with Image.open(path + ".jpg") as im:
        np.testing.assert_array_equal(np.asarray(im), want)
    np.testing.assert_array_equal(got.reshape(want.shape), want)


def test_read_jpeg_keeps_exif_orientation_unapplied(tmp_path):
    """A tall EXIF-rotated file decodes at its stored size, as libjpeg."""
    path = _write(tmp_path, "exif", 40, 24, dict(exif=_exif()), False)
    assert read_jpeg(path).shape == (24, 40, 3)


@pytest.mark.parametrize("blend_a", [True, False])
@pytest.mark.parametrize("wh,tol", [((131, 97), 0.0), ((65, 48), RESIZE_TOL),
                                    ((200, 150), RESIZE_TOL)])
@pytest.mark.parametrize("gray", [False, True])
def test_read_image_of_a_jpeg_matches_jax(tmp_path, blend_a, wh, tol, gray):
    path = _write(tmp_path, "v", 131, 97, dict(quality=90, progressive=True),
                  gray)
    got = tcolor.read_image(path, wh, blend_a)
    want = jcolor.read_image(path, wh, blend_a)
    assert got.shape == want.shape == (wh[0] * wh[1], 3)
    assert got.dtype == np.float32
    if tol == 0.0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _sof(marker, precision=8, components=3):
    """A file that ends after its frame header."""
    comps = b"".join(bytes([i + 1, 0x11, 0]) for i in range(components))
    body = struct.pack(">BHHB", precision, 8, 8, components) + comps
    return b"\xff\xd8" + bytes([0xFF, marker]) + struct.pack(
        ">H", len(body) + 2) + body + b"\xff\xd9"


@pytest.mark.parametrize("kind,match", [
    ("cmyk", r"4 components \(CMYK/YCCK\)"),
    ("arithmetic", r"arithmetic coding"),
    ("lossless", r"a lossless frame"),
    ("hierarchical", r"hierarchical"),
    ("12-bit", r"12-bit samples"),
    ("truncated", r"ends inside a scan"),
    ("not-jpeg", r"not a JPEG file")])
def test_read_jpeg_refuses_what_it_does_not_read(tmp_path, kind, match):
    path = str(tmp_path / f"{kind}.jpg")
    if kind == "cmyk":
        Image.new("CMYK", (16, 16), (10, 20, 30, 40)).save(path, "JPEG")
    elif kind == "truncated":
        _picture(64, 64).save(path, "JPEG", quality=90)
        with open(path, "rb") as f:
            data = f.read()
        with open(path, "wb") as f:
            f.write(data[:len(data) // 2])
    else:
        data = {"arithmetic": _sof(0xC9), "lossless": _sof(0xC3),
                "hierarchical": _sof(0xC5), "12-bit": _sof(0xC1, 12),
                "not-jpeg": b"\x89PNG" + bytes(16)}[kind]
        with open(path, "wb") as f:
            f.write(data)
    with pytest.raises(ValueError, match=match) as info:
        read_jpeg(path)
    assert path in str(info.value)


def test_the_decoder_links_no_libjpeg():
    """The built library needs the C (and C++) runtime only."""
    lib = str(build.build("jpeg"))
    with open(lib, "rb") as f:
        assert b"libjpeg" not in f.read()
    if shutil.which("ldd"):
        linked = subprocess.run(["ldd", lib], capture_output=True, text=True,
                                check=True).stdout
        assert "libc.so" in linked and "jpeg" not in linked


# ------------------------------------------------------- the JPEG writer
def test_jpeg_writer_tables_are_libjpegs_standard_ones(tmp_path):
    """Annex K: the Huffman tables PIL writes unoptimized, and the
    quantization tables at three qualities."""
    path = str(tmp_path / "s.jpg")
    Image.fromarray(np.zeros((16, 16, 3), np.uint8)).save(path, quality=75)
    with open(path, "rb") as f:
        data = f.read()
    tables, i = {}, 0
    while (i := data.find(b"\xff\xc4", i)) >= 0:
        seg_len, = struct.unpack(">H", data[i + 2:i + 4])
        seg, j = data[i + 4:i + 2 + seg_len], 0
        while j < len(seg):
            counts = tuple(seg[j + 1:j + 17])
            kind = "ac" if seg[j] >> 4 else "dc"
            tables[(kind, seg[j] & 15)] = (
                counts, bytes(seg[j + 17:j + 17 + sum(counts)]))
            j += 17 + sum(counts)
        i += 2
    assert tables == procedural.JPEG_HUFFMAN
    for q in (50, 75, 95):
        Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(path, quality=q)
        with Image.open(path) as im:
            want = im.quantization
        luma, chroma = procedural.jpeg_quant_tables(q)
        assert list(luma) == list(want[0]) and list(chroma) == list(want[1])


@pytest.mark.parametrize("sampling", [(1, 1), (2, 1), (2, 2), (1, 2),
                                      "gray"])
@pytest.mark.parametrize("wh", [(131, 97), (8, 8), (1, 1)])
def test_jpeg_writer_files_decode_as_pil_decodes_them(sampling, wh):
    """What ``write_jpeg`` writes (4:4:4, 4:2:2, 4:2:0, 4:4:0, gray), PIL
    decodes to the port's decode, and near the source picture."""
    gray = sampling == "gray"
    src = np.asarray(_picture(*wh, seed=3, gray=gray))
    data = procedural.encode_jpeg(src, 95, (1, 1) if gray else sampling)
    got = decode_jpeg(data)
    with Image.open(io.BytesIO(data)) as im:
        want = np.asarray(im)
    np.testing.assert_array_equal(got[..., 0] if gray else got, want)
    # and near the picture: its noise (sd 12) and the chroma cells' spread
    # are what quality 95 and the subsampling lose
    err = np.abs(want.astype(np.float64) - src).mean()
    assert err < (5.0 if gray or sampling == (1, 1) else 16.0), err


# ------------------------------------------------------------ a scene
@pytest.fixture
def jpeg_colmap(tmp_path, monkeypatch):
    """A 24x24 spread COLMAP scene whose views PIL re-saved as JPEG
    (progressive 4:2:0 with restarts), in jpeg/, the working directory
    tmp_path."""
    root = str(tmp_path / "jpeg")
    procedural.write_colmap_scene(root, procedural.make_scene(
        n_train=14, n_test=2, wh=24, seed=0, spread=5.0), spread=5.0,
        image_format="jpg")
    for name in os.listdir(os.path.join(root, "images")):
        path = os.path.join(root, "images", name)
        with Image.open(path) as im:
            im.load()
            im.save(path, "JPEG", quality=92, progressive=True,
                    restart_marker_blocks=2)
    monkeypatch.chdir(tmp_path)
    return root


@pytest.mark.parametrize("split", ["train", "test"])
def test_colmap_scene_in_jpeg_loads_as_jax_loads_it(jpeg_colmap, split):
    got, want = TColmap(jpeg_colmap, split=split), JColmap(jpeg_colmap,
                                                           split=split)
    assert sorted(os.listdir(os.path.join(jpeg_colmap, "images")))[0] \
        == "im_000.jpg"
    np.testing.assert_array_equal(got.K, want.K)
    np.testing.assert_allclose(got.poses, want.poses, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.directions, want.directions, rtol=0,
                               atol=1e-6)
    assert got.rays.shape == want.rays.shape
    np.testing.assert_array_equal(got.rays, want.rays)


def test_main_trains_a_colmap_scene_in_jpeg(jpeg_colmap, capsys):
    argv = ["--root_dir", "jpeg", "--dataset_name", "colmap", "--exp_name",
            "j", "--grid", "LowRank", "--num_epochs", "1",
            "--steps_per_epoch", "4", "--lr_levels", "2", "--lr_rank", "8",
            "--lr_k_max", "32", "--grid_size", "32", "--max_samples", "128",
            "--s_max_train", "16", "--s_max_test", "32", "--rgb_channels",
            "16", "--rgb_layers", "1", "--batch_size", "256", "--scale", "4",
            "--no_save_test"]
    metrics = ttrain.main(topt.get_opts(argv), device="cpu")
    out = capsys.readouterr().out
    assert "Loading 14 train images" in out
    assert all(np.isfinite(v) for v in metrics.values())
    assert os.path.exists("ckpts/colmap/j/epoch=0.ckpt.npz")
