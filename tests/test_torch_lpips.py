"""The port's LPIPS (``mfnerf_tpu_torch/utils/lpips.py``,
``utils/metrics.py::lpips_vgg``, ``--eval_lpips``) against the JAX
package's, on the CPU, with seeded random weights (the pretrained VGG16
weights do not ship): the same numpy weights through both. Tolerance: 1e-5
relative (13 float32 convolutions summed in another order); the identity
gives 0 and the measure is symmetric to 1e-6 relative."""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mfnerf_tpu.utils import lpips as jlpips
from mfnerf_tpu.utils import metrics as jmetrics

from mfnerf_tpu_torch import train as ttrain
from mfnerf_tpu_torch.datasets.ray_utils import get_rays
from mfnerf_tpu_torch.models import rendering as trendering
from mfnerf_tpu_torch.opt import get_opts
from mfnerf_tpu_torch.utils import lpips as tlpips
from mfnerf_tpu_torch.utils import metrics as tmetrics

import dp_workers
from test_torch_dp import CLI_FLAGS, _cli_scene

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread (the suite runs in several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(seed=0):
    """Seeded numpy weights of the canonical shapes (N(0, 0.05^2), the
    heads non-negative): {name: array}."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, shape in tlpips.canonical_weight_shapes().items():
        a = (0.05 * rng.standard_normal(shape)).astype(np.float32)
        out[key] = np.abs(a) if key.startswith("lin") else a
    return out


def _images(wh=64, seed=1):
    rng = np.random.default_rng(seed)
    a = rng.random((wh, wh, 3), dtype=np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal((wh, wh, 3)), 0, 1).astype(
        np.float32)
    return a, b


def test_weight_shapes_are_the_jax_packages():
    """13 VGG16 convolutions and 5 heads, the JAX package's shapes; the
    random weights of a generator have them, the heads non-negative."""
    shapes = tlpips.canonical_weight_shapes()
    assert shapes == jlpips.canonical_weight_shapes()
    assert (tlpips.N_CONVS, tlpips.N_TAPS) == (13, 5)
    w = tlpips.random_lpips_weights(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in w.items()} == shapes
    assert all((w[f"lin{k}_w"] >= 0).all() for k in range(5))


@pytest.mark.parametrize("wh", [64, 37])
def test_lpips_matches_jax(wh):
    """lpips_from_weights against the JAX one on the same weights and
    images (64x64, and 37x37: odd sizes through the pools), rtol 1e-5."""
    w = _weights(3)
    a, b = _images(wh)
    want = float(jlpips.lpips_from_weights(
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(a),
        jnp.asarray(b)))
    got = float(tlpips.lpips_from_weights(
        {k: torch.from_numpy(v) for k, v in w.items()}, torch.from_numpy(a),
        torch.from_numpy(b)))
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_identity_is_zero_and_symmetric():
    w = tlpips.random_lpips_weights(torch.Generator().manual_seed(1))
    a, b = (torch.from_numpy(x) for x in _images(48, seed=2))
    assert float(tlpips.lpips_from_weights(w, a, a)) == pytest.approx(
        0.0, abs=1e-6)
    dab = float(tlpips.lpips_from_weights(w, a, b))
    dba = float(tlpips.lpips_from_weights(w, b, a))
    assert dab > 0 and dab == pytest.approx(dba, rel=1e-6)


def test_npz_round_trip_and_bad_files(tmp_path):
    """The npz as misc/export_lpips_weights.py writes it (the heads as
    torch's (1, C, 1, 1) 1x1 convolutions) loads to the same weights; a
    missing key or a wrong shape raises ``ValueError``."""
    w = _weights(4)
    path = str(tmp_path / "w.npz")
    np.savez(path, **{k: (v.reshape(1, -1, 1, 1) if k.startswith("lin")
                          else v) for k, v in w.items()})
    loaded = tlpips.load_lpips_weights(path)
    assert set(loaded) == set(w)
    for k, v in loaded.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), w[k])
    missing = {k: v for k, v in w.items() if k != "conv3_b"}
    np.savez(tmp_path / "missing.npz", **missing)
    with pytest.raises(ValueError, match="missing keys"):
        tlpips.load_lpips_weights(str(tmp_path / "missing.npz"))
    np.savez(tmp_path / "shape.npz", **dict(w, lin2_w=np.ones(3, np.float32)))
    with pytest.raises(ValueError, match="lin2_w"):
        tlpips.load_lpips_weights(str(tmp_path / "shape.npz"))
    with pytest.raises(RuntimeError, match="--lpips_weights"):
        tmetrics.lpips_vgg(torch.zeros((8, 8, 3)), torch.zeros((8, 8, 3)))


def test_eval_lpips_fails_before_rendering(tmp_path, monkeypatch):
    """``--eval_lpips`` without ``--lpips_weights`` raises the JAX message
    (naming the port's files), and with a bad npz the loader's error,
    before any step or render; ``validate`` refuses the same way."""
    monkeypatch.chdir(tmp_path)
    _cli_scene("Synthetic_NeRF_proc/Spheres")

    def no_render(*args, **kwargs):
        raise AssertionError("rendered")

    monkeypatch.setattr(ttrain, "render_test", no_render)
    monkeypatch.setattr(ttrain.NeRFSystem, "fit", no_render)
    with pytest.raises(ValueError, match="mfnerf_tpu_torch/utils/lpips.py"):
        ttrain.main(get_opts(CLI_FLAGS + ["--eval_lpips"]), device="cpu")
    np.savez("bad.npz", conv0_w=np.zeros((64, 3, 3, 3), np.float32))
    with pytest.raises(ValueError, match="missing keys"):
        ttrain.main(get_opts(CLI_FLAGS + ["--eval_lpips", "--lpips_weights",
                                          "bad.npz"]), device="cpu")
    system = dp_workers.multichip_system(dp_workers.multichip_hparams(
        lpips_weights="bad.npz"), "cpu")
    with pytest.raises(ValueError, match="missing keys"):
        system.validate(eval_lpips=True)


def test_validate_reports_jax_lpips(tmp_path):
    """``validate(eval_lpips=True)`` reports ``test/lpips_vgg``: the mean
    over the views of the JAX ``lpips_vgg`` of each rendered view against
    its image, on the same npz, rtol 1e-5 (``--val_only`` on a trained
    checkpoint does the same from the command line)."""
    path = str(tmp_path / "lpips.npz")
    np.savez(path, **_weights(5))
    system = dp_workers.multichip_system(dp_workers.multichip_hparams(
        lpips_weights=path), "cpu")
    system.fit(16)
    got = system.validate(eval_lpips=True)
    ds = system.test_dataset
    w, h = ds.img_wh
    want = []
    for i in range(len(ds)):
        view = ds[i]
        out = trendering.render_test(system.model, system.occ, *get_rays(
            torch.from_numpy(ds.directions), torch.from_numpy(view["pose"])),
            system.rcfg)
        want.append(float(jmetrics.lpips_vgg(
            jnp.asarray(out["rgb"].reshape(h, w, 3).numpy()),
            jnp.asarray(view["rgb"].reshape(h, w, 3)), weights_path=path)))
    assert set(got) == {"test/psnr", "test/ssim", "test/lpips_vgg"}
    np.testing.assert_allclose(got["test/lpips_vgg"], np.mean(want),
                               rtol=RTOL)
    assert os.path.exists(path)
