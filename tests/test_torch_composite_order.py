"""The composite training kernels' order models on the CPU.

``ops/composite.py::composite_train_bwd_order_plain`` repeats, operation by
operation, what csrc/composite.cu's two backward kernels compute: the
register kernel (rows of up to four passes, which skips the scan of a pass
that includes no slot of its warp) and the two-walk kernel (longer rows,
every pass scanned). ``composite_train_fwd_order_plain`` does the same for
the two forward kernels (the register kernel, which skips the scan of a
pass masked on the whole warp, and the pass-by-pass kernel of longer
rows); the two models share their front walk. On the card
``chip_smoke.py`` holds each pair of kernels to each other and to its
model bit for bit; here the backward model is held to
``composite_train_bwd_plain`` (the analytic backward in torch's order:
rtol 1e-5 with an absolute floor of 1e-6 of the largest, as the plain
version is held to JAX's autodiff in ``test_torch_composite.py``), the
forward model to ``composite_train_fwd_plain`` and the JAX package's
``composite_train`` (within 1e-6 of the largest on the rows clear of the
threshold, the rows' included counts equal there), the forward's weights
to the backward model's bit for bit, and each skip to its full walk, bit
for bit, on rows made to break it: masked passes, rows saturating in
mid-pass, transmittances a few ulps from the threshold, negative incoming
gradients (a -0 that 0 + R would turn +0).
"""
import numpy as np
import pytest
import torch

from mfnerf_tpu.ops import composite as jcomposite

from mfnerf_tpu_torch.ops import composite as tcomposite


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread (the suite runs in several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(s, seed, n=96, thr=1e-4):
    """(sigmas, rgbs, deltas, ts, mask) of n rows of s slots: random valid
    prefixes with holes; a sixth of the rows saturating from slot s // 3 +
    1; a sixth with masked holes (slots 5-19 and the pass 32-63); a sixth
    whose transmittance before the third slot sweeps T_threshold in steps
    of about an ulp of it."""
    rng = np.random.default_rng(seed)
    sig = rng.exponential(4.0, (n, s)).astype(np.float32)
    dl = rng.uniform(2e-3, 2e-2, (n, s)).astype(np.float32)
    counts = rng.integers(0, s + 1, n)
    mask = (np.arange(s)[None, :] < counts[:, None]) \
        & (rng.random((n, s)) < 0.8)
    k = n // 6
    sig[:k, s // 3 + 1:] = 400.0
    mask[k:2 * k] = rng.random((k, s)) < 0.9
    mask[k:2 * k, 5:20] = False
    mask[k:2 * k, 32:64] = False                  # a whole pass of 32
    if s >= 3:
        rows = slice(2 * k, 3 * k)
        om0 = np.float32(1) - (np.float32(1) - np.exp(-np.float32(9.2101)))
        x1 = (om0 / np.float32(thr) - 1 + np.arange(-(k // 2), k - k // 2)
              * 1e-8).astype(np.float32)
        sig[rows, 0], sig[rows, 1] = 9.2101, x1
        dl[rows, :2] = 1.0
        mask[rows, :3] = True
    ts = (np.cumsum(dl, axis=1) + 0.05).astype(np.float32)
    rgbs = rng.random((n, s, 3), dtype=np.float32)
    return tuple(torch.from_numpy(a) for a in (sig, rgbs, dl, ts, mask))


def _grads(n, s, seed, ws=True):
    rng = np.random.default_rng(seed)
    g = [rng.normal(size=n), rng.normal(size=n), rng.normal(size=(n, 3)),
         rng.normal(size=(n, s))]
    g = [torch.from_numpy(x.astype(np.float32)) for x in g]
    if not ws:
        g[3] = None
    return g


SIZES = [1, 8, 24, 40, 64, 100, 128, 200]


@pytest.mark.parametrize("s", SIZES)
@pytest.mark.parametrize("thr", [1e-4, 1e-2])
def test_order_model_matches_the_plain_backward(s, thr):
    block = _rows(s, seed=s, thr=thr)
    for ws in (True, False):
        ups = _grads(block[0].shape[0], s, seed=s + 1, ws=ws)
        got = tcomposite.composite_train_bwd_order_plain(*block, *ups, thr)
        want = tcomposite.composite_train_bwd_plain(*block, *ups, thr)
        for g, w in zip(got, want):
            np.testing.assert_allclose(
                g.numpy(), w.numpy(), rtol=1e-5,
                atol=1e-6 * float(w.abs().max()))


@pytest.mark.parametrize("s", SIZES)
def test_the_skip_of_passes_with_nothing_included_is_exact(s):
    """The register kernel's skip (scan skipped, R carried as 0 + R) gives
    the bits of the full walk, negative gradients and ties included."""
    for thr in (1e-4, 1e-2):
        block = _rows(s, seed=10 + s, thr=thr)
        ups = _grads(block[0].shape[0], s, seed=11 + s)
        ups = [None if g is None else -g.abs() for g in ups]
        skip = tcomposite.composite_train_bwd_order_plain(*block, *ups, thr)
        walk = tcomposite.composite_train_bwd_order_plain(*block, *ups, thr,
                                                          skip=False)
        for a, b in zip(skip, walk):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_passes_past_the_warps_stop_are_positive_zeros():
    """Past the pass at which every row of its warp has fallen to the
    threshold the kernels write +0, and -0 (0 times a negative incoming
    gradient) in the reached passes that include nothing."""
    s = 64
    sig = torch.full((1, s), 1.0)
    sig[0, :4] = 3000.0                       # opaque in the first pass
    dl = torch.full((1, s), 0.01)
    mask = torch.ones((1, s), dtype=torch.bool)
    ts = torch.cumsum(dl, 1)
    rgbs = torch.rand((1, s, 3), generator=torch.Generator().manual_seed(0))
    ups = (-torch.ones(1), -torch.ones(1), -torch.ones(1, 3), None)
    d_sig, d_rgb, _, d_t = tcomposite.composite_train_bwd_order_plain(
        sig, rgbs, dl, ts, mask, *ups, 1e-4)
    bits = d_t.view(torch.int32)
    assert bool((bits[0, 32:] == 0).all())                   # +0
    assert bool((bits[0, 1:32] == torch.tensor(-0.0).view(
        torch.int32)).all())                                 # -0
    assert bool((d_rgb[0, 32:].view(torch.int32) == 0).all())
    assert float(d_sig[0, 0]) != 0.0


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _clear_rows(sigmas, deltas, mask, thr, rel=1e-4):
    """Rows in which no valid slot's transmittance before it lies within a
    relative ``rel`` of thr (in float64): where the kernels' order of the
    product and torch's cannot fall on either side of it."""
    sig, dl = (x.numpy().astype(np.float64) for x in (sigmas, deltas))
    m = mask.numpy()
    om = np.where(m, np.exp(-sig * dl), 1.0)
    t = np.cumprod(np.concatenate([np.ones_like(om[:, :1]), om[:, :-1]],
                                  axis=1), axis=1)
    near = np.abs(t - thr) <= rel * thr
    return torch.from_numpy(~(near & m).any(axis=1))


@pytest.mark.parametrize("s", SIZES)
@pytest.mark.parametrize("thr", [1e-4, 1e-2])
def test_fwd_order_model_matches_the_plain_forward_and_jax(s, thr):
    import jax.numpy as jnp
    block = _rows(s, seed=20 + s, thr=thr)
    got = tcomposite.composite_train_fwd_order_plain(*block, thr)
    want = tcomposite.composite_train_fwd_plain(*block, thr)
    keep = _clear_rows(block[0], block[2], block[4], thr)
    assert int(keep.sum()) >= block[0].shape[0] // 2
    for g, w in zip(got[:4], want[:4]):
        err = float((g[keep] - w[keep]).abs().max())
        assert err <= 1e-6 * float(w[keep].abs().max()), err
    assert torch.equal(got[4][keep], want[4][keep])
    sub = [jnp.asarray(x[keep].numpy()) for x in block]
    jax_out = jcomposite.composite_train(*sub, thr)
    for g, w in zip(got[:4], (jax_out.opacity, jax_out.depth, jax_out.rgb,
                              jax_out.ws)):
        w = np.asarray(w)
        err = float(np.abs(g[keep].numpy() - w).max())
        assert err <= 1e-6 * float(np.abs(w).max()), err
    assert int(got[4][keep].sum()) == int(jax_out.vr_samples)


@pytest.mark.parametrize("s", SIZES)
def test_fwd_skip_of_wholly_masked_passes_is_exact(s):
    """The register kernel's skip of the scans of passes masked on the
    whole warp gives the bits of the pass-by-pass walk."""
    for thr in (1e-4, 1e-2):
        block = _rows(s, seed=30 + s, thr=thr)
        skip = tcomposite.composite_train_fwd_order_plain(*block, thr)
        walk = tcomposite.composite_train_fwd_order_plain(*block, thr,
                                                          skip=False)
        for a, b in zip(skip, walk):
            assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("s", SIZES)
def test_fwd_ws_are_the_backward_models_weights(s):
    """The forward's ws are bit for bit the weights that the backward
    recomputes: its d_rgbs[..., 0] given g_rgb = 1 and no other incoming
    gradient."""
    for thr in (1e-4, 1e-2):
        block = _rows(s, seed=40 + s, thr=thr)
        n = block[0].shape[0]
        ws = tcomposite.composite_train_fwd_order_plain(*block, thr)[3]
        for skip in (True, False):
            d_rgbs = tcomposite.composite_train_bwd_order_plain(
                *block, None, None, torch.ones((n, 3)), None, thr,
                skip=skip)[1]
            assert torch.equal(_bits(ws), _bits(d_rgbs[..., 0].contiguous()))
