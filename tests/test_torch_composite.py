"""Compositing in the PyTorch port against the JAX package, on the CPU.

``mfnerf_tpu_torch/ops/composite.py`` holds ``composite_train`` (on CUDA
tensors ``composite_train_analytic``, a ``torch.autograd.Function`` whose
backward is the analytic one of ``composite_train_bwd_plain``; on CPU
tensors the plain version, differentiated through ``cumprod``),
``composite_test_step`` and its in-place form ``composite_test_step_into``;
on CUDA tensors they launch ``csrc/composite.cu``, which ``chip_smoke.py``
holds to these plain versions on the card. ``composite_train_analytic``
runs here with the plain forward and backward. Here the plain versions are held to the JAX package's
``mfnerf_tpu/ops/composite.py`` (run op by op, ``jax.disable_jit()``) on
seeded rows that cover the edges: an opaque sample (``1 - alpha == 0``
exactly), a row cut by ``T_threshold`` mid-way, masked holes between valid
samples, an all-masked row and S = 1.

Tolerances: forward values atol 1e-6 (float32 ops whose library
implementations may differ by an ulp); gradients rtol 1e-5 with an absolute
floor of 1e-6 of the largest (the analytic backward sums in another order
than autodiff through ``cumprod``, and where every G_k is equal its
``G_i T_i (1 - alpha_i) - suffix`` cancels to G T_end).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfnerf_tpu.ops import composite as jcomposite

from mfnerf_tpu_torch.ops import composite as tcomposite


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread (the suite runs in several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol=1e-5, rel_atol=1e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rel_atol * float(np.abs(want).max()))


def _edge_rows(s, seed, n=48):
    """(sigmas, rgbs, deltas, ts, mask) of n rows of s slots: row 0 with an
    opaque sample (sigma * delta = 30, ``1 - alpha == 0`` exactly), row 1
    cut by T_threshold mid-way (sigma * delta = 1 a sample), row 2 with
    masked holes between valid samples, row 3 all masked, the rest random
    valid prefixes with holes."""
    rng = np.random.default_rng(seed)
    sigmas = rng.exponential(8.0, (n, s)).astype(np.float32)
    deltas = rng.uniform(5e-3, 2e-2, (n, s)).astype(np.float32)
    counts = rng.integers(0, s + 1, n)
    mask = np.arange(s)[None, :] < counts[:, None]
    mask &= rng.random((n, s)) < 0.85
    mask[0] = True
    sigmas[0, min(2, s - 1)] = 3000.0
    deltas[0, min(2, s - 1)] = 0.01
    mask[1] = True
    deltas[1] = 0.01
    sigmas[1] = 100.0
    mask[2] = np.arange(s) % 3 != 1
    mask[3] = False
    ts = (np.cumsum(deltas, axis=1) + 0.1).astype(np.float32)
    rgbs = rng.random((n, s, 3), dtype=np.float32)
    return sigmas, rgbs, deltas, ts, mask


def _upstream(n, s, seed):
    """Seeded non-zero g_opacity, g_depth, g_rgb, g_ws."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n).astype(np.float32),
            rng.normal(size=n).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32),
            rng.normal(size=(n, s)).astype(np.float32))


CASES = [(24, 1e-4), (24, 1e-2), (40, 1e-4), (1, 1e-4)]


@pytest.mark.parametrize("s,thr", CASES)
def test_composite_train_bwd_plain_matches_jax_vjp(s, thr):
    """The analytic backward equals JAX's VJP of composite_train in sigmas,
    rgbs, deltas and ts, with every incoming gradient non-zero."""
    sigmas, rgbs, deltas, ts, mask = _edge_rows(s, seed=s)
    if s > 1:
        assert sigmas[0, 2] * deltas[0, 2] > 17
    ups = _upstream(*mask.shape, seed=s + 1)

    def fn(sig, col, dl, t):
        c = jcomposite.composite_train(sig, col, dl, t, mask, thr)
        return c.opacity, c.depth, c.rgb, c.ws

    with jax.disable_jit():
        (_, _, _, ws_j), vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (
            sigmas, rgbs, deltas, ts)))
        want = vjp(tuple(jnp.asarray(u) for u in ups))
    got = tcomposite.composite_train_bwd_plain(
        *(_t(a) for a in (sigmas, rgbs, deltas, ts, mask)),
        *(_t(u) for u in ups), thr)
    for name, g, w in zip(("sigmas", "rgbs", "deltas", "ts"), got, want):
        assert g.dtype == torch.float32, name
        _close(g.numpy(), w)
    # excluded slots (masked, or behind the cut) get nothing
    excluded = np.asarray(ws_j) == 0
    for g in got:
        flat = g.numpy().reshape(*mask.shape, -1)
        assert np.abs(flat[excluded]).max(initial=0.0) == 0
    if s > 1:
        assert not mask[3].any() and got[0][3].abs().max() == 0
        assert np.asarray(ws_j)[1, -1] == 0      # row 1 is cut mid-way
        assert np.asarray(ws_j)[0, 3:].max() == 0  # nothing behind opaque


@pytest.mark.parametrize("s,thr", CASES)
def test_composite_train_matches_jax(s, thr):
    """composite_train and its autograd Function's forward equal the JAX
    function on the edge rows, vr_samples included."""
    sigmas, rgbs, deltas, ts, mask = _edge_rows(s, seed=s + 10)
    with jax.disable_jit():
        want = jcomposite.composite_train(
            *(jnp.asarray(a) for a in (sigmas, rgbs, deltas, ts, mask)), thr)
    for fn in (tcomposite.composite_train,
               tcomposite.composite_train_analytic):
        got = fn(*(_t(a) for a in (sigmas, rgbs, deltas, ts, mask)), thr)
        for name in ("opacity", "depth", "rgb", "ws"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(want, name)),
                                       atol=1e-6, err_msg=name)
        assert got.vr_samples.dtype == torch.int64
        assert int(got.vr_samples) == int(want.vr_samples)


# which incoming gradients reach the backward: the loss's (opacity, rgb),
# all four, the distortion loss's ws alone, depth alone
UPSTREAM = [("opacity", "rgb"), ("opacity", "depth", "rgb", "ws"), ("ws",),
            ("depth",)]


@pytest.mark.parametrize("used", UPSTREAM)
@pytest.mark.parametrize("s", [24, 1])
def test_composite_train_function_matches_autograd_through_cumprod(s, used):
    """composite_train_analytic's backward gives the gradients of autograd
    through the plain version's cumprod in sigmas, rgbs, deltas and ts
    (as --optimize_ext recomputes them differentiably), whichever outputs
    the loss uses; unused inputs get None."""
    sigmas, rgbs, deltas, ts, mask = _edge_rows(s, seed=s + 20)
    ups = dict(zip(("opacity", "depth", "rgb", "ws"),
                   _upstream(*mask.shape, seed=s + 21)))
    grads = {}
    for label, fn in (("function", tcomposite.composite_train_analytic),
                      ("autograd", tcomposite.composite_train)):
        leaves = [_t(a).requires_grad_() for a in (sigmas, rgbs, deltas, ts)]
        comp = fn(*leaves, _t(mask), 1e-4)
        sum(((getattr(comp, k) * _t(ups[k])).sum() for k in used)
            ).backward()
        grads[label] = [x.grad for x in leaves]
    for name, g, w in zip(("sigmas", "rgbs", "deltas", "ts"),
                          grads["function"], grads["autograd"]):
        if name == "rgbs" and "rgb" not in used or \
                name == "ts" and "depth" not in used:
            assert g is None, name
            continue
        _close(g.numpy(), w.numpy())


@pytest.mark.parametrize("fn", [tcomposite.composite_train_analytic,
                                tcomposite.composite_train])
def test_composite_train_returns_gradients_in_the_inputs_dtypes(fn):
    """bf16 sigmas and rgbs (as --bf16 may hand them) are composited in
    float32, and their gradients come back in bf16, those of float32
    deltas and ts in float32 (the analytic path, as on the card, and the
    plain one)."""
    dtype = torch.bfloat16
    sigmas, rgbs, deltas, ts, mask = _edge_rows(8, seed=30)
    want = tcomposite.composite_train_bwd_plain(
        _t(sigmas).to(dtype), _t(rgbs).to(dtype), _t(deltas), _t(ts),
        _t(mask), torch.ones(48), torch.ones(48), torch.ones(48, 3), None)
    sig = _t(sigmas).to(dtype).requires_grad_()
    col = _t(rgbs).to(dtype).requires_grad_()
    dl, t = _t(deltas).requires_grad_(), _t(ts).requires_grad_()
    comp = fn(sig, col, dl, t, _t(mask))
    assert comp.opacity.dtype == comp.ws.dtype == torch.float32
    (comp.opacity.sum() + comp.depth.sum() + comp.rgb.sum()).backward()
    assert sig.grad.dtype == col.grad.dtype == dtype
    assert dl.grad.dtype == t.grad.dtype == torch.float32
    _close(sig.grad.float().numpy(), want[0].to(dtype).float().numpy(),
           rtol=1e-2)
    _close(dl.grad.numpy(), want[2].numpy())


def test_composite_train_bwd_asks_only_for_what_is_needed():
    sigmas, rgbs, deltas, ts, mask = (_t(a) for a in _edge_rows(6, seed=31))
    ups = [_t(u) for u in _upstream(48, 6, seed=32)]
    full = tcomposite.composite_train_bwd(sigmas, rgbs, deltas, ts, mask,
                                          *ups)
    some = tcomposite.composite_train_bwd(sigmas, rgbs, deltas, ts, mask,
                                          *ups, needs=(True, False, False,
                                                       True))
    assert some[1] is None and some[2] is None
    assert torch.equal(some[0], full[0]) and torch.equal(some[3], full[3])
    plain = tcomposite.composite_train_bwd_plain(sigmas, rgbs, deltas, ts,
                                                 mask, *ups)
    for a, b in zip(full, plain):
        assert torch.equal(a, b)


def _round_rows(s, seed, n=48):
    """A serving round's block (the edge rows) and running accumulators:
    opacities in [0, 0.9], a few dead rows, one row already past
    T_threshold = 1e-2."""
    sigmas, rgbs, deltas, ts, mask = _edge_rows(s, seed, n)
    rng = np.random.default_rng(seed + 1)
    opacity = rng.uniform(0, 0.9, n).astype(np.float32)
    opacity[5] = 0.995
    depth = rng.random(n, dtype=np.float32)
    rgb = rng.random((n, 3), dtype=np.float32)
    alive = rng.random(n) < 0.85
    return sigmas, rgbs, deltas, ts, mask, opacity, depth, rgb, alive


@pytest.mark.parametrize("s,thr", [(24, 1e-4), (24, 1e-2), (3, 1e-2),
                                   (1, 1e-2)])
def test_composite_test_step_edges_match_jax(s, thr):
    arrays = _round_rows(s, seed=s + 40)
    with jax.disable_jit():
        want = jcomposite.composite_test_step(
            *(jnp.asarray(a) for a in arrays), thr)
    got = tcomposite.composite_test_step(*(_t(a) for a in arrays), thr)
    for w, g in zip(want[:3], got[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    if thr >= 1e-2:          # row 5 starts at T = 0.005: it ends here
        assert not got[3][5]
        np.testing.assert_array_equal(got[0][5].numpy(), arrays[5][5])
    assert not got[3].numpy()[~arrays[-1]].any()    # the dead stay dead


@pytest.mark.parametrize("s", [24, 1])
def test_composite_test_step_into_updates_the_alive_entries(s):
    """The in-place round composites row r into entry index[r] of the
    frame's accumulators, as composite_test_step on the gathered rows does,
    and leaves the other entries as they were."""
    sigmas, rgbs, deltas, ts, mask, opacity, _, _, _ = (
        _t(a) for a in _round_rows(s, seed=s + 50))
    m = 100
    rng = np.random.default_rng(s + 51)
    index = torch.from_numpy(rng.permutation(m)[:48].astype(np.int64))
    frame = [torch.from_numpy(rng.random(shape, dtype=np.float32))
             for shape in ((m,), (m,), (m, 3))]
    frame[0][index] = opacity
    before = [x.clone() for x in frame]
    alive = tcomposite.composite_test_step_into(
        sigmas, rgbs, deltas, ts, mask, index, *frame, 1e-2)
    want = tcomposite.composite_test_step(
        sigmas, rgbs, deltas, ts, mask, *(b[index] for b in before),
        torch.ones(48, dtype=torch.bool), 1e-2)
    for x, w in zip(frame, want):
        assert torch.equal(x[index], w)
    assert torch.equal(alive, want[3])
    rest = torch.ones(m, dtype=torch.bool)
    rest[index] = False
    for x, b in zip(frame, before):
        assert torch.equal(x[rest], b[rest])


def test_cpu_tensors_launch_no_kernel():
    for fn in (tcomposite.composite_train, tcomposite.composite_train_bwd,
               tcomposite.composite_test_step):
        fn.launches = 0
    sigmas, rgbs, deltas, ts, mask = (_t(a) for a in _edge_rows(8, seed=60))
    sig = sigmas.clone().requires_grad_()
    tcomposite.composite_train_analytic(sig, rgbs, deltas, ts, mask).rgb.sum(
        ).backward()
    arrays = [_t(a) for a in _round_rows(8, seed=61)]
    tcomposite.composite_test_step(*arrays, 1e-2)
    assert (tcomposite.composite_train.launches,
            tcomposite.composite_train_bwd.launches,
            tcomposite.composite_test_step.launches) == (0, 0, 0)


def _bad_train_args():
    sigmas, rgbs, deltas, ts, mask = (_t(a) for a in _edge_rows(8, seed=70))
    return [
        ("shape", (sigmas, rgbs[:, :4], deltas, ts, mask)),
        ("shape", (sigmas, rgbs, deltas[:-1], ts, mask)),
        ("shape", (sigmas[0], rgbs, deltas, ts, mask)),
        ("dtype", (sigmas.double(), rgbs, deltas, ts, mask)),
        ("dtype", (sigmas, rgbs, deltas, ts.to(torch.int32), mask)),
        ("dtype", (sigmas, rgbs, deltas, ts, mask.float())),
        ("device", (sigmas, rgbs, deltas, ts, mask.to("meta"))),
        ("device", tuple(x.to("meta") for x in (sigmas, rgbs, deltas, ts,
                                                 mask))),
    ]


@pytest.mark.parametrize("case", range(8))
def test_composite_wrappers_refuse_what_the_kernels_do_not_take(case):
    """A wrong shape, dtype or device raises ValueError in each wrapper."""
    what, args = _bad_train_args()[case]
    for fn in (tcomposite.composite_train,
               tcomposite.composite_train_analytic):
        with pytest.raises(ValueError):
            fn(*args)
    with pytest.raises(ValueError):
        tcomposite.composite_train_bwd(*args, None, None, None, None)
    n = 48
    acc = (torch.zeros(n), torch.zeros(n), torch.zeros(n, 3))
    with pytest.raises(ValueError):
        tcomposite.composite_test_step(*args, *acc,
                                       torch.ones(n, dtype=torch.bool), 1e-2)
    with pytest.raises(ValueError):
        tcomposite.composite_test_step_into(
            *args, torch.arange(n), torch.zeros(64), torch.zeros(64),
            torch.zeros(64, 3), 1e-2)


def test_composite_round_refuses_bad_accumulators():
    sigmas, rgbs, deltas, ts, mask, opacity, depth, rgb, alive = (
        _t(a) for a in _round_rows(8, seed=80))
    block = (sigmas, rgbs, deltas, ts, mask)
    for bad in ((opacity.double(), depth, rgb, alive),
                (opacity, depth[:-1], rgb, alive),
                (opacity, depth, rgb[:, :2], alive),
                (opacity, depth, rgb, alive.float())):
        with pytest.raises(ValueError):
            tcomposite.composite_test_step(*block, *bad, 1e-2)
    frame = (torch.zeros(64), torch.zeros(64), torch.zeros(64, 3))
    with pytest.raises(ValueError):       # int32 index
        tcomposite.composite_test_step_into(
            *block, torch.arange(48, dtype=torch.int32), *frame, 1e-2)
    with pytest.raises(ValueError):       # rgb not (M, 3)
        tcomposite.composite_test_step_into(
            *block, torch.arange(48), frame[0], frame[1], torch.zeros(64, 2),
            1e-2)
    with pytest.raises(ValueError):       # a gradient of the wrong shape
        tcomposite.composite_train_bwd(*block, torch.zeros(47), None, None,
                                       None)
