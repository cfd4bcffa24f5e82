"""Parity of the port's line-table and hat kernels with the Pallas kernels
of the encoder formulation probes (``benchmarking/probe_pallas_*.py``) and
their XLA references, on the CPU.

The probes' kernels and references are nested in their ``main()``, so each
is transcribed here, constants made arguments, and its ``pallas_call`` run
with ``interpret=True`` at a small N that fills two or more tiles. The port
gets the same numpy inputs (CPU tensors: the plain versions) at a ragged N;
the JAX side pads N to its tile with samples that add nothing and is cut
back. Tolerances:

* the lerp (kernels 3-5): rtol 1e-6, atol 1e-6 (fp32 operations that XLA may
  fuse into FMAs);
* dW (kernel 6): 1e-5 x max |dW_JAX| (the same bf16 products summed in
  another order); the model of the kernel's sums
  (``hat_basis_dw_order_plain``) bit for bit against a sample-by-sample
  loop;
* the hat product (kernel 7): atol and rtol 1e-4, as
  ``tests/test_torch_ops.py::test_hat_prod_plain_matches_jax``.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mfnerf_tpu_torch.benchmarking import (probe_gather, probe_gather2,
                                           probe_hatmul)
from mfnerf_tpu_torch.ops import hatmul as thatmul
from mfnerf_tpu_torch.ops import linetable as tline

LERP_TOL = 1e-6
DW_TOL = 1e-5                  # x max |dW_JAX|
HAT_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pad(x, tile):
    """x padded with zeros along axis 0 to a multiple of ``tile``."""
    n_pad = -(-x.shape[0] // tile) * tile
    return np.concatenate([x, np.zeros((n_pad - x.shape[0],) + x.shape[1:],
                                       x.dtype)])


def _vmem(shape, index_map):
    return pl.BlockSpec(shape, index_map, memory_space=pltpu.VMEM)


# --------------------------- probe_pallas_gather.py (kernels 3 and 4)
def _gather_ref(table, idx, frac):                       # :49-52
    t0 = table[:, idx]
    t1 = table[:, idx + 1]
    return t0 * (1 - frac)[None, :] + t1 * frac[None, :]


def _run_onehot(table, idx, frac, tile):                 # :60-91
    rank, k = table.shape
    n = idx.shape[0]

    def k_onehot(table_ref, idx_ref, frac_ref, out_ref):
        idxs = idx_ref[:]
        oh0 = (idxs[:, None] == jax.lax.broadcasted_iota(
            jnp.int32, (tile, k), 1)).astype(jnp.float32)
        t0 = jnp.dot(oh0, table_ref[:].T, preferred_element_type=jnp.float32)
        oh1 = ((idxs + 1)[:, None] == jax.lax.broadcasted_iota(
            jnp.int32, (tile, k), 1)).astype(jnp.float32)
        t1 = jnp.dot(oh1, table_ref[:].T, preferred_element_type=jnp.float32)
        f = frac_ref[:][:, None]
        out_ref[:] = t0 * (1 - f) + t1 * f

    return pl.pallas_call(
        k_onehot, grid=(n // tile,),
        in_specs=[_vmem((rank, k), lambda i: (0, 0)),
                  _vmem((tile,), lambda i: (i,)),
                  _vmem((tile,), lambda i: (i,))],
        out_specs=_vmem((tile, rank), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((n, rank), jnp.float32),
        interpret=True)(table, idx, frac)


def _run_index(table, idx, frac, tile):                  # :105-131
    rank, k = table.shape
    n = idx.shape[0]

    def k_index(table_ref, idx_ref, frac_ref, out_ref):
        idxs = idx_ref[:]
        t = table_ref[:]
        idx2 = jnp.broadcast_to(idxs[None, :], (rank, tile))
        t0 = jnp.take_along_axis(t, idx2, axis=1)
        t1 = jnp.take_along_axis(t, idx2 + 1, axis=1)
        f = frac_ref[:][None, :]
        out_ref[:] = (t0 * (1 - f) + t1 * f).T

    table_padded = jnp.pad(table, ((0, 0), (0, tile - k)))
    return pl.pallas_call(
        k_index, grid=(n // tile,),
        in_specs=[_vmem((rank, tile), lambda i: (0, 0)),
                  _vmem((tile,), lambda i: (i,)),
                  _vmem((tile,), lambda i: (i,))],
        out_specs=_vmem((tile, rank), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((n, rank), jnp.float32),
        interpret=True)(table_padded, idx, frac)


def _gather_operands(n, seed=0):
    """The probe's operands (RANK 8, K 128) from a numpy seed, with the
    edges idx 0 and K-2, frac 0 and 1."""
    rng = np.random.default_rng(seed)
    rank, k = probe_gather.RANK, probe_gather.K
    table = rng.standard_normal((rank, k), dtype=np.float32)
    idx = rng.integers(0, k - 1, n, dtype=np.int32)
    frac = rng.random(n, dtype=np.float32)
    idx[:8], idx[8:16] = 0, k - 2
    frac[:4], frac[4:8], frac[8:12], frac[12:16] = 0, 1, 0, 1
    return table, idx, frac


@pytest.mark.parametrize("ref", ["k_onehot", "k_index", "xla_ref"])
def test_table_lerp_idx_matches_probe_gather(ref):
    tile, n = 512, 2 * 512 + 37
    table, idx, frac = _gather_operands(n)
    if ref == "xla_ref":
        want = np.asarray(_gather_ref(jnp.asarray(table), jnp.asarray(idx),
                                      jnp.asarray(frac))).T
    else:
        run = _run_onehot if ref == "k_onehot" else _run_index
        want = np.asarray(run(jnp.asarray(table), jnp.asarray(_pad(idx, tile)),
                              jnp.asarray(_pad(frac, tile)), tile))[:n]
    got = tline.table_lerp(torch.from_numpy(table.T.copy()),
                           torch.from_numpy(idx), torch.from_numpy(frac))
    assert got.shape == (n, probe_gather.RANK)
    np.testing.assert_allclose(got.numpy(), want, rtol=LERP_TOL,
                               atol=LERP_TOL)
    # frac 0 and 1 give the rows themselves
    np.testing.assert_array_equal(got[:4].numpy(), np.tile(table[:, 0], (4, 1)))
    np.testing.assert_array_equal(got[4:8].numpy(),
                                  np.tile(table[:, 1], (4, 1)))
    np.testing.assert_array_equal(got[12:16].numpy(),
                                  np.tile(table[:, -1], (4, 1)))
    assert tline.table_lerp.launches == 0


# ------------------------- probe_pallas_gather2.py (kernels 5 and 6)
def _gather2_ref(u, w, k):                                # :72-76
    pos = u * (k - 1)
    i = jnp.clip(pos.astype(jnp.int32), 0, k - 2)
    f = (pos - i.astype(jnp.float32))[:, None]
    return w[i] * (1 - f) + w[i + 1] * f


def _run_gather(u, wt, k):                                # :88-113
    r, kp = wt.shape
    tn = kp                    # the index tile has the table's lane shape
    n = u.shape[0]

    def k_gather(u_ref, wt_ref, out_ref):
        uu = u_ref[:]
        pos = uu * (k - 1)
        i = jnp.clip(pos.astype(jnp.int32), 0, k - 2)
        f = pos - i.astype(jnp.float32)
        tab = wt_ref[:]
        idx2 = jnp.broadcast_to(i, (r, tn))
        t0 = jnp.take_along_axis(tab, idx2, axis=1)
        t1 = jnp.take_along_axis(tab, idx2 + 1, axis=1)
        out_ref[:] = jnp.transpose(t0 * (1 - f) + t1 * f)

    return pl.pallas_call(
        k_gather, grid=(n // tn,),
        in_specs=[_vmem((1, tn), lambda i: (0, i)),
                  _vmem((r, kp), lambda i: (0, 0))],
        out_specs=_vmem((tn, r), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((n, r), jnp.float32),
        interpret=True)(u.reshape(1, n), wt)


def _gather2_ref_bwd(u, g, k, kp):                        # :130-136
    ks = jnp.arange(kp, dtype=jnp.float32)[None, :]
    pos = u[:, None] * (k - 1)
    basis = jnp.maximum(0.0, 1.0 - jnp.abs(pos - ks))
    return jnp.dot(basis.T.astype(jnp.bfloat16), g.astype(jnp.bfloat16),
                   preferred_element_type=jnp.float32)


def _run_bwd(u, g, k, kp, tb):                            # :143-173
    n, r = g.shape

    def k_bwd(u_ref, g_ref, dw_ref):
        step = pl.program_id(0)

        @pl.when(step == 0)
        def _init():
            dw_ref[:] = jnp.zeros_like(dw_ref)

        uu = u_ref[:]
        iota = jax.lax.broadcasted_iota(jnp.int32, (tb, kp), 1
                                        ).astype(jnp.float32)
        pos = uu.reshape(tb, 1) * (k - 1)
        basis = jnp.maximum(0.0, 1.0 - jnp.abs(pos - iota))
        dw_ref[:] += jnp.dot(basis.T.astype(jnp.bfloat16),
                             g_ref[:].astype(jnp.bfloat16),
                             preferred_element_type=jnp.float32)

    return pl.pallas_call(
        k_bwd, grid=(n // tb,),
        in_specs=[_vmem((1, tb), lambda i: (0, i)),
                  _vmem((tb, r), lambda i: (i, 0))],
        out_specs=_vmem((kp, r), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((kp, r), jnp.float32),
        interpret=True)(u.reshape(1, n), g)


def _u_operands(n, k, seed, *cols):
    """u (n,) uniform in [0, 1) with u = 1, u = 0 and knots among the first
    samples, then N(0, 1) arrays of the shapes ``cols``."""
    rng = np.random.default_rng(seed)
    u = rng.random(n, dtype=np.float32)
    u[:16], u[16:32] = 1.0, 0.0
    u[32:96] = np.round(u[32:96] * (k - 1)) / (k - 1)
    return (u,) + tuple(rng.standard_normal(c, dtype=np.float32)
                        for c in cols)


SHAPES2 = [(65, 128, 16), (513, 640, 128)]     # (K, KP, R); the probe's last


@pytest.mark.parametrize("ref", ["k_gather", "xla_ref"])
@pytest.mark.parametrize("k,kp,r", SHAPES2)
def test_table_lerp_u_matches_probe_gather2(k, kp, r, ref):
    n = 2 * kp + 37
    u, w = _u_operands(n, k, 1, (kp, r))
    w = (0.1 * w).astype(np.float32)
    w[k:] = 0.0                # the probe's zero padding rows
    if ref == "xla_ref":
        want = np.asarray(_gather2_ref(jnp.asarray(u), jnp.asarray(w), k))
    else:
        want = np.asarray(_run_gather(jnp.asarray(_pad(u, kp)),
                                      jnp.asarray(w.T.copy()), k))[:n]
    table = torch.from_numpy(w[:k].copy())
    got = tline.table_lerp(table, u=torch.from_numpy(u), k=k)
    np.testing.assert_allclose(got.numpy(), want, rtol=LERP_TOL,
                               atol=LERP_TOL)
    # u = 1: row K-2 with f = 1, the last row itself; u = 0: row 0
    np.testing.assert_array_equal(got[:16].numpy(), np.tile(w[k - 1], (16, 1)))
    np.testing.assert_array_equal(got[16:32].numpy(), np.tile(w[0], (16, 1)))
    # rows past k are never read: the padded table gives the same result
    padded = tline.table_lerp(torch.from_numpy(w), u=torch.from_numpy(u), k=k)
    assert torch.equal(padded, got)


@pytest.mark.parametrize("ref", ["k_bwd", "xla_ref"])
@pytest.mark.parametrize("k,kp,r", SHAPES2)
def test_hat_basis_dw_matches_probe_gather2(k, kp, r, ref):
    tb = 256
    n = 2 * tb + 37
    u, g = _u_operands(n, k, 2, (n, r))
    if ref == "xla_ref":
        want = np.asarray(_gather2_ref_bwd(jnp.asarray(u), jnp.asarray(g), k,
                                           kp))
    else:      # padding samples: u = 0 and g = 0 add nothing
        want = np.asarray(_run_bwd(jnp.asarray(_pad(u, tb)),
                                   jnp.asarray(_pad(g, tb)), k, kp, tb))
    assert want.shape == (kp, r)
    np.testing.assert_array_equal(want[k:], 0.0)   # the TPU's padding rows
    got = tline.hat_basis_dw(torch.from_numpy(u), torch.from_numpy(g), k)
    assert got.shape == (k, r) and got.dtype == torch.float32
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want[:k], rtol=0,
                               atol=DW_TOL * scale)
    assert tline.hat_basis_dw.launches == 0


def test_hat_basis_dw_on_the_knots():
    """A sample on a knot or at u = 0 or 1 adds its bf16 g to that row
    alone."""
    k, r = 9, 8
    u = np.float32([0.0, 1.0, 0.5, 0.25])
    g = np.random.default_rng(3).standard_normal((4, r), dtype=np.float32)
    got = tline.hat_basis_dw(torch.from_numpy(u), torch.from_numpy(g), k)
    g_bf = torch.from_numpy(g).to(torch.bfloat16).float()
    want = torch.zeros((k, r))
    for row, gi in zip((0, 8, 4, 2), g_bf):
        want[row] += gi
    assert torch.equal(got, want)


def _dw_order_loop(u, g, k):
    """The kernel's sums written out: per chunk, each sample in order adds
    its products to slab rows i and i + 1 (fp32); then the chunks in
    order."""
    n, r = g.shape
    chunk, chunks = tline.dw_chunking(n, r)
    i, w0, w1 = (x.numpy() for x in tline.hat_rows(torch.from_numpy(u), k))
    gd = torch.from_numpy(g).to(torch.bfloat16).float().numpy()
    dw = np.zeros((k, r), np.float32)
    for c in range(chunks):
        slab = np.zeros((k, r), np.float32)
        for s in range(c * chunk, min(n, (c + 1) * chunk)):
            slab[i[s]] = slab[i[s]] + w0[s] * gd[s]
            slab[i[s] + 1] = slab[i[s] + 1] + w1[s] * gd[s]
        dw = dw + slab
    return dw


def _dw_set(kind, n, k, seed):
    """u and g of one dW set: uniform with the edges, sorted, or on the
    knots."""
    u, g = _u_operands(n, k, seed, (n, 16))
    if kind == "sorted":
        u = np.sort(u)
    elif kind == "knots":
        u = (np.round(u * (k - 1)) / (k - 1)).astype(np.float32)
    return u, g


@pytest.mark.parametrize("kind", ["uniform", "sorted", "knots"])
@pytest.mark.parametrize("n,k", [(549, 65), (3 * 1024 + 37, 513),
                                 (2100, 9)])
def test_hat_basis_dw_order_model_is_the_loop(n, k, kind):
    """hat_basis_dw_order_plain (vectorised, as the card runs it) equals
    the sample-by-sample loop bit for bit, over one chunk or several."""
    u, g = _dw_set(kind, n, k, 5)
    want = _dw_order_loop(u, g, k)
    got = tline.hat_basis_dw_order_plain(torch.from_numpy(u),
                                         torch.from_numpy(g), k)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("ref", ["k_bwd", "xla_ref"])
@pytest.mark.parametrize("k,kp,r", SHAPES2)
def test_hat_basis_dw_order_model_matches_probe_gather2(k, kp, r, ref):
    """The kernel's order of sums computes the probe's dW, within DW_TOL,
    over several chunks."""
    tb = 256
    n = 9 * tb + 37
    u, g = _u_operands(n, k, 6, (n, r))
    if ref == "xla_ref":
        want = np.asarray(_gather2_ref_bwd(jnp.asarray(u), jnp.asarray(g), k,
                                           kp))
    else:
        want = np.asarray(_run_bwd(jnp.asarray(_pad(u, tb)),
                                   jnp.asarray(_pad(g, tb)), k, kp, tb))
    assert tline.dw_chunking(n, r)[1] > 1
    got = tline.hat_basis_dw_order_plain(torch.from_numpy(u),
                                         torch.from_numpy(g), k)
    np.testing.assert_allclose(got.numpy(), want[:k], rtol=0,
                               atol=DW_TOL * np.abs(want).max())


@pytest.mark.parametrize("k", [2, 9, 65, 513, 1000, tline.DW_MAX_K])
def test_hat_rows_are_the_dense_basis_nonzeros(k):
    """hat_rows' row and weights are the dense bf16 basis's two nonzeros,
    bit for bit, and the basis has no other."""
    u, _ = _dw_set("uniform", 300, k, 7)
    ut = torch.from_numpy(u)
    i, w0, w1 = tline.hat_rows(ut, k)
    dense = thatmul._pos_basis(ut, k, torch.arange(k, dtype=torch.float32))[1]
    rows = torch.arange(len(u))
    assert torch.equal(dense[rows, i], w0) and torch.equal(dense[rows, i + 1],
                                                           w1)
    dense[rows, i] = 0
    dense[rows, i + 1] = 0
    assert not dense.any()


def test_dw_warps_are_the_kernels():
    """The Python mirror's constants are csrc/linetable.cu's."""
    src = (Path(tline.__file__).resolve().parents[1] / "csrc"
           / "linetable.cu").read_text()
    for name, value in (("kDwWarps", tline.DW_WARPS),
                        ("kDwCols", tline.DW_COLS)):
        assert f"constexpr int {name} = {value};" in src, name


@pytest.mark.parametrize("k", [2, 3, 9, 100, 513, tline.DW_MAX_K])
def test_dw_row_ranges_take_each_contribution_once(k):
    """Every (sample, row) term of stage 1 has exactly one writer: the
    walker warps' rows tile [0, K), and of the warps that walk a sample
    (``dw_walks``) exactly one owns each of its rows i and i + 1. Samples:
    u = 0, u = 1, every knot, and both sides of every range's edges."""
    ranges = tline.dw_row_ranges(k)
    assert len(ranges) == tline.DW_WARPS
    owned = np.concatenate([np.arange(lo, hi) for lo, hi in ranges])
    np.testing.assert_array_equal(owned, np.arange(k))
    edges = np.array([e for lo, hi in ranges if hi > lo for e in (lo, hi)])
    pos = np.concatenate([[0.0, k - 1.0], np.arange(k), edges - 0.5,
                          edges + 0.5, edges - 1e-3, edges + 1e-3])
    u = np.clip(pos / (k - 1), 0.0, 1.0).astype(np.float32)
    u = np.concatenate([u, np.float32([0.0, 1.0])])
    i = tline.hat_rows(torch.from_numpy(u), k)[0].numpy()
    assert i.min() == 0 and i.max() == k - 2
    lo = np.array([r[0] for r in ranges])[:, None]
    hi = np.array([r[1] for r in ranges])[:, None]
    walks = tline.dw_walks(i[None, :], lo, hi)         # (warps, samples)
    for row in (i, i + 1):
        takes = walks & (row[None, :] >= lo) & (row[None, :] < hi)
        np.testing.assert_array_equal(takes.sum(0), 1)
    # a warp walks a sample only for a row of its own
    mine = ((i[None, :] >= lo) & (i[None, :] < hi)) \
        | ((i[None, :] + 1 >= lo) & (i[None, :] + 1 < hi))
    np.testing.assert_array_equal(walks, mine)


@pytest.mark.parametrize("n,r", [(0, 128), (1, 8), (31, 40), (1023, 128),
                                 (1024, 32), (65573, 128), (1 << 19, 128),
                                 (1 << 19, 40), (12345, 200)])
def test_dw_chunking_gives_each_sample_one_chunk(n, r):
    """Stage 1's chunks cover [0, N) once, none empty but the only one at
    N = 0, with about DW_BLOCKS blocks of DW_WARPS walkers."""
    chunk, chunks = tline.dw_chunking(n, r)
    starts = np.arange(chunks) * chunk
    ends = np.minimum(starts + chunk, n)
    assert starts[0] == 0 and ends[-1] == n
    np.testing.assert_array_equal(starts[1:], ends[:-1])
    assert n == 0 or (ends > starts).all()
    tiles = -(-r // tline.DW_COLS)
    assert chunks * tiles <= max(tline.DW_BLOCKS, tiles)
    assert n < 2 * tline.DW_MIN_CHUNK or chunk >= tline.DW_MIN_CHUNK


# ------------------------------- probe_pallas_hatmul.py (kernel 7)
def _hatmul_ref(u3, w, k):                                # :70-80
    kp = w.shape[1]
    prod = None
    ks = jnp.arange(kp, dtype=jnp.float32)[None, :]
    for d in range(3):
        pos = u3[:, d][:, None] * (k - 1)
        basis = jnp.maximum(0.0, 1.0 - jnp.abs(pos - ks))
        a = jnp.dot(basis.astype(jnp.bfloat16), w[d].astype(jnp.bfloat16),
                    preferred_element_type=jnp.float32)
        prod = a if prod is None else prod * a
    return prod


def _run_pallas(u3, w, k, tn):                            # :89-117
    n = u3.shape[0]
    _, kp, r = w.shape

    def kernel(u_ref, w_ref, out_ref):
        u = u_ref[:]
        iota = jax.lax.broadcasted_iota(jnp.int32, (tn, kp), 1
                                        ).astype(jnp.float32)
        prod = None
        for d in range(3):
            pos = u[:, d][:, None] * (k - 1)
            basis = jnp.maximum(0.0, 1.0 - jnp.abs(pos - iota))
            a = jnp.dot(basis.astype(jnp.bfloat16),
                        w_ref[d].astype(jnp.bfloat16),
                        preferred_element_type=jnp.float32)
            prod = a if prod is None else prod * a
        out_ref[:] = prod

    return pl.pallas_call(
        kernel, grid=(n // tn,),
        in_specs=[_vmem((tn, 3), lambda i: (i, 0)),
                  _vmem((3, kp, r), lambda i: (0, 0, 0))],
        out_specs=_vmem((tn, r), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((n, r), jnp.float32),
        interpret=True)(u3, w)


@pytest.mark.parametrize("ref", ["pallas_interpret", "xla_ref"])
def test_hat_prod_matches_probe_hatmul(ref):
    """The probe's shape but N: K 513, KP 640, R 128, tile 256; W as the
    existing hat test draws it (1 + 0.3 N(0, 1)), so that the tolerance
    means what it means there."""
    k, kp, r, tn = probe_hatmul.K, 640, probe_hatmul.R, 256
    n = 2 * tn + 37
    rng = np.random.default_rng(4)
    u3 = rng.random((n, 3), dtype=np.float32)
    u3[:5], u3[5:10] = 1.0, 0.0
    u3[10:20] = np.round(u3[10:20] * (k - 1)) / (k - 1)
    w = (1.0 + 0.3 * rng.normal(size=(3, kp, r))).astype(np.float32)
    w[:, k:] = 0.0
    if ref == "xla_ref":
        want = np.asarray(_hatmul_ref(jnp.asarray(u3), jnp.asarray(w), k))
    else:
        want = np.asarray(_run_pallas(jnp.asarray(_pad(u3, tn)),
                                      jnp.asarray(w), k, tn))[:n]
    got = thatmul.hat_prod(torch.from_numpy(u3),
                           torch.from_numpy(w[:, :k].copy()), k)
    np.testing.assert_allclose(got.numpy(), want, atol=HAT_TOL, rtol=HAT_TOL)


# ---------------------------------------------------- the wrappers
def _lerp_args(rows=16, r=8, n=10):
    return dict(table=torch.zeros((rows, r)),
                idx=torch.zeros(n, dtype=torch.int32), frac=torch.zeros(n))


@pytest.mark.parametrize("case", [
    "r_not_multiple_of_4", "table_float64", "table_1d", "idx_int64",
    "frac_length", "both_modes", "no_mode", "k_in_idx_mode", "k_too_large",
    "k_too_small", "u_2d", "meta_device", "mixed_devices"])
def test_table_lerp_rejects_bad_operands(case):
    a = _lerp_args()
    u = torch.zeros(10)
    bad = {
        "r_not_multiple_of_4": dict(a, table=torch.zeros((16, 6))),
        "table_float64": dict(a, table=torch.zeros((16, 8),
                                                   dtype=torch.float64)),
        "table_1d": dict(a, table=torch.zeros(16)),
        "idx_int64": dict(a, idx=torch.zeros(10, dtype=torch.int64)),
        "frac_length": dict(a, frac=torch.zeros(9)),
        "both_modes": dict(a, u=u),
        "no_mode": dict(table=a["table"]),
        "k_in_idx_mode": dict(a, k=16),
        "k_too_large": dict(table=a["table"], u=u, k=17),
        "k_too_small": dict(table=a["table"], u=u, k=1),
        "u_2d": dict(table=a["table"], u=torch.zeros((10, 1))),
        "meta_device": dict(table=torch.zeros((16, 8), device="meta"),
                            u=torch.zeros(10, device="meta")),
        "mixed_devices": dict(table=a["table"],
                              u=torch.zeros(10, device="meta")),
    }[case]
    with pytest.raises(ValueError):
        tline.table_lerp(**bad)


@pytest.mark.parametrize("case", [
    "g_rows", "g_float64", "g_1d", "u_2d", "u_float64", "k_too_large",
    "k_too_small", "meta_device"])
def test_hat_basis_dw_rejects_bad_operands(case):
    u, g, k = torch.zeros(10), torch.zeros((10, 8)), 16
    bad = {
        "g_rows": (u, torch.zeros((9, 8)), k),
        "g_float64": (u, g.double(), k),
        "g_1d": (u, torch.zeros(10), k),
        "u_2d": (u[:, None], g, k),
        "u_float64": (u.double(), g, k),
        "k_too_large": (u, g, tline.DW_MAX_K + 1),
        "k_too_small": (u, g, 1),
        "meta_device": (u.to("meta"), g.to("meta"), k),
    }[case]
    with pytest.raises(ValueError):
        tline.hat_basis_dw(*bad)


def test_dw_chunking_covers_every_sample():
    for n, r in ((0, 128), (1, 8), (1023, 128), (65573, 128),
                 (1 << 19, 128), (1 << 19, 40)):
        chunk, chunks = tline.dw_chunking(n, r)
        tiles = -(-r // tline.DW_COLS)
        assert chunks * chunk >= n and (chunks - 1) * chunk < max(n, 1)
        assert chunks * tiles <= max(tline.DW_BLOCKS, tiles)


# ------------------------------------------------------ the probes
PROBES = [probe_gather, probe_gather2, probe_hatmul]


@pytest.mark.parametrize("probe", PROBES, ids=lambda m: m.__name__)
def test_probe_runs_only_on_the_card(probe, monkeypatch):
    """run() times the card: it raises for the CPU, and for CUDA without a
    device; main() then exits non-zero."""
    with pytest.raises(ValueError):
        probe.run(device="cpu", n=64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        probe.run(n=64)
    assert probe.main() != 0
