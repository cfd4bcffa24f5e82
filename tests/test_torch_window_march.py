"""The serving window march's stage-A skip and its in-place form, on the CPU.

``march_rays_window_skip_plain`` is csrc/raymarch.cu's window walk as torch
tensors: it tests only the rungs of the strata that the kernel's stage-A
test keeps, in the kernel's arithmetic (the cascade's half-width from its
exponent bits, a product by the exact reciprocal of a power-of-two
divisor), for the rays that ``window_params``' margins admit. Where the
stage-A test is the superset that ``window_params`` proves, it equals the
rung-by-rung ``march_rays_window_plain``, and the JAX ``march_rays_window``
(op by op, ``jax.disable_jit``), bit for bit; these tests hold it to both on
one cascade (the two-level grid: the skip) and five (no skip: every rung,
in the kernel's arithmetic), on empty, full and sparse random bitfields,
degenerate rays, rays with |d| above the grids' ``dir_norm`` (walked rung
by rung), mid-ladder cursors, windows of 16, stratum + 1 and 3 stratum - 1
rungs and s_cap 1 and 64. The five-cascade ladder's exp rounds in the two
libraries' own ways, an ulp apart at times (tests/test_torch_ops.py):
there the JAX floats are held to 1e-6 relative and two ulps of the
ladder's largest t, its integers and masks bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfnerf_tpu.ops import ray_march as jmarch

from mfnerf_tpu_torch.models import ngp as tngp
from mfnerf_tpu_torch.models import rendering as trendering
from mfnerf_tpu_torch.ops import morton as tmorton
from mfnerf_tpu_torch.ops import ray_march as tmarch
from mfnerf_tpu_torch.ops.stepping import t_ladder

MAX_SAMPLES = 1024
GRID = 32
DIR_NORM = 1.2
N_RAYS = 160
INT_FIELDS = ("mask", "n_samples", "cursor", "exhausted", "k_idx")
FLOAT_FIELDS = ("ts", "deltas", "xyzs")
# five cascades against JAX: t reaches ~28 at scale 8, where an ulp is
# 1.9e-6, and the two libraries' exp part there by an ulp at times
JAX_ATOL_5 = 4e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread. The suite runs in several worker processes, and
    torch's default of one thread per core oversubscribes the CPU; the
    per-op thread barriers of these many small ops then stall."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Config:
    """One cascade (scale 0.5, uniform steps: the two-level grid, the
    skip) or five (scale 8, exponential steps: no skip), at grid 32."""

    def __init__(self, cascades):
        self.scale = 0.5 if cascades == 1 else 8.0
        self.e = 0.0 if cascades == 1 else 1.0 / 256
        self.cfg = tngp.NGPConfig(scale=self.scale, grid_size=GRID,
                                  dir_norm=DIR_NORM)
        assert self.cfg.cascades == cascades
        self.rcfg = trendering.RenderConfig(exp_step_factor=self.e,
                                            max_samples=MAX_SAMPLES)
        self.dt_scale = self.rcfg._dt_scale(self.scale, True)
        self.k_total = self.rcfg.n_rungs(self.scale, GRID, test=True)

    def occupancy(self, bits):
        occ = tngp.OccupancyState.create(self.cfg, "cpu")
        occ = dataclasses.replace(occ, density_bitfield=torch.from_numpy(bits))
        return occ.refresh_coarse(self.cfg)

    def skip(self, occ):
        return trendering.window_skip(self.cfg, occ, self.rcfg)

    def stratum(self, skip):
        """The skip's stratum; at five cascades (no skip) the cascade
        march's, a window length that is not a multiple of 16."""
        if skip is not None:
            return skip.stratum
        return tmarch.cascades_stratum(self.e, self.scale, self.cfg.cascades,
                                       dir_norm=DIR_NORM)[0]

    def march_args(self, rays_o, rays_d, bits):
        """(rays_o, rays_d, t_start, t2) torch and the static arguments."""
        hits = trendering._scene_hits(
            tngp.NGP(self.cfg, device="cpu"), rays_o, rays_d)
        return hits, (self.cfg.cascades, self.scale, self.e, GRID,
                      MAX_SAMPLES)


def _bits(cfg, kind, seed):
    """A bitfield: empty, full, or "random": the cells of every cascade
    whose centres lie in one of a few random balls near the box's centre,
    and sparse random cells."""
    c, g = cfg.cfg.cascades, GRID
    if kind == "empty":
        return np.zeros(c * g ** 3 // 8, np.uint8)
    if kind == "full":
        return np.full(c * g ** 3 // 8, 255, np.uint8)
    rng = np.random.default_rng(seed)
    s = cfg.scale
    centres = rng.uniform(-0.6 * s, 0.6 * s, (8, 3))
    radii = rng.uniform(0.05, 0.25, 8) * s
    ijk = np.stack(np.meshgrid(*[np.arange(g)] * 3, indexing="ij"),
                   -1).reshape(-1, 3)
    codes = tmorton.morton3d(torch.from_numpy(ijk.astype(np.int32))).numpy()
    cells = np.zeros(c * g ** 3, bool)
    for m in range(c):
        half = min(2.0 ** (m - 1), cfg.scale)
        x = (ijk + 0.5) / g * 2 * half - half
        dist = np.linalg.norm(x[:, None] - centres[None], axis=-1)
        occ = (dist < radii).any(1) | (rng.random(g ** 3) < 0.001)
        cells[m * g ** 3 + codes] = occ
    return np.packbits(cells, bitorder="little")


def _rays(cfg, seed, n=N_RAYS):
    """Camera-like rays at the box with |d| in [0.8, DIR_NORM], a quarter
    of degenerate rays (missing, from inside the box, along the axes,
    grazing a face), and a sixteenth each with |d| 1.5 and 4 DIR_NORM
    (beyond the grids' bound: walked rung by rung)."""
    rng = np.random.default_rng(seed)
    s = cfg.scale
    q = n // 8
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = -d * 2.5 * s + rng.normal(scale=0.3 * s, size=(n, 3))
    o[:q] = 3.0 * s * d[:q]                            # outward: miss
    o[q:2 * q] = rng.uniform(-s, s, (q, 3))            # inside the box
    axes = np.eye(3)[rng.integers(0, 3, q)] * rng.choice([-1.0, 1.0], (q, 1))
    o[2 * q:3 * q] = -2.0 * s * axes
    d[2 * q:3 * q] = axes                              # along an axis
    face = rng.integers(0, 3, q)
    o[3 * q:4 * q] = rng.uniform(-s, s, (q, 3))
    o[3 * q:4 * q][np.arange(q), face] = s
    d[3 * q:4 * q][np.arange(q), face] = 0.0           # grazing a face
    d[3 * q:4 * q] /= np.linalg.norm(d[3 * q:4 * q], axis=1, keepdims=True)
    d[4 * q:] *= rng.uniform(0.8, DIR_NORM, (n - 4 * q, 1))
    for norm, rows in ((1.5, slice(-q, -q // 2)), (4.0, slice(-q // 2, n))):
        d[rows] *= norm * DIR_NORM / np.linalg.norm(d[rows], axis=1,
                                                    keepdims=True)
    return (torch.from_numpy(o.astype(np.float32)),
            torch.from_numpy(d.astype(np.float32)))


def _window_set(cfg, bits_kind, seed):
    rays_o, rays_d = _rays(cfg, seed)
    bits = _bits(cfg, bits_kind, seed + 1)
    hits, static = cfg.march_args(rays_o, rays_d, bits)
    cursor = torch.from_numpy(np.random.default_rng(seed + 2).integers(
        0, cfg.k_total // 2, N_RAYS))
    cursor[::5] = 0
    occ = cfg.occupancy(bits)
    return (rays_o, rays_d, hits[:, 0].contiguous(), hits[:, 1].contiguous(),
            cursor, occ.density_bitfield, *static), cfg.skip(occ)


def _bit_equal(got, want, fields):
    for name in fields:
        a, b = getattr(got, name), getattr(want, name)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), name


def _jax(args, n_window, s_cap, dt_scale):
    (rays_o, rays_d, t_start, t2, cursor, bits, *static) = args
    with jax.disable_jit():
        return jmarch.march_rays_window(
            jnp.asarray(rays_o.numpy()), jnp.asarray(rays_d.numpy()),
            jnp.asarray(t_start.numpy()), jnp.asarray(t2.numpy()),
            jnp.asarray(cursor.numpy().astype(np.int32)),
            jnp.asarray(bits.numpy()), *static, n_window, s_cap,
            dt_scale=dt_scale)


@pytest.mark.parametrize("s_cap", [1, 64])
@pytest.mark.parametrize("window", ["16", "stratum+1", "3stratum-1"])
@pytest.mark.parametrize("bits_kind", ["empty", "full", "random"])
@pytest.mark.parametrize("cascades", [1, 5])
def test_skip_model_equals_plain_and_jax(cascades, bits_kind, window,
                                         s_cap):
    cfg = Config(cascades)
    args, skip = _window_set(cfg, bits_kind, seed=10 * cascades)
    assert (skip is None) == (cascades > 1)
    st = cfg.stratum(skip)
    n_window = {"16": 16, "stratum+1": st + 1, "3stratum-1": 3 * st - 1}[
        window]
    assert n_window % st or n_window == 16
    want = tmarch.march_rays_window_plain(*args, n_window, s_cap,
                                          cfg.dt_scale)
    got = tmarch.march_rays_window_skip_plain(*args, n_window, s_cap,
                                              cfg.dt_scale, skip=skip)
    _bit_equal(got, want, INT_FIELDS + FLOAT_FIELDS)
    jwant = _jax(args, n_window, s_cap, cfg.dt_scale)
    for name in INT_FIELDS:
        np.testing.assert_array_equal(
            getattr(got, name).numpy(),
            np.asarray(getattr(jwant, name)).astype(
                getattr(got, name).numpy().dtype), err_msg=name)
    for name in FLOAT_FIELDS:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(jwant, name))
        if cascades == 1:
            np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                          err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=JAX_ATOL_5,
                                       err_msg=name)
    if bits_kind == "random":
        assert int(want.n_samples.sum()) > 0


@pytest.mark.parametrize("lanes", [4, 16])
@pytest.mark.parametrize("bits_kind", ["full", "random"])
@pytest.mark.parametrize("cascades", [1, 5])
def test_skip_model_below_a_warp(cascades, bits_kind, lanes, monkeypatch):
    """The model at fewer than 32 lanes a ray (at 4 no head: every rung
    past the cursor in the stage-A strata; at 16 a head of 16 rungs)
    equals the plain version too."""
    cfg = Config(cascades)
    args, skip = _window_set(cfg, bits_kind, seed=10 * cascades + 1)
    n_window = 3 * cfg.stratum(skip) - 1
    monkeypatch.setattr(tmarch, "window_lanes", lambda *_: lanes)
    want = tmarch.march_rays_window_plain(*args, n_window, 4, cfg.dt_scale)
    got = tmarch.march_rays_window_skip_plain(*args, n_window, 4,
                                              cfg.dt_scale, skip=skip)
    _bit_equal(got, want, INT_FIELDS + FLOAT_FIELDS)


@pytest.mark.parametrize("cascades", [1, 5])
def test_skip_covers_the_cases(cascades):
    """The sets exercise the skip: the admitted rays skip strata, the rays
    with |d| above the grids' dir_norm are walked rung by rung, and the
    proof's d_max reaches dir_norm (``d2_max`` is dir_norm's, rounded
    down); at five cascades there is no skip, and the two-level grid's
    proof refuses the configuration."""
    cfg = Config(cascades)
    args, skip = _window_set(cfg, "random", seed=10 * cascades)
    if cascades > 1:
        assert skip is None
        fake = tmarch.WindowSkip(torch.ones((16, 16, 16), dtype=torch.bool),
                                 cfg.stratum(None), DIR_NORM)
        assert tmarch.window_params(cfg.scale, cfg.e, GRID, cascades,
                                    MAX_SAMPLES, cfg.dt_scale, 50, 8,
                                    fake).mode == 0
        return
    n_window = 3 * skip.stratum - 1
    p = tmarch.window_params(cfg.scale, cfg.e, GRID, cfg.cfg.cascades,
                             MAX_SAMPLES, cfg.dt_scale, n_window, 8, skip)
    assert p.mode == 1
    assert DIR_NORM ** 2 * (1 - 2 ** -19) <= p.d2_max < DIR_NORM ** 2
    ladder = (cfg.e, MAX_SAMPLES, GRID, cfg.dt_scale)
    rays_o, rays_d, t_start, t2, cursor = args[:5]
    skips = tmarch._window_skips(p, rays_o, rays_d, t_start, cursor, ladder)
    long_d = rays_d.norm(dim=1) > DIR_NORM * 1.01
    assert bool(long_d.any()) and not bool(skips[long_d].any())
    assert int(skips.sum()) >= N_RAYS // 2
    live = tmarch._window_live(p, skip.stage_a, rays_o, rays_d, t_start, t2,
                               cursor)
    hit = t_start >= 0
    assert 0 < int(live[skips & hit].sum()) < int((skips & hit).sum()) * 3


def _boundary_rays(cfg):
    """Rays whose positions sit on cell boundaries of every cascade (an
    axis held at a multiple of the finest cell, its direction 0 there) and
    rays with subnormal direction components (positions within subnormals
    of 0)."""
    s, n = cfg.scale, 64
    rng = np.random.default_rng(5)
    cell = 2.0 * min(0.5, s) / GRID
    o = np.zeros((n, 3), np.float32)
    d = np.zeros((n, 3), np.float32)
    o[:, 2] = -1.5 * s
    d[:, 2] = 1.0
    o[:32, 0] = cell * rng.integers(-GRID // 2, GRID // 2, 32)
    o[:32, 1] = cell * rng.integers(-GRID // 2, GRID // 2, 32)
    o[32:, :2] = 0.0
    d[32:, 0] = np.float32(1e-40) * rng.integers(1, 100, 32)
    d[32:, 1] = -np.float32(1e-42) * rng.integers(1, 100, 32)
    return torch.from_numpy(o), torch.from_numpy(d)


@pytest.mark.parametrize("cascades", [1, 5])
def test_skip_model_at_boundaries_and_subnormals(cascades):
    """The kernel's arithmetic (reciprocal products, half-widths from the
    exponent bits) at positions on cell boundaries and within subnormals of
    0, against the plain version's divisions, on a full bitfield."""
    cfg = Config(cascades)
    rays_o, rays_d = _boundary_rays(cfg)
    bits = np.full(cfg.cfg.cascades * GRID ** 3 // 8, 0x5A, np.uint8)
    hits, static = cfg.march_args(rays_o, rays_d, bits)
    occ = cfg.occupancy(bits)
    cursor = torch.zeros(rays_o.shape[0], dtype=torch.int64)
    args = (rays_o, rays_d, hits[:, 0].contiguous(), hits[:, 1].contiguous(),
            cursor, occ.density_bitfield, *static)
    for n_window, s_cap in ((64, 64), (cfg.k_total, 64)):
        want = tmarch.march_rays_window_plain(*args, n_window, s_cap,
                                              cfg.dt_scale)
        got = tmarch.march_rays_window_skip_plain(
            *args, n_window, s_cap, cfg.dt_scale, skip=cfg.skip(occ))
        _bit_equal(got, want, INT_FIELDS + FLOAT_FIELDS)
        assert int(want.n_samples.sum()) > 0
    xyz = want.xyzs[32:][want.mask[32:]]
    sub = (xyz[:, :2] != 0) & (xyz[:, :2].abs() < torch.finfo(
        torch.float32).tiny)
    assert bool(sub.any())


def test_exact_shortcuts():
    """torch.exp2 of the cascades' integers is the power of two built from
    its exponent bits, and x / 2^k is x * 2^-k, rounded once, for normal,
    subnormal, boundary, zero and infinite x, where ``_div_exact`` divides
    by anything else."""
    mip = torch.arange(0, 64, dtype=torch.int32)
    assert torch.equal(torch.exp2(mip.to(torch.float32) - 1.0),
                       ((mip + 126) << 23).view(torch.float32))
    rng = np.random.default_rng(3)
    x = np.concatenate([
        rng.normal(size=4096) * 10.0 ** rng.integers(-40, 30, 4096),
        np.float32(1e-45) * rng.integers(-2 ** 23, 2 ** 23, 4096),
        np.arange(-64, 65) / 64.0, [0.0, -0.0, np.inf, -np.inf]])
    x = torch.from_numpy(x.astype(np.float32))
    for div in (2.0 ** np.arange(-20, 30)).tolist() + [0.4, 1.5, 3.0]:
        d = torch.tensor(div, dtype=torch.float32)
        got = tmarch._div_exact(x, d)
        want = x / d
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), div


def test_window_lanes_pack_short_windows():
    """Short windows of many rays take few lanes a ray; long windows, or few
    rays, more, up to a warp."""
    p = tmarch.march_params(0.5, 0.0, 128, 1, 1024, 1, 70, 1)
    sk = tmarch.window_params(
        0.5, 0.0, 128, 1, 1024, 1, 70, 1,
        tmarch.WindowSkip(torch.zeros((64, 64, 64), dtype=torch.bool), 27,
                          1.2))
    assert sk.mode == 1 and sk.n_strata == 3
    assert tmarch.window_lanes(475_986, 70, sk) == 4
    assert tmarch.window_lanes(475_986, 70, p) == 8
    assert tmarch.window_lanes(270_071, 124, sk) == 8
    assert tmarch.window_lanes(70_419, 476, sk) == 16
    assert tmarch.window_lanes(60_000, 476, p) == 32
    assert tmarch.window_lanes(999, 1318, p) == 32
    assert tmarch.window_lanes(1000, 70, sk) == 32
    assert tmarch.window_lanes(40_000, 70, sk) == 8


def test_window_skip_needs_fresh_grids():
    cfg = Config(1)
    occ = cfg.occupancy(_bits(cfg, "random", 1))
    assert cfg.skip(occ).stratum == tmarch.twolevel_stratum(
        0.0, MAX_SAMPLES, 0.5, GRID, 1, DIR_NORM)
    occ.density_bitfield = occ.density_bitfield.clone()
    with pytest.raises(ValueError, match="stale"):
        cfg.skip(occ)
    plain = trendering.window_skip(
        cfg.cfg, cfg.occupancy(_bits(cfg, "random", 1)),
        dataclasses.replace(cfg.rcfg, exp_step_factor=1 / 256))
    assert plain is None


@pytest.mark.parametrize("change", ["cascades", "exp_step", "scale",
                                    "grid", "stage_a"])
def test_window_params_refuse_what_the_proof_does_not_cover(change):
    """The stage-A skip only where window_params' proof holds (one cascade,
    uniform steps, scale <= 0.5, power-of-two grids, a stage-A grid no
    finer than the fine one): elsewhere mode 0, every rung walked."""
    stage_a = torch.ones((16, 16, 16), dtype=torch.bool)
    kw = dict(scale=0.5, exp_step_factor=0.0, grid_size=GRID, cascades=1)
    assert tmarch.window_params(
        **kw, max_samples=MAX_SAMPLES, dt_scale=1.0, n_window=50, s_cap=8,
        skip=tmarch.WindowSkip(stage_a, 9, DIR_NORM)).mode == 1
    if change == "cascades":
        kw.update(cascades=2, scale=1.0)
    elif change == "exp_step":
        kw.update(exp_step_factor=1 / 256)
    elif change == "scale":
        kw.update(scale=0.75)
    elif change == "grid":
        kw.update(grid_size=48)
    else:
        stage_a = torch.ones((64, 64, 64), dtype=torch.bool)
    p = tmarch.window_params(
        **kw, max_samples=MAX_SAMPLES, dt_scale=1.0, n_window=50, s_cap=8,
        skip=tmarch.WindowSkip(stage_a, 9, DIR_NORM))
    assert p.mode == 0 and p.d2_max == 0.0


@pytest.mark.parametrize("cascades", [1, 5])
def test_serving_skip_leaves_dense_grids(cascades):
    """The serving loop skips with a sparse stage-A grid and walks every
    rung with a dense one (more than SKIP_MAX_SHARE of its cells set); the
    share is read once a derivation of the grid. At five cascades there
    is no skip."""
    cfg = Config(cascades)
    one = _bits(cfg, "empty", 0)
    one[GRID ** 3 // 16] = 1               # one cell of cascade 0
    for bits, dense in ((_bits(cfg, "empty", 0), False), (one, False),
                        (_bits(cfg, "full", 0), True)):
        occ = cfg.occupancy(bits)
        assert occ.stage_a_share is None
        got = trendering.serving_skip(cfg.cfg, occ, cfg.rcfg)
        if cascades > 1:
            assert got is None and occ.stage_a_share is None
            continue
        share = float(occ.stage_a.float().mean())
        assert occ.stage_a_share == share
        assert (share > tmarch.SKIP_MAX_SHARE) == dense, share
        assert (got is None) == dense
        occ.stage_a_share = 1.0 - share     # read, not derived, again
        again = trendering.serving_skip(cfg.cfg, occ, cfg.rcfg)
        assert (again is None) == (not dense)
        assert occ.to("cpu").stage_a_share == 1.0 - share
        assert occ.refresh_coarse(cfg.cfg).stage_a_share is None


@pytest.mark.parametrize("cascades", [1, 5])
def test_march_window_into_equals_gather_march_scatter(cascades):
    cfg = Config(cascades)
    args, skip = _window_set(cfg, "random", seed=3)
    rays_o, rays_d, t_start, t2, cursor, bits, *static = args
    alive = torch.nonzero(t_start >= 0).squeeze(1)[::2]
    assert alive.numel() > 20
    frame_cursor = cursor.clone()
    got = tmarch.march_rays_window_into(
        rays_o, rays_d, t_start, t2, frame_cursor, alive, bits, *static, 40,
        4, cfg.dt_scale, skip=skip)
    want = tmarch.march_rays_window_plain(
        rays_o[alive], rays_d[alive], t_start[alive], t2[alive],
        cursor[alive], bits, *static, 40, 4, cfg.dt_scale)
    _bit_equal(got, want, INT_FIELDS + FLOAT_FIELDS)
    expect = cursor.clone()
    expect[alive] = want.cursor
    assert torch.equal(frame_cursor, expect)
    assert bool((frame_cursor != cursor).any())


@pytest.mark.parametrize("cascades", [1, 5])
def test_windows_walk_the_ladder_once(cascades):
    """The whole ladder walked window by window (a window not a multiple of
    the stratum, as tests/test_twolevel_march.py's regression walks it)
    through the skip model emits each occupied rung once, the sequence the
    plain version emits."""
    cfg = Config(cascades)
    args, skip = _window_set(cfg, "random", seed=7)
    rays_o, rays_d, t_start, t2, cursor, bits, *static = args
    n_window = 2 * cfg.stratum(skip) - 1

    def walk(fn, **kw):
        cur = torch.zeros_like(cursor)
        done = t_start < 0
        out = [[] for _ in range(cur.shape[0])]
        for _ in range(-(-cfg.k_total // n_window) + 1):
            mr = fn(*args[:4], cur, bits, *static, n_window, 3, cfg.dt_scale,
                    **kw)
            for i in torch.nonzero(~done).squeeze(1).tolist():
                out[i] += mr.k_idx[i][mr.mask[i]].tolist()
            done = done | mr.exhausted | (mr.cursor >= cfg.k_total)
            cur = mr.cursor
        return out

    got = walk(tmarch.march_rays_window_skip_plain, skip=skip)
    assert got == walk(tmarch.march_rays_window_plain)
    assert all(len(set(k)) == len(k) for k in got)
    assert sum(map(len, got)) > 0


@pytest.mark.parametrize("cascades", [1, 5])
def test_render_rounds_through_the_skip_model(cascades, monkeypatch):
    """render_test on the CPU against render_test_dense within
    tests/test_torch_render.py's tolerances, with every round's window held
    to the skip model (the rounds' own operands and the frame's grids)."""
    cfg = Config(cascades)
    model = tngp.NGP(dataclasses.replace(cfg.cfg, lr_levels=2, lr_rank=8,
                                         lr_k_max=64, rgb_channels=16,
                                         rgb_layers=1),
                     torch.Generator().manual_seed(0), device="cpu")
    occ = cfg.occupancy(_bits(cfg, "random", 4))
    skip = cfg.skip(occ)
    rays_o, rays_d = _rays(cfg, 9, n=256)
    rays_d = rays_d / rays_d.norm(dim=1, keepdim=True)
    inner = trendering.march_rays_window_into
    rounds = []

    def checked(rays_o, rays_d, t_start, t2, cursor, alive, *rest, **kw):
        gathered = (rays_o[alive], rays_d[alive], t_start[alive], t2[alive],
                    cursor[alive].clone())
        mr = inner(rays_o, rays_d, t_start, t2, cursor, alive, *rest, **kw)
        model_mr = tmarch.march_rays_window_skip_plain(*gathered, *rest,
                                                       skip=skip)
        _bit_equal(model_mr, mr, INT_FIELDS + FLOAT_FIELDS)
        rounds.append(int(mr.n_samples.sum()))
        return mr

    monkeypatch.setattr(trendering, "march_rays_window_into", checked)
    rcfg = dataclasses.replace(cfg.rcfg, T_threshold=1e-2, test_chunk=256)
    alive = trendering.render_test(model, occ, rays_o, rays_d, rcfg)
    dense = trendering.render_test_dense(model, occ, rays_o, rays_d, rcfg)
    np.testing.assert_allclose(alive["rgb"].numpy(), dense["rgb"].numpy(),
                               atol=2e-4)
    np.testing.assert_allclose(alive["opacity"].numpy(),
                               dense["opacity"].numpy(), atol=2e-4)
    np.testing.assert_allclose(alive["depth"].numpy(),
                               dense["depth"].numpy(), atol=2e-3)
    assert len(rounds) > 1 and sum(rounds) > 0


def test_ladder_end_bounds_every_position():
    """The kernel bounds a ray's positions by the t of its window's last
    stratum's end: every rung and probe of the window lies at or below it."""
    cfg = Config(1)
    args, skip = _window_set(cfg, "random", seed=2)
    t_start, cursor = args[2], args[4]
    ladder = (cfg.e, MAX_SAMPLES, GRID, cfg.dt_scale)
    n_strata = -(-50 // skip.stratum)
    end = t_ladder(t_start, (cursor + n_strata * skip.stratum)[:, None],
                   *ladder)
    ks = cursor[:, None] + torch.arange(n_strata * skip.stratum + 1)
    assert bool((t_ladder(t_start, ks, *ladder) <= end).all())
