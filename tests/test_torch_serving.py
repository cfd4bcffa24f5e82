"""The serving rounds on capacity buffers (``render_test``), on the CPU.

* The tiered frame — the floors of the alive and the field tiers lowered so
  that one frame crosses at least three alive tiers and two field tiers —
  against the JAX ``render_test_dense`` (op by op, as
  tests/test_torch_render.py runs it) and the JAX ``render_test``, with
  tests/test_torch_render.py's tolerances: rgb and opacity atol 2e-4, depth
  2e-3; at an exposure; with rays capped at ``max_samples``; on a frame of
  301 rays (no multiple of any tier); with every ray dead after round one
  (an empty bitfield: every round's valid count 0) and with no ray alive.
  Two host reads a round and one a frame.
* The plain window march and compositing round with an alive count: the
  rows before it bit for bit the same call on those rows alone, the rows
  past it an empty ray at cursor 0 (the march) and not alive (the round),
  the frame's cursor and accumulators of those rows untouched.
* ``render_test_sharded`` on a group of one rank bit for bit
  ``render_test``.
* :class:`ServingRunner`'s control flow with stand-in graphs (a replay
  runs the captured function again): each step's shape captured once,
  after its eager warm-up, replayed after; the frames of the last two
  sizes kept; every graph dropped when a parameter is replaced; the frame
  bit for bit the eager rounds'.
"""
import contextlib
import dataclasses
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from mfnerf_tpu.models import ngp as jngp
from mfnerf_tpu.models import rendering as jrendering

from mfnerf_tpu_torch.models import ngp as tngp
from mfnerf_tpu_torch.models import rendering as trendering
from mfnerf_tpu_torch.ops import composite as tcomposite
from mfnerf_tpu_torch.ops import ray_march as tmarch
from mfnerf_tpu_torch.utils.ckpt import params_from_numpy

SMALL = dict(lr_levels=2, lr_rank=8, lr_k_max=64, grid_size=32,
             rgb_channels=16, rgb_layers=1)
TOL = dict(rgb=2e-4, opacity=2e-4, depth=2e-3)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread (tests/test_torch_render.py's reason)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiers(monkeypatch):
    """The tiers' floors lowered to a frame of a few hundred rays; yields
    the list of each round's [alive tier, field tier, valid samples]."""
    monkeypatch.setattr(trendering, "ALIVE_FLOOR", 16)
    monkeypatch.setattr(trendering, "FIELD_FLOOR", 64)
    seen = []
    march, field = trendering._Rounds.march, trendering._Rounds.field

    def record_march(self, c):
        seen.append([c, None, None])
        return march(self, c)

    def record_field(self, slots):
        seen[-1][1:] = slots, int(self.f.valid)
        return field(self, slots)

    monkeypatch.setattr(trendering._Rounds, "march", record_march)
    monkeypatch.setattr(trendering._Rounds, "field", record_field)
    return seen


def _setup(fill=0x33, n=256, miss_every=0, seed=0, scale=0.5, **kw):
    """The JAX and the port's small LowRank field on one seeded bitfield
    (``fill`` masks random bytes; None: every cell set), and n rays."""
    jcfg = jngp.NGPConfig(grid="LowRank", scale=scale, **SMALL, **kw)
    jmodel = jngp.NGP(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed))
    tmodel = tngp.NGP(tngp.NGPConfig(scale=scale, **SMALL, **kw),
                      device="cpu")
    tmodel.load_state_dict(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.default_rng(seed)
    n_bytes = jcfg.cascades * jcfg.n_cells // 8
    bits = (np.full(n_bytes, 255, np.uint8) if fill is None else
            rng.integers(0, 256, n_bytes, dtype=np.uint8) & np.uint8(fill))
    occ_j = dataclasses.replace(jngp.OccupancyState.create(jcfg),
                                density_bitfield=jnp.asarray(bits)
                                ).refresh_coarse(jcfg)
    occ_t = tngp.OccupancyState.create(tmodel.cfg, "cpu")
    occ_t.density_bitfield = torch.from_numpy(bits)
    rays_o = np.tile(np.float32([[0.0, 0.0, -2.8 * scale]]), (n, 1))
    d = rng.normal(size=(n, 3)).astype(np.float32) \
        * np.float32([0.3, 0.3, 0.0]) + np.float32([0.0, 0.0, 1.0])
    rays_d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    if miss_every:
        rays_d[::miss_every] = np.float32([0.0, 0.0, -1.0])
    return (jmodel, params, occ_j), (tmodel, occ_t), rays_o, rays_d


def _jax_frames(setup, rcfg_kw, exposure=None, alive=False):
    """The JAX render_test_dense frame and, with ``alive``, the JAX
    render_test's, op by op (under jit XLA's fused multiply-adds move a
    sample position by an ulp, which now and then crosses a cell:
    tests/test_torch_render.py)."""
    (jmodel, params, occ_j), _, rays_o, rays_d = setup
    jrcfg = jrendering.RenderConfig(**rcfg_kw)
    ro, rd = jnp.asarray(rays_o), jnp.asarray(rays_d)
    exp = None if exposure is None else jnp.full((1, 1), exposure,
                                                 jnp.float32)
    with jax.disable_jit():
        frames = [jrendering.render_test_dense(jmodel, params, occ_j, ro, rd,
                                               jrcfg, exposure=exp)]
        if alive:
            frames.append(jrendering.render_test(
                jmodel, params, occ_j, ro, rd, jrcfg, exposure=exposure))
    return [{k: np.asarray(f[k]) for k in TOL} for f in frames]


def _serve(setup, rcfg_kw, exposure=None):
    """The port's render_test frame and its host reads."""
    _, (tmodel, occ_t), rays_o, rays_d = setup
    before = trendering.render_test.host_reads
    out = trendering.render_test(tmodel, occ_t, torch.from_numpy(rays_o),
                                 torch.from_numpy(rays_d),
                                 trendering.RenderConfig(**rcfg_kw),
                                 exposure=exposure)
    return out, trendering.render_test.host_reads - before


def _assert_frame(got, want):
    for key, atol in TOL.items():
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=atol,
                                   err_msg=key)


@pytest.mark.parametrize("T_threshold, jax_alive", [(1e-4, False),
                                                    (1e-2, True)])
def test_tiered_frame_matches_jax(T_threshold, jax_alive, tiers):
    """A frame across at least three alive tiers and two field tiers
    against the JAX dense frame and (at T 1e-2) the JAX alive-ray frame;
    each round's field tier the smallest that holds its valid samples (at
    most twice them, or the floor); at most two host reads a round and
    one a frame."""
    setup = _setup()
    rcfg_kw = dict(T_threshold=T_threshold, test_chunk=256)
    out, reads = _serve(setup, rcfg_kw)
    for want in _jax_frames(setup, rcfg_kw, alive=jax_alive):
        _assert_frame(out, want)
    assert len({c for c, _, _ in tiers}) >= 3
    assert len({f for _, f, _ in tiers}) >= 2
    floor = trendering._tiers(256, trendering.FIELD_FLOOR)[-1]
    assert all(v <= f <= max(2 * v, floor) for _, f, v in tiers)
    assert len(tiers) == out["rounds"] > 1
    assert reads <= 2 * out["rounds"] + 1
    assert out["total_samples"] > 0


def test_tiered_frame_at_an_exposure(tiers):
    """An HDR head at a view's exposure, across the tiers, against the
    JAX dense frame (tests/test_torch_render.py holds the exposures at
    one tier)."""
    setup = _setup(seed=3, rgb_act="None")
    rcfg_kw = dict(T_threshold=1e-2, test_chunk=256)
    out, _ = _serve(setup, rcfg_kw, 2.0)
    _assert_frame(out, _jax_frames(setup, rcfg_kw, 2.0)[0])
    assert len({c for c, _, _ in tiers}) >= 3


def test_rays_capped_at_max_samples(tiers, monkeypatch):
    """Three cascades (a ray crosses more rungs than max_samples), every
    cell occupied, no ray stopped by its transmittance: rays composite up
    to max_samples samples and no more, as the JAX dense frame does."""
    taken = []
    composite = trendering._Rounds.composite

    def record(self, c):
        k = int(self.f.count)
        rows = self.f.taken[:c] + self.block(c).mask.sum(1)
        taken.append(int(rows[:k].max()))
        return composite(self, c)

    monkeypatch.setattr(trendering._Rounds, "composite", record)
    setup = _setup(fill=None, seed=4, scale=2.0)
    rcfg_kw = dict(T_threshold=1e-30, max_samples=24, test_chunk=256)
    out, _ = _serve(setup, rcfg_kw)
    _assert_frame(out, _jax_frames(setup, rcfg_kw)[0])
    assert max(taken) == 24


def test_ragged_frame(tiers):
    """301 rays (no multiple of any tier), every third missing the box."""
    setup = _setup(n=301, miss_every=3, seed=5)
    rcfg_kw = dict(T_threshold=1e-2, test_chunk=256)
    out, _ = _serve(setup, rcfg_kw)
    _assert_frame(out, _jax_frames(setup, rcfg_kw)[0])
    assert trendering._tiers(301, 16) == [301, 151, 76, 38, 19, 10]
    assert len({c for c, _, _ in tiers}) >= 3


def test_every_ray_dead_after_round_one(tiers):
    """An empty bitfield: round one marches each ray's whole ladder (its
    window), finds no sample (the valid count 0) and every ray is
    exhausted; a frame whose rays all miss the box runs no round."""
    setup = _setup(fill=0, seed=6)
    out, reads = _serve(setup, dict(T_threshold=1e-2))
    assert out["rounds"] == 1 and out["total_samples"] == 0 and reads == 3
    assert float(out["opacity"].abs().max()) == 0.0
    assert torch.equal(out["rgb"], torch.ones_like(out["rgb"]))
    setup = _setup(seed=6, miss_every=1)
    out, reads = _serve(setup, dict(T_threshold=1e-2))
    assert out["rounds"] == 0 and out["total_samples"] == 0 and reads == 1


def _window_set(n=96, seed=7):
    """A frame of n rays of the small field and its window march's static
    arguments (n_window 40, s_cap 4)."""
    _, (tmodel, occ_t), rays_o, rays_d = _setup(n=n, seed=seed)
    ro, rd = torch.from_numpy(rays_o), torch.from_numpy(rays_d)
    hits = trendering._scene_hits(tmodel, ro, rd)
    cfg = tmodel.cfg
    gen = torch.Generator().manual_seed(seed)
    cursor = torch.randint(0, 60, (n,), generator=gen)
    static = (occ_t.density_bitfield, cfg.cascades, cfg.scale, 0.0,
              cfg.grid_size, 1024, 40, 4, 2.0)
    return (ro, rd, hits[:, 0].contiguous(), hits[:, 1].contiguous(),
            cursor), static, gen


@pytest.mark.parametrize("cut", [0, 72, 96])
def test_plain_march_with_a_count(cut):
    """march_rays_window_plain and march_rays_window_into with an alive
    count: the rows before it bit for bit the same call on those rows,
    the rows past it an empty ray at cursor 0, the frame's cursor moved
    at the rows before it only."""
    frame, static, gen = _window_set()
    ro, rd, t0, t2, cursor = frame
    n_window = static[6]
    count = torch.tensor([cut])
    rows = torch.randperm(96, generator=gen)
    got = tmarch.march_rays_window_plain(ro[rows], rd[rows], t0[rows],
                                         t2[rows], cursor[rows], *static,
                                         count=count)
    want = tmarch.march_rays_window_plain(
        ro[rows[:cut]], rd[rows[:cut]], t0[rows[:cut]], t2[rows[:cut]],
        cursor[rows[:cut]], *static)
    # the rows past the count hold anything, the sentinel here
    alive = torch.where(torch.arange(96) < cut, rows, 96)
    frame_ext = [torch.cat([x, x[:1]]) for x in frame]
    into_cursor = frame_ext[4].clone()
    into = tmarch.march_rays_window_into(*frame_ext[:4], into_cursor, alive,
                                         *static, count=count)
    for mr in (got, into):
        for name in tmarch.WindowMarchResults._fields:
            a, b = getattr(mr, name), getattr(want, name)
            assert torch.equal(a[:cut], b), name
        past = slice(cut, None)
        assert not bool(mr.mask[past].any())
        assert bool((mr.n_samples[past] == 0).all())
        assert bool(mr.exhausted[past].all())
        assert bool((mr.cursor[past] == n_window).all())
        assert bool((mr.k_idx[past] == n_window - 1).all())
        for name in ("xyzs", "deltas", "ts"):
            assert not bool(getattr(mr, name)[past].any()), name
    moved = frame_ext[4].clone()
    moved[rows[:cut]] = want.cursor
    assert torch.equal(into_cursor, moved)


def _round_block(n=80, s=6, seed=8):
    gen = torch.Generator().manual_seed(seed)
    sigmas = torch.rand((n, s), generator=gen) * 8
    rgbs = torch.rand((n, s, 3), generator=gen)
    deltas = torch.rand((n, s), generator=gen) * 0.1
    ts = torch.cumsum(deltas, 1)
    mask = torch.rand((n, s), generator=gen) < 0.7
    return (sigmas, rgbs, deltas, ts, mask), gen


@pytest.mark.parametrize("cut", [0, 60, 80])
def test_plain_round_with_a_count(cut):
    """composite_test_step_into and composite_test_step_plain with an
    alive count: the rows before it bit for bit the same call on those
    rows, the rows past it not alive, their accumulators untouched."""
    block, gen = _round_block()
    n = 80
    m = 100
    index = torch.randperm(m, generator=gen)[:n]
    acc = (torch.rand((m,), generator=gen) * 0.5,
           torch.rand((m,), generator=gen),
           torch.rand((m, 3), generator=gen) * 0.5)
    count = torch.tensor([cut])
    got_acc = tuple(a.clone() for a in acc)
    # the rows past the count hold anything: here entries of earlier rows
    idx = torch.where(torch.arange(n) < cut, index, index[0])
    alive = tcomposite.composite_test_step_into(*block, idx, *got_acc, 1e-2,
                                                count=count)
    want_acc = tuple(a.clone() for a in acc)
    want = tcomposite.composite_test_step_into(
        *(x[:cut] for x in block), index[:cut], *want_acc, 1e-2)
    assert torch.equal(alive[:cut], want) and not bool(alive[cut:].any())
    for a, b in zip(got_acc, want_acc):
        assert torch.equal(a, b)
    plain = tcomposite.composite_test_step_plain(
        *block, acc[0][index], acc[1][index], acc[2][index],
        torch.ones(n, dtype=torch.bool), 1e-2, count=count)
    ref = tcomposite.composite_test_step_plain(
        *(x[:cut] for x in block), acc[0][index[:cut]],
        acc[1][index[:cut]], acc[2][index[:cut]],
        torch.ones(cut, dtype=torch.bool), 1e-2)
    for a, b, before in zip(plain, ref, (*(x[index] for x in acc), None)):
        assert torch.equal(a[:cut], b)
        if before is not None:
            assert torch.equal(a[cut:], before[cut:])
    assert not bool(plain[3][cut:].any())


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_sharded_on_one_rank_is_render_test(tiers):
    """render_test_sharded on a gloo group of one rank: render_test's
    frame bit for bit."""
    _, (tmodel, occ_t), rays_o, rays_d = _setup(seed=9)
    ro, rd = torch.from_numpy(rays_o), torch.from_numpy(rays_d)
    rcfg = trendering.RenderConfig(T_threshold=1e-2)
    want = trendering.render_test(tmodel, occ_t, ro, rd, rcfg)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        got = trendering.render_test_sharded(tmodel, occ_t, ro, rd, rcfg)
    finally:
        dist.destroy_process_group()
    for key in ("rgb", "opacity", "depth", "total_samples", "rounds"):
        assert torch.equal(torch.as_tensor(got[key]),
                           torch.as_tensor(want[key])), key


class _Graph:
    """A stand-in for a captured CUDA graph on the CPU: its replay runs the
    captured function again."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()

    def reset(self):
        self.fn = None


@contextlib.contextmanager
def _stand_in_graphs(monkeypatch):
    """ServingRunner on the CPU: its stream a no-op, each capture a
    :class:`_Graph` that runs nothing until replayed; yields the list of
    captured keys' functions in order."""
    captured = []
    stream = object()
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: stream)
    monkeypatch.setattr(trendering, "side_stream_run",
                        lambda s, fn, device: fn())
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)

    def capture(fn, s, generator=None):
        captured.append(fn)
        return _Graph(fn), None, {}

    monkeypatch.setattr(trendering, "capture_graph", capture)
    monkeypatch.setattr(trendering, "replay_graph",
                        lambda graph, launches: graph.replay())
    yield captured


def test_serving_runner_control_flow(tiers, monkeypatch):
    """Stand-in graphs: the first frame captures each step's shape once
    (after running it eagerly), the second replays them all and captures
    nothing; both bit for bit the eager rounds. A replaced parameter drops
    every graph; a third frame size drops the oldest of the two kept."""
    _, (tmodel, occ_t), rays_o, rays_d = _setup(n=256, seed=10)
    rcfg = trendering.RenderConfig(T_threshold=1e-2)
    ro, rd = torch.from_numpy(rays_o), torch.from_numpy(rays_d)
    eager = trendering.render_test(tmodel, occ_t, ro, rd, rcfg)

    with _stand_in_graphs(monkeypatch) as captured:
        runner = trendering.ServingRunner("cpu")

        @torch.no_grad()
        def serve(ro=ro, rd=rd):
            out = trendering._render_rounds(tmodel, occ_t, ro, rd, rcfg,
                                            None, runner)
            return [x.clone() if torch.is_tensor(x) else x for x in out]

        first = serve()
        keys = set(runner.frames[256].graphs)
        assert len(captured) == len(keys) >= 6
        second = serve()
        assert len(captured) == len(keys)
        for got in (first, second):
            for a, b in zip(got[:3], ("rgb", "opacity", "depth")):
                want = eager[b] if b != "rgb" else eager["rgb"]
                if b == "rgb":
                    a = trendering._with_background(rcfg, a, got[1])
                assert torch.equal(a, want), b
            assert got[3:] == [eager["total_samples"], eager["rounds"]]
        serve(ro[:200], rd[:200])
        serve(ro[:100], rd[:100])
        assert list(runner.frames) == [200, 100]
        with torch.no_grad():
            tmodel.sigma_mlp[0] = torch.nn.Parameter(
                tmodel.sigma_mlp[0].clone())
        n_before = len(captured)
        third = serve()
        assert list(runner.frames) == [256]
        assert len(captured) - n_before == len(runner.frames[256].graphs)
        assert torch.equal(third[0], first[0])
