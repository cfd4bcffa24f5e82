"""The yardstick's arithmetic against hand-worked values: the rate, the
95th percentile over all frames, the field's and the kernels' operation
and byte counts, the trace's busy union and idle gaps, and the metric
readers on made-up records."""
import pathlib

import pytest

from portbench import counts, spec
from portbench.trace import Trace

REPO = pathlib.Path(__file__).resolve().parents[2]

LOWRANK = dict(grid="LowRank", L=16, F=2, lr_levels=8, lr_rank=16,
               lr_frames=2, rgb_channels=64, rgb_layers=2)
MIXED = dict(grid="MixedFeature", L=16, F=2, rgb_channels=128, rgb_layers=2)


def test_field_flops_by_hand():
    # LowRank: 2 frames x (11 x 128 + 2 x 128 x 32) = 2816 + 16384; sigma
    # 2 (32 x 64 + 64 x 16) = 6144; rgb 2 (32 x 64 + 64 x 64 + 64 x 3)
    assert counts.field_flops(LOWRANK) == 2816 + 16384 + 6144 + 12672
    # MixedFeature: 16 levels x (6 + 8 x 6); rgb 2 (32x128 + 128x128 + 384)
    assert counts.field_flops(MIXED) == 864 + 6144 + 41728


def test_kernel_counts_by_hand():
    n, k, r = 1000, 257, 128
    assert counts.hat_bwd(n, k, r) == (
        12 * n + 4 * n * r + 6 * k * r + 12 * k * r, 27 * n * r)
    assert counts.hash_bwd(n, 16, 2, 1 << 20) == (
        12 * n + 128 * n + 8 * (1 << 20), n * 16 * 70)


def test_least_time_takes_the_slower_bound():
    s, by = counts.least_s(3.35e12, 1.0)
    assert s == pytest.approx(1.0) and by == "bytes"
    s, by = counts.least_s(1.0, 67e12 * 2)
    assert s == pytest.approx(2.0) and by == "operations"


@pytest.mark.parametrize("values, q, want", [
    (list(range(1, 101)), 95, 95), (list(range(100, 0, -1)), 95, 95),
    ([5.0], 95, 5.0), (list(range(1, 21)), 95, 19), ([3, 1, 2], 50, 2)])
def test_nearest_rank_percentile(values, q, want):
    assert counts.percentile(values, q) == want


def test_trace_busy_union_and_gaps():
    tr = Trace([("k1", 0, 10), ("k2", 5, 20), ("k3", 30, 40),
                ("k4", 60, 70)],
               [("outer", 0, 100), ("cudaGraphLaunch", 22, 28),
                ("aten::item", 41, 59)], window_s=100e-6)
    assert tr.busy_intervals() == [[0, 20], [30, 40], [60, 70]]
    assert tr.busy_s() == pytest.approx(40e-6)
    assert tr.kernel_s(("k1", "k3")) == (pytest.approx(20e-6), 2)
    assert dict(tr.device_ops())["k2"] == pytest.approx(15e-6)
    gaps = dict(tr.idle_gaps())
    assert gaps == {"cudaGraphLaunch": pytest.approx(10e-6),
                    "aten::item": pytest.approx(20e-6)}


def _metric(name):
    return spec.Layout(REPO).metric(name).read


def test_rate_and_tail_readers():
    train = {"kind": "train", "batch": 8192, "steps": 300, "window_s": 1.5,
             "trace": None}
    assert _metric("train_rays_per_s")(train) == 8192 * 300 / 1.5
    assert _metric("frames_per_s")(train) is None
    frames = [(0.001 * (i + 1), 10, 100) for i in range(40)]
    serve = {"kind": "serve", "frames": frames, "window_s": 2.0,
             "trace": None}
    assert _metric("frames_per_s")(serve) == 20.0
    assert _metric("frame_ms_p95")(serve) == pytest.approx(38.0)
    assert _metric("rounds_per_frame")(serve) == 10
    assert _metric("mfu.serve")(serve) is None       # untraced


def test_utilisation_readers():
    tr = Trace([("hat_prod_bwd_slab_kernel<bf16>", 0, 500),
                ("hat_prod_bwd_reduce_kernel", 500, 600),
                ("sgemm", 600, 900)], [], window_s=1e-3)
    rec = {"kind": "train", "hp": LOWRANK | {"lr_k_max": 256},
           "valid": [1000, 3000], "trace": tr}
    assert _metric("idle_share.train")(rec) == pytest.approx(10.0)
    flops = 3 * counts.field_flops(LOWRANK) * 4000
    assert _metric("mfu.train")(rec) == pytest.approx(
        100 * flops / (1e-3 * counts.FP32_FLOPS))
    least = 2 * sum(counts.least_s(*counts.hat_bwd(n, 257, 128))[0]
                    for n in (1000, 3000))
    assert _metric("hat_bwd_roofline")(rec) == pytest.approx(
        100 * least / 600e-6)
    assert _metric("hash_bwd_roofline")(rec) is None


def test_readers_find_nothing_without_a_trace_of_the_card():
    rec = {"kind": "train", "hp": LOWRANK | {"lr_k_max": 256},
           "valid": [1000], "trace": Trace([], [], window_s=1.0)}
    for name in ("idle_share.train", "mfu.train", "hat_bwd_roofline"):
        assert _metric(name)(rec) is None
