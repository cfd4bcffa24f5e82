"""frame_ms_p95: the nearest-rank 95th percentile of the latencies of all
the window's frames, each from the ``render_test`` call to the
synchronised frame, in milliseconds."""
from portbench.counts import percentile


def read(rec):
    if rec["kind"] != "serve":
        return None
    return 1e3 * percentile([f[0] for f in rec["frames"]], 95)
