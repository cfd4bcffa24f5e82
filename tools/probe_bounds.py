"""The least time an H100 could take for each benchmark probe's Pallas
kernel (``benchmarking/probe_pallas_*.py``), from the probes' own shapes.

    python3 tools/probe_bounds.py

Bytes: each input read once and each output written once, at 3.35 TB/s.
Operations: the bf16 matrix products the kernel does (the dense hat basis
of KP columns) at 989 TFLOP/s; the lerp kernels' few fp32 operations are
far below their bytes. The bound is the larger of the two. Runs anywhere
(no device); prints one JSON line a kernel.
"""
import json

HBM_BPS, BF16_FLOPS = 3.35e12, 989e12


def main():
    # probe_pallas_gather.py: RANK, K, N = 8, 128, 2^20; int32 idx, fp32 frac
    rank, k, n = 8, 128, 1 << 20
    gather_bytes = n * (4 + 4) + rank * k * 4 + n * rank * 4
    # probe_pallas_gather2.py: KP, R, N = 640, 128, 2^19; fp32 u, W^T, g
    kp, r, n2 = 640, 128, 1 << 19
    lane_bytes = n2 * 4 + r * kp * 4 + n2 * r * 4
    # probe_pallas_hatmul.py: KP, R, N = 640, 128, 2^19; fp32 u3, W (3, KP, R)
    hat_bytes = n2 * 3 * 4 + 3 * kp * r * 4 + n2 * r * 4
    rows = [
        ("run_onehot/k_onehot", "benchmarking/probe_pallas_gather.py:60",
         gather_bytes, 0),
        ("run_index/k_index", "benchmarking/probe_pallas_gather.py:105",
         gather_bytes, 0),
        ("run_gather/k_gather", "benchmarking/probe_pallas_gather2.py:88",
         lane_bytes, 0),
        ("run_bwd/k_bwd", "benchmarking/probe_pallas_gather2.py:143",
         lane_bytes, 2 * n2 * kp * r),
        ("run_pallas/kernel", "benchmarking/probe_pallas_hatmul.py:89",
         hat_bytes, 3 * 2 * n2 * kp * r),
    ]
    for name, where, n_bytes, ops in rows:
        by_bytes = n_bytes / HBM_BPS * 1e3
        by_ops = ops / BF16_FLOPS * 1e3
        print(json.dumps({
            "kernel": name, "file": where, "bytes": n_bytes,
            "bf16_operations": ops, "bytes_ms": by_bytes,
            "operations_ms": by_ops, "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}))


if __name__ == "__main__":
    main()
