// Line-table kernels of the encoder formulation probes — CUDA C++ for
// sm_90a. Two functions of one line table T (K rows, R columns):
//
// table_lerp (table_lerp_kernel) replaces three Pallas kernels that compute
// one function, the two-row lerp of a line table:
//   benchmarking/probe_pallas_gather.py::k_onehot  (one-hot matmuls)
//   benchmarking/probe_pallas_gather.py::k_index   (take_along_axis)
//   benchmarking/probe_pallas_gather2.py::k_gather (index from u inside)
//
//     out[n, :] = T[i_n] * (1 - f_n) + T[i_n + 1] * f_n        (N, R) fp32
//
// with (i_n, f_n) given (idx mode), or computed from u_n as k_gather does
// (u mode): pos = u * (K-1), i = clamp(trunc(pos), 0, K-2), f = pos - i, so
// u = 1 gives i = K-2 and f = 1. In idx mode the index is clamped to
// [0, K-2] too, so a stray index cannot read outside the table.
//
// Every product and sum is rounded on its own (__fmul_rn, __fsub_rn,
// __fadd_rn): nvcc would otherwise contract t0 * (1 - f) + t1 * f, or
// u * (K-1) - i, into FMAs, and the result would no longer equal the plain
// torch version bit for bit.
//
// What bounds it on Hopper: the output write, R fp32 a sample (268 MB at
// N = 2^19, R = 128), and the index stream; T is a few hundred KB at most
// and stays in L1/L2. So a thread takes 4 consecutive columns: one 16-byte
// load of each of the two rows and one 16-byte store, neighbouring threads
// on neighbouring addresses, R/4 threads a sample.
//
// hat_basis_dw (two stages) replaces benchmarking/probe_pallas_gather2.py::
// k_bwd (:143-173), one axis of the hat backward's table gradient with
// g_d = bf16(g):
//
//     dW[k, :] = sum_n bf16(max(0, 1 - |u_n (K-1) - k|)) * bf16(g[n, :])
//
// in fp32 sums (K, R). A hat row has two nonzeros, at i = clamp(floor(pos),
// 0, K-2) and i + 1, with the weights computed as the dense basis computes
// them (ops/hatmul.py::_pos_basis) and rounded to bf16; a bf16 x bf16
// product is exact in fp32, so each sample's contribution equals the dense
// form's and only the order of the fp32 sums differs.
//
// The TPU kernel sums dW into one output block that its sequential grid
// revisits. Hopper's blocks run in parallel, and float atomics would add in
// another order on every launch. Here dW is bitwise the same on every
// launch, in two stages:
//
// * Stage 1 (hat_basis_dw_slab_kernel): the grid is (column tile of 32) x
//   (sample chunk). A block is kDwWarps = 8 walker warps sharing one fp32
//   slab (K, 32) of dW in shared memory (65.7 KB at K = 513: three blocks,
//   24 walkers, an SM). Ownership: warp w owns the slab rows [w S,
//   (w + 1) S), S = ceil(K / 8) (65 at K = 513), and lane c of it is the
//   only reader and writer of column c of those rows: no barrier, no
//   atomics. A sample of hat row i gives its w0 term to the owner of row i
//   and its w1 term to the owner of row i + 1; both walk it (one warp but
//   at a range's edge), each adding only to its own rows.
//   Filter: each warp reads the chunk's u, 4 batches of 32 a step
//   (coalesced; L1 serves the block's other warps), keeps the samples that
//   touch its rows (a ballot a batch) and compacts them into slots in
//   sample order, lane t finding its slot's sample by a binary search over
//   its batch's ballot. Read-ahead: 32 selected samples at a time, each
//   lane loading g of all 32 at its column (32 loads in flight a lane, a
//   128-byte row segment a slot). Walk: the slots' rows and weights
//   (with the two rows' ownership in the weights' sign bits) come by
//   shuffles; rows i and i + 1 stay in registers while consecutive slots
//   share them, and a slot on other rows writes them back and reads its
//   own. No run-length merging: each slab element adds its chunk's
//   products one by one in sample order, from 0, and the order does not
//   depend on the warps.
// * Stage 2 (hat_basis_dw_reduce_kernel) adds the chunks' slabs in chunk
//   order into dW, from 0, writing every element.
//
// ops/linetable.py::hat_basis_dw_order_plain repeats these sums and equals
// the kernel bit for bit; the order depends on N and R alone (the caller's
// chunking), never on the launch.
//
// What bounds it. The function's bytes: g (R fp32 a sample, 268 MB at N =
// 2^19, R = 128), u and dW once, 0.0808 ms at 3.35 TB/s; the slabs add
// chunks x K x R x 4 bytes, written once and read once. The earlier
// design (one walker warp a block, three an SM) took 0.5598 ms there
// (NVIDIA H100 80GB HBM3, 700 W), and 0.4654 ms with g made in registers:
// its serial walk set it. This one takes 0.188 ms at uniform u (43% of
// the bound; 0.450 ms at sorted u, where a chunk's few rows fall to one
// warp of a block), 0.161 ms with g made in registers and 0.064 ms
// without loads or walk (tools/dw_ab.py, PERF.md §6): the SM's
// instructions, about 30 a slot in the walk and the 8-fold filter, now
// set it, not g's bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLerpCols = 4;       // columns a thread: one float4
constexpr int kLerpThreads = 256;
constexpr int kDwCols = 32;        // slab columns a block: one a lane
constexpr int kDwWarps = 8;        // walker warps a block
constexpr int kDwSlots = 32;       // selected samples a walk: one a lane
constexpr int kDwGroup = 4;        // u batches of 32 a filter step
constexpr int kDwBlocksPerSm = 3;  // the slabs at K = 513
constexpr unsigned kFull = 0xffffffffu;
constexpr int kReduceThreads = 256;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float lerp_rn(float t0, float t1, float f) {
  return __fadd_rn(__fmul_rn(t0, __fsub_rn(1.0f, f)), __fmul_rn(t1, f));
}

// idx / frac: idx mode; u (idx == null): u mode.
__global__ void __launch_bounds__(kLerpThreads)
table_lerp_kernel(const float* __restrict__ table,
                  const int32_t* __restrict__ idx,
                  const float* __restrict__ frac,
                  const float* __restrict__ u, float* __restrict__ out,
                  int n, int k, int r) {
  const int lanes = r / kLerpCols;   // threads a sample
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t s = tid / lanes;
  if (s >= n) return;
  const int c0 = static_cast<int>(tid - s * lanes) * kLerpCols;
  int i;
  float f;
  if (idx != nullptr) {
    i = min(max(idx[s], 0), k - 2);
    f = frac[s];
  } else {
    const float pos = __fmul_rn(u[s], static_cast<float>(k - 1));
    i = min(max(static_cast<int>(pos), 0), k - 2);   // trunc, as astype
    f = __fsub_rn(pos, static_cast<float>(i));
  }
  const float* row = table + static_cast<int64_t>(i) * r + c0;
  const float4 t0 = *reinterpret_cast<const float4*>(row);
  const float4 t1 = *reinterpret_cast<const float4*>(row + r);
  *reinterpret_cast<float4*>(out + s * r + c0) = make_float4(
      lerp_rn(t0.x, t1.x, f), lerp_rn(t0.y, t1.y, f),
      lerp_rn(t0.z, t1.z, f), lerp_rn(t0.w, t1.w, f));
}

// A sample's hat row i = clamp(floor(pos), 0, K-2).
__device__ __forceinline__ int hat_row(float pos, int k) {
  return min(max(static_cast<int>(floorf(pos)), 0), k - 2);
}

__device__ __forceinline__ bool in_rows(int row, int lo, int hi) {
  return row >= lo && row < hi;
}

// The position of the q-th (from 0) set bit of m; q < popc(m).
__device__ __forceinline__ int nth_set_bit(unsigned m, int q) {
  int p = 0;                         // the largest p with popc(m below p) <= q
#pragma unroll
  for (int step = 16; step > 0; step >>= 1) {
    if (__popc(m & ((1u << (p + step)) - 1u)) <= q) p += step;
  }
  return p;
}

__global__ void __launch_bounds__(kDwWarps * 32, kDwBlocksPerSm)
hat_basis_dw_slab_kernel(const float* __restrict__ u,
                         const float* __restrict__ g,
                         float* __restrict__ slabs, int n, int k, int r,
                         int chunk) {
  extern __shared__ float slab[];    // (k, kDwCols)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.x * kDwCols + lane;
  const bool live = col < r;
  const int64_t begin = static_cast<int64_t>(blockIdx.y) * chunk;
  const int64_t end = begin + chunk < n ? begin + chunk : n;
  const float scale = static_cast<float>(k - 1);
  const int span = (k + kDwWarps - 1) / kDwWarps;
  const int lo = min(warp * span, k), hi = min(lo + span, k);
  float* mine = slab + lane;         // row stride kDwCols

  for (int row = lo; row < hi; ++row) mine[row * kDwCols] = 0.0f;

  // the filter: the next group of kDwGroup batches to read and the group
  // being taken (its first sample; each batch's selected samples not yet
  // taken)
  int64_t scan = begin, base = begin;
  unsigned rest[kDwGroup];
#pragma unroll
  for (int b = 0; b < kDwGroup; ++b) rest[b] = 0u;

  int cur = -2;                      // v0, v1: slab rows cur and cur + 1,
  bool own0 = false, own1 = false;   // and whether they are this warp's
  float v0 = 0.0f, v1 = 0.0f;
  for (;;) {
    // the next kDwSlots selected samples in order: lane t keeps slot t's.
    // A group's are taken at once: each lane finds the batch and the rank
    // in it of its own slot
    int cnt = 0, mine_s = static_cast<int>(begin);
    while (cnt < kDwSlots) {
      unsigned any = 0u;
#pragma unroll
      for (int b = 0; b < kDwGroup; ++b) any |= rest[b];
      if (any == 0u) {
        if (scan >= end) break;
        float us[kDwGroup];
#pragma unroll
        for (int b = 0; b < kDwGroup; ++b) {
          const int64_t s = scan + b * 32 + lane;
          us[b] = s < end ? u[s] : 0.0f;
        }
#pragma unroll
        for (int b = 0; b < kDwGroup; ++b) {
          const int64_t s = scan + b * 32 + lane;
          const int i = hat_row(__fmul_rn(us[b], scale), k);
          rest[b] = __ballot_sync(kFull, s < end && i + 1 >= lo && i < hi);
        }
        base = scan;
        scan += kDwGroup * 32;
        continue;
      }
      unsigned sel = 0u;
      int rank = -1, batch = 0;
#pragma unroll
      for (int b = 0; b < kDwGroup; ++b) {
        const int c = __popc(rest[b]);
        const int take = min(c, kDwSlots - cnt);
        const int q = lane - cnt;
        if (q >= 0 && q < take) {
          sel = rest[b];
          rank = q;
          batch = b;
        }
        if (take == c) {
          rest[b] = 0u;
        } else if (take > 0) {       // the batch's first `take` are taken
          rest[b] = __ballot_sync(
              kFull, ((rest[b] >> lane) & 1u) &&
                         __popc(rest[b] & ((1u << lane) - 1u)) >= take);
        }
        cnt += take;
      }
      if (rank >= 0) {
        mine_s = static_cast<int>(base + batch * 32 + nth_set_bit(sel, rank));
      }
    }
    if (cnt == 0) break;

    // this lane's slot: its row, whether rows i and i + 1 are this warp's,
    // and the bf16 weights: w0 in bits 0-15, w1 in 16-31, the two flags in
    // their sign bits 15 and 31 (the weights are >= 0). A lane past cnt
    // repeats the last slot's row with weights 0, so the walk below runs
    // all kDwSlots slots without a branch: it adds +0, which leaves a sum
    // unchanged (a sum from +0 is never -0)
    const float pos = __fmul_rn(u[mine_s], scale);
    int i_own = hat_row(pos, k);
    const float w0_own = round_bf16(
        fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(pos, (float)i_own)))));
    const float w1_own = round_bf16(fmaxf(
        0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(pos, (float)(i_own + 1))))));
    unsigned w_own = (__float_as_uint(w0_own) >> 16) |
                     (__float_as_uint(w1_own) & 0xffff0000u) |
                     (in_rows(i_own, lo, hi) ? 0x8000u : 0u) |
                     (in_rows(i_own + 1, lo, hi) ? 0x80000000u : 0u);
    const int i_last = __shfl_sync(kFull, i_own, cnt - 1);
    if (lane >= cnt) {
      i_own = i_last;
      w_own = 0u;
    }

    // g of every slot at the lane's column, all loads in flight at once
    float gs[kDwSlots];
#pragma unroll
    for (int t = 0; t < kDwSlots; ++t) {
      const int s = __shfl_sync(kFull, mine_s, t);
      gs[t] = live && t < cnt ? g[static_cast<int64_t>(s) * r + col] : 0.0f;
    }

    // the walk, in sample order
#pragma unroll
    for (int t = 0; t < kDwSlots; ++t) {
      const int i = __shfl_sync(kFull, i_own, t);
      const unsigned w = __shfl_sync(kFull, w_own, t);
      if (i != cur) {
        if (own0) mine[cur * kDwCols] = v0;
        if (own1) mine[(cur + 1) * kDwCols] = v1;
        own0 = (w & 0x8000u) != 0u;
        own1 = (w & 0x80000000u) != 0u;
        v0 = own0 ? mine[i * kDwCols] : 0.0f;
        v1 = own1 ? mine[(i + 1) * kDwCols] : 0.0f;
        cur = i;
      }
      const float gd = round_bf16(gs[t]);
      v0 = __fadd_rn(v0, __fmul_rn(fabsf(__uint_as_float(w << 16)), gd));
      v1 = __fadd_rn(v1,
                     __fmul_rn(fabsf(__uint_as_float(w & 0xffff0000u)), gd));
    }
    if (cnt < kDwSlots) break;
  }
  if (own0) mine[cur * kDwCols] = v0;
  if (own1) mine[(cur + 1) * kDwCols] = v1;
  if (live) {                        // each lane writes out its own column
    float* dst = slabs + static_cast<int64_t>(blockIdx.y) * k * r + col;
    for (int row = lo; row < hi; ++row) {
      dst[static_cast<int64_t>(row) * r] = mine[row * kDwCols];
    }
  }
}

__global__ void __launch_bounds__(kReduceThreads)
hat_basis_dw_reduce_kernel(const float* __restrict__ slabs, int chunks,
                           float* __restrict__ dw, int64_t dw_size) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (j >= dw_size) return;
  float s = 0.0f;
#pragma unroll 8
  for (int c = 0; c < chunks; ++c) s = __fadd_rn(s, slabs[c * dw_size + j]);
  dw[j] = s;
}

size_t dw_smem_bytes(int k) {
  return sizeof(float) * static_cast<size_t>(k) * kDwCols;
}

}  // namespace

// table: (k, r) fp32 row-major; idx mode: idx (n,) int32 and frac (n,) fp32,
// u null; u mode: u (n,) fp32, idx and frac null. out: (n, r) fp32. All
// contiguous on the current device; r a multiple of 4, k >= 2, table and
// out 16-byte aligned. Launches on `stream`; returns cudaGetLastError().
extern "C" int table_lerp(const void* table, const void* idx,
                          const void* frac, const void* u, void* out, int n,
                          int k, int r, void* stream) {
  const int64_t threads = static_cast<int64_t>(n) * (r / kLerpCols);
  const int64_t blocks = (threads + kLerpThreads - 1) / kLerpThreads;
  if (blocks > 0) {
    table_lerp_kernel<<<static_cast<unsigned>(blocks), kLerpThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(table), static_cast<const int32_t*>(idx),
        static_cast<const float*>(frac), static_cast<const float*>(u),
        static_cast<float*>(out), n, k, r);
  }
  return static_cast<int>(cudaGetLastError());
}

// Both stages on `stream`. u: (n,) fp32; g: (n, r) fp32, contiguous; dw:
// (k, r) fp32; slabs: scratch (chunks, k, r) fp32. Samples [c * chunk,
// (c + 1) * chunk) form chunk c; chunks * chunk >= n. k >= 2 and k * 128
// bytes of shared memory within the block's opt-in limit (k <= 1,816 on an
// H100). Nothing needs zeroing: stage 2 writes every element of dw. Returns
// a cudaError_t: a refused launch, or cudaErrorInvalidValue for a slab too
// large.
extern "C" int hat_basis_dw(const void* u, const void* g, void* dw,
                            void* slabs, int n, int k, int r, int chunk,
                            int chunks, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = dw_smem_bytes(k);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(optin)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = cudaFuncSetAttribute(hat_basis_dw_slab_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(hat_basis_dw_slab_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const int tiles = (r + kDwCols - 1) / kDwCols;
    hat_basis_dw_slab_kernel<<<dim3(tiles, chunks), kDwWarps * 32, smem,
                               st>>>(
        static_cast<const float*>(u), static_cast<const float*>(g),
        static_cast<float*>(slabs), n, k, r, chunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t dw_size = static_cast<int64_t>(k) * r;
  const int64_t blocks = (dw_size + kReduceThreads - 1) / kReduceThreads;
  hat_basis_dw_reduce_kernel<<<static_cast<unsigned>(blocks), kReduceThreads,
                               0, st>>>(static_cast<const float*>(slabs),
                                        n > 0 ? chunks : 0,
                                        static_cast<float*>(dw), dw_size);
  return static_cast<int>(cudaGetLastError());
}
