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
// k_bwd, one axis of the hat backward's table gradient with g_d = bf16(g):
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
// launch, in two stages, as the hat-CP backward (hatmul.cu) takes them:
//
// * Stage 1 (hat_basis_dw_slab_kernel): the grid is (column tile of 32) x
//   (sample chunk); a block is one warp and keeps a private fp32 slab (K, 32)
//   of dW in shared memory (65.7 KB at K = 513: three blocks an SM). Lane c
//   is the only writer of slab column c and walks the chunk's samples in
//   order. A batch of 32 samples is read ahead: each lane finds the hat row
//   and weights of one sample (one coalesced load of u) and loads g of the
//   32 samples at its column (a 128-byte row segment a sample); the lanes
//   then take the batch's rows and weights from each other by shuffles. A
//   lane keeps the two rows it last touched and their running sums in
//   registers, and writes to the slab only when a sample's rows differ
//   (run-length merging).
// * Stage 2 (hat_basis_dw_reduce_kernel) adds the chunks' slabs in chunk
//   order into dW, writing every element.
//
// The order of the sums depends on N and R alone (the caller's chunking),
// never on the launch. What bounds it: the bytes of g (R fp32 a sample, 268
// MB at N = 2^19, R = 128); the slabs add chunks x K x R x 4 bytes, written
// once and read once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLerpCols = 4;       // columns a thread: one float4
constexpr int kLerpThreads = 256;
constexpr int kDwCols = 32;        // slab columns a block: one a lane
constexpr int kDwBatch = 32;       // samples read ahead: one a lane
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

// One batch read ahead: u of sample s0 + lane, g of samples s0 .. s0 + 31
// at the lane's column (0 past the chunk's end or past the last column).
struct Batch {
  float u;
  float g[kDwBatch];
};

__device__ __forceinline__ void load_batch(const float* __restrict__ u,
                                           const float* __restrict__ g,
                                           int64_t s0, int64_t end, int r,
                                           int col, bool live, int lane,
                                           Batch& b) {
  const int64_t cnt = end - s0 < kDwBatch ? end - s0 : kDwBatch;
  b.u = lane < cnt ? u[s0 + lane] : 0.0f;
#pragma unroll
  for (int j = 0; j < kDwBatch; ++j) {
    b.g[j] = live && j < cnt ? g[(s0 + j) * r + col] : 0.0f;
  }
}

__global__ void __launch_bounds__(kDwCols)
hat_basis_dw_slab_kernel(const float* __restrict__ u,
                         const float* __restrict__ g,
                         float* __restrict__ slabs, int n, int k, int r,
                         int chunk) {
  extern __shared__ float slab[];    // (k, kDwCols)
  const int lane = threadIdx.x;
  const int col = blockIdx.x * kDwCols + lane;
  const bool live = col < r;
  const int64_t begin = static_cast<int64_t>(blockIdx.y) * chunk;
  const int64_t end = begin + chunk < n ? begin + chunk : n;
  const float scale = static_cast<float>(k - 1);

  for (int q = lane; q < k * kDwCols; q += kDwCols) slab[q] = 0.0f;
  __syncwarp();

  int cur = -2;                      // acc0, acc1 hold rows cur and cur + 1
  float acc0 = 0.0f, acc1 = 0.0f;
  float* mine = slab + lane;         // row stride kDwCols

  // the batch at s0: this lane's sample's hat row and weights, then the
  // run-length walk over the batch's samples in order
  auto walk = [&](int64_t s0, const Batch& b) {
    const int cnt =
        static_cast<int>(end - s0 < kDwBatch ? end - s0 : kDwBatch);
    const float pos = __fmul_rn(b.u, scale);
    const int i0 = min(max(static_cast<int>(floorf(pos)), 0), k - 2);
    const float w0_own = round_bf16(
        fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(pos, (float)i0)))));
    const float w1_own = round_bf16(
        fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(pos, (float)(i0 + 1))))));
#pragma unroll
    for (int j = 0; j < kDwBatch; ++j) {
      const int i = __shfl_sync(0xffffffffu, i0, j);
      const float w0 = __shfl_sync(0xffffffffu, w0_own, j);
      const float w1 = __shfl_sync(0xffffffffu, w1_own, j);
      if (j < cnt) {                 // the same for the whole warp
        // A sample whose row differs from cur writes the window's rows out
        // (adding 0 to a row that stays in the window leaves it unchanged)
        if (i != cur) {
          const bool up = i == cur + 1, down = i == cur - 1;
          const int lo = cur < 0 ? 0 : cur;   // no window yet: add 0 to row 0
          const float v0 = mine[lo * kDwCols];
          const float v1 = mine[(lo + 1) * kDwCols];
          mine[lo * kDwCols] = __fadd_rn(v0, down ? 0.0f : acc0);
          mine[(lo + 1) * kDwCols] = __fadd_rn(v1, up ? 0.0f : acc1);
          const float keep0 = up ? acc1 : 0.0f;
          acc1 = down ? acc0 : 0.0f;
          acc0 = keep0;
          cur = i;
        }
        const float gd = round_bf16(b.g[j]);
        acc0 = __fadd_rn(acc0, __fmul_rn(w0, gd));
        acc1 = __fadd_rn(acc1, __fmul_rn(w1, gd));
      }
    }
  };

  Batch b0, b1;                      // buffers alternate
  if (begin < end) load_batch(u, g, begin, end, r, col, live, lane, b0);
  for (int64_t s0 = begin; s0 < end; s0 += 2 * kDwBatch) {
    const int64_t s1 = s0 + kDwBatch;
    if (s1 < end) load_batch(u, g, s1, end, r, col, live, lane, b1);
    walk(s0, b0);
    if (s1 < end) {
      if (s1 + kDwBatch < end) {
        load_batch(u, g, s1 + kDwBatch, end, r, col, live, lane, b0);
      }
      walk(s1, b1);
    }
  }
  if (cur >= 0) {
    mine[cur * kDwCols] = __fadd_rn(mine[cur * kDwCols], acc0);
    mine[(cur + 1) * kDwCols] = __fadd_rn(mine[(cur + 1) * kDwCols], acc1);
  }
  if (live) {                        // each lane writes out its own column
    float* dst = slabs + static_cast<int64_t>(blockIdx.y) * k * r + col;
    for (int row = 0; row < k; ++row) {
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
    hat_basis_dw_slab_kernel<<<dim3(tiles, chunks), kDwCols, smem, st>>>(
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
