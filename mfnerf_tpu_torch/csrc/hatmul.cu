// Hat-basis CP product for one LowRank frame, forward and backward — CUDA C++
// for sm_90a.
//
// Replaces: mfnerf_tpu/ops/hatmul.py::_fwd_kernel (the Pallas forward behind
// hat_prod), whose JAX production twin is mfnerf_tpu/ops/lowrank.py::
// _hat_cp_prod. Computes, for N samples, K knots and R columns,
//
//     out[n, :] = prod_{d=0..2}  B_K(u3[n, d]) @ W[d]          (N, R) fp32
//
// where B_K(u) is the piecewise-linear hat basis, B[k] = max(0, 1-|u(K-1)-k|).
//
// The TPU kernel builds each dense (TN, KP) basis tile from an iota and feeds
// the MXU. A hat row has exactly two nonzeros, so here a_d is a lerp of two
// rows of W_d: i = clamp(floor(u(K-1)), 0, K-2), and
//     a_d = w0 * W_d[i] + w1 * W_d[i+1]
// with w0, w1 computed exactly as the dense basis computes them and rounded to
// bf16, W stored in bf16, products and sums in fp32 — the same operand
// rounding as the dense bf16 matmul with fp32 accumulation, so the result
// equals the dense form up to summation order. At u = 1 the row index is
// clamped to K-2 and the basis there is exactly e_{K-1} (w0 = 0, w1 = 1).
//
// What bounds it on Hopper: per sample it reads 2 rows x R bf16 x 3 axes
// (L1/L2 hits: W is 3*K*R*2 bytes, 197 KB at K=257, R=128) and writes R fp32
// (512 B at R=128) to device memory; there are ~6 FLOPs per output value. It
// is bound by the output write and the row reads, not by arithmetic. The
// design therefore gives each thread 8 consecutive columns: one 16-byte load
// per W row and two 16-byte stores per thread, neighbouring threads on
// neighbouring addresses, R/8 threads per sample. Staging W in shared memory
// (TMA) and writing both frames into one (N, 2R) row are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;        // columns per thread: 8 bf16 = one 16-byte load
constexpr int kThreads = 256;  // threads per block

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void unpack_row(uint4 raw, float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < kVec / 2; ++j) {
    float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* v) {
  unpack_row(*reinterpret_cast<const uint4*>(p), v);
}

__global__ void __launch_bounds__(kThreads)
hat_prod_fwd_kernel(const float* __restrict__ u3,
                    const __nv_bfloat16* __restrict__ w,
                    float* __restrict__ out, int n, int k, int r) {
  const int lanes = r / kVec;  // threads per sample
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t s = tid / lanes;
  if (s >= n) return;
  const int c0 = static_cast<int>(tid - s * lanes) * kVec;
  const float scale = static_cast<float>(k - 1);

  float acc[kVec];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = u3[s * 3 + d] * scale;
    int i = static_cast<int>(floorf(pos));
    i = min(max(i, 0), k - 2);
    const float w0 = round_bf16(fmaxf(0.0f, 1.0f - fabsf(pos - (float)i)));
    const float w1 =
        round_bf16(fmaxf(0.0f, 1.0f - fabsf(pos - (float)(i + 1))));
    const __nv_bfloat16* row = w + (static_cast<int64_t>(d) * k + i) * r + c0;
    float r0[kVec], r1[kVec];
    load_row(row, r0);
    load_row(row + r, r1);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float a = w0 * r0[j] + w1 * r1[j];
      acc[j] = d == 0 ? a : acc[j] * a;
    }
  }
  float4* dst = reinterpret_cast<float4*>(out + s * r + c0);
  dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
}

// ---------------------------------------------------------------- backward
//
// Replaces: mfnerf_tpu/ops/hatmul.py::_make_bwd_kernel (the Pallas backward
// behind hat_prod's custom VJP), whose XLA twin is mfnerf_tpu/ops/lowrank.py::
// _hat_cp_prod_bwd. For the output cotangent g (N, R):
//
//     g_d  = bf16(g * a_e * a_f)                              e, f != d
//     dW_d = B_K(u_d)^T @ g_d                                 (K, R) fp32
//     du_d = (K-1) * sum_c g_d[c] * (W_d[i+1, c] - W_d[i, c])
//
// du_d is exactly 0 where pos = u_d(K-1) is a whole number (the hat's
// subgradient on a knot), including pos = K-1, where the clamped row index
// i = K-2 lies a whole step below pos.
//
// The TPU kernel rebuilds each dense (TN, KP) basis tile and accumulates dW
// into one output block that the sequential TPU grid revisits. A Hopper
// grid's blocks run in parallel, so here every (sample, axis) adds its two
// nonzero basis rows, w0 * g_d and w1 * g_d, into a zeroed fp32 dW with
// 16-byte vector atomics (atomicAdd(float4*), sm_90). The order of those
// additions varies from run to run, so dW is not bitwise deterministic; every
// other output is. a_d and g_d are recomputed exactly as the forward kernel
// computes them (bf16 hat weights and rows, fp32 products and sums), and
// w * g_d is exact in fp32, so each sample's contribution equals the dense
// form's; only the summation order differs.
//
// The thread layout is the forward's: R/8 threads a sample, 8 columns a
// thread, whole samples in a block. Each thread sums its 8 columns of
// g_d . W_d[i] and g_d . W_d[i+1] for du; the sample's first thread adds the
// R/8 partial sums from shared memory in a fixed order.
//
// What bounds it on Hopper: per sample it reads u (12 B), g (R fp32) and two
// bf16 rows per axis (L2 hits), and makes 6 * R/4 vector atomics into a
// 3*K*R fp32 table (395 KB at K=257, R=128) that stays in L2. Samples of one
// ray sit at neighbouring positions and hit the same rows, so the atomics
// contend at L2; they, not the bytes read, bound it. Aggregating a block's
// samples in shared memory first is later work.

__global__ void __launch_bounds__(kThreads)
hat_prod_bwd_kernel(const float* __restrict__ u3,
                    const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ g, float* __restrict__ du,
                    float* __restrict__ dw, int n, int k, int r) {
  extern __shared__ float part[];  // per thread: (g_d.W[i], g_d.W[i+1]) x 3
  const int lanes = r / kVec;      // threads per sample
  const int per_block = blockDim.x / lanes;
  const int local = threadIdx.x / lanes;
  const int lane = threadIdx.x - local * lanes;
  const int64_t s = static_cast<int64_t>(blockIdx.x) * per_block + local;
  const bool live = s < n;
  const int c0 = lane * kVec;
  const float scale = static_cast<float>(k - 1);

  bool knot[3];
  if (live) {
    int row[3];
    float w0[3], w1[3];
    uint4 raw0[3], raw1[3];
    float a[3][kVec];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float pos = u3[s * 3 + d] * scale;
      const float fl = floorf(pos);
      knot[d] = pos == fl;
      const int i = min(max(static_cast<int>(fl), 0), k - 2);
      row[d] = i;
      w0[d] = round_bf16(fmaxf(0.0f, 1.0f - fabsf(pos - (float)i)));
      w1[d] = round_bf16(fmaxf(0.0f, 1.0f - fabsf(pos - (float)(i + 1))));
      const __nv_bfloat16* p = w + (static_cast<int64_t>(d) * k + i) * r + c0;
      raw0[d] = *reinterpret_cast<const uint4*>(p);
      raw1[d] = *reinterpret_cast<const uint4*>(p + r);
      float r0[kVec], r1[kVec];
      unpack_row(raw0[d], r0);
      unpack_row(raw1[d], r1);
#pragma unroll
      for (int j = 0; j < kVec; ++j) a[d][j] = w0[d] * r0[j] + w1[d] * r1[j];
    }
    float gv[kVec];
    const float4* gp = reinterpret_cast<const float4*>(g + s * r + c0);
    const float4 g_lo = gp[0], g_hi = gp[1];
    gv[0] = g_lo.x; gv[1] = g_lo.y; gv[2] = g_lo.z; gv[3] = g_lo.w;
    gv[4] = g_hi.x; gv[5] = g_hi.y; gv[6] = g_hi.z; gv[7] = g_hi.w;

#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int e = (d + 1) % 3, f = (d + 2) % 3;
      float gd[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) gd[j] = round_bf16(gv[j] * a[e][j] * a[f][j]);
      float4* dst = reinterpret_cast<float4*>(
          dw + (static_cast<int64_t>(d) * k + row[d]) * r + c0);
      atomicAdd(dst, make_float4(w0[d] * gd[0], w0[d] * gd[1], w0[d] * gd[2],
                                 w0[d] * gd[3]));
      atomicAdd(dst + 1, make_float4(w0[d] * gd[4], w0[d] * gd[5],
                                     w0[d] * gd[6], w0[d] * gd[7]));
      dst += r / 4;  // row i + 1
      atomicAdd(dst, make_float4(w1[d] * gd[0], w1[d] * gd[1], w1[d] * gd[2],
                                 w1[d] * gd[3]));
      atomicAdd(dst + 1, make_float4(w1[d] * gd[4], w1[d] * gd[5],
                                     w1[d] * gd[6], w1[d] * gd[7]));
      if (du != nullptr) {
        float r0[kVec], r1[kVec];
        unpack_row(raw0[d], r0);
        unpack_row(raw1[d], r1);
        float p0 = 0.0f, p1 = 0.0f;
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          p0 += gd[j] * r0[j];
          p1 += gd[j] * r1[j];
        }
        part[threadIdx.x * 6 + 2 * d] = p0;
        part[threadIdx.x * 6 + 2 * d + 1] = p1;
      }
    }
  }
  if (du == nullptr) return;  // the same for every thread of the block
  __syncthreads();
  if (!live || lane != 0) return;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float db0 = 0.0f, db1 = 0.0f;
    for (int l = 0; l < lanes; ++l) {
      db0 += part[(threadIdx.x + l) * 6 + 2 * d];
      db1 += part[(threadIdx.x + l) * 6 + 2 * d + 1];
    }
    // dhat is -(K-1) at row i and +(K-1) at row i+1 between knots
    du[s * 3 + d] = knot[d] ? 0.0f
                            : __fsub_rn(__fmul_rn(scale, db1),
                                        __fmul_rn(scale, db0));
  }
}

}  // namespace

// u3: (n, 3) fp32; w: (3, k, r) bf16; out: (n, r) fp32, all contiguous on
// the current device; r a multiple of 8, k >= 2, pointers 16-byte aligned.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int hat_prod_fwd(const void* u3, const void* w, void* out, int n,
                            int k, int r, void* stream) {
  const int64_t threads = static_cast<int64_t>(n) * (r / kVec);
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0) {
    hat_prod_fwd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(u3),
        static_cast<const __nv_bfloat16*>(w), static_cast<float*>(out), n, k,
        r);
  }
  return static_cast<int>(cudaGetLastError());
}

// u3: (n, 3) fp32; w: (3, k, r) bf16; g: (n, r) fp32; dw: (3, k, r) fp32,
// ZEROED by the caller; du: (n, 3) fp32, or null to skip du. All contiguous
// on the current device; r a multiple of 8 and at most 8 * 256, k >= 2,
// w, g and dw 16-byte aligned. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int hat_prod_bwd(const void* u3, const void* w, const void* g,
                            void* du, void* dw, int n, int k, int r,
                            void* stream) {
  const int lanes = r / kVec;
  const int per_block = lanes >= kThreads ? 1 : kThreads / lanes;
  const int threads = per_block * lanes;
  const int64_t blocks = (static_cast<int64_t>(n) + per_block - 1) / per_block;
  const size_t smem = static_cast<size_t>(threads) * 6 * sizeof(float);
  if (blocks > 0) {
    hat_prod_bwd_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(u3), static_cast<const __nv_bfloat16*>(w),
        static_cast<const float*>(g), static_cast<float*>(du),
        static_cast<float*>(dw), n, k, r);
  }
  return static_cast<int>(cudaGetLastError());
}
