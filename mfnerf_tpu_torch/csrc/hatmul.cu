// Hat-basis CP product, forward, for one LowRank frame — CUDA C++ for sm_90a.
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

__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* v) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < kVec / 2; ++j) {
    float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
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
