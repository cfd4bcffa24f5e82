// Multiresolution hash-grid encoding (Hash / Window / MixedFeature),
// forward and backward — CUDA C++ for sm_90a.
//
// Replaces an XLA function, not a Pallas kernel: mfnerf_tpu/ops/hashgrid.py::
// _fwd_impl (8 corner gathers per level, batched over levels, fused by XLA)
// and ::_encode_bwd (the custom VJP: one scatter-add of the table gradient,
// d_x and d_window). For N samples x in [0, 1]^3, L levels and F features:
//
//     pos   = x * scale_l + 0.5,  base = floor(pos),  frac = pos - base
//     out[n, l*F + f] = window_l * sum_{c=0..7} w_c * T[row_l(base + c), f]
//
// with w_c the trilinear weight of corner c, (wb0 * wb1) * wb2, wb_d = frac_d
// or 1 - frac_d, and row_l the level's dense index or salted XOR hash plus
// its offset, the corner first clamped to res - 1 (which acts only on the
// box face x == 1). Every product and sum of pos, the weights and the blend
// is rounded on its own (__fmul_rn / __fadd_rn): nvcc would otherwise
// contract x * scale + 0.5 into an FMA, and a different pos can move
// floor(pos) across a cell and change the corner rows, not only the last
// bit. So the forward equals the plain torch version bit for bit.
//
// Forward (hashgrid_fwd_kernel): one thread per (sample, level), the level
// fastest, so the (N, L*F) output is written coalesced. At F = 2, every
// configuration the repo ships, a corner row is one 8-byte load. What bounds
// it on Hopper: the bytes of x, of the output and of the distinct table rows
// the launch reads (PERF.md); the 8 row loads of a thread are random, and
// the coarse levels' rows are L2 hits.
//
// Backward, three passes, with d_params bitwise equal from launch to launch:
//
// * Float atomics add in another order on every launch. The table gradient
//   is summed instead in 64-bit fixed point with integer atomics, whose
//   addition is associative, so the order does not matter. A first pass
//   (hashgrid_bwd_prep_kernel) zeroes the fixed-point table and sums
//   S = sum |g * window| in a fixed order. No row's sum can exceed S: a
//   level's trilinear weights sum to 1, and the sampled-corner gradient adds
//   m copies of g / m. Each update w * g (or g / m) is scaled by 2^k, the
//   power of two with S * 2^k < 2^61, and rounded to an integer: its error
//   is at most 2^-k / 2 <= S * 2^-61. A sort by row and a fixed-order
//   segmented sum (the other deterministic design) would move the 8 * L
//   updates of every sample through memory twice more and need a radix sort
//   by hand; the atomics keep the updates in L2.
// * hashgrid_bwd_scatter_kernel: a block holds (256 / L) samples x L levels;
//   blocks walk the sample tiles in a fixed stride. A thread finds its 8
//   corner rows and weights as the forward does, and adds w_c * g (or, given
//   the per-sample uniforms and m < 8, the unweighted g / m at m corners
//   drawn by inverse CDF, min(count(cumsum(w) < u), 7)) to the fixed-point
//   table. With d_x or a window it also reads the 8 rows: d_x sums each
//   level's part in shared memory in level order, and the level's
//   un-windowed output dotted with g goes into the block's d_window partial
//   (fp64: a sum over every sample, most of whose terms cancel).
//   Updates of one sample go to L different levels, so a warp's atomics hit
//   different rows even where consecutive samples of a ray share the coarse
//   levels' few rows.
// * hashgrid_bwd_finish_kernel converts the table to fp32 and sums the
//   blocks' d_window partials in block order.
//
// What bounds the backward: the updates, 8 * L * F 64-bit atomics a sample
// (2^19 samples, L = 16, F = 2: 134M), resolved in L2 at ~48G a second on
// an H100, 2.8 ms, far above the bytes of g, x, the fixed-point table
// (zeroed, read) and d_params (PERF.md). A level-major order, which keeps
// the rows in flight to one level's, measured the same: the atomics' rate,
// not the 91 MB table's L2 misses, sets the time. Fewer atomics (merging a
// warp's updates of one row, shared-memory sums of the coarse levels) is
// the way to make it faster.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kThreads = 256;
constexpr uint32_t kPrime1 = 2654435761u, kPrime2 = 805459861u;

struct Level {
  float scale;
  uint32_t res, offset, mask, salt, dense;
};

// The level table travels by value in the kernels' parameters.
struct Levels {
  Level lv[kMaxLevels];
};

// pos = x * scale + 0.5 unfused: its floor and fraction per axis.
__device__ __forceinline__ void locate(const float* __restrict__ x,
                                       float scale, int base[3],
                                       float frac[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = __fadd_rn(__fmul_rn(__ldg(x + d), scale), 0.5f);
    const float fl = floorf(pos);
    base[d] = static_cast<int>(fl);
    frac[d] = __fsub_rn(pos, fl);
  }
}

// The table row of corner c of the cell at base.
__device__ __forceinline__ uint32_t corner_row(const Level& lv,
                                               const int base[3], int c) {
  const uint32_t top = lv.res - 1;
  const uint32_t cx = min(static_cast<uint32_t>(base[0] + (c & 1)), top);
  const uint32_t cy = min(static_cast<uint32_t>(base[1] + ((c >> 1) & 1)),
                          top);
  const uint32_t cz = min(static_cast<uint32_t>(base[2] + ((c >> 2) & 1)),
                          top);
  const uint32_t idx =
      lv.dense ? cx + cy * lv.res + cz * lv.res * lv.res
               : (cx ^ (cy * kPrime1) ^ (cz * kPrime2) ^ lv.salt) & lv.mask;
  return idx + lv.offset;
}

// Per-axis weights of corner c, and their product (wb0 * wb1) * wb2.
__device__ __forceinline__ float corner_weight(const float frac[3], int c,
                                               float wb[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    wb[d] = ((c >> d) & 1) ? frac[d] : __fsub_rn(1.0f, frac[d]);
  }
  return __fmul_rn(__fmul_rn(wb[0], wb[1]), wb[2]);
}

template <int FC>
__global__ void __launch_bounds__(kThreads)
hashgrid_fwd_kernel(const float* __restrict__ params,
                    const float* __restrict__ x,
                    const float* __restrict__ window,
                    float* __restrict__ out, int64_t n, int levels,
                    int f_dim, Levels lvs) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= n * levels) return;
  const int64_t s = t / levels;
  const int l = static_cast<int>(t - s * levels);
  const Level lv = lvs.lv[l];
  int base[3];
  float frac[3], wb[3];
  locate(x + s * 3, lv.scale, base, frac);
  uint32_t rows[8];
  float w[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    rows[c] = corner_row(lv, base, c);
    w[c] = corner_weight(frac, c, wb);
  }
  if constexpr (FC == 2) {
    const float2* p2 = reinterpret_cast<const float2*>(params);
    float2 acc = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float2 v = __ldg(p2 + rows[c]);
      acc.x = __fadd_rn(acc.x, __fmul_rn(w[c], v.x));
      acc.y = __fadd_rn(acc.y, __fmul_rn(w[c], v.y));
    }
    if (window != nullptr) {
      const float wl = __ldg(window + l);
      acc.x = __fmul_rn(acc.x, wl);
      acc.y = __fmul_rn(acc.y, wl);
    }
    reinterpret_cast<float2*>(out)[t] = acc;
  } else {
    for (int f = 0; f < f_dim; ++f) {
      float acc = 0.0f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        acc = __fadd_rn(acc, __fmul_rn(w[c], __ldg(params +
            static_cast<int64_t>(rows[c]) * f_dim + f)));
      }
      if (window != nullptr) acc = __fmul_rn(acc, __ldg(window + l));
      out[t * f_dim + f] = acc;
    }
  }
}

// Sum of a block's values in a fixed order: a butterfly in each warp, then
// the warps' sums in warp order. Every thread of the block must call it.
template <typename T>
__device__ T block_sum(T v, T* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, warps = (blockDim.x + 31) >> 5;
  if ((threadIdx.x & 31) == 0) scratch[warp] = v;
  __syncthreads();
  T total = 0;
  for (int i = 0; i < warps; ++i) total += scratch[i];
  __syncthreads();
  return total;
}

// Zero the fixed-point table; write this block's part of S = sum |g * win|.
__global__ void __launch_bounds__(kThreads)
hashgrid_bwd_prep_kernel(const float* __restrict__ g,
                         const float* __restrict__ window, int64_t n_g,
                         int levels, int f_dim,
                         unsigned long long* __restrict__ acc, int64_t n_acc,
                         double* __restrict__ sums) {
  __shared__ double scratch[kThreads / 32];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  for (int64_t i = t0; i < n_acc; i += stride) acc[i] = 0ull;
  double v = 0.0;
  for (int64_t i = t0; i < n_g; i += stride) {
    float gv = __ldg(g + i);
    if (window != nullptr) {
      gv = __fmul_rn(gv, __ldg(window + (i / f_dim) % levels));
    }
    v += fabs(static_cast<double>(gv));
  }
  v = block_sum(v, scratch);
  if (threadIdx.x == 0) sums[blockIdx.x] = v;
}

// 2^k with S * 2^k < 2^61 (1 for S = 0), or NaN when S is not finite.
__device__ double fixed_scale(double s) {
  if (!isfinite(s)) return nan("");
  if (s == 0.0) return 1.0;
  int e = 0;
  frexp(s, &e);                      // s < 2^e
  return ldexp(1.0, max(-1000, min(1000, 61 - e)));
}

__device__ __forceinline__ void add_fixed(unsigned long long* acc, float v,
                                          double scale) {
  atomicAdd(acc, static_cast<unsigned long long>(
                     __double2ll_rn(static_cast<double>(v) * scale)));
}

// One (sample, level)'s table gradient into the fixed-point table: w_c * g
// at the 8 corners, or with m > 0 the unweighted g / m at m corners drawn
// by the uniforms u[0..m) (inverse CDF of the weights in corner order).
template <int FC>
__device__ __forceinline__ void add_table_grad(
    const Level& lv, const float* __restrict__ x,
    const float* __restrict__ gp, float win, int f_dim,
    const float* __restrict__ u, int m, unsigned long long* acc,
    double scale) {
  const int F = FC > 0 ? FC : f_dim;
  int base[3];
  float frac[3], wb[3];
  locate(x, lv.scale, base, frac);
  if (m == 0) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int64_t row = corner_row(lv, base, c);
      const float w = corner_weight(frac, c, wb);
      for (int f = 0; f < F; ++f) {
        add_fixed(acc + row * F + f,
                  __fmul_rn(w, __fmul_rn(__ldg(gp + f), win)), scale);
      }
    }
    return;
  }
  float cumw[8];
  float run = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    run = __fadd_rn(run, corner_weight(frac, c, wb));
    cumw[c] = run;
  }
  for (int j = 0; j < m; ++j) {
    const float uj = __ldg(u + j);
    int cstar = 0;
#pragma unroll
    for (int c = 0; c < 8; ++c) cstar += cumw[c] < uj ? 1 : 0;
    const int64_t row = corner_row(lv, base, min(cstar, 7));
    for (int f = 0; f < F; ++f) {
      add_fixed(acc + row * F + f,
                __fdiv_rn(__fmul_rn(__ldg(gp + f), win),
                          static_cast<float>(m)),
                scale);
    }
  }
}

template <int FC>
__global__ void __launch_bounds__(kThreads)
hashgrid_bwd_scatter_kernel(
    const float* __restrict__ params, const float* __restrict__ x,
    const float* __restrict__ g, const float* __restrict__ window,
    const float* __restrict__ noise, int m,
    unsigned long long* __restrict__ acc, double* __restrict__ sums,
    int prep_blocks, float* __restrict__ d_x, double* __restrict__ win_part,
    int64_t n, int levels, int f_dim, int spb, Levels lvs) {
  __shared__ double s_scale;
  __shared__ float s_dx[kThreads * 3];
  __shared__ double s_win[kThreads];
  if (threadIdx.x < 32) {            // S from the prep blocks, fixed order
    double v = 0.0;
    for (int i = threadIdx.x; i < prep_blocks; i += 32) v += sums[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v += __shfl_xor_sync(0xffffffffu, v, o);
    }
    if (threadIdx.x == 0) {
      s_scale = fixed_scale(v);
      if (blockIdx.x == 0) sums[prep_blocks] = s_scale;
    }
  }
  __syncthreads();
  const double scale = s_scale;
  const int F = FC > 0 ? FC : f_dim;
  // (spb samples) x (levels) a block, the level fastest.
  const int s = threadIdx.x / levels, l = threadIdx.x - s * levels;
  const Level lv = lvs.lv[l];
  const float win = window != nullptr ? __ldg(window + l) : 1.0f;
  const bool feats = d_x != nullptr || window != nullptr;
  double dwin = 0.0;
  const int64_t tiles = (n + spb - 1) / spb;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t smp = tile * spb + s;
    const float* gp = g + (smp * levels + l) * F;
    float dx[3] = {0.0f, 0.0f, 0.0f};
    if (smp < n) {
      add_table_grad<FC>(lv, x + smp * 3, gp, win, f_dim, noise + smp * m,
                         m, acc, scale);
    }
    if (smp < n && feats) {          // the rows again, for d_x and d_window
      int base[3];
      float frac[3], wb[3];
      locate(x + smp * 3, lv.scale, base, frac);
      float out[FC > 0 ? FC : 1] = {};  // the un-windowed output (F = FC)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int64_t row = corner_row(lv, base, c);
        const float w = corner_weight(frac, c, wb);
        float gdot = 0.0f;
        for (int f = 0; f < F; ++f) {
          const float ft = __ldg(params + row * F + f);
          gdot = __fadd_rn(gdot, __fmul_rn(ft, __fmul_rn(__ldg(gp + f),
                                                         win)));
          if constexpr (FC > 0) out[f] = __fadd_rn(out[f], __fmul_rn(w, ft));
        }
        const float sgn0 = (c & 1) ? 1.0f : -1.0f;
        const float sgn1 = ((c >> 1) & 1) ? 1.0f : -1.0f;
        const float sgn2 = ((c >> 2) & 1) ? 1.0f : -1.0f;
        dx[0] = __fadd_rn(dx[0], __fmul_rn(__fmul_rn(gdot, __fmul_rn(
            __fmul_rn(sgn0, wb[1]), wb[2])), lv.scale));
        dx[1] = __fadd_rn(dx[1], __fmul_rn(__fmul_rn(gdot, __fmul_rn(
            __fmul_rn(sgn1, wb[0]), wb[2])), lv.scale));
        dx[2] = __fadd_rn(dx[2], __fmul_rn(__fmul_rn(gdot, __fmul_rn(
            __fmul_rn(sgn2, wb[0]), wb[1])), lv.scale));
      }
      if (window != nullptr) {       // the un-windowed output, dotted with g
        for (int f = 0; f < F; ++f) {
          float o;
          if constexpr (FC > 0) {
            o = out[f];
          } else {
            o = 0.0f;
            for (int c = 0; c < 8; ++c) {
              o = __fadd_rn(o, __fmul_rn(corner_weight(frac, c, wb), __ldg(
                  params + static_cast<int64_t>(corner_row(lv, base, c)) *
                               F + f)));
            }
          }
          dwin += static_cast<double>(__fmul_rn(o, __ldg(gp + f)));
        }
      }
    }
    if (d_x != nullptr) {            // sum the levels in level order
#pragma unroll
      for (int d = 0; d < 3; ++d) s_dx[threadIdx.x * 3 + d] = dx[d];
      __syncthreads();
      if (l == 0 && smp < n) {
        float sum[3] = {0.0f, 0.0f, 0.0f};
        for (int li = 0; li < levels; ++li) {
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            sum[d] = __fadd_rn(sum[d], s_dx[(threadIdx.x + li) * 3 + d]);
          }
        }
#pragma unroll
        for (int d = 0; d < 3; ++d) d_x[smp * 3 + d] = sum[d];
      }
      __syncthreads();
    }
  }
  if (window != nullptr) {           // this block's d_window, sample order
    s_win[threadIdx.x] = dwin;
    __syncthreads();
    if (s == 0) {
      double sum = 0.0;
      for (int si = 0; si < spb; ++si) sum += s_win[si * levels + l];
      win_part[static_cast<int64_t>(blockIdx.x) * levels + l] = sum;
    }
  }
}

// d_params = fixed-point table * 2^-k; d_window = the blocks' partials
// summed in block order.
__global__ void __launch_bounds__(kThreads)
hashgrid_bwd_finish_kernel(const long long* __restrict__ acc,
                           const double* __restrict__ scale_slot,
                           float* __restrict__ d_params, int64_t n_acc,
                           const double* __restrict__ win_part, int parts,
                           int levels, float* __restrict__ d_window) {
  const double inv = 1.0 / *scale_slot;   // a power of two, or NaN
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n_acc; i += stride) {
    d_params[i] = static_cast<float>(static_cast<double>(acc[i]) * inv);
  }
  if (d_window != nullptr && blockIdx.x == 0 && threadIdx.x < levels) {
    double sum = 0.0;
    for (int b = 0; b < parts; ++b) {
      sum += win_part[static_cast<int64_t>(b) * levels + threadIdx.x];
    }
    d_window[threadIdx.x] = static_cast<float>(sum);
  }
}

Levels unpack_levels(const void* table, int levels) {
  const uint32_t* t = static_cast<const uint32_t*>(table);
  Levels out = {};
  for (int l = 0; l < levels; ++l) {
    const uint32_t* row = t + 6 * l;
    Level& lv = out.lv[l];
    static_assert(sizeof(float) == sizeof(uint32_t), "fp32 bits");
    memcpy(&lv.scale, row, sizeof(float));
    lv.res = row[1];
    lv.offset = row[2];
    lv.mask = row[3];
    lv.salt = row[4];
    lv.dense = row[5];
  }
  return out;
}

unsigned blocks_for(int64_t threads, int64_t cap) {
  int64_t b = (threads + kThreads - 1) / kThreads;
  if (b > cap) b = cap;
  return static_cast<unsigned>(b < 1 ? 1 : b);
}

}  // namespace

// params: (n_params, f) fp32; x: (n, 3) fp32; window: (levels,) fp32 or
// null; out: (n, levels * f) fp32; all contiguous on the current device,
// params 8-byte aligned. table: host (levels, 6) uint32 rows {scale's fp32
// bits, res, offset, size - 1, salt, dense}, levels <= 32. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int hashgrid_fwd(const void* params, const void* x,
                            const void* window, void* out, long long n,
                            int levels, int f, const void* table,
                            void* stream) {
  if (levels < 1 || levels > kMaxLevels || f < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Levels lvs = unpack_levels(table, levels);
  const int64_t threads = static_cast<int64_t>(n) * levels;
  if (threads <= 0) return static_cast<int>(cudaSuccess);
  const unsigned blocks = blocks_for(threads, INT32_MAX);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(params);
  const float* xs = static_cast<const float*>(x);
  const float* win = static_cast<const float*>(window);
  float* o = static_cast<float*>(out);
  if (f == 2) {
    hashgrid_fwd_kernel<2><<<blocks, kThreads, 0, st>>>(p, xs, win, o, n,
                                                        levels, f, lvs);
  } else {
    hashgrid_fwd_kernel<0><<<blocks, kThreads, 0, st>>>(p, xs, win, o, n,
                                                        levels, f, lvs);
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward's three passes on `stream`. params, x, window as for the
// forward; g: (n, levels * f) fp32 contiguous; noise: (n, m) fp32 uniforms
// for the sampled-corner gradient when 0 < m < 8, else null with m = 0.
// Outputs: d_params (n_params, f) fp32; d_x (n, 3) fp32 or null to skip it;
// d_window (levels,) fp32, written when window is given. Scratch: acc
// (n_params, f) int64 (zeroed here), sums (prep_blocks + 1) fp64, win_part
// (blocks, levels) fp64 when window is given. spb samples a block, spb *
// levels <= 256; blocks walk the sample tiles in a fixed stride. Returns a
// cudaError_t.
extern "C" int hashgrid_bwd(const void* params, const void* x, const void* g,
                            const void* window, const void* noise, int m,
                            void* d_params, void* acc, void* sums,
                            void* win_part, void* d_x, void* d_window,
                            long long n, long long n_params, int levels,
                            int f, int spb, int blocks, int prep_blocks,
                            const void* table, void* stream) {
  if (levels < 1 || levels > kMaxLevels || f < 1 || spb < 1 ||
      spb * levels > kThreads || blocks < 1 || prep_blocks < 1 || m < 0 ||
      m >= 8 || (m > 0 && noise == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Levels lvs = unpack_levels(table, levels);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n_acc = static_cast<int64_t>(n_params) * f;
  const float* win = static_cast<const float*>(window);
  unsigned long long* fixed = static_cast<unsigned long long*>(acc);
  double* s = static_cast<double*>(sums);
  hashgrid_bwd_prep_kernel<<<prep_blocks, kThreads, 0, st>>>(
      static_cast<const float*>(g), win, static_cast<int64_t>(n) * levels * f,
      levels, f, fixed, n_acc, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* p = static_cast<const float*>(params);
  const float* xs = static_cast<const float*>(x);
  const float* gs = static_cast<const float*>(g);
  const float* u = static_cast<const float*>(noise);
  float* dx = static_cast<float*>(d_x);
  double* part = static_cast<double*>(win_part);
  if (f == 2) {
    hashgrid_bwd_scatter_kernel<2><<<blocks, spb * levels, 0, st>>>(
        p, xs, gs, win, u, m, fixed, s, prep_blocks, dx, part, n, levels, f,
        spb, lvs);
  } else {
    hashgrid_bwd_scatter_kernel<0><<<blocks, spb * levels, 0, st>>>(
        p, xs, gs, win, u, m, fixed, s, prep_blocks, dx, part, n, levels, f,
        spb, lvs);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  hashgrid_bwd_finish_kernel<<<blocks_for(n_acc, 132 * 16), kThreads, 0,
                               st>>>(
      static_cast<const long long*>(acc), s + prep_blocks,
      static_cast<float*>(d_params), n_acc, part, blocks, levels,
      win == nullptr ? nullptr : static_cast<float*>(d_window));
  return static_cast<int>(cudaGetLastError());
}
