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
// Both kernels put one level of 32 consecutive samples in a warp (a lane a
// sample). In training the samples arrive ray by ray (~13 consecutive
// samples a ray), so at the coarse levels, whose cells span several march
// steps, the lanes of a warp share cells and so corner rows.
//
// Forward (hashgrid_fwd_kernel): a block holds 32 samples; warp w computes
// levels w, w + 8, ... of them. Lanes that share a cell load the same 8-byte
// rows in one request, and at F = 2 so do lanes in adjacent cells: a lane
// loads its corners in the order of their vertex's parity (as the backward
// below visits them), then blends them in corner order. The block's
// (32, L*F) output tile goes through shared memory (row stride L*F | 1, so
// a warp's stores of one level hit 32 banks) and out as whole contiguous
// rows. What bounds it on Hopper: the bytes of
// x, of the output and of the distinct table rows the launch reads
// (PERF.md); the fine levels' 8 row loads a sample are random.
//
// Both kernels take an optional valid count in device memory (the
// trainer's capacity layout, a static buffer of N samples whose first
// count are real): the forward writes zeros past it, and the backward adds
// nothing from those samples (a warp wholly past it skips its levels) and
// writes their d_x as 0. A null count leaves the kernels as they were.
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
// * hashgrid_bwd_scatter_kernel: a warp holds 32 consecutive samples, a
//   lane a sample, and walks their L levels in order; blocks walk tiles of
//   spb samples in a fixed stride. A lane finds its 8
//   corner rows and weights as the forward does and rounds each update
//   w_c * g (or, given the per-sample uniforms and m < 8, the unweighted
//   g / m at m corners drawn by inverse CDF, min(count(cumsum(w) < u), 7))
//   to its integer. Then the warp merges equal rows before the atomics
//   (add_row): a run of consecutive lanes with the same row sums its
//   integers by a segmented suffix sum in shuffles, and the run's first
//   lane adds the sum, one RED a run and feature. Lanes past N take part
//   with the row kNoRow and add nothing. The exact gradient visits a lane's
//   corners in the order of their vertex's parity: round r takes corner
//   r ^ (base & 1) (per axis), the vertex base + (r ^ (base & 1)), whose
//   parity is r whatever the cell. So the cells that share a vertex, along
//   a ray the cells a few steps apart, offer its row in the same round, in
//   consecutive lanes, and merge across corners as well as across lanes.
//   Equal rows that are not adjacent (two rays through one cell) are not
//   merged: __match_any_sync would find them too, but it and the group's
//   shared-memory sum cost more SM time than the atomics they save (PERF.md,
//   PR 7).
//   Integer addition is exact and associative and every update is rounded
//   before any sum, so the table holds the same integers as with one atomic
//   an update: d_params is unchanged to the bit. Nor can a merge overflow:
//   a group's sum is a partial sum of one row's updates, bounded by the same
//   S * 2^k < 2^61 as the row's total. With d_x or a window the lane also
//   reads the 8 rows: d_x sums each level's part in registers in level
//   order, and the level's un-windowed output dotted with g goes into the
//   warp's fp64 d_window partial (lanes summed in sample order).
// * hashgrid_bwd_finish_kernel converts the table to fp32 and sums the
//   blocks' d_window partials in block order.
//
// What bounds the backward: at uniform random points the atomics, ~48G a
// second in L2 on an H100 (2.8 ms at 2^19 samples, 8 * L * F a sample),
// which the merge barely thins there. The merge issues one a run of equal
// rows (warp, level, round) and feature: on training's ray-ordered samples
// about a third of 8 * L * F, and the SM's own work (rows, weights, the
// updates' fp64 conversions, the shuffles) then weighs about as much as
// the atomics (PERF.md, PR 7). The fixed part, zeroing and reading the
// (rows, F) int64 table and writing d_params, is ~0.07 ms at 5.7M rows.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr uint32_t kPrime1 = 2654435761u, kPrime2 = 805459861u;
constexpr uint32_t kNoRow = 0xffffffffu;   // a lane past N (rows < 2^31)
constexpr unsigned kAll = 0xffffffffu;

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

// The cell's parity, bit d = base[d] & 1. Corner r ^ parity of the cell is
// its vertex of parity r (per axis, vertex mod 2), whichever of the up to 8
// cells around that vertex it is.
__device__ __forceinline__ int cell_parity(const int base[3]) {
  return (base[0] & 1) | (base[1] & 1) << 1 | (base[2] & 1) << 2;
}

// Row stride of the forward's output tile: odd, so that the 32 lanes of a
// warp, 32 rows apart, store to 32 different banks.
__host__ __device__ __forceinline__ int tile_ld(int width) {
  return width | 1;
}

template <int FC>
__global__ void __launch_bounds__(kThreads)
hashgrid_fwd_kernel(const float* __restrict__ params,
                    const float* __restrict__ x,
                    const float* __restrict__ window,
                    float* __restrict__ out, int64_t n, int levels,
                    int f_dim, Levels lvs,
                    const long long* __restrict__ n_valid) {
  extern __shared__ float tile[];    // (32, levels * F), row stride ld
  const int F = FC > 0 ? FC : f_dim;
  const int width = levels * F, ld = tile_ld(width);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * 32;
  // rows at or past the valid count are written as zeros
  int64_t nv = n;
  if (n_valid != nullptr && *n_valid < nv) nv = *n_valid;
  if (first >= nv) {
    const int64_t end = first + 32 < n ? first + 32 : n;
    for (int64_t i = first * width + threadIdx.x; i < end * width;
         i += kThreads) {
      out[i] = 0.0f;
    }
    return;
  }
  const bool live = first + lane < nv;
  // lanes past N redo sample n - 1; their rows are never stored
  const int64_t smp = first + lane < n ? first + lane : n - 1;
  for (int l = warp; l < levels; l += kWarps) {
    const Level lv = lvs.lv[l];
    int base[3];
    float frac[3], wb[3];
    locate(x + smp * 3, lv.scale, base, frac);
    float w[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) w[c] = corner_weight(frac, c, wb);
    float* dst = tile + lane * ld + l * F;
    if constexpr (FC == 2) {
      // load r takes the vertex of parity r, corner r ^ par, so that lanes
      // in adjacent cells read a shared vertex in the same request; then
      // conditional swaps put corner c's row at v[c] for the blend, which
      // runs in corner order
      const float2* p2 = reinterpret_cast<const float2*>(params);
      const int par = cell_parity(base);
      float2 v[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        v[r] = __ldg(p2 + corner_row(lv, base, r ^ par));
      }
#pragma unroll
      for (int b = 1; b < 8; b <<= 1) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if ((i & b) == 0) {
            const float2 lo = v[i], hi = v[i | b];
            v[i] = (par & b) ? hi : lo;
            v[i | b] = (par & b) ? lo : hi;
          }
        }
      }
      float2 acc = make_float2(0.0f, 0.0f);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        acc.x = __fadd_rn(acc.x, __fmul_rn(w[c], v[c].x));
        acc.y = __fadd_rn(acc.y, __fmul_rn(w[c], v[c].y));
      }
      if (window != nullptr) {
        const float wl = __ldg(window + l);
        acc.x = __fmul_rn(acc.x, wl);
        acc.y = __fmul_rn(acc.y, wl);
      }
      dst[0] = live ? acc.x : 0.0f;
      dst[1] = live ? acc.y : 0.0f;
    } else {
      uint32_t rows[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) rows[c] = corner_row(lv, base, c);
      for (int f = 0; f < f_dim; ++f) {
        float acc = 0.0f;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          acc = __fadd_rn(acc, __fmul_rn(w[c], __ldg(params +
              static_cast<int64_t>(rows[c]) * f_dim + f)));
        }
        if (window != nullptr) acc = __fmul_rn(acc, __ldg(window + l));
        dst[f] = live ? acc : 0.0f;
      }
    }
  }
  __syncthreads();
  // the tile's valid rows are one contiguous run of the output
  const int count = (n - first < 32 ? static_cast<int>(n - first) : 32) *
                    width;
  float* o = out + first * width;
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const int s = i / width;
    o[i] = tile[s * ld + (i - s * width)];
  }
}

// Sum of a block's values in a fixed order: a butterfly in each warp, then
// the warps' sums in warp order. Every thread of the block must call it.
template <typename T>
__device__ T block_sum(T v, T* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kAll, v, o);
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
                         double* __restrict__ sums,
                         const long long* __restrict__ n_valid) {
  __shared__ double scratch[kThreads / 32];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  for (int64_t i = t0; i < n_acc; i += stride) acc[i] = 0ull;
  // only the samples before the valid count add to S
  if (n_valid != nullptr && *n_valid * levels * f_dim < n_g) {
    n_g = *n_valid * levels * f_dim;
  }
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

__device__ __forceinline__ long long to_fixed(float v, double scale) {
  return __double2ll_rn(static_cast<double>(v) * scale);
}

// Add this lane's fixed-point updates of `row` (one a feature) to the
// table, merged: a run of consecutive lanes with the same row (a ray's
// samples in one cell, or in cells that share the vertex) sums its updates
// by a segmented suffix sum in shuffles, and the run's first lane adds the
// sum, one RED a run and feature. Lanes past N pass kNoRow and add
// nothing. Every lane of the warp must call it.
__device__ __forceinline__ void add_row(uint32_t row, const float* vals,
                                        int F, double scale,
                                        unsigned long long* acc) {
  const int lane = threadIdx.x & 31;
  const uint32_t prev = __shfl_up_sync(kAll, row, 1);
  const unsigned heads = __ballot_sync(kAll, lane == 0 || prev != row);
  // the lanes after this one in its run
  const unsigned after = lane == 31 ? 0u : heads >> (lane + 1);
  const int run = after == 0u ? 31 - lane : __ffs(after) - 1;
  const bool head = (heads >> lane) & 1u;
  for (int f = 0; f < F; ++f) {
    unsigned long long v =
        static_cast<unsigned long long>(to_fixed(vals[f], scale));
    if (heads != kAll) {             // a run longer than one lane
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned long long w = __shfl_down_sync(kAll, v, o);
        if (o <= run) v += w;
      }
    }
    if (head && row != kNoRow) {
      atomicAdd(acc + static_cast<int64_t>(row) * F + f, v);
    }
  }
}

// Features the backward takes; its kernels' FC is F = 2, or 0 for any F.
constexpr int kMaxF = 16;

// One level's table gradient of the warp's 32 samples (lane: sample sr,
// `valid` unless past N) into the fixed-point table: w_c * g at the 8
// corners, or with m > 0 g / m at m corners drawn by the uniforms. Writes
// the level's cell (base, frac) and g * window (gw). Every lane of the warp
// must call it.
template <int FC>
__device__ __forceinline__ void scatter_level(
    const Level& lv, const float* __restrict__ xs,
    const float* __restrict__ gp, float win,
    const float* __restrict__ noise, int m, int64_t sr, bool valid, int F,
    double scale, unsigned long long* acc,
    int base[3], float frac[3], float* gw) {
  float wb[3];
  for (int f = 0; f < F; ++f) gw[f] = __fmul_rn(__ldg(gp + f), win);
  locate(xs, lv.scale, base, frac);
  float vals[FC > 0 ? FC : kMaxF];
  if (m == 0) {
    // in round r the corner whose vertex has parity r: every cell of a
    // vertex takes it in the same round, so adjacent cells merge too
    const int par = cell_parity(base);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int c = r ^ par;
      const uint32_t row = valid ? corner_row(lv, base, c) : kNoRow;
      const float w = corner_weight(frac, c, wb);
      for (int f = 0; f < F; ++f) vals[f] = __fmul_rn(w, gw[f]);
      add_row(row, vals, F, scale, acc);
    }
    return;
  }
  float cumw[8];
  float sum = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    sum = __fadd_rn(sum, corner_weight(frac, c, wb));
    cumw[c] = sum;
  }
  for (int f = 0; f < F; ++f) {
    vals[f] = __fdiv_rn(gw[f], static_cast<float>(m));
  }
  for (int j = 0; j < m; ++j) {
    const float uj = __ldg(noise + sr * m + j);
    int cstar = 0;
#pragma unroll
    for (int c = 0; c < 8; ++c) cstar += cumw[c] < uj ? 1 : 0;
    const uint32_t row = valid ? corner_row(lv, base, min(cstar, 7)) : kNoRow;
    add_row(row, vals, F, scale, acc);
  }
}

// FEATS: d_x or d_window wanted. A warp holds 32 consecutive samples and
// walks their levels in order (d_x sums them in registers); blocks walk
// tiles of spb samples in a fixed stride.
template <int FC, bool FEATS>
__global__ void __launch_bounds__(kThreads)
hashgrid_bwd_scatter_kernel(
    const float* __restrict__ params, const float* __restrict__ x,
    const float* __restrict__ g, const float* __restrict__ window,
    const float* __restrict__ noise, int m,
    unsigned long long* __restrict__ acc, double* __restrict__ sums,
    int prep_blocks, float* __restrict__ d_x, double* __restrict__ win_part,
    int64_t n, int levels, int f_dim, int spb, Levels lvs,
    const long long* __restrict__ n_valid) {
  __shared__ double s_scale;
  __shared__ double s_win[kWarps][kMaxLevels];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x < 32) {            // S from the prep blocks, fixed order
    double v = 0.0;
    for (int i = threadIdx.x; i < prep_blocks; i += 32) v += sums[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kAll, v, o);
    if (threadIdx.x == 0) {
      s_scale = fixed_scale(v);
      if (blockIdx.x == 0) sums[prep_blocks] = s_scale;
    }
  }
  if (lane < kMaxLevels) s_win[warp][lane] = 0.0;
  __syncthreads();
  const double scale = s_scale;
  const int F = FC > 0 ? FC : f_dim;
  const int warps = spb >> 5;
  const int64_t tiles = (n + spb - 1) / spb;
  // samples at or past the valid count add nothing and get d_x 0
  int64_t nv = n;
  if (n_valid != nullptr && *n_valid < nv) nv = *n_valid;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t first = tile * spb + warp * 32;
    if (first >= n) continue;        // the whole warp past N
    const int64_t smp = first + lane;
    if (first >= nv) {               // the whole warp past the valid count
      if (FEATS && d_x != nullptr && smp < n) {
#pragma unroll
        for (int d = 0; d < 3; ++d) d_x[smp * 3 + d] = 0.0f;
      }
      continue;
    }
    const bool valid = smp < nv;
    const int64_t sr = smp < n ? smp : n - 1;   // a lane past N: any sample
    const float* xs = x + sr * 3;
    float dx[3] = {0.0f, 0.0f, 0.0f};
    for (int l = 0; l < levels; ++l) {
      const Level lv = lvs.lv[l];
      const float* gp = g + (sr * levels + l) * F;
      int base[3];
      float frac[3];
      float gw[FC > 0 ? FC : kMaxF];   // g * window, the table's cotangent
      scatter_level<FC>(lv, xs, gp,
                        window != nullptr ? __ldg(window + l) : 1.0f, noise,
                        m, sr, valid, F, scale, acc, base, frac, gw);
      if constexpr (!FEATS) continue;
      // the rows again, for d_x and d_window
      float wb[3];
      float dxl[3] = {0.0f, 0.0f, 0.0f};
      float out[FC > 0 ? FC : 1] = {};  // the un-windowed output (F = FC)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int64_t row = corner_row(lv, base, c);
        const float w = corner_weight(frac, c, wb);
        float gdot = 0.0f;
        for (int f = 0; f < F; ++f) {
          const float ft = __ldg(params + row * F + f);
          gdot = __fadd_rn(gdot, __fmul_rn(ft, gw[f]));
          if constexpr (FC > 0) out[f] = __fadd_rn(out[f], __fmul_rn(w, ft));
        }
        const float sgn0 = (c & 1) ? 1.0f : -1.0f;
        const float sgn1 = ((c >> 1) & 1) ? 1.0f : -1.0f;
        const float sgn2 = ((c >> 2) & 1) ? 1.0f : -1.0f;
        dxl[0] = __fadd_rn(dxl[0], __fmul_rn(__fmul_rn(gdot, __fmul_rn(
            __fmul_rn(sgn0, wb[1]), wb[2])), lv.scale));
        dxl[1] = __fadd_rn(dxl[1], __fmul_rn(__fmul_rn(gdot, __fmul_rn(
            __fmul_rn(sgn1, wb[0]), wb[2])), lv.scale));
        dxl[2] = __fadd_rn(dxl[2], __fmul_rn(__fmul_rn(gdot, __fmul_rn(
            __fmul_rn(sgn2, wb[0]), wb[1])), lv.scale));
      }
#pragma unroll
      for (int d = 0; d < 3; ++d) dx[d] = __fadd_rn(dx[d], dxl[d]);
      if (window != nullptr) {       // the un-windowed output, dotted with g
        double dwin = 0.0;
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
        dwin = valid ? dwin : 0.0;
        double total = 0.0;          // the warp's lanes in sample order
        for (int i = 0; i < 32; ++i) total += __shfl_sync(kAll, dwin, i);
        if (lane == 0) s_win[warp][l] += total;
      }
    }
    if (FEATS && d_x != nullptr && smp < n) {
#pragma unroll
      for (int d = 0; d < 3; ++d) d_x[smp * 3 + d] = valid ? dx[d] : 0.0f;
    }
  }
  if (FEATS && window != nullptr) {  // this block's d_window, warp order
    __syncthreads();
    if (threadIdx.x < levels) {
      double sum = 0.0;
      for (int w = 0; w < warps; ++w) sum += s_win[w][threadIdx.x];
      win_part[static_cast<int64_t>(blockIdx.x) * levels + threadIdx.x] = sum;
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

// The forward's dynamic shared memory: the (32, levels * f) tile.
constexpr int kMaxSmem = 232448;     // a block's most on an H100

size_t fwd_smem(int levels, int f) {
  return sizeof(float) * 32 * static_cast<size_t>(tile_ld(levels * f));
}

template <int FC>
int launch_fwd(const float* p, const float* xs, const float* win, float* o,
               long long n, int levels, int f, const Levels& lvs,
               const long long* n_valid, cudaStream_t st) {
  const size_t smem = fwd_smem(levels, f);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hashgrid_fwd_kernel<FC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>((n + 31) / 32);
  hashgrid_fwd_kernel<FC><<<blocks, kThreads, smem, st>>>(p, xs, win, o, n,
                                                         levels, f, lvs,
                                                         n_valid);
  return static_cast<int>(cudaGetLastError());
}

struct ScatterArgs {
  const float* params;
  const float* x;
  const float* g;
  const float* window;
  const float* noise;
  int m;
  unsigned long long* acc;
  double* sums;
  int prep_blocks;
  float* d_x;
  double* win_part;
  int64_t n;
  int levels, f_dim, spb;
  Levels lvs;
  const long long* n_valid;
};

template <int FC, bool FEATS>
cudaError_t launch_scatter(const ScatterArgs& a, int blocks,
                           cudaStream_t st) {
  hashgrid_bwd_scatter_kernel<FC, FEATS><<<blocks, a.spb, 0, st>>>(
      a.params, a.x, a.g, a.window, a.noise, a.m, a.acc, a.sums,
      a.prep_blocks, a.d_x, a.win_part, a.n, a.levels, a.f_dim, a.spb,
      a.lvs, a.n_valid);
  return cudaGetLastError();
}

}  // namespace

// params: (n_params, f) fp32; x: (n, 3) fp32; window: (levels,) fp32 or
// null; out: (n, levels * f) fp32; all contiguous on the current device,
// params 8-byte aligned. table: host (levels, 6) uint32 rows {scale's fp32
// bits, res, offset, size - 1, salt, dense}, levels <= 32, and a 32-sample
// output tile, 32 * (levels * f | 1) fp32, of at most 227 KB. n_valid:
// null, or one int64 on the device, the valid count: rows at or past it are
// written as zeros. Launches on `stream` and returns cudaGetLastError().
extern "C" int hashgrid_fwd(const void* params, const void* x,
                            const void* window, void* out, long long n,
                            int levels, int f, const void* table,
                            const void* n_valid, void* stream) {
  if (levels < 1 || levels > kMaxLevels || f < 1 ||
      fwd_smem(levels, f) > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const Levels lvs = unpack_levels(table, levels);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(params);
  const float* xs = static_cast<const float*>(x);
  const float* win = static_cast<const float*>(window);
  float* o = static_cast<float*>(out);
  const long long* nv = static_cast<const long long*>(n_valid);
  return f == 2 ? launch_fwd<2>(p, xs, win, o, n, levels, f, lvs, nv, st)
                : launch_fwd<0>(p, xs, win, o, n, levels, f, lvs, nv, st);
}

// The backward's three passes on `stream`. params, x, window as for the
// forward; g: (n, levels * f) fp32 contiguous; noise: (n, m) fp32 uniforms
// for the sampled-corner gradient when 0 < m < 8, else null with m = 0.
// Outputs: d_params (n_params, f) fp32; d_x (n, 3) fp32 or null to skip it;
// d_window (levels,) fp32, written when window is given. Scratch: acc
// (n_params, f) int64 (zeroed here), sums (prep_blocks + 1) fp64, win_part
// (blocks, levels) fp64 when window is given. spb samples a block (a
// multiple of 32, at most 256: a warp a 32 samples), f <= 16; blocks walk
// the sample tiles in a fixed stride. n_valid: null, or one int64 on the
// device, the valid count: samples at or past it add nothing to d_params or
// d_window and get d_x 0. Returns a cudaError_t.
extern "C" int hashgrid_bwd(const void* params, const void* x, const void* g,
                            const void* window, const void* noise, int m,
                            void* d_params, void* acc, void* sums,
                            void* win_part, void* d_x, void* d_window,
                            long long n, long long n_params, int levels,
                            int f, int spb, int blocks, int prep_blocks,
                            const void* table, const void* n_valid,
                            void* stream) {
  if (levels < 1 || levels > kMaxLevels || f < 1 || f > kMaxF ||
      spb < 32 || spb % 32 != 0 || spb > kThreads || blocks < 1 ||
      prep_blocks < 1 || m < 0 || m >= 8 || (m > 0 && noise == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Levels lvs = unpack_levels(table, levels);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n_acc = static_cast<int64_t>(n_params) * f;
  const float* win = static_cast<const float*>(window);
  unsigned long long* fixed = static_cast<unsigned long long*>(acc);
  double* s = static_cast<double*>(sums);
  const long long* nv = static_cast<const long long*>(n_valid);
  hashgrid_bwd_prep_kernel<<<prep_blocks, kThreads, 0, st>>>(
      static_cast<const float*>(g), win, static_cast<int64_t>(n) * levels * f,
      levels, f, fixed, n_acc, s, nv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* p = static_cast<const float*>(params);
  const float* xs = static_cast<const float*>(x);
  const float* gs = static_cast<const float*>(g);
  const float* u = static_cast<const float*>(noise);
  float* dx = static_cast<float*>(d_x);
  double* part = static_cast<double*>(win_part);
  const ScatterArgs a = {p, xs, gs, win, u, m, fixed, s, prep_blocks, dx,
                         part, n, levels, f, spb, lvs, nv};
  const bool feats = dx != nullptr || win != nullptr;
  if (f == 2) {
    err = feats ? launch_scatter<2, true>(a, blocks, st)
                : launch_scatter<2, false>(a, blocks, st);
  } else {
    err = feats ? launch_scatter<0, true>(a, blocks, st)
                : launch_scatter<0, false>(a, blocks, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  hashgrid_bwd_finish_kernel<<<blocks_for(n_acc, 132 * 16), kThreads, 0,
                               st>>>(
      static_cast<const long long*>(acc), s + prep_blocks,
      static_cast<float*>(d_params), n_acc, part, blocks, levels,
      win == nullptr ? nullptr : static_cast<float*>(d_window));
  return static_cast<int>(cudaGetLastError());
}
