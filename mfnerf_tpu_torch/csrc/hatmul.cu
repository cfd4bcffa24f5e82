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
//
// The fp32 mode (the JAX lr_matmul_dtype="float32", _hat_cp_prod with
// mm_dtype float32) is the same kernel instantiated for float W: a thread's
// 8 columns of a row are two 16-byte loads, and the hat weights are not
// rounded. Products then round in fp32, so the result equals the dense
// fp32 form up to that rounding and the order of the sums.
//
// Both directions take an optional valid count in device memory (the
// trainer's capacity layout: a static buffer of N samples, of which the
// first count are real, so that a CUDA graph can capture the step). Rows at
// or past it write zeros and add nothing; the backward's chunks stay those
// of N, so dW's order of sums does not depend on the count. A null count
// leaves the kernels as they were.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;        // columns per thread: 8 bf16 = one 16-byte load
constexpr int kThreads = 256;  // threads per block

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The operand type T of W, the hat weights and g_d: bf16 (the default mode)
// or float (the fp32 mode). Pair holds two consecutive columns of a W row,
// and g_d of two samples of one column in the backward's ring; Slots is the
// backward's ring depth (see bwd_smem_bytes).
template <typename T>
struct Hat;

template <>
struct Hat<__nv_bfloat16> {
  using Pair = uint32_t;                 // a bf16 pair
  static constexpr int kSlots = 4;
  static __device__ __forceinline__ float operand(float x) {
    return round_bf16(x);
  }
  static __device__ __forceinline__ float2 unpack(Pair p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&p));
  }
  static __device__ __forceinline__ Pair pack(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const Pair*>(&h);
  }
  // kVec columns of a row: one 16-byte load
  static __device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                                  float* v) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec / 2; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  }
  // two Pairs (two columns) at dst, 8-byte aligned: one store
  static __device__ __forceinline__ void store2(Pair* dst, Pair a, Pair b) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(a, b);
  }
};

template <>
struct Hat<float> {
  using Pair = float2;
  // two slots keep the fp32 ring at the bf16 ring's 12,288 bytes, and so
  // two blocks an SM at K = 257 (bwd_smem_bytes)
  static constexpr int kSlots = 2;
  static __device__ __forceinline__ float operand(float x) { return x; }
  static __device__ __forceinline__ float2 unpack(Pair p) { return p; }
  static __device__ __forceinline__ Pair pack(float a, float b) {
    return make_float2(a, b);
  }
  // kVec columns of a row: two 16-byte loads
  static __device__ __forceinline__ void load_row(const float* p, float* v) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
  // two Pairs at dst, 16-byte aligned: one store
  static __device__ __forceinline__ void store2(Pair* dst, Pair a, Pair b) {
    *reinterpret_cast<float4*>(dst) = make_float4(a.x, a.y, b.x, b.y);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
hat_prod_fwd_kernel(const float* __restrict__ u3, const T* __restrict__ w,
                    float* __restrict__ out, int n, int k, int r,
                    const long long* __restrict__ n_valid) {
  const int lanes = r / kVec;  // threads per sample
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t s = tid / lanes;
  if (s >= n) return;
  const int c0 = static_cast<int>(tid - s * lanes) * kVec;
  if (n_valid != nullptr && s >= *n_valid) {   // past the valid count: zeros
    float4* dst = reinterpret_cast<float4*>(out + s * r + c0);
    dst[0] = dst[1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }
  const float scale = static_cast<float>(k - 1);

  float acc[kVec];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = u3[s * 3 + d] * scale;
    int i = static_cast<int>(floorf(pos));
    i = min(max(i, 0), k - 2);
    const float w0 =
        Hat<T>::operand(fmaxf(0.0f, 1.0f - fabsf(pos - (float)i)));
    const float w1 =
        Hat<T>::operand(fmaxf(0.0f, 1.0f - fabsf(pos - (float)(i + 1))));
    const T* row = w + (static_cast<int64_t>(d) * k + i) * r + c0;
    float r0[kVec], r1[kVec];
    Hat<T>::load_row(row, r0);
    Hat<T>::load_row(row + r, r1);
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
// The TPU kernel accumulates dW into one output block that its sequential
// grid revisits, so its sums run in one fixed order. Hopper's blocks run in
// parallel, and a scatter with global float atomics adds in another order
// on every launch. Here dW is bitwise deterministic and no atomics are
// used, in two stages.
//
// Stage 1 (hat_prod_bwd_slab_kernel). The grid is (column tile of 32) x
// (sample chunk). Each block keeps a private fp32 slab of dW for its 32
// columns, 3 axes and all K rows in shared memory (3 * K * 32 * 4 bytes,
// 98.7 KB at K = 257: two blocks an SM). Its warps are specialised:
//
// * 3 walker warps own the slab: warp d owns axis d and lane c column c,
//   so every slab column has exactly one writer, which walks the chunk's
//   samples in order; program order fixes the order of the sums. A lane
//   keeps the two rows it last touched, (row, row + 1), and their running
//   sums in registers and writes to the slab only when a sample's rows
//   differ (run-length merging: the samples of one ray sit at neighbouring
//   positions). A walker only reads, adds and writes shared memory.
// * 4 producer warps compute g_d for 16 samples a step, 4 each; a lane
//   takes two adjacent columns of two samples. They find the hat rows and
//   weights from u, a_0..a_2 from two bf16 rows of each W_d (L2 hits, one
//   4-byte load a row and column pair), read g in place through its row
//   stride (the column slice of the (N, 2R) feature gradient needs no
//   copy), round g_d to bf16, and sum the partial du of each (sample,
//   axis) over the tile's 32 columns in a fixed order. u and g are loaded
//   two steps ahead and the W rows one step ahead.
//
// They meet in a ring of 4 steps in shared memory (the rows and weights,
// and g_d as bf16 pairs), handed over with named barriers: a slot is full
// when the producers have arrived, empty when the walkers have read it.
//
// The fp32 mode instantiates stage 1 for float W: a producer lane reads a
// W row's two columns as one 8-byte load, g_d stays fp32 (g * a_e * a_f,
// not rounded), and the ring carries it as float pairs, 8 bytes a sample
// pair and column. The ring keeps 2 steps instead of 4, so that it stays
// 12,288 bytes and two blocks still fit an SM at K = 257 (a 4-step fp32
// ring, 24,576 bytes, would leave one); K <= 569.
//
// Stage 2 (hat_prod_bwd_reduce_kernel) adds the chunks' slabs in chunk order
// into dW, writing every element, and the tiles' partial du in tile order,
// times K-1 (0 on the knots).
//
// a_d and g_d are recomputed exactly as the forward kernel computes them
// (bf16 hat weights and rows, fp32 products and sums), and w * g_d is exact
// in fp32, so each sample's contribution equals the dense form's. Only the
// order of the fp32 sums differs from it, and that order depends on N and R
// alone (the caller's chunking), never on the launch.
//
// What bounds it on Hopper: the bytes it must move are g (R fp32 a sample,
// 268 MB at N = 2^19 and R = 128, 80 us of HBM time), u and du. The slab's
// size caps a block's residency at two an SM, 14 warps, and at that
// occupancy the producers' instruction stream is issue- and latency-bound
// well before the bytes are (PERF.md has the times); the walkers add
// shared-memory round trips where rows change every sample.

constexpr int kBwdCols = 32;      // columns a block: one a lane
constexpr int kBwdStage = 16;     // samples a step
constexpr int kWalkers = 3;       // warps: one an axis, the slab's writers
constexpr int kProducers = 4;     // warps computing g_d
constexpr int kPerProducer = kBwdStage / kProducers;   // samples a step
static_assert(kPerProducer == 4, "a producer lane takes 2 of 4 samples");
constexpr int kBwdThreads = 32 * (kWalkers + kProducers);
constexpr int kReduceThreads = 256;

// shared memory of stage 1: the hat rows and weights {row, w0, w1, -} of
// (slot, axis, sample); g_d as Pairs of (slot, axis, sample pair, column);
// the slab (3, k, 32). bf16: 15,360 + 384 k bytes; fp32: 13,824 + 384 k.
// An SM's 233,472 bytes, less 1 KB a block, hold two blocks up to K = 261
// (bf16) or 265 (fp32); the opt-in limit a block, 232,448 bytes, allows one
// up to K = 565 (bf16) or 569 (fp32).
template <typename T>
size_t bwd_smem_bytes(int k) {
  constexpr int slots = Hat<T>::kSlots;
  return sizeof(float4) * slots * 3 * kBwdStage
         + sizeof(typename Hat<T>::Pair) * slots * 3 * (kBwdStage / 2)
               * kBwdCols
         + sizeof(float) * 3 * static_cast<size_t>(k) * kBwdCols;
}

// Named barriers (0 is __syncthreads): slot j is full at 1 + j, empty at
// 1 + slots + j; every thread of the block takes part in each.
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(kBwdThreads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(kBwdThreads) : "memory");
}

// One step of a fixed-order sum over the warp: each lane keeps H of its 2H
// values and adds its partner's (lane ^ 2H) copy of them.
template <int H>
__device__ __forceinline__ void halve(float* v, int lane) {
  const bool hi = lane & (2 * H);
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float send = hi ? v[j] : v[j + H];
    const float keep = hi ? v[j + H] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * H);
  }
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads, 2)
hat_prod_bwd_slab_kernel(const float* __restrict__ u3,
                         const T* __restrict__ w,
                         const float* __restrict__ g, int64_t ldg,
                         float* __restrict__ slabs, float* __restrict__ part,
                         int n, int k, int r, int chunk,
                         const long long* __restrict__ n_valid) {
  using H = Hat<T>;
  using Pair = typename H::Pair;
  constexpr int kBwdSlots = H::kSlots;   // steps the producers may run ahead
  extern __shared__ float4 smem4[];
  float4* par = smem4;
  Pair* ring = reinterpret_cast<Pair*>(par + kBwdSlots * 3 * kBwdStage);
  float* slab = reinterpret_cast<float*>(
      ring + kBwdSlots * 3 * (kBwdStage / 2) * kBwdCols);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tile = blockIdx.x;
  const int col0 = tile * kBwdCols;
  const int col = col0 + lane;
  const bool live = col < r;
  // samples at or past the valid count add nothing: a chunk ends there
  int64_t nv = n;
  if (n_valid != nullptr && *n_valid < nv) nv = *n_valid;
  const int64_t begin = static_cast<int64_t>(blockIdx.y) * chunk;
  const int64_t end = begin + chunk < nv ? begin + chunk : nv;
  const int steps = end > begin
      ? static_cast<int>((end - begin + kBwdStage - 1) / kBwdStage) : 0;
  const float scale = static_cast<float>(k - 1);

  for (int q = threadIdx.x; q < 3 * k * kBwdCols; q += kBwdThreads) {
    slab[q] = 0.0f;
  }
  __syncthreads();

  if (warp >= kWalkers) {
    // ---- producer: samples t0 .. t0 + 3 of every step. Lane 16h + c
    // computes columns col0 + 2c and + 1 of samples t0 + 2h and + 1, so
    // that one 4-byte load brings a W row's two columns and one 8-byte load
    // g's. u and g are loaded two steps ahead, and the W rows of step s + 1
    // are requested before step s is computed, so that neither HBM's nor
    // L2's latency stalls the step. A sample past the chunk's end takes the
    // last sample's u and a zero g and weights, so it changes nothing.
    const int t0 = (warp - kWalkers) * kPerProducer;
    const int c2 = lane % 16, h = lane / 16;
    const int pc = col0 + 2 * c2;       // the lane's first column
    const bool live2 = pc < r;          // r % 8 == 0: both columns or none
    const int lp = (live2 ? pc : col0) / 2;   // a dead pair reads a live one
    const int r2 = r / 2;
    const Pair* w2 = reinterpret_cast<const Pair*>(w);   // column pairs
    struct Ahead {            // u of (t0 + lane / 3, lane % 3); g of 2 rows
      float u;
      float2 g[2];
    };
    struct Rows {             // this lane's 2 samples x 3 axes
      Pair lo[2][3], hi[2][3];       // W rows i and i+1, 2 columns each
      float w0[2][3], w1[2][3];
    };
    auto load = [&](int step, Ahead& out) {
      const int64_t s0 = begin + static_cast<int64_t>(step) * kBwdStage;
      const int64_t cnt = end - s0 < kBwdStage ? end - s0 : kBwdStage;
      out.u = 0.0f;
      if (lane < 3 * kPerProducer) {
        const int64_t t = t0 + lane / 3;
        out.u = u3[(s0 + (t < cnt ? t : cnt - 1)) * 3 + lane % 3];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int t = t0 + 2 * h + j;
        out.g[j] = live2 && t < cnt
            ? *reinterpret_cast<const float2*>(g + (s0 + t) * ldg + pc)
            : make_float2(0.0f, 0.0f);
      }
    };
    // the hat rows and weights of step `step` into its slot; then this
    // lane's weights and W rows of each (sample, axis) into `out`
    auto stage = [&](int step, float u, Rows& out) {
      const int slot = step % kBwdSlots;
      const int64_t s0 = begin + static_cast<int64_t>(step) * kBwdStage;
      const int64_t cnt = end - s0 < kBwdStage ? end - s0 : kBwdStage;
      float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (lane < 3 * kPerProducer) {
        const bool in = t0 + lane / 3 < cnt;
        const float pos = u * scale;
        const int i = min(max(static_cast<int>(floorf(pos)), 0), k - 2);
        q = make_float4(
            __int_as_float(i),
            in ? H::operand(fmaxf(0.0f, 1.0f - fabsf(pos - (float)i)))
               : 0.0f,
            in ? H::operand(fmaxf(0.0f, 1.0f - fabsf(pos - (float)(i + 1))))
               : 0.0f,
            0.0f);
      }
      if (step >= kBwdSlots) bar_sync(1 + kBwdSlots + slot);   // empty
      float4* sp = par + slot * 3 * kBwdStage;
      if (lane < 3 * kPerProducer) {
        sp[(lane % 3) * kBwdStage + t0 + lane / 3] = q;
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float4 pq = sp[a * kBwdStage + t0 + 2 * h + j];
          const Pair* p =
              w2 + (static_cast<int64_t>(a) * k + __float_as_int(pq.x)) * r2
              + lp;
          out.lo[j][a] = p[0];
          out.hi[j][a] = p[r2];
          out.w0[j][a] = pq.y;
          out.w1[j][a] = pq.z;
        }
      }
    };
    auto body = [&](int step, Ahead& a_now, Ahead& a_next, Rows& rw,
                    Rows& rw_next) {
      const int slot = step % kBwdSlots;
      const int64_t s0 = begin + static_cast<int64_t>(step) * kBwdStage;
      const int64_t cnt = end - s0 < kBwdStage ? end - s0 : kBwdStage;
      if (step + 1 < steps) stage(step + 1, a_next.u, rw_next);
      const float2 gv[2] = {a_now.g[0], a_now.g[1]};
      if (step + 2 < steps) load(step + 2, a_now);
      // g_d = T(g * a_e * a_f), a as the forward computes it; the du
      // product sum_c g_d[c] (W_d[i+1, c] - W_d[i, c]) of the lane's two
      // columns at v[2d + j]
      float gd[2][3][2], v[8];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float av[3][2], df[3][2];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float2 lo = H::unpack(rw.lo[j][a]);
          const float2 hi = H::unpack(rw.hi[j][a]);
          av[a][0] = rw.w0[j][a] * lo.x + rw.w1[j][a] * hi.x;
          av[a][1] = rw.w0[j][a] * lo.y + rw.w1[j][a] * hi.y;
          df[a][0] = hi.x - lo.x;
          df[a][1] = hi.y - lo.y;
        }
        const float gc[2] = {gv[j].x, gv[j].y};
#pragma unroll
        for (int d = 0; d < 3; ++d) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            gd[j][d][c] =
                H::operand(gc[c] * av[(d + 1) % 3][c] * av[(d + 2) % 3][c]);
          }
          v[2 * d + j] = gd[j][d][0] * df[d][0] + gd[j][d][1] * df[d][1];
        }
      }
      v[6] = v[7] = 0.0f;
      // g_d of samples (t0 + 2h, + 1) as one Pair a column
      Pair* rs = ring + slot * 3 * (kBwdStage / 2) * kBwdCols;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        H::store2(rs + (d * (kBwdStage / 2) + t0 / 2 + h) * kBwdCols + 2 * c2,
                  H::pack(gd[0][d][0], gd[1][d][0]),
                  H::pack(gd[0][d][1], gd[1][d][1]));
      }
      bar_arrive(1 + slot);                                     // full
      if (part != nullptr) {
        // partial du of (sample, axis): the sum of v over the 16 lanes of
        // this half-warp, in a fixed order
        halve<4>(v, lane);       // lanes ^ 8, ^ 4, ^ 2: a value each
        halve<2>(v, lane);
        halve<1>(v, lane);
        v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1);
        const int q = ((lane >> 3) & 1) * 4 + ((lane >> 2) & 1) * 2
                      + ((lane >> 1) & 1);
        const int t = t0 + 2 * h + q % 2;
        if ((lane & 1) == 0 && q < 6 && t < cnt) {
          part[(static_cast<int64_t>(tile) * n + s0 + t) * 3 + q / 2] = v[0];
        }
      }
    };

    Ahead a0{}, a1{};
    Rows rw0{}, rw1{};
    if (steps > 0) load(0, a0);
    if (steps > 1) load(1, a1);
    if (steps > 0) stage(0, a0.u, rw0);
    for (int step = 0; step < steps; step += 2) {   // buffers alternate
      body(step, a0, a1, rw0, rw1);
      if (step + 1 < steps) body(step + 1, a1, a0, rw1, rw0);
    }
    return;
  }

  // ---- walker: axis d, column col; the run-length slab walk
  const int d = warp;
  int cur = -2;                  // acc0, acc1 hold rows cur and cur + 1
  float acc0 = 0.0f, acc1 = 0.0f;
  float* mine = slab + d * k * kBwdCols + lane;   // row stride kBwdCols
  for (int step = 0; step < steps; ++step) {
    const int slot = step % kBwdSlots;
    bar_sync(1 + slot);                                         // full
    const float4* sp = par + (slot * 3 + d) * kBwdStage;
    int rows[kBwdStage];
    float w0[kBwdStage], w1[kBwdStage], gd[kBwdStage];
#pragma unroll
    for (int t = 0; t < kBwdStage; ++t) {
      const float4 q = sp[t];
      rows[t] = __float_as_int(q.x);
      w0[t] = q.y;
      w1[t] = q.z;
    }
    const Pair* rs =
        ring + (slot * 3 + d) * (kBwdStage / 2) * kBwdCols + lane;
#pragma unroll
    for (int m = 0; m < kBwdStage / 2; ++m) {
      const float2 pair = H::unpack(rs[m * kBwdCols]);
      gd[2 * m] = pair.x;
      gd[2 * m + 1] = pair.y;
    }
    if (step + kBwdSlots < steps) bar_arrive(1 + kBwdSlots + slot);  // empty
    // A sample whose row differs from cur writes the window's rows out
    // (adding 0 to a row that stays in the window leaves it unchanged);
    // the branch is the same for the whole warp (the row is the sample's).
#pragma unroll
    for (int t = 0; t < kBwdStage; ++t) {
      const int i = rows[t];
      if (i != cur) {
        const bool up = i == cur + 1, down = i == cur - 1;
        const int lo = cur < 0 ? 0 : cur;   // no window yet: add 0 to row 0
        const float v0 = mine[lo * kBwdCols];
        const float v1 = mine[(lo + 1) * kBwdCols];
        mine[lo * kBwdCols] = v0 + (down ? 0.0f : acc0);
        mine[(lo + 1) * kBwdCols] = v1 + (up ? 0.0f : acc1);
        const float keep0 = up ? acc1 : 0.0f;
        acc1 = down ? acc0 : 0.0f;
        acc0 = keep0;
        cur = i;
      }
      acc0 += w0[t] * gd[t];
      acc1 += w1[t] * gd[t];
    }
  }
  if (cur >= 0) {
    mine[cur * kBwdCols] += acc0;
    mine[(cur + 1) * kBwdCols] += acc1;
  }
  if (live) {                    // each lane writes out its own column
    float* out = slabs + (static_cast<int64_t>(blockIdx.y) * 3 + d) * k * r
                 + col;
    for (int row = 0; row < k; ++row) {
      out[static_cast<int64_t>(row) * r] = mine[row * kBwdCols];
    }
  }
}

__global__ void __launch_bounds__(kReduceThreads)
hat_prod_bwd_reduce_kernel(const float* __restrict__ slabs, int chunks,
                           float* __restrict__ dw, int64_t dw_size,
                           const float* __restrict__ u3,
                           const float* __restrict__ part, int tiles,
                           float* __restrict__ du, int n, int k,
                           const long long* __restrict__ n_valid) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (j < dw_size) {
    float s = 0.0f;
#pragma unroll 8
    for (int c = 0; c < chunks; ++c) s += slabs[c * dw_size + j];
    dw[j] = s;
  }
  if (du != nullptr && j < 3 * static_cast<int64_t>(n)) {
    if (n_valid != nullptr && j / 3 >= *n_valid) {   // stage 1 skipped it
      du[j] = 0.0f;
      return;
    }
    const float scale = static_cast<float>(k - 1);
    const float pos = u3[j] * scale;
    float s = 0.0f;
    for (int t = 0; t < tiles; ++t) {
      s += part[t * 3 * static_cast<int64_t>(n) + j];
    }
    // dhat is -(K-1) at row i and +(K-1) at row i+1 between knots
    du[j] = pos == floorf(pos) ? 0.0f : scale * s;
  }
}


template <typename T>
int launch_fwd(const void* u3, const void* w, void* out, int n, int k, int r,
               const void* n_valid, void* stream) {
  const int64_t threads = static_cast<int64_t>(n) * (r / kVec);
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0) {
    hat_prod_fwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(u3), static_cast<const T*>(w),
        static_cast<float*>(out), n, k, r,
        static_cast<const long long*>(n_valid));
  }
  return static_cast<int>(cudaGetLastError());
}

constexpr int kMaxDevices = 64;

// Stage 1's function attributes, set once a device: the dynamic shared
// memory up to the block's opt-in limit, and all of the SM's shared memory
// (two blocks). Later launches, those captured into a CUDA graph among
// them, only read the limit. Returns a cudaError_t.
template <typename T>
cudaError_t bwd_optin(size_t* limit) {
  static int optin[kMaxDevices] = {};    // 0: not yet set on that device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (optin[dev] == 0) {
    int bytes = 0;
    err = cudaDeviceGetAttribute(
        &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(hat_prod_bwd_slab_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bytes);
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          hat_prod_bwd_slab_kernel<T>,
          cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return err;
    optin[dev] = bytes;
  }
  *limit = static_cast<size_t>(optin[dev]);
  return cudaSuccess;
}

template <typename T>
int launch_bwd(const void* u3, const void* w, const void* g, long long ldg,
               void* du, void* dw, void* slabs, void* part, int n, int k,
               int r, int chunk, int chunks, const void* n_valid,
               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = bwd_smem_bytes<T>(k);
  size_t limit = 0;
  cudaError_t err = bwd_optin<T>(&limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > limit) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const int tiles = (r + kBwdCols - 1) / kBwdCols;
  float* part_f = du == nullptr ? nullptr : static_cast<float*>(part);
  const long long* nv = static_cast<const long long*>(n_valid);
  hat_prod_bwd_slab_kernel<T><<<dim3(tiles, chunks), kBwdThreads, smem, st>>>(
      static_cast<const float*>(u3), static_cast<const T*>(w),
      static_cast<const float*>(g), static_cast<int64_t>(ldg),
      static_cast<float*>(slabs), part_f, n, k, r, chunk, nv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t dw_size = static_cast<int64_t>(3) * k * r;
  const int64_t du_size = du == nullptr ? 0 : static_cast<int64_t>(3) * n;
  const int64_t m = dw_size > du_size ? dw_size : du_size;
  const int64_t blocks = (m + kReduceThreads - 1) / kReduceThreads;
  hat_prod_bwd_reduce_kernel<<<static_cast<unsigned>(blocks), kReduceThreads,
                               0, st>>>(
      static_cast<const float*>(slabs), chunks, static_cast<float*>(dw),
      dw_size, static_cast<const float*>(u3), part_f, tiles,
      static_cast<float*>(du), n, k, nv);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int blocks_per_sm(int k) {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, hat_prod_bwd_slab_kernel<T>, kBwdThreads,
          bwd_smem_bytes<T>(k)) != cudaSuccess) {
    return -1;
  }
  return blocks;
}

}  // namespace

// u3: (n, 3) fp32; w: (3, k, r) bf16 (hat_prod_fwd) or fp32
// (hat_prod_fwd_f32); out: (n, r) fp32, all contiguous on the current
// device; r a multiple of 8, k >= 2, pointers 16-byte aligned. n_valid: null,
// or one int64 on the device, the valid count: rows at or past it are
// written as zeros. Launches on `stream` and returns cudaGetLastError().
extern "C" int hat_prod_fwd(const void* u3, const void* w, void* out, int n,
                            int k, int r, const void* n_valid,
                            void* stream) {
  return launch_fwd<__nv_bfloat16>(u3, w, out, n, k, r, n_valid, stream);
}

extern "C" int hat_prod_fwd_f32(const void* u3, const void* w, void* out,
                                int n, int k, int r, const void* n_valid,
                                void* stream) {
  return launch_fwd<float>(u3, w, out, n, k, r, n_valid, stream);
}

// The backward, both stages, on `stream`. u3: (n, 3) fp32 and w: (3, k, r)
// bf16 (hat_prod_bwd) or fp32 (hat_prod_bwd_f32), contiguous; g: (n, r) fp32
// with row stride ldg floats (a multiple of 4) and unit column stride,
// 16-byte aligned; dw: (3, k, r) fp32; du: (n, 3) fp32, or null to skip du;
// scratch, all fp32: slabs (chunks, 3, k, r), and with du part
// (ceil(r / 32), n, 3). Samples [c * chunk, (c + 1) * chunk) form chunk c;
// chunks * chunk >= n. r a multiple of 8, k >= 2, bwd_smem_bytes(k) within
// the block's opt-in limit (k <= 565 bf16, 569 fp32 on H100). n_valid: null,
// or one int64 on the device: samples at or past it add nothing to dw and
// get du 0 (the chunks stay those of n, so dw's order does not depend on
// it). Nothing needs zeroing: stage 2 writes every element of dw and du.
// Returns a cudaError_t: a refused launch, or cudaErrorInvalidValue for a
// slab too large.
extern "C" int hat_prod_bwd(const void* u3, const void* w, const void* g,
                            long long ldg, void* du, void* dw, void* slabs,
                            void* part, int n, int k, int r, int chunk,
                            int chunks, const void* n_valid, void* stream) {
  return launch_bwd<__nv_bfloat16>(u3, w, g, ldg, du, dw, slabs, part, n, k,
                                   r, chunk, chunks, n_valid, stream);
}

extern "C" int hat_prod_bwd_f32(const void* u3, const void* w, const void* g,
                                long long ldg, void* du, void* dw,
                                void* slabs, void* part, int n, int k, int r,
                                int chunk, int chunks, const void* n_valid,
                                void* stream) {
  return launch_bwd<float>(u3, w, g, ldg, du, dw, slabs, part, n, k, r,
                           chunk, chunks, n_valid, stream);
}

// Stage 1's resident blocks an SM at K knots on the current device (after
// a launch has set its attributes), or -1 on an error.
extern "C" int hat_prod_bwd_blocks_per_sm(int k) {
  return blocks_per_sm<__nv_bfloat16>(k);
}

extern "C" int hat_prod_bwd_blocks_per_sm_f32(int k) {
  return blocks_per_sm<float>(k);
}
