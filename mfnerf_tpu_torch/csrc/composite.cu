// Volume compositing over padded (N, S) sample rows: the training forward,
// its analytic backward and the serving loop's compositing round — CUDA C++
// for sm_90a.
//
// Replaces XLA functions, not Pallas kernels: mfnerf_tpu/ops/composite.py::
// composite_train (:35, differentiated there by JAX autodiff through
// jnp.cumprod) and ::composite_test_step (:489). The reference implemented
// them as the CUDA kernels composite_train_fw, composite_train_bw and
// composite_test_fw (volumerendering.cu:7-285). Their port's plain versions
// are ops/composite.py::composite_train_plain, ::composite_train_bwd_plain
// and ::composite_test_step_plain.
//
// A row's samples are composited front to back: the transmittance before
// sample i is T_i, the product of (1 - alpha_j) over the samples j < i, with
// alpha_j = 1 - exp(-sigma_j delta_j) where mask_j is set and 0 elsewhere (a
// masked slot leaves T unchanged, so holes may sit between valid samples).
// Sample i is included iff mask_i and T_i > T_threshold; its weight is
// w_i = alpha_i T_i, and 0 for every other slot. opacity, depth and rgb sum
// w_i, w_i t_i and w_i rgb_i. The serving round starts each row from
// T = 1 - opacity and adds to the accumulators it is given; with an alive
// count in device memory (the serving rounds' static capacity buffers), a
// row at or past it reads and writes no accumulator and comes back not
// alive. A null count leaves the round as it was.
//
// The backward is analytic and division-free, with true suffix sums (no
// total-minus-prefix, which cancels): for an included sample k, G_k =
// g_ws[k] + g_opacity + g_depth t_k + sum_c g_rgb[c] rgb_k[c];
//   B_i = G_i T_i (1 - alpha_i) - sum_{k > i, included} G_k w_k
//       = T_i (1 - alpha_i) (G_i - R_i),
//   R_i = sum_{k > i, included} G_k alpha_k prod_{i < j < k} (1 - alpha_j),
//   d sigma_i = delta_i B_i, d delta_i = sigma_i B_i,
//   d rgb_i = w_i g_rgb, d t_i = w_i g_depth,
// and 0 for the excluded slots. R_i is the suffix recurrence R_i =
// [i+1 included] G_{i+1} alpha_{i+1} + (1 - alpha_{i+1}) R_{i+1}. The
// leading 1 - alpha_i is exp(-sigma_i delta_i), its exact value, as
// autodiff through the exp takes it: the rounded 1 - (1 - e) of a dense
// sample is off by up to 3e-8 / e of itself, and 0 above sigma delta ~17.
// An absent incoming gradient (a null pointer) is 0, and an output the
// caller does not ask for (null) is not written.
//
// Layout: a row takes `width` lanes of a warp, the power of two at or above
// S and at most 32 (a serving round's rows of one to a few samples share a
// warp), and walks its slots `width` at a time: each lane loads its slot
// (coalesced across the row), a shuffle scan gives each lane the product of
// (1 - alpha) before it within the pass and the pass's product, and a
// shuffle tree sums the lanes' partial sums at the end. A warp stops when
// every one of its rows has fallen to T <= T_threshold (nothing later is
// included: the products of factors in [0, 1] never rise); the training
// forward then writes 0 to the rest of ws. Rows of up to four passes (a
// training step's 64 and 128 slots) load a lane's operands once for all
// its passes into registers, skip the scans of passes masked on the whole
// warp and store ws after the walk (composite_train_fw_regs_kernel);
// longer rows load each pass's operands as they walk
// (composite_train_fw_kernel). Both give the same bits. The backward walks
// each row twice: front to back for the transmittance at the start of each
// pass, then back to front, recomputing each pass's weights from that
// transmittance (the same operations as the forward, so the same included
// samples), R within the pass by a shuffle scan of the affine maps and
// across passes by carrying R from the pass behind. Rows of up to four
// passes (a training step's 64 and 128 slots) keep their operands, e and T
// in registers between the walks and skip the passes that include nothing
// (composite_train_bw_regs_kernel); longer rows keep each pass's starting
// transmittance in shared memory and reload their operands
// (composite_train_bw_kernel). Both give the same bits.
//
// Rounding: every product and sum is rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn), so nvcc's FMA contraction cannot move
// w = alpha T or the sums; expf is PyTorch's own exp on CUDA (no fast math);
// T_threshold arrives as a float, as torch compares a float32 tensor with a
// Python float. The scan and the trees associate otherwise than torch's
// cumprod and sum, so the results are the plain version's to rounding, not
// bit for bit; the order is fixed, so every launch gives the same bits. No
// atomics.
//
// What bounds it on Hopper: not bytes or operations but each warp's frame
// of dependent loads, votes, shuffles and stores. A training step's forward
// reads the mask and, up to the stop, sigma, delta, t and rgb (~25 B a
// slot) and writes ws, 4 B a slot; at 8,192 rows of 64 slots that is ~1 us
// of HBM time, yet an empty launch of the grid takes ~2 us by graph replay
// and a copy of the register forward cut to its loads and stores ~5 us of
// its ~6 (NVIDIA H100 80GB HBM3, 700 W; tools/composite_check.py --fwd-ab
// with cut trees). The backward reads the same and writes up to 24 B a
// slot; the arithmetic is a few tens of fp32 operations a sample. On the
// main path each kernel replaces some twenty small torch launches (the
// plain forward, autograd's backward through cumprod, a serving round's
// gathers and scatters).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                  // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kMaxSharedBytes = 48 * 1024;

// Lanes a row: the power of two at or above s, at most a warp.
int row_width(int s) {
  int w = 1;
  while (w < s && w < 32) w <<= 1;
  return w;
}

unsigned blocks_for(long long n, int width) {
  const long long lanes = n * width;
  return static_cast<unsigned>((lanes + kThreads - 1) / kThreads);
}

// Bytes of shared memory the backward keeps: a float a pass for each row
// of a block.
long long bw_shared_bytes(int s, int width) {
  const long long passes = (s + width - 1) / width;
  return static_cast<long long>(kThreads / width) * passes * 4;
}

struct Lane {
  long long ray;   // this lane's row (may be past n)
  int sl;          // its lane within the row's segment
  int width;       // lanes a row
  bool live;       // ray < n
};

__device__ __forceinline__ Lane lane_of(long long n, int width) {
  const long long g =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  Lane l;
  l.width = width;
  l.ray = g / width;
  l.sl = static_cast<int>(threadIdx.x & (width - 1));
  l.live = l.ray < n;
  return l;
}

// Whether every row of this lane's warp lies past n (the same on every lane
// of the warp, so the warp returns as one).
__device__ __forceinline__ bool warp_past_end(long long n, int width) {
  const long long first =
      (static_cast<long long>(blockIdx.x) * kThreads + (threadIdx.x & ~31))
      / width;
  return first >= n;
}

// alpha and 1 - alpha of a slot, as the plain version computes them:
// where(mask, 1 - exp(-sigma * delta), 0), then 1 - alpha; and e, the
// exp itself (1 where masked).
__device__ __forceinline__ void alpha_from(bool m, float sigma, float delta,
                                           float& a, float& om, float& e) {
  a = 0.0f;
  om = 1.0f;
  e = 1.0f;
  if (m) {
    e = expf(-__fmul_rn(sigma, delta));
    a = __fsub_rn(1.0f, e);
    om = __fsub_rn(1.0f, a);
  }
}

__device__ __forceinline__ void alpha_of(const float* sigmas,
                                         const float* deltas, long long at,
                                         bool m, float& a, float& om,
                                         float& e) {
  alpha_from(m, m ? sigmas[at] : 0.0f, m ? deltas[at] : 0.0f, a, om, e);
}

// The product of v over the segment's lanes before this one (1 on its first
// lane); `total` is the product over the whole segment.
__device__ __forceinline__ float excl_product(float v, int sl, int width,
                                              float& total) {
  for (int d = 1; d < width; d <<= 1) {
    const float y = __shfl_up_sync(kFull, v, d, width);
    if (sl >= d) v = __fmul_rn(y, v);
  }
  total = __shfl_sync(kFull, v, width - 1, width);
  const float before = __shfl_up_sync(kFull, v, 1, width);
  return sl == 0 ? 1.0f : before;
}

// The sum of v over the segment's lanes, the same bits on every lane.
__device__ __forceinline__ float seg_sum(float v, int width) {
  for (int d = width >> 1; d > 0; d >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, d, width));
  }
  return v;
}

__device__ __forceinline__ int seg_sum(int v, int width) {
  for (int d = width >> 1; d > 0; d >>= 1) {
    v += __shfl_xor_sync(kFull, v, d, width);
  }
  return v;
}

// The composition of the affine maps x -> c + m x of this lane and the
// segment's lanes after it (this lane's applied last), in (c, m).
__device__ __forceinline__ void affine_suffix(float& c, float& m, int sl,
                                              int width) {
  for (int d = 1; d < width; d <<= 1) {
    const float c2 = __shfl_down_sync(kFull, c, d, width);
    const float m2 = __shfl_down_sync(kFull, m, d, width);
    if (sl + d < width) {
      c = __fadd_rn(c, __fmul_rn(m, c2));
      m = __fmul_rn(m, m2);
    }
  }
}

// A lane's partial sums of its row.
struct Sums {
  float op = 0.0f, de = 0.0f, r = 0.0f, g = 0.0f, b = 0.0f;
  int count = 0;
};

// One pass of a row: the weight of this lane's slot `i` from the
// transmittance `t` at the pass's start. Sets `inc`, `a`, `om`, `e`, the
// transmittance before the slot `t_i`, the pass's product in `total`, and
// returns w.
__device__ __forceinline__ float pass_weight(
    const Lane& l, int s, float thr, float t, bool active, long long at,
    int i, const float* sigmas, const float* deltas, const bool* mask,
    bool& inc, float& a, float& om, float& e, float& total, float& t_i) {
  const bool m = active && i < s && mask[at];
  alpha_of(sigmas, deltas, at, m, a, om, e);
  const float before = excl_product(om, l.sl, l.width, total);
  t_i = __fmul_rn(t, before);
  inc = m && t_i > thr;
  return inc ? __fmul_rn(a, t_i) : 0.0f;
}

// Walks a row front to back from transmittance t0 (`active` false: every
// slot is masked), adding the lane's samples to `acc` and writing ws where
// ws is not null. Returns the transmittance after the row, or, where the
// warp stopped early, one at or below thr.
__device__ __forceinline__ float walk_forward(
    const Lane& l, int s, float thr, float t0, bool active,
    const float* sigmas, const float* rgbs, const float* deltas,
    const float* ts, const bool* mask, float* ws, Sums& acc) {
  float t = t0;
  const long long row = l.ray * s;
  int base = 0;
  for (; base < s; base += l.width) {
    if (__all_sync(kFull, !(active && t > thr))) break;
    const int i = base + l.sl;
    const long long at = row + i;
    bool inc;
    float a, om, e, total, t_i;
    const float w = pass_weight(l, s, thr, t, active, at, i, sigmas, deltas,
                                mask, inc, a, om, e, total, t_i);
    if (ws != nullptr && l.live && i < s) ws[at] = w;
    if (inc) {
      acc.op = __fadd_rn(acc.op, w);
      acc.de = __fadd_rn(acc.de, __fmul_rn(w, ts[at]));
      acc.r = __fadd_rn(acc.r, __fmul_rn(w, rgbs[3 * at]));
      acc.g = __fadd_rn(acc.g, __fmul_rn(w, rgbs[3 * at + 1]));
      acc.b = __fadd_rn(acc.b, __fmul_rn(w, rgbs[3 * at + 2]));
      ++acc.count;
    }
    t = __fmul_rn(t, total);
  }
  if (ws != nullptr && l.live) {
    for (int i = base + l.sl; i < s; i += l.width) ws[row + i] = 0.0f;
  }
  return t;
}

__device__ __forceinline__ void reduce(Sums& acc, int width) {
  acc.op = seg_sum(acc.op, width);
  acc.de = seg_sum(acc.de, width);
  acc.r = seg_sum(acc.r, width);
  acc.g = seg_sum(acc.g, width);
  acc.b = seg_sum(acc.b, width);
  acc.count = seg_sum(acc.count, width);
}

__global__ void __launch_bounds__(kThreads) composite_train_fw_kernel(
    long long n, int s, int width, float thr,
    const float* __restrict__ sigmas, const float* __restrict__ rgbs,
    const float* __restrict__ deltas, const float* __restrict__ ts,
    const bool* __restrict__ mask, float* __restrict__ opacity,
    float* __restrict__ depth, float* __restrict__ rgb,
    float* __restrict__ ws, int* __restrict__ counts) {
  if (warp_past_end(n, width)) return;
  const Lane l = lane_of(n, width);
  Sums acc;
  walk_forward(l, s, thr, 1.0f, l.live, sigmas, rgbs, deltas, ts, mask, ws,
               acc);
  reduce(acc, width);
  if (l.live && l.sl == 0) {
    opacity[l.ray] = acc.op;
    depth[l.ray] = acc.de;
    rgb[3 * l.ray] = acc.r;
    rgb[3 * l.ray + 1] = acc.g;
    rgb[3 * l.ray + 2] = acc.b;
    counts[l.ray] = acc.count;
  }
}

// The sums of a row on a whole warp (width 32): seg_sum's xor tree over the
// five partial sums, with the values split between the lanes as the tree
// goes, so that a shuffle carries a value the partner needs each way: at the
// level of 16 lanes each half of the warp keeps four of eight slots (the
// sums and three zeros; a pair of zeros is not traded) and receives its
// partner's four, at 8 two, at 4 one, then the last two levels as seg_sum.
// Each lane's value at each level is seg_sum's at that lane, so the result
// has its bits; slot j ends on lanes 4j to 4j + 3: opacity on lane 0,
// depth 4, r 8, g 16, b 20. Eight shuffles where seg_sum takes 25.
__device__ __forceinline__ float warp_sums(const Sums& acc, int lane) {
  const float v[8] = {acc.op, acc.de, acc.r, 0.0f,
                      acc.g, acc.b, 0.0f, 0.0f};
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
  float k4[4];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float theirs = __shfl_xor_sync(kFull, h16 ? v[j] : v[4 + j], 16);
    k4[j] = __fadd_rn(h16 ? v[4 + j] : v[j], theirs);
  }
  k4[3] = 0.0f;                          // v[3] + v[7]
  float k2[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float theirs = __shfl_xor_sync(kFull, h8 ? k4[j] : k4[2 + j], 8);
    k2[j] = __fadd_rn(h8 ? k4[2 + j] : k4[j], theirs);
  }
  const float theirs = __shfl_xor_sync(kFull, h4 ? k2[0] : k2[1], 4);
  float k = __fadd_rn(h4 ? k2[1] : k2[0], theirs);
  k = __fadd_rn(k, __shfl_xor_sync(kFull, k, 2));
  return __fadd_rn(k, __shfl_xor_sync(kFull, k, 1));
}

// The training forward of rows of at most P passes (a template parameter:
// 1, 2 or 4): walk_forward's walk, with the same operations in the same
// order, so the same bits as composite_train_fw_kernel (and the same
// included samples as the backward's walks recompute), with a lane's
// operands loaded once for all its passes: the mask bytes of its P slots,
// then sigma and delta of its valid ones, and after the walk t and rgb of
// its included ones (three dependent round trips to memory a row, where
// walk_forward makes three a pass). A pass masked on the whole warp loads
// nothing and skips its scan: T before each slot is t, and t * 1 is t. Each
// lane keeps its partial sums across passes in pass order; ws is stored
// after the walk, a slot once (0 past the warp's stop and where excluded).
// A row on a whole warp sums them by warp_sums (seg_sum's bits) and counts
// its included samples by ballots, and a warp that includes nothing skips
// the sums (each +0); narrower rows sum by reduce() and write from their
// first lane. Loading t and rgb with sigma and delta for every valid slot
// (two round trips, more bytes) measured the same on trained bench and
// MixedFeature steps and 0.2-0.6 us slower on the edge blocks (NVIDIA H100
// 80GB HBM3, 700 W, tools/composite_check.py --fwd-ab), and went.
template <int P>
__global__ void __launch_bounds__(kThreads) composite_train_fw_regs_kernel(
    long long n, int s, int width, float thr,
    const float* __restrict__ sigmas, const float* __restrict__ rgbs,
    const float* __restrict__ deltas, const float* __restrict__ ts,
    const bool* __restrict__ mask, float* __restrict__ opacity,
    float* __restrict__ depth, float* __restrict__ rgb,
    float* __restrict__ ws, int* __restrict__ counts) {
  if (warp_past_end(n, width)) return;
  const Lane l = lane_of(n, width);
  const long long row = l.ray * s;

  // every slot's mask, then every valid slot's operands
  bool mk[P];
  unsigned valid = 0;                // bit p: the warp's pass p has a sample
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int i = p * width + l.sl;
    mk[p] = l.live && i < s && mask[row + i];
    if (__any_sync(kFull, mk[p])) valid |= 1u << p;
  }
  float sg[P], dl[P], tv[P], cr[P], cg[P], cb[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const long long at = row + p * width + l.sl;
    sg[p] = dl[p] = tv[p] = cr[p] = cg[p] = cb[p] = 0.0f;
    if (((valid >> p) & 1u) && mk[p]) {
      sg[p] = sigmas[at];
      dl[p] = deltas[at];
    }
  }

  // front to back, up to the pass at which every row of the warp has
  // fallen to thr
  float t = 1.0f;
  bool stopped = false;
  bool inc[P];
  float w[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    inc[p] = false;
    w[p] = 0.0f;
    if (stopped) continue;           // the same on the whole warp
    if (p * width >= s || __all_sync(kFull, !(l.live && t > thr))) {
      stopped = true;
      continue;
    }
    if (!((valid >> p) & 1u)) continue;
    float a, om, e, total;
    alpha_from(mk[p], sg[p], dl[p], a, om, e);
    const float t_i = __fmul_rn(t, excl_product(om, l.sl, width, total));
    inc[p] = mk[p] && t_i > thr;
    if (inc[p]) w[p] = __fmul_rn(a, t_i);
    t = __fmul_rn(t, total);
  }

#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int i = p * width + l.sl;
    if (l.live && i < s) ws[row + i] = w[p];
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (inc[p]) {
      const long long at = row + p * width + l.sl;
      tv[p] = ts[at];
      cr[p] = rgbs[3 * at];
      cg[p] = rgbs[3 * at + 1];
      cb[p] = rgbs[3 * at + 2];
    }
  }
  Sums acc;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (inc[p]) {
      acc.op = __fadd_rn(acc.op, w[p]);
      acc.de = __fadd_rn(acc.de, __fmul_rn(w[p], tv[p]));
      acc.r = __fadd_rn(acc.r, __fmul_rn(w[p], cr[p]));
      acc.g = __fadd_rn(acc.g, __fmul_rn(w[p], cg[p]));
      acc.b = __fadd_rn(acc.b, __fmul_rn(w[p], cb[p]));
      ++acc.count;
    }
  }
  if (width == 32) {                 // a warp a row, and it is live
    int count = 0;
#pragma unroll
    for (int p = 0; p < P; ++p) count += __popc(__ballot_sync(kFull, inc[p]));
    const float sum = count > 0 ? warp_sums(acc, l.sl) : 0.0f;
    float* out = nullptr;
    float value = sum;
    switch (l.sl) {
      case 0: out = opacity + l.ray; break;
      case 4: out = depth + l.ray; break;
      case 8: out = rgb + 3 * l.ray; break;
      case 16: out = rgb + 3 * l.ray + 1; break;
      case 20: out = rgb + 3 * l.ray + 2; break;
      case 12:
        out = reinterpret_cast<float*>(counts + l.ray);
        value = __int_as_float(count);
        break;
      default: break;
    }
    if (out != nullptr) *out = value;
    return;
  }
  reduce(acc, width);
  if (l.live && l.sl == 0) {
    opacity[l.ray] = acc.op;
    depth[l.ray] = acc.de;
    rgb[3 * l.ray] = acc.r;
    rgb[3 * l.ray + 1] = acc.g;
    rgb[3 * l.ray + 2] = acc.b;
    counts[l.ray] = acc.count;
  }
}

// The backward's gradients of a row's slots from, from + stride, .. below
// s: 0 in every output asked for.
__device__ __forceinline__ void zero_slots(long long row, int from, int s,
                                           int stride, float* d_sigmas,
                                           float* d_rgbs, float* d_deltas,
                                           float* d_ts) {
  for (int i = from; i < s; i += stride) {
    const long long at = row + i;
    if (d_sigmas != nullptr) d_sigmas[at] = 0.0f;
    if (d_deltas != nullptr) d_deltas[at] = 0.0f;
    if (d_rgbs != nullptr) {
      d_rgbs[3 * at] = 0.0f;
      d_rgbs[3 * at + 1] = 0.0f;
      d_rgbs[3 * at + 2] = 0.0f;
    }
    if (d_ts != nullptr) d_ts[at] = 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads) composite_train_bw_kernel(
    long long n, int s, int width, float thr,
    const float* __restrict__ sigmas, const float* __restrict__ rgbs,
    const float* __restrict__ deltas, const float* __restrict__ ts,
    const bool* __restrict__ mask, const float* __restrict__ g_opacity,
    const float* __restrict__ g_depth, const float* __restrict__ g_rgb,
    const float* __restrict__ g_ws, float* __restrict__ d_sigmas,
    float* __restrict__ d_rgbs, float* __restrict__ d_deltas,
    float* __restrict__ d_ts) {
  extern __shared__ float starts[];        // [row of the block][pass]
  if (warp_past_end(n, width)) return;
  const Lane l = lane_of(n, width);
  const int passes = (s + width - 1) / width;
  float* start = starts + static_cast<long long>(threadIdx.x / width) * passes;
  const long long row = l.ray * s;

  // front to back: the transmittance at each pass's start, up to the pass
  // at which every row of the warp has fallen to thr
  float t = 1.0f;
  int walked = 0;
  for (; walked < passes; ++walked) {
    if (__all_sync(kFull, !(l.live && t > thr))) break;
    if (l.sl == 0) start[walked] = t;
    const int i = walked * width + l.sl;
    bool inc;
    float a, om, e, total, t_i;
    pass_weight(l, s, thr, t, l.live, row + i, i, sigmas, deltas, mask, inc,
                a, om, e, total, t_i);
    t = __fmul_rn(t, total);
  }
  __syncwarp();

  float go = 0.0f, gd = 0.0f, gr = 0.0f, gg = 0.0f, gb = 0.0f;
  if (l.live) {
    if (g_opacity != nullptr) go = g_opacity[l.ray];
    if (g_depth != nullptr) gd = g_depth[l.ray];
    if (g_rgb != nullptr) {
      gr = g_rgb[3 * l.ray];
      gg = g_rgb[3 * l.ray + 1];
      gb = g_rgb[3 * l.ray + 2];
    }
  }
  // back to front: R_i = sum over the included k > i of G_k alpha_k times
  // the product of (1 - alpha_j) over i < j < k, by R_i = [i+1 included]
  // G_{i+1} alpha_{i+1} + (1 - alpha_{i+1}) R_{i+1}: within a pass as a
  // suffix scan of the affine maps x -> G_j alpha_j + (1 - alpha_j) x,
  // across passes from `behind`, R at the last slot of the pass
  float behind = 0.0f;
  for (int p = walked - 1; p >= 0; --p) {
    const int i = p * width + l.sl;
    const long long at = row + i;
    bool inc;
    float a, om, e, total, t_i;
    const float w = pass_weight(l, s, thr, start[p], l.live, at, i, sigmas,
                                deltas, mask, inc, a, om, e, total, t_i);
    float big_g = 0.0f;
    if (inc) {
      big_g = g_ws != nullptr ? g_ws[at] : 0.0f;
      big_g = __fadd_rn(big_g, go);
      big_g = __fadd_rn(big_g, __fmul_rn(gd, ts[at]));
      big_g = __fadd_rn(big_g, __fmul_rn(gr, rgbs[3 * at]));
      big_g = __fadd_rn(big_g, __fmul_rn(gg, rgbs[3 * at + 1]));
      big_g = __fadd_rn(big_g, __fmul_rn(gb, rgbs[3 * at + 2]));
    }
    float c = inc ? __fmul_rn(big_g, a) : 0.0f;
    float m = om;
    affine_suffix(c, m, l.sl, width);
    const float c_next = __shfl_down_sync(kFull, c, 1, width);
    const float m_next = __shfl_down_sync(kFull, m, 1, width);
    const float c_pass = __shfl_sync(kFull, c, 0, width);
    const float m_pass = __shfl_sync(kFull, m, 0, width);
    const float r = l.sl + 1 < width
                        ? __fadd_rn(c_next, __fmul_rn(m_next, behind))
                        : behind;
    const float big_b =
        inc ? __fmul_rn(__fmul_rn(t_i, e), __fsub_rn(big_g, r)) : 0.0f;
    if (l.live && i < s) {
      if (d_sigmas != nullptr) {
        d_sigmas[at] = inc ? __fmul_rn(deltas[at], big_b) : 0.0f;
      }
      if (d_deltas != nullptr) {
        d_deltas[at] = inc ? __fmul_rn(sigmas[at], big_b) : 0.0f;
      }
      if (d_rgbs != nullptr) {
        d_rgbs[3 * at] = __fmul_rn(w, gr);
        d_rgbs[3 * at + 1] = __fmul_rn(w, gg);
        d_rgbs[3 * at + 2] = __fmul_rn(w, gb);
      }
      if (d_ts != nullptr) d_ts[at] = __fmul_rn(w, gd);
    }
    behind = __fadd_rn(c_pass, __fmul_rn(m_pass, behind));
  }
  // the passes past the warp's stop hold no included sample
  if (l.live) {
    zero_slots(row, walked * width + l.sl, s, width, d_sigmas, d_rgbs,
               d_deltas, d_ts);
  }
}

// The backward of rows of at most P passes (a template parameter: 1, 2 or
// 4): the same walks and the same operations in the same order as
// composite_train_bw_kernel, so the same bits, with every operand of a
// lane's slots loaded once, before the front walk (the mask, then sigma,
// delta, t, rgb and g_ws of the valid slots), and kept in registers with
// each slot's e and T for the back walk; no shared memory. The front walk
// records, per pass, whether a slot of the warp's pass is included; the
// back walk skips the scan of a pass with none, writing its gradients
// (0, and w g = 0 g for d_rgbs and d_ts, as the two-walk kernel rounds them)
// and carrying R as 0 + R. That is exact: with the row on the whole warp
// (S > 16), a pass the front walk reached starts above the threshold, and
// the first valid slot's T is that start (the scan multiplies it by ones),
// so a pass with no included slot is wholly masked, where every lane's map
// is x -> 0 + 1 x and the two-walk kernel's R is 0 + 1 R; with narrower
// rows a row has one pass, and nothing reads R after it. A pass masked on
// the whole warp skips its front scan too (T is unchanged by it). On a
// trained bench step (8,192 rows of 64 slots, most with fewer than 32
// samples) this took the kernel from 9.9 to 6.4 us (NVIDIA H100 80GB
// HBM3, 700 W, tools/composite_check.py --bwd-ab); 16 B stores of d_rgbs
// (each lane's four floats shuffled from their slots' lanes) and of the
// zero tail cost more instructions than they saved, and went.
template <int P>
__global__ void __launch_bounds__(kThreads) composite_train_bw_regs_kernel(
    long long n, int s, int width, float thr,
    const float* __restrict__ sigmas, const float* __restrict__ rgbs,
    const float* __restrict__ deltas, const float* __restrict__ ts,
    const bool* __restrict__ mask, const float* __restrict__ g_opacity,
    const float* __restrict__ g_depth, const float* __restrict__ g_rgb,
    const float* __restrict__ g_ws, float* __restrict__ d_sigmas,
    float* __restrict__ d_rgbs, float* __restrict__ d_deltas,
    float* __restrict__ d_ts) {
  if (warp_past_end(n, width)) return;
  const Lane l = lane_of(n, width);
  const long long row = l.ray * s;

  // every slot's mask, then every valid slot's operands
  bool mk[P];
  float sg[P], dl[P], tv[P], cr[P], cg[P], cb[P], gw[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int i = p * width + l.sl;
    mk[p] = l.live && i < s && mask[row + i];
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const long long at = row + p * width + l.sl;
    sg[p] = dl[p] = tv[p] = cr[p] = cg[p] = cb[p] = gw[p] = 0.0f;
    if (mk[p]) {
      sg[p] = sigmas[at];
      dl[p] = deltas[at];
      tv[p] = ts[at];
      cr[p] = rgbs[3 * at];
      cg[p] = rgbs[3 * at + 1];
      cb[p] = rgbs[3 * at + 2];
      if (g_ws != nullptr) gw[p] = g_ws[at];
    }
  }

  // front to back: each slot's e and T before it, up to the pass at which
  // every row of the warp has fallen to thr
  float t = 1.0f;
  int walked = 0;
  bool stopped = false;
  unsigned included = 0;             // bit p: the warp's pass p includes
  float e[P], ti[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    e[p] = 1.0f;
    ti[p] = 0.0f;
    if (stopped) continue;           // the same on the whole warp
    if (p * width >= s || __all_sync(kFull, !(l.live && t > thr))) {
      stopped = true;
      continue;
    }
    walked = p + 1;
    // a pass masked on the whole warp: T before each slot is t, and t * 1
    // is t, so its scan is skipped too
    if (!__any_sync(kFull, mk[p])) continue;
    float a, om, total;
    alpha_from(mk[p], sg[p], dl[p], a, om, e[p]);
    ti[p] = __fmul_rn(t, excl_product(om, l.sl, width, total));
    if (__any_sync(kFull, mk[p] && ti[p] > thr)) included |= 1u << p;
    t = __fmul_rn(t, total);
  }

  float go = 0.0f, gd = 0.0f, gr = 0.0f, gg = 0.0f, gb = 0.0f;
  if (l.live) {
    if (g_opacity != nullptr) go = g_opacity[l.ray];
    if (g_depth != nullptr) gd = g_depth[l.ray];
    if (g_rgb != nullptr) {
      gr = g_rgb[3 * l.ray];
      gg = g_rgb[3 * l.ray + 1];
      gb = g_rgb[3 * l.ray + 2];
    }
  }
  // back to front, as composite_train_bw_kernel
  float behind = 0.0f;
#pragma unroll
  for (int p = P - 1; p >= 0; --p) {
    if (p >= walked) continue;
    const int i = p * width + l.sl;
    const long long at = row + i;
    bool inc = false;
    float w = 0.0f, big_b = 0.0f;
    if ((included >> p) & 1u) {
      float a = 0.0f, om = 1.0f;
      if (mk[p]) {
        a = __fsub_rn(1.0f, e[p]);
        om = __fsub_rn(1.0f, a);
      }
      inc = mk[p] && ti[p] > thr;
      if (inc) w = __fmul_rn(a, ti[p]);
      float big_g = 0.0f;
      if (inc) {
        big_g = __fadd_rn(gw[p], go);
        big_g = __fadd_rn(big_g, __fmul_rn(gd, tv[p]));
        big_g = __fadd_rn(big_g, __fmul_rn(gr, cr[p]));
        big_g = __fadd_rn(big_g, __fmul_rn(gg, cg[p]));
        big_g = __fadd_rn(big_g, __fmul_rn(gb, cb[p]));
      }
      float c = inc ? __fmul_rn(big_g, a) : 0.0f;
      float m = om;
      affine_suffix(c, m, l.sl, width);
      const float c_next = __shfl_down_sync(kFull, c, 1, width);
      const float m_next = __shfl_down_sync(kFull, m, 1, width);
      const float c_pass = __shfl_sync(kFull, c, 0, width);
      const float m_pass = __shfl_sync(kFull, m, 0, width);
      const float r = l.sl + 1 < width
                          ? __fadd_rn(c_next, __fmul_rn(m_next, behind))
                          : behind;
      if (inc) {
        big_b = __fmul_rn(__fmul_rn(ti[p], e[p]), __fsub_rn(big_g, r));
      }
      behind = __fadd_rn(c_pass, __fmul_rn(m_pass, behind));
    } else {
      behind = __fadd_rn(0.0f, behind);
    }
    if (l.live && i < s) {
      if (d_sigmas != nullptr) {
        d_sigmas[at] = inc ? __fmul_rn(dl[p], big_b) : 0.0f;
      }
      if (d_deltas != nullptr) {
        d_deltas[at] = inc ? __fmul_rn(sg[p], big_b) : 0.0f;
      }
      if (d_rgbs != nullptr) {
        d_rgbs[3 * at] = __fmul_rn(w, gr);
        d_rgbs[3 * at + 1] = __fmul_rn(w, gg);
        d_rgbs[3 * at + 2] = __fmul_rn(w, gb);
      }
      if (d_ts != nullptr) d_ts[at] = __fmul_rn(w, gd);
    }
  }
  // the passes past the warp's stop hold no included sample
  if (l.live) {
    zero_slots(row, walked * width + l.sl, s, width, d_sigmas, d_rgbs,
               d_deltas, d_ts);
  }
}

__global__ void __launch_bounds__(kThreads) composite_test_kernel(
    long long n, int s, int width, float thr,
    const float* __restrict__ sigmas, const float* __restrict__ rgbs,
    const float* __restrict__ deltas, const float* __restrict__ ts,
    const bool* __restrict__ mask, const int64_t* __restrict__ index,
    const long long* __restrict__ count, const float* op_in,
    const float* de_in, const float* rgb_in,
    const bool* __restrict__ alive_in, float* op_out, float* de_out,
    float* rgb_out, bool* __restrict__ alive_out) {
  if (warp_past_end(n, width)) return;
  const Lane l = lane_of(n, width);
  // a row before the alive count (every row without one)
  const bool in = l.live && (count == nullptr || l.ray < __ldg(count));
  // the accumulators' row: the index's entry (the in-place form), else the
  // row itself; op_in may be op_out there (each row owns its entry)
  const long long acc_at =
      in ? (index != nullptr ? index[l.ray] : l.ray) : 0;
  const bool alive =
      in && (alive_in == nullptr || alive_in[l.ray]);
  const float op0 = in ? op_in[acc_at] : 0.0f;
  Sums acc;
  const float t = walk_forward(l, s, thr, __fsub_rn(1.0f, op0), alive,
                               sigmas, rgbs, deltas, ts, mask, nullptr, acc);
  reduce(acc, width);
  if (in && l.sl == 0) {
    op_out[acc_at] = __fadd_rn(op0, acc.op);
    de_out[acc_at] = __fadd_rn(de_in[acc_at], acc.de);
    rgb_out[3 * acc_at] = __fadd_rn(rgb_in[3 * acc_at], acc.r);
    rgb_out[3 * acc_at + 1] = __fadd_rn(rgb_in[3 * acc_at + 1], acc.g);
    rgb_out[3 * acc_at + 2] = __fadd_rn(rgb_in[3 * acc_at + 2], acc.b);
  }
  if (l.live && l.sl == 0) alive_out[l.ray] = alive && t > thr;
}

int check_sizes(long long n, int s) {
  if (n < 0 || s < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaSuccess);
}

}  // namespace

// The training forward on `stream`. sigmas, deltas, ts (n, s), rgbs
// (n, s, 3) fp32 and mask (n, s) bool, contiguous. Outputs: opacity,
// depth (n,), rgb (n, 3), ws (n, s) fp32 and counts (n,) int32, each row's
// included samples. `passes` 1, 2 or 4 takes
// composite_train_fw_regs_kernel<passes> (rows of at most `passes` passes of
// row_width(s) slots); 0 composite_train_fw_kernel, for any s.
extern "C" int composite_train_fw(long long n, int s, int passes, float thr,
                                  const void* sigmas, const void* rgbs,
                                  const void* deltas, const void* ts,
                                  const void* mask, void* opacity,
                                  void* depth, void* rgb, void* ws,
                                  void* counts, void* stream) {
  const int bad = check_sizes(n, s);
  if (bad) return bad;
  const int width = row_width(s);
  const bool ok = passes == 0 ||
      ((passes == 1 || passes == 2 || passes == 4) &&
       (s + width - 1) / width <= passes);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = blocks_for(n, width);
#define COMPOSITE_FW_ARGS                                                     \
  n, s, width, thr, static_cast<const float*>(sigmas),                       \
      static_cast<const float*>(rgbs), static_cast<const float*>(deltas),    \
      static_cast<const float*>(ts), static_cast<const bool*>(mask),         \
      static_cast<float*>(opacity), static_cast<float*>(depth),              \
      static_cast<float*>(rgb), static_cast<float*>(ws),                     \
      static_cast<int*>(counts)
  switch (passes) {
    case 1:
      composite_train_fw_regs_kernel<1><<<blocks, kThreads, 0, st>>>(
          COMPOSITE_FW_ARGS);
      break;
    case 2:
      composite_train_fw_regs_kernel<2><<<blocks, kThreads, 0, st>>>(
          COMPOSITE_FW_ARGS);
      break;
    case 4:
      composite_train_fw_regs_kernel<4><<<blocks, kThreads, 0, st>>>(
          COMPOSITE_FW_ARGS);
      break;
    default:
      composite_train_fw_kernel<<<blocks, kThreads, 0, st>>>(
          COMPOSITE_FW_ARGS);
      break;
  }
#undef COMPOSITE_FW_ARGS
  return static_cast<int>(cudaGetLastError());
}

// The analytic backward on `stream`: the forward's inputs, then the
// incoming gradients g_opacity, g_depth (n,), g_rgb (n, 3), g_ws (n, s),
// each fp32 or null (0); the outputs d_sigmas, d_deltas, d_ts (n, s) and
// d_rgbs (n, s, 3) fp32, each written unless null. `passes` 1, 2 or 4
// takes composite_train_bw_regs_kernel<passes> (rows of at most `passes`
// passes of row_width(s) slots); 0 the two-walk kernel, for s up to 49,152
// (its shared memory holds a float a pass for each row of a block).
extern "C" int composite_train_bw(long long n, int s, int passes, float thr,
                                  const void* sigmas, const void* rgbs,
                                  const void* deltas, const void* ts,
                                  const void* mask, const void* g_opacity,
                                  const void* g_depth, const void* g_rgb,
                                  const void* g_ws, void* d_sigmas,
                                  void* d_rgbs, void* d_deltas, void* d_ts,
                                  void* stream) {
  const int bad = check_sizes(n, s);
  if (bad) return bad;
  const int width = row_width(s);
  const long long smem = bw_shared_bytes(s, width);
  const bool ok = passes == 0
      ? smem <= kMaxSharedBytes
      : (passes == 1 || passes == 2 || passes == 4) &&
        (s + width - 1) / width <= passes;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = blocks_for(n, width);
#define COMPOSITE_BW_ARGS                                                     \
  n, s, width, thr, static_cast<const float*>(sigmas),                       \
      static_cast<const float*>(rgbs), static_cast<const float*>(deltas),    \
      static_cast<const float*>(ts), static_cast<const bool*>(mask),         \
      static_cast<const float*>(g_opacity),                                  \
      static_cast<const float*>(g_depth), static_cast<const float*>(g_rgb),  \
      static_cast<const float*>(g_ws), static_cast<float*>(d_sigmas),        \
      static_cast<float*>(d_rgbs), static_cast<float*>(d_deltas),            \
      static_cast<float*>(d_ts)
  switch (passes) {
    case 1:
      composite_train_bw_regs_kernel<1><<<blocks, kThreads, 0, st>>>(
          COMPOSITE_BW_ARGS);
      break;
    case 2:
      composite_train_bw_regs_kernel<2><<<blocks, kThreads, 0, st>>>(
          COMPOSITE_BW_ARGS);
      break;
    case 4:
      composite_train_bw_regs_kernel<4><<<blocks, kThreads, 0, st>>>(
          COMPOSITE_BW_ARGS);
      break;
    default:
      composite_train_bw_kernel<<<blocks, kThreads,
                                  static_cast<size_t>(smem), st>>>(
          COMPOSITE_BW_ARGS);
      break;
  }
#undef COMPOSITE_BW_ARGS
  return static_cast<int>(cudaGetLastError());
}

// One serving round on `stream`: the forward's inputs; the accumulators
// op_in, de_in (m,), rgb_in (m, 3) fp32 at row r's entry index[r] (int64;
// null: entry r), alive_in (n,) bool (null: every row alive); count null,
// or one int64 on the device, the alive count (rows at or past it touch no
// accumulator and come back not alive); writes op_out, de_out, rgb_out at
// the same entries (they may be the inputs: the in-place form) and
// alive_out (n,) bool: alive and T after the block > thr.
extern "C" int composite_test(long long n, int s, float thr,
                              const void* sigmas, const void* rgbs,
                              const void* deltas, const void* ts,
                              const void* mask, const void* index,
                              const void* count, const void* op_in,
                              const void* de_in, const void* rgb_in,
                              const void* alive_in,
                              void* op_out, void* de_out, void* rgb_out,
                              void* alive_out, void* stream) {
  const int bad = check_sizes(n, s);
  if (bad) return bad;
  if (n == 0) return static_cast<int>(cudaSuccess);
  const int width = row_width(s);
  composite_test_kernel<<<blocks_for(n, width), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      n, s, width, thr, static_cast<const float*>(sigmas),
      static_cast<const float*>(rgbs), static_cast<const float*>(deltas),
      static_cast<const float*>(ts), static_cast<const bool*>(mask),
      static_cast<const int64_t*>(index),
      static_cast<const long long*>(count), static_cast<const float*>(op_in),
      static_cast<const float*>(de_in), static_cast<const float*>(rgb_in),
      static_cast<const bool*>(alive_in), static_cast<float*>(op_out),
      static_cast<float*>(de_out), static_cast<float*>(rgb_out),
      static_cast<bool*>(alive_out));
  return static_cast<int>(cudaGetLastError());
}
