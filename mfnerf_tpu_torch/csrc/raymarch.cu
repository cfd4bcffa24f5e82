// Occupancy-grid ray marching on the closed-form t-ladder: the training
// march and the serving loop's window march — CUDA C++ for sm_90a.
//
// Replaces XLA functions, not Pallas kernels: mfnerf_tpu/ops/ray_march.py::
// march_rays_train (:107, the exact march, with rank windows for the dense
// test oracle), ::march_rays_train_twolevel (:220) and
// ::march_rays_train_cascades (:388) (the strata budgets), and
// ::march_rays_window (:876, the alive-ray loop's cursor window; the
// reference's raymarching_test, raymarching.cu:335-454). Their port's plain
// versions are ops/ray_march.py::march_rays_train_plain and
// ::march_rays_window_plain, which evaluate every rung of the ladder as
// (N, K) tensors; these kernels compute the same samples bit for bit.
//
// A ray visits the rungs t_k = t_ladder(t_start, k) (ops/stepping.py, in
// closed form); a rung is occupied when its position's cell, in the cascade
// that mip_from_pos and mip_from_dt pick, has its bit set in the Morton-
// ordered bitfield (ops/morton.py), and t_k < t2. The training march emits
// the occupied rungs ranked rank_start+1 .. rank_start+s_max (at most
// max_samples a ray); under a strata budget only the rungs of the chosen
// strata count. The window march inspects n_window rungs from the ray's
// cursor, emits at most s_cap and moves the cursor.
//
// The training march: one warp a ray, four rays a block. The warp takes 32
// consecutive rungs a pass, one a lane; each lane computes its rung's t,
// step and cell, and __ballot_sync / __popc give each occupied rung its rank
// on the ray, so a lane whose rank falls in the window writes its sample's
// slot (the rank less rank_start, less one). Slots are the ranks: the output
// is the same on every launch, with no atomics. The warp stops at the
// buffer's end, at max_samples, or at the first rung with t >= t2 (the
// ladder rises by at least a step of ~1e-3 a rung, far above an ulp, so
// every later rung is past the exit too). Slots past the ray's samples get
// zeros, mask false and k_idx n_rungs - 1 (cursor + n_window - 1 for the
// window); the plain training march leaves the rung of the rank there when
// the rank lies between max_samples and the ray's total, which nothing
// reads.
//
// Strata (the two-level and the cascade budgets): a first pass, a lane a
// stratum, tests each stratum's stage-A cells (the two-level march's probes
// on the pooled, dilated grid, or the cascade march's union-grid cell at the
// stratum's t-midpoint) and keeps a word of live bits a 32 strata in shared
// memory; the second picks the strata the budget samples (all live ones, or
// the live ranks jj * n_live / s_strata + 1) and lists them in order. The
// rung pass then walks only those strata's rungs, packed 32 to a pass, where
// the plain version tests every rung of the ladder and masks.
//
// The window march: a ray takes L lanes of a warp (a template parameter: 4,
// 8, 16 or 32; the wrapper picks it from the window's strata and the rays'
// count), so a short window packs 32 / L rays into a warp; the L lanes of a
// ray synchronise among themselves only (group-masked ballots and
// shuffles). Row r of a launch is the frame's row index[r]: it reads that
// row's ray, t_start, t2 and cursor there and writes its new cursor back
// there, so the serving loop neither gathers nor scatters. With the
// two-level stage-A grid (params.mode 1: one cascade, uniform steps; a
// second instantiation, kSkip), the window is cut into strata of
// params.stratum rungs from the cursor, the last one cut at cursor +
// n_window; L strata at a time, a lane a stratum tests the stratum's probes
// on the pooled, dilated grid, then the live strata's rungs are listed in
// order (shared memory) and walked L to a pass with the exact rung test.
// There is no budget: every live stratum is walked, so a ray stops only at
// the (s_cap + 1)-th occupied rung, at its exit or at the window's end, and
// its samples, cursor and exhausted are those of the rung-by-rung walk.
// That holds because the stage-A test is a superset of the rung test
// (ops/ray_march.py::window_params derives the probes and the margins); a
// ray whose |d| or rounding could leave that proof (|d|^2 above
// params.d2_max, or its position error bound above params.slack_max) walks
// every rung, as does every ray of the walk-only instantiation (mode 0:
// several cascades, or no grid).
//
// The window march takes an optional alive count in device memory (the
// serving rounds' static capacity buffers, whose first count rows are
// alive): a row at or past it marches nothing and reads nothing of the
// frame, and is written as an empty ray at cursor 0 would be (no samples,
// k_idx n_window - 1, new cursor n_window, exhausted); the frame's cursor
// is left alone. A null count leaves the kernel as it was.
//
// Bit for bit: every product, sum and quotient is rounded on its own
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), since nvcc would contract
// rays_o + t * rays_d or the ladder into fused multiply-adds and a different
// position can move a cell; the float constants are the plain version's,
// computed in double by the wrapper and rounded once; expf, logf and ceilf
// are PyTorch's own functions on CUDA (no fast math); the frexp exponent
// comes from the float's bits; float-to-int casts truncate; the Morton code
// wraps in uint32 with the same masks. Two exact shortcuts: a cascade's
// half-width 2^(mip - 1) (the plain version's exp2 of a small integer, an
// exact power of two) is built from its exponent bits, and a cell
// coordinate's x / div is x times the exact reciprocal where div is a power
// of two: x * 2^-k is the same real number as x / 2^k, and both round it
// once to nearest, subnormal results, zeros and infinities included.
//
// What bounds it on Hopper: the bytes of the rays and of the (N, S) sample
// buffers it writes; the bitfield and the stage-A grids (G^3/8 bytes a
// cascade, at most a few MB) stay in L2 and are read through the read-only
// cache. The rung tests' arithmetic is a few tens of fp32 operations a rung;
// a serving round's first window finds almost nothing in most rays, so
// there the rung tests, not the bytes, take the time, and the stage-A skip
// removes most of them. A training step's rays walk few rungs (a trained
// bench step: 1.1 passes of 32 on average, 5 at most, after 2 stage-A
// passes), so there a warp a ray leaves the time to fixed costs: on that
// step (NVIDIA H100 80GB HBM3, 700 W, graph replay) the launch and each
// warp's ray loads alone take 7.0 us, stage A 5.1, the budget and the
// tail 2.7, the rung passes 4.9, of 19.6 us. Several passes a lane with
// their loads issued before their ballots made every measured step 3-17%
// slower (more rungs tested than walked), as did 16 B tail stores (more
// instructions); a block a ray sharing stage A helps only batches of at
// most ~2,000 rays, which no training recipe uses.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMaxProbes = 16;             // two-level probes a stratum

// Mirrored by ops/ray_march.py::_MarchParams (every field 4 bytes). Outside
// the anonymous namespace: the C entry points take it, and a parameter of
// an internal type would keep them from being exported.
struct MarchParams {
  // the ladder and calc_dt at dt_scale (ops/stepping.py), as float32
  float a, b, e, ta, tb, log1pe, dt_min, dt_max;
  // _occupancy_at's scale and grid, and the two-level stage-A grid's side
  float scale, grid_f, grid_m1, gc_f, gc_m1;
  float probe_off[kMaxProbes];            // stage_a_probes, as float32
  // n_rungs and s_max are the window's n_window and s_cap there
  int grid, cascades, n_rungs, s_max, max_samples, rank_start;
  int mode, stratum, s_strata, n_strata, g_c, n_probes, expo;
  // the window march's stage-A skip: the rays it may take (|d|^2 and the
  // bound on a position's rounding error, in world units)
  float d2_max, slack_max;
};

namespace {

constexpr int kWarps = 4;                  // rays a block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxStrata = 4096;           // strata a ray
constexpr int kMaxChosen = 512;            // s_strata at most
constexpr unsigned kFull = 0xffffffffu;
// the window march's bound on a position's rounding error: this times
// |o|_1 + (|t_start| + |t_end|) |d|_1 (ray_march.py::window_params)
constexpr float kPosErr = 1.0f / (1 << 20);

enum Mode { kExact = 0, kTwoLevel = 1, kUnion = 2 };

// ------------------------------------------- ops/stepping.py on the device
__device__ __forceinline__ float calc_dt(const MarchParams& p, float t) {
  // torch.clamp(t * e, dt_min, dt_max)
  return fminf(fmaxf(__fmul_rn(t, p.e), p.dt_min), p.dt_max);
}

__device__ __forceinline__ int frexp_exponent(float x) {
  return ((__float_as_int(fabsf(x)) >> 23) & 0xFF) - 126;
}

struct Ladder {
  float t0, n1, m2;     // the start and the linear and geometric rung counts
};

__device__ __forceinline__ Ladder ladder_of(const MarchParams& p, float t0) {
  Ladder l{t0, 0.0f, 0.0f};
  if (p.expo) {
    l.n1 = ceilf(__fdiv_rn(fmaxf(__fsub_rn(p.ta, t0), 0.0f), p.a));
    const float t_g0 = __fadd_rn(t0, __fmul_rn(l.n1, p.a));
    l.m2 = ceilf(__fdiv_rn(
        fmaxf(logf(fmaxf(__fdiv_rn(p.tb, t_g0), 1.0f)), 0.0f), p.log1pe));
  }
  return l;
}

// t_ladder(t0, k): linear (+a) up to rung n1, geometric (*(1+e)) for m2
// rungs, linear (+b) after.
__device__ __forceinline__ float ladder_at(const MarchParams& p,
                                           const Ladder& l, float k) {
  if (!p.expo) return __fadd_rn(l.t0, __fmul_rn(k, p.a));
  const float k1 = fminf(k, l.n1);
  const float d = __fsub_rn(k, l.n1);
  const float kg = fminf(fmaxf(d, 0.0f), l.m2);
  const float kb = fmaxf(__fsub_rn(d, l.m2), 0.0f);
  return __fadd_rn(
      __fmul_rn(__fadd_rn(l.t0, __fmul_rn(k1, p.a)),
                expf(__fmul_rn(kg, p.log1pe))),
      __fmul_rn(kb, p.b));
}

// --------------------------------------------- ops/morton.py on the device
__device__ __forceinline__ uint32_t expand_bits(uint32_t v) {
  v = (v * 0x00010001u) & 0xFF0000FFu;
  v = (v * 0x00000101u) & 0x0F00F00Fu;
  v = (v * 0x00000011u) & 0xC30C30C3u;
  v = (v * 0x00000005u) & 0x49249249u;
  return v;
}

__device__ __forceinline__ uint32_t morton3d(uint32_t x, uint32_t y,
                                             uint32_t z) {
  return expand_bits(x) | (expand_bits(y) << 1) | (expand_bits(z) << 2);
}

__device__ __forceinline__ bool bit_at(const uint8_t* __restrict__ bits,
                                       uint64_t idx) {
  return (__ldg(bits + (idx >> 3)) >> (idx & 7)) & 1;
}

// x / div rounded once: where div is a positive normal power of two whose
// reciprocal is normal too, the product by that exact reciprocal (the same
// real number, rounded the same way), else IEEE division
__device__ __forceinline__ float div_exact(float x, float div) {
  const int bits = __float_as_int(div);
  const int ex = (bits >> 23) & 0xFF;
  if ((bits & 0x807FFFFF) == 0 && ex >= 1 && ex <= 253) {
    return __fmul_rn(x, __int_as_float((254 - ex) << 23));
  }
  return __fdiv_rn(x, div);
}

// clamp(0.5 * (x / div + 1) * g, 0, g - 1) truncated: a cell coordinate
__device__ __forceinline__ uint32_t cell_of(float x, float div, float g,
                                            float g_m1) {
  const float q = __fmul_rn(
      __fmul_rn(0.5f, __fadd_rn(div_exact(x, div), 1.0f)), g);
  return static_cast<uint32_t>(__float2int_rz(fminf(fmaxf(q, 0.0f), g_m1)));
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d,
                                        int64_t i) {
  return Ray{__ldg(o + 3 * i), __ldg(o + 3 * i + 1), __ldg(o + 3 * i + 2),
             __ldg(d + 3 * i), __ldg(d + 3 * i + 1), __ldg(d + 3 * i + 2)};
}

__device__ __forceinline__ void point_at(const Ray& r, float t, float& x,
                                         float& y, float& z) {
  x = __fadd_rn(r.ox, __fmul_rn(t, r.dx));
  y = __fadd_rn(r.oy, __fmul_rn(t, r.dy));
  z = __fadd_rn(r.oz, __fmul_rn(t, r.dz));
}

// ray_march.py::_occupancy_at
__device__ __forceinline__ bool occupied(const MarchParams& p,
                                         const uint8_t* __restrict__ bits,
                                         float x, float y, float z,
                                         float dt) {
  const float mx = fmaxf(fmaxf(fabsf(x), fabsf(y)), fabsf(z));
  const int top = p.cascades - 1;
  const int mip_pos = min(max(frexp_exponent(mx) + 1, 0), top);
  const int mip_dt = min(max(frexp_exponent(__fmul_rn(dt, p.grid_f)), 0),
                         top);
  const int mip = max(mip_pos, mip_dt);
  // exp2(mip - 1) = 2^(mip - 1) exactly: its exponent field is mip + 126
  const float bound = fminf(__int_as_float((mip + 126) << 23), p.scale);
  const uint64_t g3 = static_cast<uint64_t>(p.grid) * p.grid * p.grid;
  const uint32_t code = morton3d(cell_of(x, bound, p.grid_f, p.grid_m1),
                                 cell_of(y, bound, p.grid_f, p.grid_m1),
                                 cell_of(z, bound, p.grid_f, p.grid_m1));
  return bit_at(bits, static_cast<uint64_t>(mip) * g3 + code);
}

// Whether one of the two-level probes of the stratum whose first rung is
// `first` (uniform steps) lies in an occupied cell of the stage-A grid
__device__ bool probes_hit(const MarchParams& p,
                           const uint8_t* __restrict__ stage_a,
                           const Ray& r, float t_start, float first) {
  const int g = p.g_c;
  bool any = false;
  for (int q = 0; q < p.n_probes; ++q) {
    const float t = __fadd_rn(
        t_start, __fmul_rn(__fadd_rn(first, p.probe_off[q]), p.a));
    float x, y, z;
    point_at(r, t, x, y, z);
    const uint32_t cx = cell_of(x, p.scale, p.gc_f, p.gc_m1);
    const uint32_t cy = cell_of(y, p.scale, p.gc_f, p.gc_m1);
    const uint32_t cz = cell_of(z, p.scale, p.gc_f, p.gc_m1);
    any |= __ldg(stage_a + (static_cast<int64_t>(cz) * g + cy) * g + cx) != 0;
  }
  return any;
}

// ray_march.py::_live_twolevel for stratum j
__device__ bool live_twolevel(const MarchParams& p,
                              const uint8_t* __restrict__ stage_a,
                              const Ray& r, float t_start, float t2, int j) {
  const float first = __fmul_rn(static_cast<float>(j),
                                static_cast<float>(p.stratum));
  return probes_hit(p, stage_a, r, t_start, first) &&
         __fadd_rn(t_start, __fmul_rn(first, p.a)) < t2;
}

// ray_march.py::_live_union for stratum j
__device__ bool live_union(const MarchParams& p,
                           const uint8_t* __restrict__ union_bits,
                           const Ray& r, const Ladder& l, float t2, int j) {
  const float first = __fmul_rn(static_cast<float>(j),
                                static_cast<float>(p.stratum));
  const float t_lo = ladder_at(p, l, first);
  const float t_hi = ladder_at(
      p, l, __fadd_rn(first, static_cast<float>(p.stratum)));
  float x, y, z;
  point_at(r, __fmul_rn(0.5f, __fadd_rn(t_lo, t_hi)), x, y, z);
  const uint32_t code = morton3d(cell_of(x, p.scale, p.grid_f, p.grid_m1),
                                 cell_of(y, p.scale, p.grid_f, p.grid_m1),
                                 cell_of(z, p.scale, p.grid_f, p.grid_m1));
  return bit_at(union_bits, code) && t_lo < t2;
}

// Whether the budget samples the live stratum of 1-based live rank r when
// the ray has n_live > s live strata: r - 1 == floor(jj * n_live / s) for a
// jj < s. floor(jj * n / s) rises with jj by at least one, so only the
// smallest jj with jj * n / s >= r - 1 can match.
__device__ __forceinline__ bool even_rank(int r, int n_live, int s) {
  const int q = r - 1;
  const int jj = (q * s + n_live - 1) / n_live;
  return jj < s && jj * n_live / s == q;
}

__device__ __forceinline__ void write_sample(int64_t slot, float t, float dt,
                                             float x, float y, float z,
                                             int64_t k, float* xyzs,
                                             float* deltas, float* ts,
                                             bool* mask, int64_t* k_idx) {
  ts[slot] = t;
  deltas[slot] = dt;
  xyzs[3 * slot] = x;
  xyzs[3 * slot + 1] = y;
  xyzs[3 * slot + 2] = z;
  mask[slot] = true;
  k_idx[slot] = k;
}

// Slots from .. to of a row, lanes `stride` apart: zeros, mask false and
// k_idx k_fill
__device__ __forceinline__ void clear_slots(int64_t row, int from, int to,
                                            int lane, int stride,
                                            int64_t k_fill, float* xyzs,
                                            float* deltas, float* ts,
                                            bool* mask, int64_t* k_idx) {
  for (int s = from + lane; s < to; s += stride) {
    const int64_t slot = row + s;
    ts[slot] = 0.0f;
    deltas[slot] = 0.0f;
    xyzs[3 * slot] = 0.0f;
    xyzs[3 * slot + 1] = 0.0f;
    xyzs[3 * slot + 2] = 0.0f;
    mask[slot] = false;
    k_idx[slot] = k_fill;
  }
}

__global__ void __launch_bounds__(kThreads) march_train_kernel(
    const MarchParams p, int64_t n, const float* __restrict__ rays_o,
    const float* __restrict__ rays_d, const float* __restrict__ hits,
    const float* __restrict__ noise, const uint8_t* __restrict__ bits,
    const uint8_t* __restrict__ stage_a, float* __restrict__ xyzs,
    float* __restrict__ deltas, float* __restrict__ ts,
    bool* __restrict__ mask, int64_t* __restrict__ n_samples,
    int64_t* __restrict__ k_idx, float* __restrict__ t_start_out) {
  __shared__ uint32_t live_words[kWarps][kMaxStrata / 32];
  __shared__ int chosen[kWarps][kMaxChosen];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uint32_t below = (1u << lane) - 1u;
  const int64_t ray = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (ray >= n) return;                       // the whole warp

  const Ray r = load_ray(rays_o, rays_d, ray);
  const float t1 = __ldg(hits + 2 * ray);
  const float t2 = __ldg(hits + 2 * ray + 1);
  const bool valid = t1 >= 0.0f;
  const float t0 = valid
      ? __fadd_rn(t1, __fmul_rn(calc_dt(p, t1), __ldg(noise + ray))) : 0.0f;
  const Ladder l = ladder_of(p, t0);

  // the rungs to walk: every rung, or the chosen strata's
  int list_len = 0;
  if (valid && p.mode == kExact) {
    list_len = p.n_rungs;
  } else if (valid) {
    int n_live = 0;
    for (int c = 0; c < p.n_strata; c += 32) {
      const int j = c + lane;
      bool live = false;
      if (j < p.n_strata) {
        live = p.mode == kTwoLevel
            ? live_twolevel(p, stage_a, r, t0, t2, j)
            : live_union(p, stage_a, r, l, t2, j);
      }
      const uint32_t m = __ballot_sync(kFull, live);
      if (lane == 0) live_words[warp][c >> 5] = m;
      n_live += __popc(m);
    }
    __syncwarp();
    int run = 0, n_chosen = 0;
    for (int c = 0; c < p.n_strata; c += 32) {
      const uint32_t m = live_words[warp][c >> 5];
      const int rank = run + __popc(m & below) + 1;
      const bool pick = ((m >> lane) & 1) &&
          (n_live <= p.s_strata || even_rank(rank, n_live, p.s_strata));
      const uint32_t picked = __ballot_sync(kFull, pick);
      if (pick) chosen[warp][n_chosen + __popc(picked & below)] = c + lane;
      n_chosen += __popc(picked);
      run += __popc(m);
    }
    __syncwarp();
    list_len = n_chosen * p.stratum;
  }

  const int64_t row = ray * p.s_max;
  const int cap = min(p.max_samples, p.rank_start + p.s_max);
  int count = 0;
  for (int base = 0; base < list_len && count < cap; base += 32) {
    const int pos = base + lane;
    int k = p.n_rungs;
    if (pos < list_len) {
      k = p.mode == kExact ? pos
          : chosen[warp][pos / p.stratum] * p.stratum + pos % p.stratum;
    }
    bool occ = false, past = false;
    float t = 0.0f, dt = 0.0f, x = 0.0f, y = 0.0f, z = 0.0f;
    if (k < p.n_rungs) {
      t = ladder_at(p, l, static_cast<float>(k));
      past = !(t < t2);
      if (!past) {
        dt = calc_dt(p, t);
        point_at(r, t, x, y, z);
        occ = occupied(p, bits, x, y, z, dt);
      }
    }
    const uint32_t m = __ballot_sync(kFull, occ);
    const int rank = count + __popc(m & below) + 1;
    if (occ && rank > p.rank_start && rank <= cap) {
      write_sample(row + rank - p.rank_start - 1, t, dt, x, y, z, k, xyzs,
                   deltas, ts, mask, k_idx);
    }
    count += __popc(m);
    if (__any_sync(kFull, past)) break;
  }
  const int kept = max(min(count, cap) - p.rank_start, 0);
  clear_slots(row, kept, p.s_max, lane, 32, p.n_rungs - 1, xyzs, deltas, ts,
              mask, k_idx);
  if (lane == 0) {
    n_samples[ray] = kept;
    t_start_out[ray] = t0;
  }
}

// ------------------------------------------------------------ the window
// The L lanes of a window ray within their warp.
template <int L>
struct Group {
  int sl;            // this lane within the group
  int first;         // the group's first lane in the warp
  unsigned mask;     // the group's lanes
  unsigned below;    // the group's lanes before this one, as L bits
  __device__ __forceinline__ Group() {
    const int lane = threadIdx.x & 31;
    sl = lane & (L - 1);
    first = lane - sl;
    mask = L == 32 ? kFull : ((1u << (L & 31)) - 1u) << first;
    below = (1u << sl) - 1u;
  }
  // The group's ballot of pred, as L bits.
  __device__ __forceinline__ unsigned ballot(bool pred) const {
    return (__ballot_sync(mask, pred) & mask) >> first;
  }
};

// A ray's walk over its window: the occupied rungs found so far, the window
// rung of the s_cap-th, and whether the walk has ended.
struct Walk {
  int count;
  int kth;
  bool done;
};

struct WindowOut {
  float* xyzs;
  float* deltas;
  float* ts;
  bool* mask;
  int64_t* k_idx;
};

// One pass of a window walk: this lane tests window rung k (-1: none); the
// occupied rungs take their ranks on the ray (count before the pass, plus
// the group's occupied lanes before this one) and write their slots. Ends
// the walk at the (s_cap + 1)-th occupied rung or at a rung past the exit
// (the rungs a walk lists rise, and so do their t).
template <int L>
__device__ __forceinline__ void window_pass(
    const Group<L>& g, const MarchParams& p, const uint8_t* bits,
    const Ray& r, const Ladder& l, float t2, int64_t c0, int k, int64_t row,
    Walk& w, const WindowOut& out) {
  bool occ = false, past = false;
  float t = 0.0f, dt = 0.0f, x = 0.0f, y = 0.0f, z = 0.0f;
  if (k >= 0) {
    t = ladder_at(p, l, static_cast<float>(c0 + k));
    past = !(t < t2);
    if (!past) {
      dt = calc_dt(p, t);
      point_at(r, t, x, y, z);
      occ = occupied(p, bits, x, y, z, dt);
    }
  }
  const unsigned m = g.ballot(occ);
  const int rank = w.count + __popc(m & g.below) + 1;
  if (occ && rank <= p.s_max) {
    write_sample(row + rank - 1, t, dt, x, y, z, c0 + k, out.xyzs,
                 out.deltas, out.ts, out.mask, out.k_idx);
  }
  const unsigned last = g.ballot(occ && rank == p.s_max);
  if (last) w.kth = __shfl_sync(g.mask, k, g.first + __ffs(last) - 1);
  w.count += __popc(m);
  w.done = w.count > p.s_max || g.ballot(past) != 0;
}

// Every rung of the window from the cursor, L a pass.
template <int L>
__device__ void walk_rungs(const Group<L>& g, const MarchParams& p,
                           const uint8_t* bits, const Ray& r,
                           const Ladder& l, float t2, int64_t c0,
                           int64_t row, Walk& w, const WindowOut& out) {
  for (int base = 0; base < p.n_rungs && !w.done; base += L) {
    const int k = base + g.sl;
    window_pass(g, p, bits, r, l, t2, c0, k < p.n_rungs ? k : -1, row, w,
                out);
  }
}

// The window's strata from the cursor, L at a time: a lane a stratum tests
// its two-level probes; the live strata are listed in order in `list` (the
// warp's 32 ints of shared memory, the group's L of them) and their rungs
// below n_window walked L a pass. A stratum whose first rung is at or past
// the exit ends the walk after the live strata before it.
//
// The head: a ray of 16 or 32 lanes (its window long, or the launch's rays
// few, so that latency and not lanes bounds it) first walks one pass of L
// rungs from the cursor, so that a ray in occupied space stops there
// without waiting on a stage-A pass; the strata wholly in the head are not
// tested, and the head's rungs are not walked again. Where a chunk's
// strata are all live, their rungs follow on from j0 * stratum and the
// list is not read.
template <int L>
__device__ void walk_strata(const Group<L>& g, const MarchParams& p,
                            const uint8_t* bits, const uint8_t* stage_a,
                            const Ray& r, const Ladder& l, float t0,
                            float t2, int64_t c0, int64_t row, int* list,
                            Walk& w, const WindowOut& out) {
  constexpr int head = L >= 16 ? L : 0;
  const int st = p.stratum;
  const int n_strata = (p.n_rungs + st - 1) / st;
  if (head > 0) {
    window_pass(g, p, bits, r, l, t2, c0, g.sl < p.n_rungs ? g.sl : -1, row,
                w, out);
  }
  for (int j0 = head / st; j0 < n_strata && !w.done; j0 += L) {
    const int j = j0 + g.sl;
    const float first = static_cast<float>(c0 + static_cast<int64_t>(j) * st);
    bool live = false, over = false;
    if (j < n_strata) {
      over = !(__fadd_rn(t0, __fmul_rn(first, p.a)) < t2);
      live = !over && probes_hit(p, stage_a, r, t0, first);
    }
    const unsigned lm = g.ballot(live);
    const bool stop = g.ballot(over) != 0;
    if (live) list[g.first + __popc(lm & g.below)] = j;
    __syncwarp(g.mask);
    const int len = __popc(lm) * st;
    const bool all = __popc(lm) == min(L, n_strata - j0);
    for (int base = 0; base < len && !w.done; base += L) {
      const int pos = base + g.sl;
      int k = -1;
      if (pos < len) {
        if (all) {
          k = j0 * st + pos;
        } else {
          const int q = pos / st;
          k = list[g.first + q] * st + (pos - q * st);
        }
        // the last stratum's cut, and the head's rungs
        if (k >= p.n_rungs || k < head) k = -1;
      }
      window_pass(g, p, bits, r, l, t2, c0, k, row, w, out);
    }
    __syncwarp(g.mask);          // read before the next chunk writes it
    if (stop) w.done = true;
  }
}

// Whether the stage-A skip may take this ray: |d|^2 within d2_max, and the
// bound kPosErr (|o|_1 + (|t_start| + |t_end|) |d|_1) on the rounding error
// of any position the walk computes (t_end the t of the window's last
// stratum's end) within slack_max. NaN fails both.
__device__ __forceinline__ bool window_skips(const MarchParams& p,
                                             const Ray& r, const Ladder& l,
                                             float t0, int64_t c0) {
  const float n2 = __fadd_rn(
      __fadd_rn(__fmul_rn(r.dx, r.dx), __fmul_rn(r.dy, r.dy)),
      __fmul_rn(r.dz, r.dz));
  const int n_strata = (p.n_rungs + p.stratum - 1) / p.stratum;
  const float t_end = ladder_at(
      p, l, static_cast<float>(c0 + static_cast<int64_t>(n_strata) *
                                        p.stratum));
  const float o1 = __fadd_rn(__fadd_rn(fabsf(r.ox), fabsf(r.oy)),
                             fabsf(r.oz));
  const float d1 = __fadd_rn(__fadd_rn(fabsf(r.dx), fabsf(r.dy)),
                             fabsf(r.dz));
  const float err = __fmul_rn(
      kPosErr,
      __fadd_rn(o1, __fmul_rn(__fadd_rn(fabsf(t0), fabsf(t_end)), d1)));
  return n2 <= p.d2_max && err <= p.slack_max;
}

// Row r of the window is the frame's row index[r]: its ray, t_start, t2 and
// cursor are read there and its new cursor is written there (cursor is
// read and written in place: each row reads its entry before any lane of
// it writes, as the walk's ballots consume the cursor first, and the rows'
// entries are distinct). kSkip: the stage-A skip (params.mode 1); without
// it every ray walks every rung, with none of the skip's registers.
template <int L, bool kSkip>
__global__ void __launch_bounds__(kThreads) march_window_kernel(
    const MarchParams p, int64_t n, const float* __restrict__ rays_o,
    const float* __restrict__ rays_d, const float* __restrict__ t_start,
    const float* __restrict__ t_exit, int64_t* cursor,
    const int64_t* __restrict__ index, const long long* __restrict__ count,
    const uint8_t* __restrict__ bits, const uint8_t* __restrict__ stage_a,
    WindowOut out, int64_t* __restrict__ n_samples,
    int64_t* __restrict__ cursor_out, bool* __restrict__ exhausted) {
  __shared__ int lists[kThreads];
  const Group<L> g;
  const int64_t ray =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / L;
  if (ray >= n) return;                       // the ray's whole group
  if (count != nullptr && ray >= __ldg(count)) {
    // past the alive count: an empty ray at cursor 0, the frame untouched
    clear_slots(ray * p.s_max, 0, p.s_max, g.sl, L, p.n_rungs - 1, out.xyzs,
                out.deltas, out.ts, out.mask, out.k_idx);
    if (g.sl == 0) {
      n_samples[ray] = 0;
      cursor_out[ray] = p.n_rungs;
      exhausted[ray] = true;
    }
    return;
  }
  const int64_t src = __ldg(index + ray);
  const Ray r = load_ray(rays_o, rays_d, src);
  const float t0 = __ldg(t_start + src);
  const float t2 = __ldg(t_exit + src);
  const int64_t c0 = cursor[src];
  const Ladder l = ladder_of(p, t0);
  const int64_t row = ray * p.s_max;

  Walk w{0, -1, false};
  if (kSkip && window_skips(p, r, l, t0, c0)) {
    walk_strata(g, p, bits, stage_a, r, l, t0, t2, c0, row,
                lists + (threadIdx.x & ~31), w, out);
  } else {
    walk_rungs(g, p, bits, r, l, t2, c0, row, w, out);
  }
  const int kept = min(w.count, p.s_max);
  clear_slots(row, kept, p.s_max, g.sl, L, c0 + p.n_rungs - 1, out.xyzs,
              out.deltas, out.ts, out.mask, out.k_idx);
  if (g.sl == 0) {
    const int64_t c1 = w.count > p.s_max ? c0 + w.kth + 1 : c0 + p.n_rungs;
    n_samples[ray] = kept;
    cursor_out[ray] = c1;
    exhausted[ray] = ladder_at(p, l, static_cast<float>(c1)) >= t2;
    cursor[src] = c1;
  }
}

int check_params(const MarchParams* p) {
  const bool ok = p != nullptr && p->grid >= 1 && p->grid <= 1024 &&
      p->cascades >= 1 && p->n_rungs >= 1 && p->s_max >= 1 &&
      p->mode >= kExact && p->mode <= kUnion &&
      (p->mode == kExact ||
       (p->stratum >= 1 && p->s_strata >= 1 && p->s_strata <= kMaxChosen &&
        p->n_strata >= 1 && p->n_strata <= kMaxStrata)) &&
      (p->mode != kTwoLevel ||
       (p->n_probes >= 1 && p->n_probes <= kMaxProbes && p->g_c >= 1));
  return ok ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kWarps - 1) / kWarps);
}

}  // namespace

// The training march on `stream`. rays_o, rays_d (n, 3), hits (n, 2) and
// noise (n,) fp32; bits the uint8 occupancy bitfield; stage_a the two-level
// march's (g, g, g) bool grid or the cascade march's union bitfield, null in
// the exact march. Outputs: xyzs (n, s_max, 3), deltas, ts (n, s_max) fp32,
// mask (n, s_max) bool, n_samples (n,) int64, k_idx (n, s_max) int64,
// t_start (n,) fp32.
extern "C" int march_train(const MarchParams* params, long long n,
                           const void* rays_o, const void* rays_d,
                           const void* hits, const void* noise,
                           const void* bits, const void* stage_a,
                           void* xyzs, void* deltas, void* ts, void* mask,
                           void* n_samples, void* k_idx, void* t_start,
                           void* stream) {
  const int bad = check_params(params);
  if (bad) return bad;
  if (params->mode != kExact && stage_a == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return static_cast<int>(cudaSuccess);
  march_train_kernel<<<blocks_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      *params, n, static_cast<const float*>(rays_o),
      static_cast<const float*>(rays_d), static_cast<const float*>(hits),
      static_cast<const float*>(noise), static_cast<const uint8_t*>(bits),
      static_cast<const uint8_t*>(stage_a), static_cast<float*>(xyzs),
      static_cast<float*>(deltas), static_cast<float*>(ts),
      static_cast<bool*>(mask), static_cast<int64_t*>(n_samples),
      static_cast<int64_t*>(k_idx), static_cast<float*>(t_start));
  return static_cast<int>(cudaGetLastError());
}

// The window march on `stream` over the rows index[0 .. n) (int64) of the
// frame's arrays: params->n_rungs is n_window and params->s_max is s_cap;
// a ray takes `lanes` lanes (4, 8, 16 or 32). rays_o, rays_d (m, 3),
// t_start, t2 (m,) fp32 and cursor (m,) int64 are the frame's, the new
// cursors written into cursor at index[r]; count null, or one int64 on the
// device, the alive count: rows at or past it march nothing (above); bits
// the uint8 bitfield; stage_a, for params->mode 1, the (g, g, g) bool
// stage-A grid. Outputs:
// xyzs (n, s_cap, 3), deltas, ts (n, s_cap) fp32, mask (n, s_cap) bool,
// n_samples (n,) int64, cursor_out (n,) int64, exhausted (n,) bool, k_idx
// (n, s_cap) int64.
extern "C" int march_window(const MarchParams* params, int lanes,
                            long long n, const void* rays_o,
                            const void* rays_d, const void* t_start,
                            const void* t2, void* cursor, const void* index,
                            const void* count, const void* bits,
                            const void* stage_a,
                            void* xyzs, void* deltas, void* ts, void* mask,
                            void* n_samples, void* cursor_out,
                            void* exhausted, void* k_idx, void* stream) {
  const MarchParams* p = params;
  const bool ok = p != nullptr && p->grid >= 1 && p->grid <= 1024 &&
      p->cascades >= 1 && p->n_rungs >= 1 && p->s_max >= 1 &&
      index != nullptr &&
      (p->mode == kExact ||
       (p->mode == kTwoLevel && p->stratum >= 1 && stage_a != nullptr &&
        p->n_probes >= 1 && p->n_probes <= kMaxProbes && p->g_c >= 1)) &&
      (lanes == 4 || lanes == 8 || lanes == 16 || lanes == 32);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const unsigned blocks =
      static_cast<unsigned>((n * lanes + kThreads - 1) / kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const WindowOut out{static_cast<float*>(xyzs), static_cast<float*>(deltas),
                      static_cast<float*>(ts), static_cast<bool*>(mask),
                      static_cast<int64_t*>(k_idx)};
#define MARCH_WINDOW_LAUNCH(L, SKIP)                                        \
  march_window_kernel<L, SKIP><<<blocks, kThreads, 0, s>>>(                 \
      *p, n, static_cast<const float*>(rays_o),                             \
      static_cast<const float*>(rays_d), static_cast<const float*>(t_start), \
      static_cast<const float*>(t2), static_cast<int64_t*>(cursor),         \
      static_cast<const int64_t*>(index),                                   \
      static_cast<const long long*>(count),                                 \
      static_cast<const uint8_t*>(bits),                                    \
      static_cast<const uint8_t*>(stage_a), out,                            \
      static_cast<int64_t*>(n_samples), static_cast<int64_t*>(cursor_out),  \
      static_cast<bool*>(exhausted))
#define MARCH_WINDOW_LANES(SKIP)                \
  switch (lanes) {                              \
    case 4: MARCH_WINDOW_LAUNCH(4, SKIP); break;   \
    case 8: MARCH_WINDOW_LAUNCH(8, SKIP); break;   \
    case 16: MARCH_WINDOW_LAUNCH(16, SKIP); break; \
    default: MARCH_WINDOW_LAUNCH(32, SKIP); break; \
  }
  if (p->mode == kTwoLevel) {
    MARCH_WINDOW_LANES(true)
  } else {
    MARCH_WINDOW_LANES(false)
  }
#undef MARCH_WINDOW_LANES
#undef MARCH_WINDOW_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
