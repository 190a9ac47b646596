// Row softmax with a non-uniform PWL exp: the fused PWL-exp softmax of paper
// Sec. V-B.
//
// Replaces repro/kernels/fused/softmax.py:_softmax_kernel (forward).  Each row
// of x (R, N) f32 becomes
//
//   xm = keep ? x : -1e30            m = max(xm)
//   p  = max(pwl(max(xm - m, -1e4)), 0) * keep
//   y  = p / max(sum(p), 1e-30)
//
// keep is either an explicit {0, 1} f32 mask (R, N) or synthesized from the
// position: rows flatten (..., seq_len), so qpos = row % seq_len, and keep is
// (col <= qpos) under causal and (qpos - col < window) under a window; with
// neither it is all ones.  pwl is the launch's epilogue (epilogue.cuh): the
// table's decode, or the exact exp (act="exp", the JAX package's default
// when no table is given) inside the same clamps.
//
// What bounds it on an H100: bytes, at least.  It must read x where a score
// is kept (and the mask, where there is one) and write y once: at most 8
// bytes a score (12 with a mask, about 6 under a causal mask).  The table is
// decoded by the breakpoint search of pwl_decode.cuh (two compares on pivots
// in registers, five shared loads, one float2 read of the host-built prefix
// table), about 6 warp-wide shared loads for 32 scores, where the linear
// chain took 2-3 for each of the 32 breakpoints: at the training rows the
// search's loads take ~9 us of shared-memory issue on 132 SMs against the
// 45 us the bytes need.  Measured there, the kernel takes ~1.7x the bytes'
// time: a kept score still costs ~50 instructions (the search, and the
// IEEE division by the sum that keeps the bits of the design before it), so
// instruction issue, not bandwidth, holds it.  The design:
//   * a masked score is never decoded and x is not read there: its
//     probability is +0 and it adds nothing to the row sum;
//   * rows up to 1024 wide take one warp each, 8 rows a 256-thread block,
//     and live in registers (ceil(N / 32) floats a lane, in a bucket of 1,
//     2, 4, ..., 32): lane l owns columns l, l + 32, ... and sums them in
//     that order, then a __shfl_xor_sync tree -- the order of the shared-
//     memory design before it, so these rows give its bits;
//   * wider rows split over a thread-block cluster of 1-8 blocks of 256
//     threads (the host picks the size, kernels/fused/softmax.py:
//     _split_plan: enough blocks to fill the SMs, and a slice of at most
//     4096 columns a block, 16 registers a thread).  Each block reduces its
//     slice, publishes the partial max, then the partial sum, in its shared
//     memory, and after a cluster barrier every block reads its peers'
//     partials through distributed shared memory in rank order, so every
//     block of the row finishes with the same max and sum.  Nothing carries
//     over between launches.  A row of one block sums in the order of the
//     shared-memory design before it.
//
// The backward (pwl_softmax_backward) replaces
// repro/kernels/fused/softmax.py:_softmax_bwd_kernel: one launch recomputes a
// row's forward and applies the JAX package's VJP, with the row max
// differentiated (for a PWL exp the shift term does not cancel):
//
//   u  = max(pwl(s), 0) * keep,  s = max(t, -1e4),  t = xm - m,  L = max(sum(u), 1e-30)
//   du = g / L - gl * sum(g * u) / (L * L)
//   dt = du * keep * gate_p * slope * gate_t
//   dx = (dt + dm * eq / ntie) * keep,  dm = -sum(dt)
//
// where each gate is 1 above its clamp's threshold, 0.5 at it and 0 below
// (jnp's convention for maximum), and eq marks the argmax ties, over which
// dm is split equally.  It reads x and g where a score is kept, once each,
// and writes dx in full (about 8 bytes a causal score), with one search
// decode of value and slope a kept score: bound by bytes, as the forward.
// The row stays in registers (x, then the gates times the slope, then dt;
// and g) with the same split as the forward.  A masked column's dx is
// (shift * 0 + tie) * 0, the value the formula above gives it for finite
// inputs without its decode: +0, or the NaN an all-masked row gets (there
// m = -1e30, every column ties, l = 0 and gl * 0 / (L * L) is 0 / 0, in the
// JAX package too).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_WIDTH = 32768;
constexpr int NARROW_WIDTH = 1024;   // rows up to this wide take one warp each
constexpr int MAX_CLUSTER = 8;       // blocks a wide row splits over, at most
constexpr int WIDE_PER_THREAD = 16;  // a wide row's columns a thread holds, at most
constexpr int SLICE_ALIGN = 32;      // a block's slice starts on a warp's 32 columns

struct Keep {
  const float* mask;  // row of the explicit mask, or nullptr
  int qpos;
  int causal;
  int has_window;
  int window;
  // the synthesized mask (mask == nullptr) keeps the columns lo..hi
  __device__ __forceinline__ int lo() const { return has_window ? qpos - window + 1 : 0; }
  __device__ __forceinline__ int hi() const { return causal ? qpos : 0x7fffffff; }
};

template <bool IS_MAX>
__device__ __forceinline__ float combine(float a, float b) {
  return IS_MAX ? fmaxf(a, b) : a + b;
}

template <bool IS_MAX>
__device__ __forceinline__ float warp_reduce(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = combine<IS_MAX>(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The row's reduction of NV values at once over the blocks of a wide row: a
// warp tree, the warps' partials in warp order, then (a cluster) each block's
// partial in rank order, read from the peers' s_part.  Every thread of every
// block of the row returns the same values.  s_part[slot .. slot + NV) must
// not have been used by an earlier reduction of this launch.
template <int NV, bool IS_MAX>
__device__ __forceinline__ void row_reduce(float* v, float (*s_red)[WARPS], float* s_part,
                                           int slot, int cs) {
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = warp_reduce<IS_MAX>(v[i]);
  __syncthreads();  // the previous reduction's readers are done with s_red
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) s_red[i][threadIdx.x / 32] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    v[i] = s_red[i][0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) v[i] = combine<IS_MAX>(v[i], s_red[i][w]);
  }
  if (cs == 1) return;
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) s_part[slot + i] = v[i];
  }
  cluster.sync();
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float part[MAX_CLUSTER];  // the peers' partials, all read before any is combined
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (r < cs) part[r] = *cluster.map_shared_rank(s_part + slot + i, r);
    v[i] = part[0];
#pragma unroll
    for (int r = 1; r < MAX_CLUSTER; ++r)
      if (r < cs) v[i] = combine<IS_MAX>(v[i], part[r]);
  }
}

// the 0 / 0.5 / 1 gradient gate of max(v, threshold), jnp's convention
__device__ __forceinline__ float max_gate(float v, float threshold) {
  return v > threshold ? 1.0f : (v == threshold ? 0.5f : 0.0f);
}

// Where a row's columns live: a warp's lanes (narrow rows; one row a warp) or
// a block's threads over the block's slice of a wide row.  Thread `me` of
// `stride` holds columns c0 + me + stride * j, j < PT, below c1.
struct Cols {
  int c0, c1, me, stride;
  __device__ __forceinline__ int at(int j) const { return c0 + me + stride * j; }
};

// Bits j < PT of the thread's columns at(j) in lo..hi, by arithmetic on the
// range rather than a test a column.
template <int PT>
__device__ __forceinline__ unsigned span_bits(const Cols& cols, int lo, int hi) {
  const int base = cols.c0 + cols.me;
  lo = max(lo, cols.c0);
  hi = min(hi, cols.c1 - 1);
  if (hi < base || hi < lo) return 0u;
  const int first = lo > base ? (lo - base + cols.stride - 1) / cols.stride : 0;
  const int last = min((hi - base) / cols.stride, PT - 1);
  if (first > last) return 0u;
  return ((2u << last) - 1u) & ~((1u << first) - 1u);  // 2u << 31 wraps to 0
}

// Bit j set where this thread's column cols.at(j) is kept (in: the bits of
// its columns in the row).  The mask, where there is one, is read for every
// column before any is tested, so the loads are in flight together.
template <int PT>
__device__ __forceinline__ unsigned kept_bits(const Keep& keep, const Cols& cols, unsigned in) {
  if (keep.mask == nullptr) return span_bits<PT>(cols, keep.lo(), keep.hi());
  float mk[PT];
#pragma unroll
  for (int j = 0; j < PT; ++j) mk[j] = (in >> j & 1u) ? keep.mask[cols.at(j)] : 0.0f;
  unsigned kept = 0;
#pragma unroll
  for (int j = 0; j < PT; ++j) kept |= (mk[j] > 0.0f ? 1u : 0u) << j;
  return kept;
}

// x where kept and -1e30 where masked (the masked-score fill), every load
// issued before the row max reads one; returns the thread's max.
template <int PT>
__device__ __forceinline__ float load_scores(const float* __restrict__ x, unsigned kept,
                                             unsigned in, const Cols& cols, float (&v)[PT]) {
#pragma unroll
  for (int j = 0; j < PT; ++j) v[j] = (kept >> j & 1u) ? x[cols.at(j)] : NEG_FILL;
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < PT; ++j)
    if (in >> j & 1u) mx = fmaxf(mx, v[j]);
  return mx;
}

// The table search operands, once a block.
template <int TABLE>
struct Search {
  const SearchTable<TABLE>* tab;
  float3 piv;
};

// Without a table: the exact exp (act="exp", the softmax's own function)
// inline; the other exact functions and the identity out of line, since a
// row's PT decodes are unrolled.
__device__ __noinline__ float2 other_value_and_slope(Epilogue ep, float x, const PwlSearch* tab) {
  return epi_search_value_and_slope<false>(ep, x, *tab, make_float3(0.0f, 0.0f, 0.0f));
}

__device__ __forceinline__ bool is_exact_exp(const Epilogue& ep) {
  return ep.kind == EPI_EXACT && ep.fn == FN_EXP;
}

// max(act(max(x, -1e4)), 0): the exp of the softmax chains.
template <int TABLE>
__device__ __forceinline__ float row_exp(const Epilogue& ep, float x, const Search<TABLE>& sr) {
  if constexpr (TABLE != TABLE_NONE) {
    return epi_search_exp<TABLE>(ep, x, *sr.tab, sr.piv);
  } else {
    if (is_exact_exp(ep)) return epi_search_exp<false>(Epilogue{EPI_EXACT, FN_EXP, 0}, x, *sr.tab,
                                                       sr.piv);
    return fmaxf(other_value_and_slope(ep, fmaxf(x, SHIFT_CLAMP), sr.tab).x, 0.0f);
  }
}

// (act(s), act'(s)) of the clamped shifted score s.
template <int TABLE>
__device__ __forceinline__ float2 row_value_and_slope(const Epilogue& ep, float s,
                                                      const Search<TABLE>& sr) {
  if constexpr (TABLE != TABLE_NONE) {
    return epi_search_value_and_slope<TABLE>(ep, s, *sr.tab, sr.piv);
  } else {
    if (is_exact_exp(ep))
      return epi_search_value_and_slope<false>(Epilogue{EPI_EXACT, FN_EXP, 0}, s, *sr.tab, sr.piv);
    return other_value_and_slope(ep, s, sr.tab);
  }
}

// The forward on one row's columns: max, PWL exp of the kept scores, sum,
// y.  WIDE: the row's reductions span the block and its cluster (cs blocks a
// row); otherwise the warp holds the whole row.
template <int PT, int TABLE, bool WIDE>
__device__ __forceinline__ void softmax_row(const float* __restrict__ x, const Keep& keep,
                                            const Epilogue& ep, const Search<TABLE>& sr,
                                            float* __restrict__ out, const Cols& cols,
                                            float (*s_red)[WARPS], float* s_part, int cs) {
  float v[PT];
  const unsigned in = span_bits<PT>(cols, cols.c0, cols.c1 - 1);
  const unsigned kept = kept_bits<PT>(keep, cols, in);
  const float mx = load_scores<PT>(x, kept, in, cols, v);
  float red[1] = {mx};
  if constexpr (WIDE) row_reduce<1, true>(red, s_red, s_part, 0, cs);
  else red[0] = warp_reduce<true>(mx);
  const float m = red[0];

  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < PT; ++j) {
    if (kept >> j & 1u) {
      v[j] = row_exp<TABLE>(ep, v[j] - m, sr);
      sum += v[j];
    }
  }
  red[0] = sum;
  if constexpr (WIDE) row_reduce<1, false>(red, s_red, s_part, 1, cs);
  else red[0] = warp_reduce<false>(sum);
  const float l = fmaxf(red[0], 1e-30f);

#pragma unroll
  for (int j = 0; j < PT; ++j)
    if (in >> j & 1u) out[cols.at(j)] = (kept >> j & 1u) ? v[j] / l : 0.0f;
}

// The backward on one row's columns (the VJP in the header).
template <int PT, int TABLE, bool WIDE>
__device__ __forceinline__ void softmax_bwd_row(const float* __restrict__ x, const Keep& keep,
                                                const float* __restrict__ g, const Epilogue& ep,
                                                const Search<TABLE>& sr, float* __restrict__ dx,
                                                const Cols& cols, float (*s_red)[WARPS],
                                                float* s_part, int cs) {
  float v[PT];   // x, then gate_p * gate_t * slope, then dt
  float gv[PT];  // g where kept
  const unsigned in = span_bits<PT>(cols, cols.c0, cols.c1 - 1);
  const unsigned kept = kept_bits<PT>(keep, cols, in);
#pragma unroll
  for (int j = 0; j < PT; ++j) gv[j] = (kept >> j & 1u) ? g[cols.at(j)] : 0.0f;
  const float mx = load_scores<PT>(x, kept, in, cols, v);
  unsigned tie = 0;
  float red[3] = {mx, 0.0f, 0.0f};
  if constexpr (WIDE) row_reduce<1, true>(red, s_red, s_part, 0, cs);
  else red[0] = warp_reduce<true>(mx);
  const float m = red[0];
  const bool fill_ties = m == NEG_FILL;  // then the masked columns tie with the max

  // value and slope once a kept score: the sums l, sum(g * u) and the tie
  // count; v keeps gate_p * gate_t * slope (the gates are 0, 0.5 or 1, so
  // this product times du rounds as du * slope does)
  float l_part = 0.0f, gu_part = 0.0f, tie_part = 0.0f;
#pragma unroll
  for (int j = 0; j < PT; ++j) {
    if (kept >> j & 1u) {
      const float xm = v[j];
      const float t = xm - m;
      const float2 vs = row_value_and_slope<TABLE>(ep, fmaxf(t, SHIFT_CLAMP), sr);
      const float u = fmaxf(vs.x, 0.0f);
      l_part += u;
      gu_part += gv[j] * u;
      if (xm == m) {
        tie_part += 1.0f;
        tie |= 1u << j;
      }
      v[j] = max_gate(vs.x, 0.0f) * max_gate(t, SHIFT_CLAMP) * vs.y;
    } else if (fill_ties && (in >> j & 1u)) {
      tie_part += 1.0f;
    }
  }
  red[0] = l_part;
  red[1] = gu_part;
  red[2] = tie_part;
  if constexpr (WIDE) {
    row_reduce<3, false>(red, s_red, s_part, 1, cs);
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i) red[i] = warp_reduce<false>(red[i]);
  }
  const float l = red[0], gu = red[1], ntie = red[2];
  const float L = fmaxf(l, 1e-30f);
  const float gl = max_gate(l, 1e-30f);
  const float shift = gl * gu / (L * L);

  // dt, and dm = -sum(dt)
  float dt_part = 0.0f;
#pragma unroll
  for (int j = 0; j < PT; ++j) {
    if (kept >> j & 1u) {
      v[j] = (gv[j] / L - shift) * v[j];
      dt_part += v[j];
    }
  }
  red[0] = dt_part;
  if constexpr (WIDE) row_reduce<1, false>(red, s_red, s_part, 4, cs);
  else red[0] = warp_reduce<false>(dt_part);
  const float dm = -red[0];

  // dx, with dm split over the argmax ties; a masked column's as in the header
  const float masked = (shift * 0.0f + (fill_ties ? dm / ntie : 0.0f)) * 0.0f;
#pragma unroll
  for (int j = 0; j < PT; ++j) {
    if (in >> j & 1u) {
      if (kept >> j & 1u) {
        const float tv = (tie >> j & 1u) ? dm / ntie : 0.0f;
        dx[cols.at(j)] = v[j] + tv;
      } else {
        dx[cols.at(j)] = masked;
      }
    }
  }
}

template <int TABLE>
__device__ __forceinline__ Search<TABLE> load_search(SearchTable<TABLE>* s_tab, const float* bp,
                                                     const float* mq, const Epilogue& ep) {
  epi_load_search<TABLE>(s_tab, bp, mq, ep);
  __syncthreads();
  return Search<TABLE>{s_tab, epi_search_pivots<TABLE>(*s_tab)};
}

__device__ __forceinline__ Keep keep_of(const float* mask, long long row, int N, int seq_len,
                                        int causal, int has_window, int window) {
  return Keep{mask != nullptr ? mask + (size_t)row * N : nullptr, (int)(row % seq_len), causal,
              has_window, window};
}

// Narrow rows: a warp a row, WARPS rows a block, PT = ceil(N / 32) bucketed.
template <int PT, int TABLE>
__global__ void __launch_bounds__(THREADS)
softmax_narrow_kernel(const float* __restrict__ x, const float* __restrict__ mask,
                      const float* __restrict__ bp, const float* __restrict__ mq, Epilogue ep,
                      float* __restrict__ out, int R, int N, int seq_len, int causal,
                      int has_window, int window) {
  __shared__ SearchTable<TABLE> s_tab;
  const Search<TABLE> sr = load_search<TABLE>(&s_tab, bp, mq, ep);
  const long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= R) return;  // the whole warp: no block barrier follows
  const size_t base = (size_t)row * N;
  const Cols cols{0, N, (int)(threadIdx.x & 31), 32};
  softmax_row<PT, TABLE, false>(x + base, keep_of(mask, row, N, seq_len, causal, has_window,
                                                  window),
                                ep, sr, out + base, cols, nullptr, nullptr, 1);
}

template <int PT, int TABLE>
__global__ void __launch_bounds__(THREADS)
softmax_bwd_narrow_kernel(const float* __restrict__ x, const float* __restrict__ mask,
                          const float* __restrict__ g, const float* __restrict__ bp,
                          const float* __restrict__ mq, Epilogue ep, float* __restrict__ dx,
                          int R, int N, int seq_len, int causal, int has_window, int window) {
  __shared__ SearchTable<TABLE> s_tab;
  const Search<TABLE> sr = load_search<TABLE>(&s_tab, bp, mq, ep);
  const long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= R) return;
  const size_t base = (size_t)row * N;
  const Cols cols{0, N, (int)(threadIdx.x & 31), 32};
  softmax_bwd_row<PT, TABLE, false>(x + base, keep_of(mask, row, N, seq_len, causal, has_window,
                                                      window),
                                    g + base, ep, sr, dx + base, cols, nullptr, nullptr, 1);
}

// Wide rows: cs blocks a row (a cluster when cs > 1), rank r owning columns
// [r * slice, (r + 1) * slice) of it, PT = ceil(slice / THREADS) bucketed.
template <int PT, int TABLE>
__global__ void __launch_bounds__(THREADS)
softmax_wide_kernel(const float* __restrict__ x, const float* __restrict__ mask,
                    const float* __restrict__ bp, const float* __restrict__ mq, Epilogue ep,
                    float* __restrict__ out, int N, int seq_len, int causal, int has_window,
                    int window, int cs, int slice) {
  __shared__ SearchTable<TABLE> s_tab;
  __shared__ float s_red[1][WARPS];
  __shared__ float s_part[2];
  const Search<TABLE> sr = load_search<TABLE>(&s_tab, bp, mq, ep);
  const long long row = blockIdx.x / cs;
  const int c0 = (int)(blockIdx.x % cs) * slice;
  const size_t base = (size_t)row * N;
  const Cols cols{c0, min(c0 + slice, N), (int)threadIdx.x, THREADS};
  softmax_row<PT, TABLE, true>(x + base, keep_of(mask, row, N, seq_len, causal, has_window,
                                                 window),
                               ep, sr, out + base, cols, s_red, s_part, cs);
  if (cs > 1) cg::this_cluster().sync();  // the peers have read this block's s_part
}

template <int PT, int TABLE>
__global__ void __launch_bounds__(THREADS)
softmax_bwd_wide_kernel(const float* __restrict__ x, const float* __restrict__ mask,
                        const float* __restrict__ g, const float* __restrict__ bp,
                        const float* __restrict__ mq, Epilogue ep, float* __restrict__ dx, int N,
                        int seq_len, int causal, int has_window, int window, int cs, int slice) {
  __shared__ SearchTable<TABLE> s_tab;
  __shared__ float s_red[3][WARPS];
  __shared__ float s_part[5];
  const Search<TABLE> sr = load_search<TABLE>(&s_tab, bp, mq, ep);
  const long long row = blockIdx.x / cs;
  const int c0 = (int)(blockIdx.x % cs) * slice;
  const size_t base = (size_t)row * N;
  const Cols cols{c0, min(c0 + slice, N), (int)threadIdx.x, THREADS};
  softmax_bwd_row<PT, TABLE, true>(x + base, keep_of(mask, row, N, seq_len, causal, has_window,
                                                     window),
                                   g + base, ep, sr, dx + base, cols, s_red, s_part, cs);
  if (cs > 1) cg::this_cluster().sync();
}

// The smallest bucket (a power of two) that holds n, up to MAX.
template <int MAX>
int bucket(int n) {
  int b = 1;
  while (b < n && b < MAX) b *= 2;
  return n <= b ? b : -1;
}

// f(std::integral_constant<int, PT>{}) for PT in 1, 2, 4, ..., MAX.
template <int MAX, class F>
int with_bucket(int pt, F&& f) {
  switch (pt) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    default:
      if constexpr (MAX >= 32) {
        if (pt == 32) return f(std::integral_constant<int, 32>{});
      }
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// A launch's blocks: R rows, cs blocks a row, each owning slice columns of
// it and holding pt a thread (a lane, for a narrow row).
struct Shape {
  int R, cs, slice, pt;
};

// Checks the launch's arguments and derives a wide row's slice and the
// register bucket: the same rule as kernels/fused/softmax.py:_split_plan.
int plan_shape(const Epilogue& ep, const void* mq, int R, int N, int seq_len, int cs, Shape* s) {
  if (!epilogue_ok(ep) || (is_table(ep.kind) && mq == nullptr) || R < 0 || N < 1 ||
      N > MAX_WIDTH || seq_len < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  *s = Shape{R, cs, N, 0};
  if (N <= NARROW_WIDTH) {
    if (cs != 1) return static_cast<int>(cudaErrorInvalidValue);
    s->pt = bucket<32>((N + 31) / 32);
    const long long blocks = ((long long)R + WARPS - 1) / WARPS;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    return 0;
  }
  if (cs < 1 || cs > MAX_CLUSTER || (cs & (cs - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = (N + cs - 1) / cs;
  s->slice = (per_block + SLICE_ALIGN - 1) / SLICE_ALIGN * SLICE_ALIGN;
  s->pt = bucket<WIDE_PER_THREAD>((s->slice + THREADS - 1) / THREADS);
  if (s->pt < 0 || (long long)R * cs > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// Launch a wide kernel: a plain launch for one block a row, a cluster of cs
// blocks otherwise (capturable in a CUDA graph).
template <class... Params, class... Args>
int launch_wide(void (*kern)(Params...), const Shape& s, cudaStream_t stream, Args... args) {
  const unsigned blocks = static_cast<unsigned>((long long)s.R * s.cs);
  if (s.cs == 1) {
    kern<<<blocks, THREADS, 0, stream>>>(args...);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = s.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

unsigned narrow_blocks(int R) { return static_cast<unsigned>(((long long)R + WARPS - 1) / WARPS); }

}  // namespace

// x, out: (R, N) f32, contiguous; mask: (R, N) f32 in {0, 1} or null.
// seq_len: rows per query block for the synthesized causal/window mask.  The
// exp is the epilogue (bp, dmq, n_bp, kind, fn) of epilogue.cuh: the PWL
// table, decoded by the search from the padded breakpoints bp and the prefix
// table mq ((n_bp + 1) x 2 f32, epilogue.py:search_prefix; dmq is not read),
// or an exact function (exp).  cluster: blocks a row wider than 1024 splits
// over (1, 2, 4 or 8; 1 for narrower rows), from _split_plan.  Returns the
// cudaError_t of the launch.
extern "C" int pwl_softmax_forward(const void* x, const void* mask, const void* bp,
                                   const void* dmq, int n_bp, int kind, int fn, const void* mq,
                                   void* out, int R, int N, int seq_len, int causal,
                                   int has_window, int window, int cluster, void* stream) {
  (void)dmq;
  const Epilogue ep{kind, fn, n_bp};
  Shape s;
  if (int e = plan_shape(ep, mq, R, N, seq_len, cluster, &s)) return e;
  if (R == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* mf = static_cast<const float*>(mask);
  const float* bpf = static_cast<const float*>(bp);
  const float* mqf = static_cast<const float*>(mq);
  float* of = static_cast<float*>(out);
  return with_table(ep, [&](auto table) {
    constexpr int TB = decltype(table)::value;
    if (N <= NARROW_WIDTH) {
      return with_bucket<32>(s.pt, [&](auto pt) {
        constexpr int PT = decltype(pt)::value;
        softmax_narrow_kernel<PT, TB><<<narrow_blocks(R), THREADS, 0, st>>>(
            xf, mf, bpf, mqf, ep, of, R, N, seq_len, causal, has_window, window);
        return static_cast<int>(cudaGetLastError());
      });
    }
    return with_bucket<WIDE_PER_THREAD>(s.pt, [&](auto pt) {
      constexpr int PT = decltype(pt)::value;
      return launch_wide(softmax_wide_kernel<PT, TB>, s, st, xf, mf, bpf, mqf, ep, of, N,
                         seq_len, causal, has_window, window, s.cs, s.slice);
    });
  });
}

// x, g, dx: (R, N) f32, contiguous; mask: (R, N) f32 in {0, 1} or null;
// seq_len, causal, window, the epilogue, mq and cluster as for the forward.
// Returns the cudaError_t of the launch.
extern "C" int pwl_softmax_backward(const void* x, const void* mask, const void* g,
                                    const void* bp, const void* dmq, int n_bp, int kind, int fn,
                                    const void* mq, void* dx, int R, int N, int seq_len,
                                    int causal, int has_window, int window, int cluster,
                                    void* stream) {
  (void)dmq;
  const Epilogue ep{kind, fn, n_bp};
  Shape s;
  if (int e = plan_shape(ep, mq, R, N, seq_len, cluster, &s)) return e;
  if (R == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* mf = static_cast<const float*>(mask);
  const float* gf = static_cast<const float*>(g);
  const float* bpf = static_cast<const float*>(bp);
  const float* mqf = static_cast<const float*>(mq);
  float* df = static_cast<float*>(dx);
  return with_table(ep, [&](auto table) {
    constexpr int TB = decltype(table)::value;
    if (N <= NARROW_WIDTH) {
      return with_bucket<32>(s.pt, [&](auto pt) {
        constexpr int PT = decltype(pt)::value;
        softmax_bwd_narrow_kernel<PT, TB><<<narrow_blocks(R), THREADS, 0, st>>>(
            xf, mf, gf, bpf, mqf, ep, df, R, N, seq_len, causal, has_window, window);
        return static_cast<int>(cudaGetLastError());
      });
    }
    return with_bucket<WIDE_PER_THREAD>(s.pt, [&](auto pt) {
      constexpr int PT = decltype(pt)::value;
      return launch_wide(softmax_bwd_wide_kernel<PT, TB>, s, st, xf, mf, gf, bpf, mqf, ep, df,
                         N, seq_len, causal, has_window, window, s.cs, s.slice);
    });
  });
}
