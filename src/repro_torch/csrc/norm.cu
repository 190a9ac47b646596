// Fused RMSNorm with an epilogue, forward and backward.
//
// Replaces repro/kernels/fused/norm.py:_rmsnorm_kernel (forward) and
// _rmsnorm_bwd_kernel (backward).  x is (M, D) in T (bf16 or f32), scale (D,)
// f32; per row, in f32,
//
//   r  = rsqrt(sum(x^2) / D + eps)      (D the true width: nothing is padded)
//   xh = x * r;  w = 1 + scale;  y = xh * w;  out = act(y), stored in T
//
// act being the launch's epilogue (epilogue.cuh: identity, an exact function
// or the PWL table).  The backward recomputes r, xh and y, decodes the slope
// and writes, with g read in T,
//
//   dy = g * act'(y);  du = dy * w;  dx = r * (du - xh * sum(du * xh) / D)  (f32)
//
// and one f32 partial of ds = sum over the rows of dy * xh per tile of
// TILE_ROWS rows, (ceil(M / TILE_ROWS), D), which the caller sums in a fixed
// order (torch.sum), as the JAX package sums its per-block partials in jnp.
// Each partial is summed over its rows in row order by one thread: no
// atomics, so ds is bitwise the same from run to run.
//
// What bounds them on an H100: bytes.  The forward reads x once and writes y
// once (4 bytes an element in bf16: 12.6 MB, ~3.8 us at 3.35 TB/s for
// repro-100m's 4096 x 768 training rows); the backward reads x and g and
// writes dx in f32 (8 bytes an element in bf16).  A table is decoded by the
// breakpoint search of pwl_decode.cuh (pwl_search_value_and_slope, the flash,
// GLU and softmax kernels' decode: seven steps, two on pivots in registers,
// then the prefix table's (m, q)), where the linear chain took three shared
// loads and two fmaf a breakpoint.
// The design:
//   * lane l of a row owns columns l, l + 32, ...: it sums their squares
//     from +0 in that order and a __shfl_xor_sync tree closes the row, the
//     order of the design before this one, so r, y and every output keep its
//     bits (the search gives the chain's (m, q) on ascending breakpoints, and
//     the value is the same fmaf);
//   * the row lives in registers, read once.  A backward row is one warp's up
//     to 1024 columns.  A forward row is one warp's up to 768, wider ones
//     split over S = 2 or 4 warps (up to 4096 columns), part s holding the
//     lane's columns s P .. s P + P - 1; the lane's sum runs through the
//     parts in column order, handed over in shared memory between block
//     barriers, so the split changes no bit.  The host picks P and S
//     (kernels/fused/norm.py:_row_plan) among the splits built here
//     (with_fwd_split, with_bwd_split).  Wider rows are streamed a few
//     columns a lane at a time and read twice, the second time from the
//     cache, in the same order;
//   * 1 + scale is staged in shared memory once a block, and the row's loads
//     are in flight while the block stages it and the table;
//   * the backward gives a block one tile of TILE_ROWS rows, a warp a row.
//     A row loads x and g, reduces r, decodes each element's slope once into
//     dy, which stays in registers (x is read again from the cache past 16
//     columns a lane, so that two 768-wide tiles share an SM; a streamed row
//     parks dy in dx's own buffer), reduces sum(du * xh), then writes dx and
//     stages (dy, xh) in shared memory 256 columns at a time, where one
//     thread a column sums the tile's rows in row order into the ds partial:
//     the order, and so the bits, of the column walk before it;
//   * identity and exact gelu are inlined into the unrolled rows; the other
//     exact functions are called out of line.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "epilogue.cuh"

namespace {

constexpr int TILE_ROWS = 16;      // rows of a ds partial, and of a backward block
constexpr int FWD_THREADS = 256;   // a forward block: 8 warps, 8 / S rows
constexpr int FWD_WARPS = FWD_THREADS / 32;
constexpr int SC_FWD = 8;          // a streamed row's columns a lane at a time:
constexpr int SC_BWD = 16;         //   forward, backward
constexpr int STAGE_J = 8;         // a lane's columns a ds stage: 256 columns
constexpr int STAGE_COLS = 32 * STAGE_J;

// The epilogue as a compile-time mode: a table (the breakpoint search), the
// identity and exact gelu are inlined; any other exact function is called
// out of line.
enum Mode : int { MODE_TABLE, MODE_IDENTITY, MODE_GELU, MODE_EXACT };

template <class F>
int with_mode(const Epilogue& e, F&& f) {
  if (e.kind == EPI_PWL) return f(std::integral_constant<int, MODE_TABLE>{});
  if (e.kind == EPI_IDENTITY) return f(std::integral_constant<int, MODE_IDENTITY>{});
  if (e.fn == FN_GELU) return f(std::integral_constant<int, MODE_GELU>{});
  return f(std::integral_constant<int, MODE_EXACT>{});
}

// The table in shared memory and its pivots, once a block
struct Search {
  const PwlSearch* tab;
  float3 piv;  // pwl_search_pivots
};

// The block's shared operands: the table (a table mode) and, given s_w,
// w = 1 + scale of the D columns padded with zeros to n_w, so that a row's
// gains are shared loads and not one global load each on the row's critical
// path.  A padded column (x read as 0) then decodes to exact zeros that add
// +0 to a sum which starts at +0 and so change no bit: the forward's rows
// need no branch a column.  Every thread of the block calls it once.
template <int MODE>
__device__ __forceinline__ Search load_block(PwlSearch* s_tab, const float* bp, const float* mq,
                                             const Epilogue& ep, float* s_w, int n_w,
                                             const float* __restrict__ scale, int D) {
  Search sr{s_tab, make_float3(0.0f, 0.0f, 0.0f)};
  constexpr bool TAB = MODE == MODE_TABLE;
  if constexpr (TAB) pwl_search_load(s_tab, bp, mq, ep.n_bp);
  for (int c = threadIdx.x; c < n_w; c += blockDim.x) s_w[c] = c < D ? 1.0f + scale[c] : 0.0f;
  if (TAB || n_w > 0) __syncthreads();
  if constexpr (TAB) sr.piv = pwl_search_pivots(*s_tab);
  return sr;
}

__device__ __forceinline__ float2 search(float y, const Search& sr) {
  return pwl_search_value_and_slope(y, *sr.tab, sr.piv);
}

__device__ __noinline__ float exact_value(int fn, float y) { return exact_eval<false>(fn, y).x; }
__device__ __noinline__ float exact_slope(int fn, float y) { return exact_eval<true>(fn, y).y; }

// act(y): the forward's epilogue (the PWL value is fmaf(m, y, q), as before)
template <int MODE>
__device__ __forceinline__ float act_value(const Epilogue& ep, float y, const Search& sr) {
  if constexpr (MODE == MODE_TABLE) return search(y, sr).x;
  else if constexpr (MODE == MODE_IDENTITY) return y;
  else if constexpr (MODE == MODE_GELU) return exact_eval<false>(FN_GELU, y).x;
  else return exact_value(ep.fn, y);
}

// act'(y): the backward's
template <int MODE>
__device__ __forceinline__ float act_slope(const Epilogue& ep, float y, const Search& sr) {
  if constexpr (MODE == MODE_TABLE) return search(y, sr).y;
  else if constexpr (MODE == MODE_IDENTITY) return 1.0f;
  else if constexpr (MODE == MODE_GELU) return exact_eval<true>(FN_GELU, y).y;
  else return exact_slope(ep.fn, y);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float row_rsqrt(float ss, int D, float eps) {
  return rsqrtf(warp_sum(ss) / static_cast<float>(D) + eps);
}

// A second read of x or scale, from the cache: an ld.global.ca the compiler
// does not merge with the first read, so a row's values are not kept live
// across the reductions in registers the block does not have.
__device__ __forceinline__ float reread(const float* p) { return __ldca(p); }
__device__ __forceinline__ float reread(const __nv_bfloat16* p) {
  const unsigned short bits = __ldca(reinterpret_cast<const unsigned short*>(p));
  return __bfloat162float(__ushort_as_bfloat16(bits));
}

// ---------------------------------------------------------------------------
// forward

// The lane's running sum over its row's S parts in column order: part s
// (step) continues part s - 1's sum, handed over in s_hand between block
// barriers (every thread of the block passes them).  The sum is whole in
// part S - 1.
template <int S, class Step>
__device__ __forceinline__ float chain_parts(int part, int lane, float* s_hand, Step&& step) {
  float acc = 0.0f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (part == s) {
      if (s > 0) acc = s_hand[lane];
      acc = step(acc);
      if (s + 1 < S) s_hand[lane] = acc;
    }
    if (S > 1) __syncthreads();
  }
  return acc;
}

// A value of the row's last part to every part: part S - 1's lane 0 writes
// it to *slot, every thread passes a block barrier, every part reads it.
template <int S>
__device__ __forceinline__ float from_last_part(float v, int part, int lane, float* slot) {
  if constexpr (S == 1) return v;
  if (part == S - 1 && lane == 0) *slot = v;
  __syncthreads();
  return *slot;
}

// Rows in registers: a row of D <= 32 * P * S is S warps', part s (warp s of
// the row's S) holding columns lane + 32 (s P + j), j < P.  The row's loads
// are in flight while the block loads its shared operands, every output is
// formed before the first store (the decodes of a lane's columns overlap),
// and the registers are held to 64 a thread, so that 4096 rows up to 768
// wide fit the card at once.
template <typename T, int P, int S, int MODE>
__global__ void __launch_bounds__(FWD_THREADS, 4)
rmsnorm_rows_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                    const float* __restrict__ bp, const float* __restrict__ mq, Epilogue ep,
                    T* __restrict__ out, int M, int D, float eps) {
  constexpr int R = FWD_WARPS / S;  // rows a block
  __shared__ PwlSearch s_tab;
  __shared__ float s_w[32 * P * S];
  __shared__ float s_hand[R][32];
  __shared__ float s_r[R];
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int grp = warp / S, part = warp % S;
  const long long row = (long long)blockIdx.x * R + grp;
  const bool live = row < M;
  const int cb = 32 * P * part + lane;  // the lane's first column
  const T* xr = x + (size_t)row * D;
  T* orow = out + (size_t)row * D;
  float v[P];
#pragma unroll
  for (int j = 0; j < P; ++j) v[j] = live && cb + 32 * j < D ? to_f32(xr[cb + 32 * j]) : 0.0f;
  const Search sr = load_block<MODE>(&s_tab, bp, mq, ep, s_w, 32 * P * S, scale, D);
  const float ss = chain_parts<S>(part, lane, s_hand[grp], [&](float acc) {
#pragma unroll
    for (int j = 0; j < P; ++j) acc += v[j] * v[j];
    return acc;
  });
  const float r = from_last_part<S>(part == S - 1 ? row_rsqrt(ss, D, eps) : 0.0f, part, lane,
                                    &s_r[grp]);
  if (!live) return;  // the whole row's warps, after the last block barrier
#pragma unroll
  for (int j = 0; j < P; ++j) v[j] = act_value<MODE>(ep, v[j] * r * s_w[cb + 32 * j], sr);
#pragma unroll
  for (int j = 0; j < P; ++j)
    if (cb + 32 * j < D) store(v[j], orow + cb + 32 * j);
}

// A row wider than the registers, SC_FWD columns a lane at a time: x read twice,
// the second time from the cache.
template <typename T, int MODE>
__global__ void __launch_bounds__(FWD_THREADS)
rmsnorm_stream_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bp, const float* __restrict__ mq, Epilogue ep,
                      T* __restrict__ out, int M, int D, float eps) {
  __shared__ PwlSearch s_tab;
  const Search sr = load_block<MODE>(&s_tab, bp, mq, ep, nullptr, 0, scale, D);
  const long long row = (long long)blockIdx.x * FWD_WARPS + threadIdx.x / 32;
  if (row >= M) return;
  const int lane = threadIdx.x & 31;
  const T* xr = x + (size_t)row * D;
  T* orow = out + (size_t)row * D;
  float ss = 0.0f;
  for (int c0 = lane; c0 < D; c0 += 32 * SC_FWD) {
    float v[SC_FWD];
#pragma unroll
    for (int j = 0; j < SC_FWD; ++j) v[j] = c0 + 32 * j < D ? to_f32(xr[c0 + 32 * j]) : 0.0f;
#pragma unroll
    for (int j = 0; j < SC_FWD; ++j)
      if (c0 + 32 * j < D) ss += v[j] * v[j];
  }
  const float r = row_rsqrt(ss, D, eps);
  for (int c0 = lane; c0 < D; c0 += 32 * SC_FWD) {
    float v[SC_FWD], w[SC_FWD];
#pragma unroll
    for (int j = 0; j < SC_FWD; ++j) {
      const bool in = c0 + 32 * j < D;
      v[j] = in ? reread(xr + c0 + 32 * j) : 0.0f;
      w[j] = in ? 1.0f + scale[c0 + 32 * j] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < SC_FWD; ++j)
      if (c0 + 32 * j < D) v[j] = act_value<MODE>(ep, v[j] * r * w[j], sr);
#pragma unroll
    for (int j = 0; j < SC_FWD; ++j)
      if (c0 + 32 * j < D) store(v[j], orow + c0 + 32 * j);
  }
}

// ---------------------------------------------------------------------------
// backward

// The tile's ds partial over the columns c0 .. c0 + n of the stage: one
// thread a column sums the live rows' dy * xh in row order from +0, every
// row's pair read before the sum starts.  The warps have staged their rows;
// returns when the stage may be refilled.
__device__ __forceinline__ void stage_ds(float2 (*s_stage)[STAGE_COLS], int rows, int c0,
                                         int n, float* __restrict__ ds_row) {
  __syncthreads();
  const int cc = threadIdx.x;
  if (cc < n) {
    float2 p[TILE_ROWS];
#pragma unroll
    for (int i = 0; i < TILE_ROWS; ++i)
      if (i < rows) p[i] = s_stage[i][cc];
    float ds = 0.0f;
#pragma unroll
    for (int i = 0; i < TILE_ROWS; ++i)
      if (i < rows) ds += p[i].x * p[i].y;
    ds_row[c0 + cc] = ds;
  }
  __syncthreads();
}

// A tile whose rows live in registers, P columns a lane, D <= 32 * P: dy,
// and x up to 16 columns a lane (beyond, x is read again from the cache, so
// that up to 24 columns a lane two tiles share an SM).
template <typename T, int P, int MODE>
__global__ void __launch_bounds__(32 * TILE_ROWS, P <= 24 ? 2 : 1)
rmsnorm_bwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                        const T* __restrict__ g, const float* __restrict__ bp,
                        const float* __restrict__ mq, Epilogue ep, float* __restrict__ dx,
                        float* __restrict__ ds_part, int M, int D, float eps) {
  constexpr bool HOLD_X = P <= 16;
  constexpr int SJ = P < STAGE_J ? P : STAGE_J;  // a lane's columns a stage
  __shared__ PwlSearch s_tab;
  __shared__ float2 s_stage[TILE_ROWS][STAGE_COLS];  // (dy, xh)
  __shared__ float s_w[32 * P];
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const long long row0 = (long long)blockIdx.x * TILE_ROWS;
  const int rows = (int)min((long long)TILE_ROWS, (long long)M - row0);
  const bool live = warp < rows;
  const size_t base = (size_t)(row0 + warp) * D;
  const T* xr = x + base;
  float xv[HOLD_X ? P : 1];
  float dy[P];  // g, then dy
#pragma unroll
  for (int j = 0; j < P; ++j) {  // in flight while the block loads its shared operands
    const int col = lane + 32 * j;
    if constexpr (HOLD_X) xv[j] = live && col < D ? to_f32(xr[col]) : 0.0f;
    dy[j] = live && col < D ? to_f32(g[base + col]) : 0.0f;
  }
  const Search sr = load_block<MODE>(&s_tab, bp, mq, ep, s_w, 32 * P, scale, D);
  auto xh_of = [&](int j, float r) {  // x r of the lane's column j (< D)
    if constexpr (HOLD_X) return xv[j] * r;
    else return reread(xr + lane + 32 * j) * r;
  };
  float r = 0.0f, c = 0.0f;
  if (live) {
    float ss = 0.0f;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (lane + 32 * j < D) {
        float v;
        if constexpr (HOLD_X) v = xv[j];
        else v = to_f32(xr[lane + 32 * j]);
        ss += v * v;
      }
    }
    r = row_rsqrt(ss, D, eps);
    float dot = 0.0f;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (lane + 32 * j < D) {
        const float w = s_w[lane + 32 * j];
        const float xh = xh_of(j, r);
        dy[j] = dy[j] * act_slope<MODE>(ep, xh * w, sr);
        dot += dy[j] * w * xh;
      }
    }
    c = warp_sum(dot) / static_cast<float>(D);
  }
  float* dxr = dx + base;
  float* ds_row = ds_part + (size_t)blockIdx.x * D;
#pragma unroll
  for (int j0 = 0; j0 < P; j0 += SJ) {
    if (live) {
#pragma unroll
      for (int jj = 0; jj < SJ; ++jj) {
        const int j = j0 + jj, col = lane + 32 * j;
        if (col < D) {
          const float xh = xh_of(j, r);
          const float du = dy[j] * s_w[col];
          dxr[col] = r * (du - xh * c);
          s_stage[warp][32 * jj + lane] = make_float2(dy[j], xh);
        }
      }
    }
    const int c0 = 32 * j0;
    stage_ds(s_stage, rows, c0, min(32 * SJ, D - c0), ds_row);
  }
}

// A tile of rows wider than the registers, SC_BWD columns a lane at a time: dy
// waits in dx's buffer (each lane rereads only what it wrote) until the
// row's sum(du * xh) is known.
template <typename T, int MODE>
__global__ void __launch_bounds__(32 * TILE_ROWS)
rmsnorm_bwd_stream_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                          const T* __restrict__ g, const float* __restrict__ bp,
                          const float* __restrict__ mq, Epilogue ep, float* __restrict__ dx,
                          float* __restrict__ ds_part, int M, int D, float eps) {
  __shared__ PwlSearch s_tab;
  __shared__ float2 s_stage[TILE_ROWS][STAGE_COLS];
  const Search sr = load_block<MODE>(&s_tab, bp, mq, ep, nullptr, 0, scale, D);
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const long long row0 = (long long)blockIdx.x * TILE_ROWS;
  const int rows = (int)min((long long)TILE_ROWS, (long long)M - row0);
  const bool live = warp < rows;
  const size_t base = (size_t)(row0 + warp) * D;
  const T* xr = x + base;
  float* dxr = dx + base;
  float r = 0.0f, c = 0.0f;
  if (live) {
    float ss = 0.0f;
    for (int c0 = lane; c0 < D; c0 += 32 * SC_BWD) {
      float v[SC_BWD];
#pragma unroll
      for (int j = 0; j < SC_BWD; ++j) v[j] = c0 + 32 * j < D ? to_f32(xr[c0 + 32 * j]) : 0.0f;
#pragma unroll
      for (int j = 0; j < SC_BWD; ++j)
        if (c0 + 32 * j < D) ss += v[j] * v[j];
    }
    r = row_rsqrt(ss, D, eps);
    float dot = 0.0f;
    for (int c0 = lane; c0 < D; c0 += 32 * SC_BWD) {
      float gv[SC_BWD], xv[SC_BWD], w[SC_BWD];
#pragma unroll
      for (int j = 0; j < SC_BWD; ++j) {
        const int col = c0 + 32 * j;
        gv[j] = col < D ? to_f32(g[base + col]) : 0.0f;
        xv[j] = col < D ? reread(xr + col) : 0.0f;
        w[j] = col < D ? 1.0f + scale[col] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < SC_BWD; ++j) {
        const int col = c0 + 32 * j;
        if (col < D) {
          const float xh = xv[j] * r;
          const float d = gv[j] * act_slope<MODE>(ep, xh * w[j], sr);
          dxr[col] = d;
          dot += d * w[j] * xh;
        }
      }
    }
    c = warp_sum(dot) / static_cast<float>(D);
  }
  float* ds_row = ds_part + (size_t)blockIdx.x * D;
  for (int c0 = 0; c0 < D; c0 += STAGE_COLS) {
    if (live) {
      float d[STAGE_J], xv[STAGE_J], w[STAGE_J];
#pragma unroll
      for (int jj = 0; jj < STAGE_J; ++jj) {
        const int col = c0 + 32 * jj + lane;
        d[jj] = col < D ? dxr[col] : 0.0f;
        xv[jj] = col < D ? reread(xr + col) : 0.0f;
        w[jj] = col < D ? 1.0f + reread(scale + col) : 0.0f;
      }
#pragma unroll
      for (int jj = 0; jj < STAGE_J; ++jj) {
        const int col = c0 + 32 * jj + lane;
        if (col < D) {
          const float xh = xv[jj] * r;
          const float du = d[jj] * w[jj];
          dxr[col] = r * (du - xh * c);
          s_stage[warp][32 * jj + lane] = make_float2(d[jj], xh);
        }
      }
    }
    stage_ds(s_stage, rows, c0, min(STAGE_COLS, D - c0), ds_row);
  }
}

// ---------------------------------------------------------------------------
// host side

int tiles_of(int M) { return (M + TILE_ROWS - 1) / TILE_ROWS; }

// How a row of D is held, the host's plan (kernels/fused/norm.py:_row_plan):
// S warps of P columns a lane, or {0, 0} for a row the kernels stream.
struct RowSplit {
  int per_lane, warps;
};

// f(P, S) as integral constants for a split the kernels are built for; the
// splits are the lists of with_fwd_split and with_bwd_split (the host's
// FWD_SPLITS and BWD_SPLITS), any other is refused.
template <int P, int S, class F>
bool run_split(RowSplit sp, F& f, int* rc) {
  if (sp.per_lane != P || sp.warps != S) return false;
  *rc = f(std::integral_constant<int, P>{}, std::integral_constant<int, S>{});
  return true;
}

template <class F>
int with_fwd_split(RowSplit sp, F&& f) {
  int rc = static_cast<int>(cudaErrorInvalidValue);
  (void)(run_split<4, 1>(sp, f, &rc) || run_split<8, 1>(sp, f, &rc) ||
         run_split<16, 1>(sp, f, &rc) || run_split<24, 1>(sp, f, &rc) ||
         run_split<16, 2>(sp, f, &rc) || run_split<24, 2>(sp, f, &rc) ||
         run_split<32, 2>(sp, f, &rc) || run_split<24, 4>(sp, f, &rc) ||
         run_split<32, 4>(sp, f, &rc));
  return rc;
}

template <class F>
int with_bwd_split(RowSplit sp, F&& f) {
  int rc = static_cast<int>(cudaErrorInvalidValue);
  (void)(run_split<4, 1>(sp, f, &rc) || run_split<8, 1>(sp, f, &rc) ||
         run_split<16, 1>(sp, f, &rc) || run_split<24, 1>(sp, f, &rc) ||
         run_split<32, 1>(sp, f, &rc));
  return rc;
}

// The checks both entry points share: the epilogue, the prefix table of a
// PWL epilogue, the shape, and that the host's plan streams the row or holds
// all of it (with_fwd_split / with_bwd_split refuse a split not built).
bool args_ok(const Epilogue& ep, const void* mq, int M, int D, RowSplit sp) {
  if (!epilogue_ok(ep) || (ep.kind == EPI_PWL && mq == nullptr) || M < 0 || D < 1) return false;
  return (sp.per_lane == 0 && sp.warps == 0) || 32LL * sp.per_lane * sp.warps >= D;
}

template <typename T>
int forward(const T* x, const float* scale, const float* bp, const float* mq, Epilogue ep,
            T* out, int M, int D, float eps, RowSplit sp, cudaStream_t s) {
  return with_mode(ep, [&](auto mode) {
    constexpr int MD = decltype(mode)::value;
    if (sp.warps == 0) {
      const unsigned blocks = static_cast<unsigned>(((long long)M + FWD_WARPS - 1) / FWD_WARPS);
      rmsnorm_stream_kernel<T, MD><<<blocks, FWD_THREADS, 0, s>>>(x, scale, bp, mq, ep, out, M,
                                                                  D, eps);
      return static_cast<int>(cudaGetLastError());
    }
    return with_fwd_split(sp, [&](auto pp, auto ww) {
      constexpr int P = decltype(pp)::value, S = decltype(ww)::value;
      constexpr int R = FWD_WARPS / S;
      const unsigned blocks = static_cast<unsigned>(((long long)M + R - 1) / R);
      rmsnorm_rows_kernel<T, P, S, MD><<<blocks, FWD_THREADS, 0, s>>>(x, scale, bp, mq, ep, out,
                                                                      M, D, eps);
      return static_cast<int>(cudaGetLastError());
    });
  });
}

template <typename T>
int backward(const T* x, const float* scale, const T* g, const float* bp, const float* mq,
             Epilogue ep, float* dx, float* ds_part, int M, int D, float eps, RowSplit sp,
             cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>(tiles_of(M));
  return with_mode(ep, [&](auto mode) {
    constexpr int MD = decltype(mode)::value;
    if (sp.warps == 0) {
      rmsnorm_bwd_stream_kernel<T, MD><<<blocks, 32 * TILE_ROWS, 0, s>>>(
          x, scale, g, bp, mq, ep, dx, ds_part, M, D, eps);
      return static_cast<int>(cudaGetLastError());
    }
    return with_bwd_split(sp, [&](auto pp, auto) {
      constexpr int P = decltype(pp)::value;
      rmsnorm_bwd_rows_kernel<T, P, MD><<<blocks, 32 * TILE_ROWS, 0, s>>>(
          x, scale, g, bp, mq, ep, dx, ds_part, M, D, eps);
      return static_cast<int>(cudaGetLastError());
    });
  });
}

}  // namespace

// The rows a block owns, and so a ds partial sums: ds_part has
// ceil(M / rmsnorm_tile_rows()) rows.
extern "C" int rmsnorm_tile_rows() { return TILE_ROWS; }

// x, out: (M, D) in dtype (0 = float32, 1 = bfloat16); scale: (D,) f32; the
// epilogue (bp, dmq, n_bp, kind, fn) of epilogue.cuh, a table decoded by the
// search from the breakpoints bp and the prefix table mq ((n_bp + 1) x 2 f32,
// epilogue.py:search_prefix; dmq is not read); per_lane, warps: the host's
// plan of a row (norm.py:_row_plan), a split built here or (0, 0) to stream
// the row.  Returns the cudaError_t of the launch.
extern "C" int rmsnorm_forward(const void* x, const void* scale, const void* bp,
                               const void* dmq, int n_bp, int kind, int fn, const void* mq,
                               void* out, int M, int D, float eps, int dtype, int per_lane,
                               int warps, void* stream) {
  (void)dmq;
  const Epilogue ep{kind, fn, n_bp};
  const RowSplit sp{per_lane, warps};
  if (!args_ok(ep, mq, M, D, sp))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bp);
  const float* q = static_cast<const float*>(mq);
  if (dtype == 0)
    return forward(static_cast<const float*>(x), sc, b, q, ep, static_cast<float*>(out), M, D,
                   eps, sp, s);
  if (dtype == 1)
    return forward(static_cast<const __nv_bfloat16*>(x), sc, b, q, ep,
                   static_cast<__nv_bfloat16*>(out), M, D, eps, sp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x, g: (M, D) in dtype; scale: (D,) f32; dx: (M, D) f32; ds_part:
// (ceil(M / TILE_ROWS), D) f32, the partials of ds by row tile; the epilogue,
// mq and the plan (per_lane, warps) as for the forward.  Returns the
// cudaError_t of the launch.
extern "C" int rmsnorm_backward(const void* x, const void* scale, const void* g,
                                const void* bp, const void* dmq, int n_bp, int kind, int fn,
                                const void* mq, void* dx, void* ds_part, int M, int D,
                                float eps, int dtype, int per_lane, int warps, void* stream) {
  (void)dmq;
  const Epilogue ep{kind, fn, n_bp};
  const RowSplit sp{per_lane, warps};
  if (!args_ok(ep, mq, M, D, sp))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bp);
  const float* q = static_cast<const float*>(mq);
  float* dxf = static_cast<float*>(dx);
  float* dsf = static_cast<float*>(ds_part);
  if (dtype == 0)
    return backward(static_cast<const float*>(x), sc, static_cast<const float*>(g), b, q, ep,
                    dxf, dsf, M, D, eps, sp, s);
  if (dtype == 1)
    return backward(static_cast<const __nv_bfloat16*>(x), sc,
                    static_cast<const __nv_bfloat16*>(g), b, q, ep, dxf, dsf, M, D, eps, sp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
