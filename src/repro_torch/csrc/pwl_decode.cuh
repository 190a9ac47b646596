// Non-uniform PWL value-and-slope decode on one accumulator value.
//
// Replaces repro/kernels/fused/epilogue.py:pwl_value_and_slope_tile, the decode
// every fused Pallas kernel shares.  f32 delta layout only: bp[n_bp] sorted
// breakpoints; dmq[2*(n_bp+1)] with (dmq[0], dmq[1]) = (m_0, q_0) and
// (dmq[2i+2], dmq[2i+3]) = (m_{i+1} - m_i, q_{i+1} - q_i).  Every table
// format arrives so: the host packs bf16/f16 tables into this layout from
// their exactly upcast values (kernels/fused/epilogue.py:device_operands),
// which decodes bitwise as the JAX package's native layout does.
//
// The decode starts from (m_0, q_0) and adds (x > bp_i) * (dm_i, dq_i) for
// i = 0..n_bp-1 in that order.  The compare is strict, so the segment left of
// a breakpoint owns it.  c * d with c in {0, 1} is exact, so each fmaf equals
// the unfused m + c * d and the slope is bitwise the plain version's.  The
// value m * x + q is one fmaf in the fused kernels (one rounding fewer than
// the plain version); pwl_value, the standalone activation's, rounds the
// product and the sum apart, as the plain version does, so it is bitwise.
//
// The table is at most 64 + 65 * 2 floats: a block loads it into shared
// memory once, and every thread reads it from there (a broadcast read).
//
// A table of more breakpoints takes the TABLE_WIDE instantiation of the same
// kernels (TableMode below; the host asks for it by the epilogue kind
// EPI_PWL_WIDE, epilogue.cuh): ChainTable<TABLE_WIDE> and PwlSearchWide read
// the table through pointers into device memory (a few KB, L1-resident)
// instead of the fixed shared arrays, and the wide search runs log2(P) steps
// over the breakpoints the host pads with +inf to P - 1, P the power of two
// above n_bp (epilogue.py:prefix_for appends them behind the prefix table).
// Both decodes keep the strict compare and the chain's order, so the wide
// instantiation gives the same bits as the shared one would.
//
// pwl_search_value_and_slope is the same function by a search over the
// breakpoints (the paper's binary-tree address decoder), for the bf16
// tensor-core kernels and the standalone activation (pwl_search_mq, the
// value then rounded as pwl_value rounds it): ~7 steps and one table read a
// score, not n_bp.
//
// Also here: the element conversions every kernel shares and the JAX
// package's masking constants.  epilogue.cuh selects between this decode, an
// exact function and the identity.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>

#include <type_traits>

#define PWL_MAX_BP 64

// How a kernel instantiation holds its epilogue's table: none (the identity
// or an exact function), in shared memory (at most PWL_MAX_BP breakpoints),
// or where it lies in device memory (any number).
enum TableMode : int { TABLE_NONE = 0, TABLE_SHARED = 1, TABLE_WIDE = 2 };

constexpr float NEG_FILL = -1e30f;     // masked-score fill
constexpr float SHIFT_CLAMP = -1e4f;   // lower clamp on the shifted scores

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ void store(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store(float v, __half* dst) { *dst = __float2half_rn(v); }

// The chain's table as a kernel declares it, __shared__ ChainTable<TABLE>:
// two shared arrays, which pwl_load_table fills; for TABLE_WIDE nothing, and
// bp() and dmq() hand back the operands where they lie.
template <int TABLE>
struct ChainTable {
  float s_bp[PWL_MAX_BP];
  float s_dmq[2 * (PWL_MAX_BP + 1)];
  __device__ __forceinline__ float* bp(const float*) { return s_bp; }
  __device__ __forceinline__ float* dmq(const float*) { return s_dmq; }
};

template <>
struct ChainTable<TABLE_WIDE> {
  __device__ __forceinline__ float* bp(const float* g) { return const_cast<float*>(g); }
  __device__ __forceinline__ float* dmq(const float* g) { return const_cast<float*>(g); }
};

__device__ __forceinline__ void pwl_load_table(float* s_bp, float* s_dmq,
                                               const float* __restrict__ bp,
                                               const float* __restrict__ dmq,
                                               int n_bp) {
  for (int i = threadIdx.x; i < n_bp; i += blockDim.x) s_bp[i] = bp[i];
  for (int i = threadIdx.x; i < 2 * (n_bp + 1); i += blockDim.x) s_dmq[i] = dmq[i];
}

__device__ __forceinline__ float2 pwl_value_and_slope(float x, const float* s_bp,
                                                      const float* s_dmq, int n_bp) {
  float m = s_dmq[0];
  float q = s_dmq[1];
  for (int i = 0; i < n_bp; ++i) {
    const float c = x > s_bp[i] ? 1.0f : 0.0f;
    m = fmaf(c, s_dmq[2 * i + 2], m);
    q = fmaf(c, s_dmq[2 * i + 3], q);
  }
  return make_float2(fmaf(m, x, q), m);
}

// The value alone, m * x + q with the product and the sum rounded apart (no
// contraction): bitwise the plain version's two operations.
__device__ __forceinline__ float pwl_value(float x, const float* s_bp, const float* s_dmq,
                                           int n_bp) {
  float m = s_dmq[0];
  float q = s_dmq[1];
  for (int i = 0; i < n_bp; ++i) {
    const float c = x > s_bp[i] ? 1.0f : 0.0f;
    m = fmaf(c, s_dmq[2 * i + 2], m);
    q = fmaf(c, s_dmq[2 * i + 3], q);
  }
  return __fadd_rn(__fmul_rn(m, x), q);
}

// The search decode.  For ascending breakpoints the set {i : x > bp_i} is a
// prefix, so the linear chain's (m, q) is entry k = #{i : x > bp_i} of the
// table of its partial sums: (m_0, q_0) = (dmq[0], dmq[1]), (m_{k+1}, q_{k+1})
// = (m_k + dm_k, q_k + dq_k), each an f32 add rounded in that order, then the
// adds of 0 * dm_i (i >= k) the chain makes for the breakpoints x does not
// pass (they turn a -0 into +0).  The host builds that table
// (kernels/fused/epilogue.py:search_prefix) and refuses breakpoints that are
// not ascending.  The breakpoints are padded with +inf to 128, so the search
// is seven branch-free steps whatever n_bp is, and a warp's searches for its
// many scores interleave: the compare is strict, a NaN passes none (segment
// 0), +inf every real one.  The first two steps compare against three
// pivots held in registers, the other five read shared memory.  The value is
// fmaf(m, x, q), as pwl_value_and_slope forms it, so both give the same bits.
#define PWL_SEARCH_PAD (2 * PWL_MAX_BP)  // the padded breakpoints

struct PwlSearch {
  float bp[PWL_SEARCH_PAD];
  float2 mq[PWL_MAX_BP + 1];
};

// Into shared memory, every thread of the block: the padded breakpoints and
// the (n_bp + 1) x 2 prefix table mq.  The caller synchronises.
__device__ __forceinline__ void pwl_search_load(PwlSearch* t, const float* __restrict__ bp,
                                                const float* __restrict__ mq, int n_bp) {
  for (int i = threadIdx.x; i < PWL_SEARCH_PAD; i += blockDim.x)
    t->bp[i] = i < n_bp ? bp[i] : INFINITY;
  for (int i = threadIdx.x; i <= n_bp; i += blockDim.x)
    t->mq[i] = make_float2(mq[2 * i], mq[2 * i + 1]);
}

// The first two steps' pivots, bp[63], bp[31] and bp[95], once a thread.
__device__ __forceinline__ float3 pwl_search_pivots(const PwlSearch& t) {
  return make_float3(t.bp[63], t.bp[31], t.bp[95]);
}

// The chain's (m, q) for x.  k is kept as the byte offset 4 k, so each
// step's read is one shared load at a register plus a constant.
__device__ __forceinline__ float2 pwl_search_mq(float x, const PwlSearch& t, float3 piv) {
  const char* bp = reinterpret_cast<const char*>(t.bp);
  int k4 = x > piv.x ? 4 * 64 : 0;
  k4 += x > (k4 ? piv.z : piv.y) ? 4 * 32 : 0;
#pragma unroll
  for (int h = 16; h > 0; h >>= 1)
    k4 += x > *reinterpret_cast<const float*>(bp + k4 + 4 * (h - 1)) ? 4 * h : 0;
  return *reinterpret_cast<const float2*>(reinterpret_cast<const char*>(t.mq) + 2 * k4);
}

// The TABLE_WIDE search: the table stays in device memory, and a block holds
// only pointers to it in shared memory.  mq is the prefix table,
// (n_bp + 1) x 2 floats, followed by the breakpoints padded with +inf to
// P - 1 (P = the power of two above n_bp); the search halves [0, P) in
// log2(P) steps, the same k = #{i : x > bp_i} as the shared-memory search.
struct PwlSearchWide {
  const float2* mq;
  const float* bp;
  int half;  // P / 2
};

// Every thread of the block writes the same pointers; the caller
// synchronises.
__device__ __forceinline__ void pwl_search_load(PwlSearchWide* t, const float* __restrict__ bp,
                                                const float* __restrict__ mq, int n_bp) {
  (void)bp;
  int p = 1;
  while (p < n_bp + 1) p <<= 1;
  t->mq = reinterpret_cast<const float2*>(mq);
  t->bp = mq + 2 * (n_bp + 1);
  t->half = p >> 1;
}

__device__ __forceinline__ float3 pwl_search_pivots(const PwlSearchWide&) {
  return make_float3(0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ float2 pwl_search_mq(float x, const PwlSearchWide& t, float3) {
  const float* bp = t.bp;
  int k = 0;
  for (int h = t.half; h > 0; h >>= 1) k += x > bp[k + h - 1] ? h : 0;
  return t.mq[k];
}

template <class Tab>
__device__ __forceinline__ float2 pwl_search_value_and_slope(float x, const Tab& t, float3 piv) {
  const float2 mq = pwl_search_mq(x, t, piv);
  return make_float2(fmaf(mq.x, x, mq.y), mq.x);
}

// The search table of a TableMode (TABLE_NONE declares the shared one, as
// the kernels did before the wide tables, and never loads it).
template <int TABLE>
using SearchTable = std::conditional_t<TABLE == TABLE_WIDE, PwlSearchWide, PwlSearch>;
