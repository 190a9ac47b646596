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
// Also here: the element conversions every kernel shares and the JAX
// package's masking constants.  epilogue.cuh selects between this decode, an
// exact function and the identity.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#define PWL_MAX_BP 64

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
