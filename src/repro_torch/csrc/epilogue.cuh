// The epilogue every fused kernel applies to its f32 accumulator: identity,
// an exact function, or the non-uniform PWL decode of pwl_decode.cuh.
//
// Replaces the kinds of repro/kernels/fused/epilogue.py:EpiloguePlan, which the
// Pallas kernels specialise at trace time: "identity" gives (x, 1), "exact:<fn>"
// the function and its derivative, "pwl" the table's value and per-segment
// slope.  Here the kind is a run-time argument of one launch interface, and
// every kernel is compiled twice (with_table below): with TABLE true it holds
// the PWL decode alone, the code it had before the other kinds came, so a
// table costs what it did; with TABLE false a uniform branch picks the
// identity or the exact function.
//
// The exact functions are those of repro_torch/core/functions.py, with the ids
// of kernels/fused/epilogue.py:EXACT_IDS, computed in f32 with the accurate
// libdevice functions (expf, erff, tanhf, expm1f, log1pf; no fast-math
// intrinsics).  The slope is the closed form of the derivative, with JAX's
// autodiff at the kinks: hardswish's clip splits its gradient 0.5 at
// x = -3 and 3 (jnp.clip is minimum(maximum(.))), elu takes the expm1 branch
// at 0 (slope 1), softplus (logaddexp(x, 0)) has slope 1/2 at 0.
#pragma once

#include <math.h>

#include <type_traits>

#include "pwl_decode.cuh"

enum EpiKind : int { EPI_IDENTITY = 0, EPI_EXACT = 1, EPI_PWL = 2 };

// The order of repro_torch.core.functions.REGISTRY.
enum ExactFn : int {
  FN_GELU = 0,
  FN_GELU_TANH,
  FN_SILU,
  FN_SIGMOID,
  FN_TANH,
  FN_EXP,
  FN_SOFTPLUS,
  FN_HARDSWISH,
  FN_ELU,
  FN_MISH,
  FN_COUNT
};

struct Epilogue {
  int kind;
  int fn;    // EPI_EXACT only
  int n_bp;  // EPI_PWL only: breakpoints of the table
};

// Host-side check of a launch's epilogue arguments.
inline bool epilogue_ok(const Epilogue& e) {
  if (e.kind == EPI_PWL) return e.n_bp >= 1 && e.n_bp <= PWL_MAX_BP;
  if (e.kind == EPI_EXACT) return e.fn >= 0 && e.fn < FN_COUNT;
  return e.kind == EPI_IDENTITY;
}

// Host side: f(std::true_type{}) for a PWL epilogue, f(std::false_type{}) for
// the identity or an exact function, so that a launcher instantiates its
// kernel with TABLE = decltype(f's argument)::value.
template <class F>
int with_table(const Epilogue& e, F&& f) {
  return e.kind == EPI_PWL ? f(std::true_type{}) : f(std::false_type{});
}

// The table into shared memory, for a PWL epilogue only (the other kinds have
// no table operands: bp and dmq may be null).
template <bool TABLE>
__device__ __forceinline__ void epi_load_table(float* s_bp, float* s_dmq,
                                               const float* __restrict__ bp,
                                               const float* __restrict__ dmq,
                                               const Epilogue& e) {
  if constexpr (TABLE) pwl_load_table(s_bp, s_dmq, bp, dmq, e.n_bp);
}

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

// (f(x), f'(x)) of exact function fn; with SLOPE false only .x is formed.
template <bool SLOPE>
__device__ __forceinline__ float2 exact_eval(int fn, float x) {
  constexpr float INV_SQRT2 = 0.70710678118654752f;
  constexpr float INV_SQRT_2PI = 0.39894228040143268f;
  constexpr float SQRT_2_OVER_PI = 0.79788456080286536f;
  constexpr float GELU_C = 0.044715f;
  float v = x, d = 1.0f;
  switch (fn) {
    case FN_GELU: {
      const float cdf = 1.0f + erff(x * INV_SQRT2);
      v = 0.5f * x * cdf;
      if (SLOPE) d = 0.5f * cdf + x * INV_SQRT_2PI * expf(-0.5f * x * x);
      break;
    }
    case FN_GELU_TANH: {
      const float t = tanhf(SQRT_2_OVER_PI * (x + GELU_C * (x * x * x)));
      v = 0.5f * x * (1.0f + t);
      if (SLOPE)
        d = 0.5f * (1.0f + t) +
            0.5f * x * (1.0f - t * t) * SQRT_2_OVER_PI * (1.0f + 3.0f * GELU_C * x * x);
      break;
    }
    case FN_SILU: {
      const float den = 1.0f + expf(-x);
      v = x / den;
      if (SLOPE) {
        const float s = 1.0f / den;
        d = s + x * s * (1.0f - s);
      }
      break;
    }
    case FN_SIGMOID: {
      v = sigmoid_f(x);
      if (SLOPE) d = v * (1.0f - v);
      break;
    }
    case FN_TANH: {
      v = tanhf(x);
      if (SLOPE) d = 1.0f - v * v;
      break;
    }
    case FN_EXP: {
      v = expf(x);
      d = v;
      break;
    }
    case FN_SOFTPLUS: {
      v = fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
      if (SLOPE) d = sigmoid_f(x);
      break;
    }
    case FN_HARDSWISH: {
      const float u = x + 3.0f;
      const float c = fminf(fmaxf(u, 0.0f), 6.0f);
      v = x * c / 6.0f;
      if (SLOPE) {
        const float dc = (u > 0.0f && u < 6.0f) ? 1.0f : ((u == 0.0f || u == 6.0f) ? 0.5f : 0.0f);
        d = c / 6.0f + x / 6.0f * dc;
      }
      break;
    }
    case FN_ELU: {
      const float em1 = expm1f(x);
      v = x > 0.0f ? x : em1;
      if (SLOPE) d = x > 0.0f ? 1.0f : em1 + 1.0f;
      break;
    }
    case FN_MISH: {
      const float sp = fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
      const float t = tanhf(sp);
      v = x * t;
      if (SLOPE) d = t + x * (1.0f - t * t) * sigmoid_f(x);
      break;
    }
    default:
      break;
  }
  return make_float2(v, d);
}

// (act(x), act'(x)): the backward kernels' epilogue.
template <bool TABLE>
__device__ __forceinline__ float2 epi_value_and_slope(const Epilogue& e, float x,
                                                      const float* s_bp, const float* s_dmq) {
  if constexpr (TABLE) {
    return pwl_value_and_slope(x, s_bp, s_dmq, e.n_bp);
  } else {
    return e.kind == EPI_EXACT ? exact_eval<true>(e.fn, x) : make_float2(x, 1.0f);
  }
}

// act(x): the forward kernels' epilogue (the PWL value is the fused one, m * x
// + q in one fmaf).
template <bool TABLE>
__device__ __forceinline__ float epi_value(const Epilogue& e, float x, const float* s_bp,
                                           const float* s_dmq) {
  if constexpr (TABLE) {
    return pwl_value_and_slope(x, s_bp, s_dmq, e.n_bp).x;
  } else {
    return e.kind == EPI_EXACT ? exact_eval<false>(e.fn, x).x : x;
  }
}

// The exp of the softmax chains: the epilogue on x clamped at -1e4, clamped at
// 0 after it.  An exact exp keeps both clamps, as the JAX package's plan.apply
// does inside the same chain.
template <bool TABLE>
__device__ __forceinline__ float epi_exp(const Epilogue& e, float x, const float* s_bp,
                                         const float* s_dmq) {
  return fmaxf(epi_value<TABLE>(e, fmaxf(x, SHIFT_CLAMP), s_bp, s_dmq), 0.0f);
}

// The flash kernels' bf16 design decodes by the search (pwl_decode.cuh): the
// same values and slopes from the padded breakpoints and the prefix table.
// piv: pwl_search_pivots of the table (unused without one).
template <bool TABLE>
__device__ __forceinline__ void epi_load_search(PwlSearch* t, const float* __restrict__ bp,
                                                const float* __restrict__ mq, const Epilogue& e) {
  if constexpr (TABLE) pwl_search_load(t, bp, mq, e.n_bp);
}

template <bool TABLE>
__device__ __forceinline__ float3 epi_search_pivots(const PwlSearch& t) {
  if constexpr (TABLE) return pwl_search_pivots(t);
  return make_float3(0.0f, 0.0f, 0.0f);
}

template <bool TABLE>
__device__ __forceinline__ float2 epi_search_value_and_slope(const Epilogue& e, float x,
                                                             const PwlSearch& t, float3 piv) {
  if constexpr (TABLE) {
    return pwl_search_value_and_slope(x, t, piv);
  } else {
    return e.kind == EPI_EXACT ? exact_eval<true>(e.fn, x) : make_float2(x, 1.0f);
  }
}

template <bool TABLE>
__device__ __forceinline__ float epi_search_exp(const Epilogue& e, float x, const PwlSearch& t,
                                                float3 piv) {
  float v;
  if constexpr (TABLE) {
    v = pwl_search_value_and_slope(fmaxf(x, SHIFT_CLAMP), t, piv).x;
  } else {
    v = epi_value<false>(e, fmaxf(x, SHIFT_CLAMP), nullptr, nullptr);
  }
  return fmaxf(v, 0.0f);
}
