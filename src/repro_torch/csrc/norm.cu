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
// What bounds them on an H100: the forward reads x once and writes y once
// (4 bytes an element in bf16: 12.6 MB, ~3.8 us at 3.35 TB/s for repro-100m's
// 4096 x 768 training rows), against ~3 * n_bp f32 operations an element for
// a PWL decode (~4.5 us at 32 breakpoints and 67 TFLOP/s); the backward reads
// x and g and writes dx in f32 (8 bytes an element in bf16), so bytes bound
// it.  The design, a simple first version: a block owns TILE_ROWS rows.  Its
// warps first take a row each and reduce the row's sum of squares (and, in
// the backward, sum(du * xh)) with shuffles; then every thread owns columns
// c = tid, tid + 256, ... and walks the tile's rows in order, so the loads
// and stores of a warp are consecutive columns of one row, w = 1 + scale is
// read once a column, and the ds partial of a column stays in a register.
// x (and g) are read twice, the second time mostly from L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_ROWS = 16;  // rows a block owns, and rows of one ds partial

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// r = rsqrt(mean(x^2) + eps) of row `row`, on every lane of the calling warp.
template <typename T>
__device__ __forceinline__ float row_rsqrt(const T* __restrict__ x, int row, int D, float eps,
                                           int lane) {
  float ss = 0.0f;
  for (int c = lane; c < D; c += 32) {
    const float v = to_f32(x[(size_t)row * D + c]);
    ss += v * v;
  }
  return rsqrtf(warp_sum(ss) / static_cast<float>(D) + eps);
}

template <typename T, bool TABLE>
__global__ void __launch_bounds__(THREADS)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bp, const float* __restrict__ dmq, Epilogue ep,
               T* __restrict__ out, int M, int D, float eps) {
  __shared__ float s_bp[PWL_MAX_BP];
  __shared__ float s_dmq[2 * (PWL_MAX_BP + 1)];
  __shared__ float s_r[TILE_ROWS];
  const int row0 = blockIdx.x * TILE_ROWS;
  const int rows = min(TILE_ROWS, M - row0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  epi_load_table<TABLE>(s_bp, s_dmq, bp, dmq, ep);
  for (int i = warp; i < rows; i += WARPS) {
    const float r = row_rsqrt(x, row0 + i, D, eps, lane);
    if (lane == 0) s_r[i] = r;
  }
  __syncthreads();

  for (int c = threadIdx.x; c < D; c += THREADS) {
    const float w = 1.0f + scale[c];
    for (int i = 0; i < rows; ++i) {
      const size_t o = (size_t)(row0 + i) * D + c;
      const float y = to_f32(x[o]) * s_r[i] * w;
      store(epi_value<TABLE>(ep, y, s_bp, s_dmq), out + o);
    }
  }
}

template <typename T, bool TABLE>
__global__ void __launch_bounds__(THREADS)
rmsnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   const T* __restrict__ g, const float* __restrict__ bp,
                   const float* __restrict__ dmq, Epilogue ep, float* __restrict__ dx,
                   float* __restrict__ ds_part, int M, int D, float eps) {
  __shared__ float s_bp[PWL_MAX_BP];
  __shared__ float s_dmq[2 * (PWL_MAX_BP + 1)];
  __shared__ float s_r[TILE_ROWS];
  __shared__ float s_c[TILE_ROWS];  // sum(du * xh) / D of each row
  const int row0 = blockIdx.x * TILE_ROWS;
  const int rows = min(TILE_ROWS, M - row0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  epi_load_table<TABLE>(s_bp, s_dmq, bp, dmq, ep);
  __syncthreads();
  for (int i = warp; i < rows; i += WARPS) {
    const int row = row0 + i;
    const float r = row_rsqrt(x, row, D, eps, lane);
    float dot = 0.0f;
    for (int c = lane; c < D; c += 32) {
      const size_t o = (size_t)row * D + c;
      const float w = 1.0f + scale[c];
      const float xh = to_f32(x[o]) * r;
      const float dy = to_f32(g[o]) * epi_value_and_slope<TABLE>(ep, xh * w, s_bp, s_dmq).y;
      dot += dy * w * xh;
    }
    dot = warp_sum(dot);
    if (lane == 0) {
      s_r[i] = r;
      s_c[i] = dot / static_cast<float>(D);
    }
  }
  __syncthreads();

  for (int c = threadIdx.x; c < D; c += THREADS) {
    const float w = 1.0f + scale[c];
    float ds = 0.0f;
    for (int i = 0; i < rows; ++i) {
      const size_t o = (size_t)(row0 + i) * D + c;
      const float r = s_r[i];
      const float xh = to_f32(x[o]) * r;
      const float dy = to_f32(g[o]) * epi_value_and_slope<TABLE>(ep, xh * w, s_bp, s_dmq).y;
      ds += dy * xh;
      const float du = dy * w;
      dx[o] = r * (du - xh * s_c[i]);
    }
    ds_part[(size_t)blockIdx.x * D + c] = ds;
  }
}

int tiles_of(int M) { return (M + TILE_ROWS - 1) / TILE_ROWS; }

template <typename T, bool TABLE>
int launch(const void* x, const float* scale, const float* bp, const float* dmq, Epilogue ep,
           void* out, int M, int D, float eps, cudaStream_t s) {
  rmsnorm_kernel<T, TABLE><<<tiles_of(M), THREADS, 0, s>>>(
      static_cast<const T*>(x), scale, bp, dmq, ep, static_cast<T*>(out), M, D, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool TABLE>
int launch_bwd(const void* x, const float* scale, const void* g, const float* bp,
               const float* dmq, Epilogue ep, float* dx, float* ds_part, int M, int D, float eps,
               cudaStream_t s) {
  rmsnorm_bwd_kernel<T, TABLE><<<tiles_of(M), THREADS, 0, s>>>(
      static_cast<const T*>(x), scale, static_cast<const T*>(g), bp, dmq, ep, dx, ds_part, M, D,
      eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int forward(const void* x, const float* scale, const float* bp, const float* dmq, Epilogue ep,
            void* out, int M, int D, float eps, cudaStream_t s) {
  return with_table(ep, [&](auto table) {
    return launch<T, decltype(table)::value>(x, scale, bp, dmq, ep, out, M, D, eps, s);
  });
}

template <typename T>
int backward(const void* x, const float* scale, const void* g, const float* bp,
             const float* dmq, Epilogue ep, float* dx, float* ds_part, int M, int D, float eps,
             cudaStream_t s) {
  return with_table(ep, [&](auto table) {
    return launch_bwd<T, decltype(table)::value>(x, scale, g, bp, dmq, ep, dx, ds_part, M, D,
                                                 eps, s);
  });
}

}  // namespace

// The rows a block owns, and so a ds partial sums: ds_part has
// ceil(M / rmsnorm_tile_rows()) rows.
extern "C" int rmsnorm_tile_rows() { return TILE_ROWS; }

// x, out: (M, D) in dtype (0 = float32, 1 = bfloat16); scale: (D,) f32; the
// epilogue (bp, dmq, n_bp, kind, fn) of epilogue.cuh.  Returns the cudaError_t
// of the launch.
extern "C" int rmsnorm_forward(const void* x, const void* scale, const void* bp,
                               const void* dmq, int n_bp, int kind, int fn, void* out, int M,
                               int D, float eps, int dtype, void* stream) {
  const Epilogue ep{kind, fn, n_bp};
  if (!epilogue_ok(ep) || M < 0 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bp);
  const float* d = static_cast<const float*>(dmq);
  if (dtype == 0) return forward<float>(x, sc, b, d, ep, out, M, D, eps, s);
  if (dtype == 1) return forward<__nv_bfloat16>(x, sc, b, d, ep, out, M, D, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x, g: (M, D) in dtype; scale: (D,) f32; dx: (M, D) f32; ds_part:
// (ceil(M / TILE_ROWS), D) f32, the partials of ds by row tile.  Returns the
// cudaError_t of the launch.
extern "C" int rmsnorm_backward(const void* x, const void* scale, const void* g,
                                const void* bp, const void* dmq, int n_bp, int kind, int fn,
                                void* dx, void* ds_part, int M, int D, float eps, int dtype,
                                void* stream) {
  const Epilogue ep{kind, fn, n_bp};
  if (!epilogue_ok(ep) || M < 0 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bp);
  const float* d = static_cast<const float*>(dmq);
  float* dxf = static_cast<float*>(dx);
  float* dsf = static_cast<float*>(ds_part);
  if (dtype == 0) return backward<float>(x, sc, g, b, d, ep, dxf, dsf, M, D, eps, s);
  if (dtype == 1) return backward<__nv_bfloat16>(x, sc, g, b, d, ep, dxf, dsf, M, D, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
