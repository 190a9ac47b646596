// Fused GLU with a PWL epilogue: out = pwl(x @ Wg) * (x @ Wu), and its
// backward, for one weight pair (the dense GLU) or one per expert (the MoE);
// and, with one weight matrix, the fused linear layer out = pwl(x @ W + b)
// and its backward.  The epilogue may also be an exact function (act=) or
// the identity (epilogue.cuh), as the JAX kernels' plans may.
//
// Replaces repro/kernels/fused/glu.py:_glu_kernel (the GeGLU gate GEMM of every
// dense layer, with gelu_tanh as a non-uniform PWL table in its epilogue),
// repro/kernels/fused/glu.py:_glu_bwd_kernel, and their per-expert forms
// repro/kernels/fused/moe.py:_moe_glu_kernel and _moe_bwd_kernel (the SwiGLU
// experts of an MoE layer, silu as the table).  The backward is the same kernel
// with another epilogue: it recomputes both accumulators exactly as the
// forward does, decodes value and slope of the gate accumulator at once, and
// writes dzg = g * zu * m(zg) and dzu = g * pwl(zg) in f32 (g read in T and
// widened per element), so the pre-activation never goes to device memory.
//
// The linear layer replaces repro/kernels/fused/linear.py:_linear_kernel
// (whisper's MLP input projection, gelu as the table, with its bias) and
// _linear_bwd_kernel (dz = g * m(x @ W + b), f32).  It is the same kernel with
// one weight matrix (Cfg::NW = 1): the up product and its shared-memory tiles
// drop out, and its two epilogues add the bias to the f32 accumulator after
// the last K tile, as the JAX kernel does, before the decode.  At whisper's
// shapes (K = 768, N = 3072; M = 4 per decode step, 128 per prefill of
// 4 x 32 tokens, 6000 per encoder call over 4 x 1500 frames) it is bound by
// the 4.7 MB of bf16 weights for small M and by the products for large M,
// which run as the GLU's do, as f32 FMAs on the CUDA cores.
//
// x is (E, M, K), Wg and Wu are (E, K, N) row-major as the JAX package stores
// them, out is (E, M, N); all in T (bf16 or f32), accumulation in f32.  The
// expert is blockIdx.z: each slice of the grid is the dense kernel on its
// expert's x bucket and weights, so E = 1 is the dense GLU, launch for launch.
// For the MoE, M is the bucket capacity C (1 at a 4-slot decode step of
// olmoe-1b-7b, 5 for a 32-token prefill, 640 for 8 x 512 training tokens) and
// every bucket is computed, empty or not, as the JAX kernel computes it.
//
// What bounds it: at the serving shapes (M = 4 decode, M = 32 prefill,
// K = 768, N = 3072) the two weight matrices are 9.4 MB of bf16 per call and
// the products are ~0.3 GFLOP, far below the tensor-core line, so the call is
// bound by reading the weights once (~2.8 us at 3.35 TB/s).  What the design
// does about it:
//   * every weight element is read once per M tile, as 16-byte cp.async
//     copies into a ring of STAGES shared-memory tiles, so several K tiles are
//     in flight while one is multiplied;
//   * small M (decode, short prefill) takes narrow 4 x 16 (M <= 4) or 8 x 16
//     output tiles: 192 blocks for N = 3072, enough to keep every SM
//     streaming weights.  Each K tile is split over 4 groups of threads
//     (8 warps per block, so the FMA chains of one SM hide each other's
//     latency) and the 4 partial sums meet in shared memory before the
//     epilogue, in a fixed order;
//   * large M takes 64 x 64 tiles with a 4 x 4 register tile per thread;
//   * the gate and up accumulators of an output element live in the same
//     thread, so the PWL decode and the product happen in registers before
//     the one store;
//   * ragged M, N and K edges are masked (zero-filled) in the kernel; nothing
//     is padded or copied.
// The products are plain f32 FMAs (no tensor cores yet).  At the training
// shape (M = 4096, K = 768, N = 3072) that makes both passes bound by
// operations: 38.7 GFLOP is 577 us at the 67 TFLOP/s of f32 CUDA cores,
// against 39 us on bf16 tensor cores and ~42 us for the backward's 142 MB.
// The MoE experts of olmoe-1b-7b (E = 64, K = 2048, N = 1024) hold 537 MB of
// bf16 gate and up weights, read once per call: ~160 us at C <= 40, where
// each expert's bucket is one or a few M tiles; at C = 640 the 344 GFLOP of
// the two products bound it (~350 us on tensor cores, 5.1 ms at the f32
// CUDA-core peak).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace {

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16_rn(0.0f); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// V = 16 / sizeof(T) elements of a row-major rows x cols matrix at
// (row, col .. col+V) into shared memory, zero outside the matrix.  vec: cols
// is a multiple of V and the base is 16-byte aligned, so a vector is either
// wholly inside (one cp.async) or wholly outside (a zero-filling cp.async).
template <typename T>
__device__ __forceinline__ void load_vec(T* dst, const T* __restrict__ base, int row, int col,
                                         int rows, int cols, bool vec) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    const bool in = row < rows && col < cols;
    cp_async16(dst, in ? base + (size_t)row * cols + col : base, in ? 16 : 0);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i)
      dst[i] = (row < rows && col + i < cols) ? base[(size_t)row * cols + col + i] : zero<T>();
  }
}

template <typename T, int BM_, int BN_, int BK_, int TM_, int TN_, int STAGES_, int KS_,
          int NW_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_, STAGES = STAGES_;
  static constexpr int KS = KS_;                     // thread groups splitting a K tile
  static constexpr int NW = NW_;                     // weight matrices: 2 (GLU) or 1 (linear)
  static constexpr int V = 16 / sizeof(T);
  static constexpr int TX = BN / TN;                 // threads across N
  static constexpr int GROUP = (BM / TM) * TX;       // threads of one K group
  static constexpr int THREADS = KS * GROUP;
  static constexpr int KCHUNK = BK / KS;             // depth each group multiplies
  static constexpr int XS = BK + V;                  // padded x row, 16-byte multiple
  static constexpr int X_ELEMS = BM * XS;
  static constexpr int W_ELEMS = BK * BN;
  static constexpr int STAGE_ELEMS = X_ELEMS + NW * W_ELEMS;
  static constexpr size_t SMEM = (size_t)STAGES * STAGE_ELEMS * sizeof(T);
  static_assert(NW == 1 || NW == 2, "one or two weight matrices");
  static_assert(BK % KS == 0, "K groups must split a tile evenly");
  static_assert(KS == 1 || NW * KS * BM * BN * sizeof(float) <= SMEM,
                "the partial sums must fit in the ring");
};

// The two epilogues on one output element (gm, gn), gm counting the rows of
// all experts (e * M + m), with its gate and up accumulators, each a template
// argument of the kernel (two instantiations with their own symbol names, no
// branch in the store loop): the forward's act(zg) * zu in T, and the
// backward's (g * zu * act'(zg), g * act(zg)) in f32, act the launch's
// epilogue (epilogue.cuh: the PWL table, an exact function or the identity;
// TABLE selects the table's instantiation, the code the kernel had before the
// other kinds came).
template <typename T, bool TABLE>
struct ForwardEpi {
  static constexpr bool kTable = TABLE;
  T* out;
  int N;
  __device__ __forceinline__ void operator()(int gm, int gn, float zg, float zu,
                                             const float* s_bp, const float* s_dmq,
                                             const Epilogue& ep) const {
    store(epi_value<TABLE>(ep, zg, s_bp, s_dmq) * zu, out + (size_t)gm * N + gn);
  }
};

template <typename T, bool TABLE>
struct BackwardEpi {
  static constexpr bool kTable = TABLE;
  const T* g;
  float* dzg;
  float* dzu;
  int N;
  __device__ __forceinline__ void operator()(int gm, int gn, float zg, float zu,
                                             const float* s_bp, const float* s_dmq,
                                             const Epilogue& ep) const {
    const size_t o = (size_t)gm * N + gn;
    const float2 vs = epi_value_and_slope<TABLE>(ep, zg, s_bp, s_dmq);
    const float gf = to_f32(g[o]);
    dzg[o] = gf * zu * vs.y;
    dzu[o] = gf * vs.x;
  }
};

// The linear layer's two epilogues (NW = 1: one accumulator, the up slot
// unused): the bias, when there is one, is added to the f32 accumulator
// after the last K tile, as the JAX kernel adds it, then the forward's
// act(z) in T, or the backward's dz = g * act'(z) in f32.
template <typename T, bool TABLE>
struct LinearForwardEpi {
  static constexpr bool kTable = TABLE;
  T* out;
  const T* bias;  // (N,) or nullptr
  int N;
  __device__ __forceinline__ void operator()(int gm, int gn, float z, float,
                                             const float* s_bp, const float* s_dmq,
                                             const Epilogue& ep) const {
    if (bias != nullptr) z += to_f32(bias[gn]);
    store(epi_value<TABLE>(ep, z, s_bp, s_dmq), out + (size_t)gm * N + gn);
  }
};

template <typename T, bool TABLE>
struct LinearBackwardEpi {
  static constexpr bool kTable = TABLE;
  const T* g;
  const T* bias;  // (N,) or nullptr
  float* dz;
  int N;
  __device__ __forceinline__ void operator()(int gm, int gn, float z, float,
                                             const float* s_bp, const float* s_dmq,
                                             const Epilogue& ep) const {
    if (bias != nullptr) z += to_f32(bias[gn]);
    const size_t o = (size_t)gm * N + gn;
    dz[o] = to_f32(g[o]) * epi_value_and_slope<TABLE>(ep, z, s_bp, s_dmq).y;
  }
};

// One kernel for both layers: C::NW = 2 is the GLU (the gate and up
// products share each x tile), C::NW = 1 the linear layer (wu unused, the
// epilogue's up accumulator 0).
template <typename T, class C, class Epi>
__global__ void __launch_bounds__(C::THREADS)
glu_pwl_kernel(const T* __restrict__ x, const T* __restrict__ wg, const T* __restrict__ wu,
               const float* __restrict__ bp, const float* __restrict__ dmq, Epilogue ep,
               Epi epi, int M, int N, int K, bool vec_x, bool vec_w) {
  constexpr int BM = C::BM, BN = C::BN, BK = C::BK, TM = C::TM, TN = C::TN;
  constexpr int V = C::V, TX = C::TX, XS = C::XS, STAGES = C::STAGES, KS = C::KS;
  constexpr int NW = C::NW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const ring = reinterpret_cast<T*>(smem_raw);
  __shared__ float s_bp[PWL_MAX_BP];
  __shared__ float s_dmq[2 * (PWL_MAX_BP + 1)];

  // this block's expert: its x bucket and weights, its rows of the output
  const size_t e = blockIdx.z;
  x += e * M * K;
  wg += e * K * N;
  if constexpr (NW == 2) wu += e * K * N;
  const int row0 = static_cast<int>(e) * M;

  const int tid = threadIdx.x;
  const int kg = tid / C::GROUP;  // K group
  const int tx = (tid % C::GROUP) % TX;
  const int ty = (tid % C::GROUP) / TX;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;

  epi_load_table<Epi::kTable>(s_bp, s_dmq, bp, dmq, ep);

  auto load_stage = [&](int stage, int k0) {
    T* xs = ring + stage * C::STAGE_ELEMS;
    T* gs = xs + C::X_ELEMS;
    T* us = gs + C::W_ELEMS;
    for (int e = tid; e < BM * (BK / V); e += C::THREADS) {
      const int r = e / (BK / V), c = (e % (BK / V)) * V;
      load_vec<T>(xs + r * XS + c, x, m0 + r, k0 + c, M, K, vec_x);
    }
    for (int e = tid; e < BK * (BN / V); e += C::THREADS) {
      const int r = e / (BN / V), c = (e % (BN / V)) * V;
      load_vec<T>(gs + r * BN + c, wg, k0 + r, n0 + c, K, N, vec_w);
      if constexpr (NW == 2) load_vec<T>(us + r * BN + c, wu, k0 + r, n0 + c, K, N, vec_w);
    }
  };

  float accg[TM][TN], accu[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) accg[i][j] = accu[i][j] = 0.0f;

  // prologue: STAGES - 1 tiles in flight
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed
    __syncthreads();              // ... for every thread; tile kt-1 is consumed
    const int pf = kt + STAGES - 1;
    if (pf < nk) load_stage(pf % STAGES, pf * BK);  // refill the slot of tile kt-1
    cp_async_commit();

    const T* xs = ring + (kt % STAGES) * C::STAGE_ELEMS;
    const T* gs = xs + C::X_ELEMS;
    const T* us = gs + C::W_ELEMS;
#pragma unroll 8
    for (int kk = kg * C::KCHUNK; kk < (kg + 1) * C::KCHUNK; ++kk) {
      float a[TM], b[TN], u[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = to_f32(xs[(ty * TM + i) * XS + kk]);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        b[j] = to_f32(gs[kk * BN + tx + j * TX]);
        if constexpr (NW == 2) u[j] = to_f32(us[kk * BN + tx + j * TX]);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          accg[i][j] = fmaf(a[i], b[j], accg[i][j]);
          if constexpr (NW == 2) accu[i][j] = fmaf(a[i], u[j], accu[i][j]);
        }
    }
  }
  cp_async_wait<0>();

  if constexpr (KS > 1) {
    // the K groups' partial sums meet in the (now idle) ring; each output is
    // summed in group order 0..KS-1, then decoded and stored by one thread
    __syncthreads();
    float* red_g = reinterpret_cast<float*>(smem_raw);
    float* red_u = red_g + KS * BM * BN;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int o = kg * BM * BN + (ty * TM + i) * BN + tx + j * TX;
        red_g[o] = accg[i][j];
        if constexpr (NW == 2) red_u[o] = accu[i][j];
      }
    __syncthreads();
    for (int o = tid; o < BM * BN; o += C::THREADS) {
      const int gm = m0 + o / BN, gn = n0 + o % BN;
      if (gm >= M || gn >= N) continue;
      float g = 0.0f, u = 0.0f;
#pragma unroll
      for (int q = 0; q < KS; ++q) {
        g += red_g[q * BM * BN + o];
        if constexpr (NW == 2) u += red_u[q * BM * BN + o];
      }
      epi(row0 + gm, gn, g, u, s_bp, s_dmq, ep);
    }
    return;
  }

  // epilogue: PWL decode on the gate accumulator, then the forward's product
  // with the up accumulator (one store in T) or the backward's two gradients
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * TX;
      if (gn >= N) continue;
      epi(row0 + gm, gn, accg[i][j], accu[i][j], s_bp, s_dmq, ep);
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename T, class C, class Epi>
int launch(const void* x, const void* wg, const void* wu, const void* bp, const void* dmq,
           Epilogue ep, Epi epi, int E, int M, int N, int K, cudaStream_t stream) {
  constexpr int V = C::V;
  const bool vec_x = K % V == 0 && aligned16(x);
  const bool vec_w = N % V == 0 && aligned16(wg) && aligned16(wu);
  if ((M + C::BM - 1) / C::BM > 65535 || E > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = glu_pwl_kernel<T, C, Epi>;
  if (C::SMEM > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::SMEM));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((N + C::BN - 1) / C::BN, (M + C::BM - 1) / C::BM, E);
  kern<<<grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg), static_cast<const T*>(wu),
      static_cast<const float*>(bp), static_cast<const float*>(dmq), ep, epi, M, N, K,
      vec_x, vec_w);
  return static_cast<int>(cudaGetLastError());
}

// M <= 4 (a decode step; an MoE bucket at decode holds one row): 4 x 16 output tiles, 4 K groups of 64 threads,
// 4-deep ring of 64-deep K tiles
template <typename T, int NW>
using Tiny = Cfg<T, 4, 16, 64, 1, 1, 4, 4, NW>;
// M <= 64: 8 x 16 output tiles, otherwise as Tiny
template <typename T, int NW>
using Small = Cfg<T, 8, 16, 64, 2, 1, 4, 4, NW>;
// large M: 64 x 64 output tiles, 256 threads with 4 x 4 register tiles
template <typename T, int NW>
using Large = Cfg<T, 64, 64, 32, 4, 4, 3, 1, NW>;
constexpr int TINY_M = 4, SMALL_M = 64;

template <typename T, int NW, class Epi>
int dispatch(const void* x, const void* wg, const void* wu, const void* bp, const void* dmq,
             Epilogue ep, Epi epi, int E, int M, int N, int K, cudaStream_t s) {
  if (M <= TINY_M)
    return launch<T, Tiny<T, NW>>(x, wg, wu, bp, dmq, ep, epi, E, M, N, K, s);
  if (M <= SMALL_M)
    return launch<T, Small<T, NW>>(x, wg, wu, bp, dmq, ep, epi, E, M, N, K, s);
  return launch<T, Large<T, NW>>(x, wg, wu, bp, dmq, ep, epi, E, M, N, K, s);
}

template <typename T>
int forward(const void* x, const void* wg, const void* wu, const void* bp, const void* dmq,
            Epilogue ep, void* out, int E, int M, int N, int K, cudaStream_t s) {
  return with_table(ep, [&](auto table) {
    const ForwardEpi<T, decltype(table)::value> epi{static_cast<T*>(out), N};
    return dispatch<T, 2>(x, wg, wu, bp, dmq, ep, epi, E, M, N, K, s);
  });
}

template <typename T>
int backward(const void* x, const void* wg, const void* wu, const void* g, const void* bp,
             const void* dmq, Epilogue ep, void* dzg, void* dzu, int E, int M, int N, int K,
             cudaStream_t s) {
  return with_table(ep, [&](auto table) {
    const BackwardEpi<T, decltype(table)::value> epi{
        static_cast<const T*>(g), static_cast<float*>(dzg), static_cast<float*>(dzu), N};
    return dispatch<T, 2>(x, wg, wu, bp, dmq, ep, epi, E, M, N, K, s);
  });
}

template <typename T>
int linear_forward(const void* x, const void* w, const void* b, const void* bp,
                   const void* dmq, Epilogue ep, void* out, int M, int N, int K,
                   cudaStream_t s) {
  return with_table(ep, [&](auto table) {
    const LinearForwardEpi<T, decltype(table)::value> epi{static_cast<T*>(out),
                                                          static_cast<const T*>(b), N};
    return dispatch<T, 1>(x, w, nullptr, bp, dmq, ep, epi, 1, M, N, K, s);
  });
}

template <typename T>
int linear_backward(const void* x, const void* w, const void* b, const void* g,
                    const void* bp, const void* dmq, Epilogue ep, void* dz, int M, int N, int K,
                    cudaStream_t s) {
  return with_table(ep, [&](auto table) {
    const LinearBackwardEpi<T, decltype(table)::value> epi{
        static_cast<const T*>(g), static_cast<const T*>(b), static_cast<float*>(dz), N};
    return dispatch<T, 1>(x, w, nullptr, bp, dmq, ep, epi, 1, M, N, K, s);
  });
}

}  // namespace

// Every entry point takes the epilogue as (bp, dmq, n_bp, kind, fn): kind
// EPI_PWL with the table's f32 delta operands and n_bp breakpoints, EPI_EXACT
// with exact function fn, or EPI_IDENTITY (bp and dmq unread, may be null).

// x (E, M, K), wg/wu (E, K, N), out (E, M, N), all in dtype (0 = float32,
// 1 = bfloat16).  Returns the cudaError_t of the launch.
extern "C" int glu_pwl_forward(const void* x, const void* wg, const void* wu, const void* bp,
                               const void* dmq, int n_bp, int kind, int fn, void* out, int E,
                               int M, int N, int K, int dtype, void* stream) {
  const Epilogue ep{kind, fn, n_bp};
  if (!epilogue_ok(ep) || E <= 0 || M <= 0 || N <= 0 || K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return forward<float>(x, wg, wu, bp, dmq, ep, out, E, M, N, K, s);
  if (dtype == 1) return forward<__nv_bfloat16>(x, wg, wu, bp, dmq, ep, out, E, M, N, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x (E, M, K), wg/wu (E, K, N) and g (E, M, N) in dtype (0 = float32,
// 1 = bfloat16); dzg, dzu (E, M, N) float32.  Returns the cudaError_t of the
// launch.
extern "C" int glu_pwl_backward(const void* x, const void* wg, const void* wu, const void* g,
                                const void* bp, const void* dmq, int n_bp, int kind, int fn,
                                void* dzg, void* dzu, int E, int M, int N, int K, int dtype,
                                void* stream) {
  const Epilogue ep{kind, fn, n_bp};
  if (!epilogue_ok(ep) || E <= 0 || M <= 0 || N <= 0 || K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return backward<float>(x, wg, wu, g, bp, dmq, ep, dzg, dzu, E, M, N, K, s);
  if (dtype == 1)
    return backward<__nv_bfloat16>(x, wg, wu, g, bp, dmq, ep, dzg, dzu, E, M, N, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The fused linear layer: x (M, K), w (K, N), b (N,) or null, out (M, N), all
// in dtype (0 = float32, 1 = bfloat16).  Returns the cudaError_t of the launch.
extern "C" int linear_pwl_forward(const void* x, const void* w, const void* b, const void* bp,
                                  const void* dmq, int n_bp, int kind, int fn, void* out, int M,
                                  int N, int K, int dtype, void* stream) {
  const Epilogue ep{kind, fn, n_bp};
  if (!epilogue_ok(ep) || M <= 0 || N <= 0 || K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return linear_forward<float>(x, w, b, bp, dmq, ep, out, M, N, K, s);
  if (dtype == 1)
    return linear_forward<__nv_bfloat16>(x, w, b, bp, dmq, ep, out, M, N, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Its backward: x, w, b as above and g (M, N) in dtype; dz (M, N) float32.
// Returns the cudaError_t of the launch.
extern "C" int linear_pwl_backward(const void* x, const void* w, const void* b, const void* g,
                                   const void* bp, const void* dmq, int n_bp, int kind, int fn,
                                   void* dz, int M, int N, int K, int dtype, void* stream) {
  const Epilogue ep{kind, fn, n_bp};
  if (!epilogue_ok(ep) || M <= 0 || N <= 0 || K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return linear_backward<float>(x, w, b, g, bp, dmq, ep, dz, M, N, K, s);
  if (dtype == 1)
    return linear_backward<__nv_bfloat16>(x, w, b, g, bp, dmq, ep, dz, M, N, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
