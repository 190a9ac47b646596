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
// one weight matrix (NW = 1): the up product and its shared-memory tiles drop
// out, and its two epilogues add the bias to the f32 accumulator after the
// last K tile, as the JAX kernel does, before the decode.
//
// x is (E, M, K), Wg and Wu are (E, K, N) row-major as the JAX package stores
// them, out is (E, M, N); all in T (bf16 or f32), accumulation in f32.  The
// expert is blockIdx.z: each slice of the grid is the dense kernel on its
// expert's x bucket and weights, so E = 1 is the dense GLU, launch for launch.
// For the MoE, M is the bucket capacity C (1 at a 4-slot decode step of
// olmoe-1b-7b, 5 for a 32-token prefill, 640 for 8 x 512 training tokens).
// In the bf16 decode configurations, in a launch of several experts, a block
// whose x rows are all +-0 (its expert's whole bucket, of at most 16 rows: a
// 4-slot decode step routes 32 pairs into 64 buckets of one row, so half of
// them or more are empty) reads none of its weights and writes what its
// epilogue gives on +0 accumulators, as the sum of a zero row from +0 gives
// them: act(+0) * (+0) forward, (g * 0 * act'(0), g * act(0)) backward.
// That differs from the JAX kernel, which computes every bucket, only where
// the weights hold inf or NaN (0 * inf is NaN there).
//
// What bounds it on an H100, and what the design does about it:
//   * Training and long prefills (M = 4096 at 8 x 512 tokens of repro-100m,
//     6000 and 12000 in whisper's encoder, C = 640 for olmoe's experts) are
//     bound by the products: 38.7 GFLOP at M = 4096, K = 768, N = 3072, 39 us
//     at the 989 TFLOP/s of bf16 tensor cores (577 us as f32 FMAs on CUDA
//     cores).  So bf16 runs on the tensor cores (tc:: below), as the JAX
//     kernel's jnp.dot(..., preferred_element_type=f32) on bf16 tiles does:
//     mma.sync m16n8k16 bf16 products with f32 accumulation (mma.cuh), x as
//     the A operand by ldmatrix, the (K, N) weights as B by ldmatrix.trans
//     from rows padded by 16 bytes (no bank conflicts), both fed by a ring of
//     cp.async tiles.  The gate and up products share each A fragment, and a
//     thread holds both accumulators of its C-fragment elements, so the
//     epilogue decodes the gate in registers before the one store.  The
//     decode is the binary search over the breakpoints (pwl_decode.cuh) from
//     the host-built prefix table: ~7 steps an output, not the chain's ~100
//     instructions, which at M = 4096 would cost as much as the products.
//   * Every output is summed over K in 16-wide chunks from 0 in one
//     accumulator (no split-K; chunks wholly past K are not issued), and each
//     element of an mma depends only on its row of A, its column of B and its
//     accumulator (mma.cuh).  So the bits do not depend on the tile shape, on
//     M or on the grid: an expert's bucket gives what its own E = 1 launch
//     gives, and the E = 1 MoE what the dense GLU gives.
//   * The tile follows M and the grid (tc::pick): 128 x 128 blocks of 8 warps
//     for the training shapes, 64 x 64 or 32 x 32 where fewer rows or a
//     narrow grid would leave SMs idle (prefills, whisper's M = 128, the
//     MoE's C = 40).
//   * Serving's decode steps and short prefills (M <= DECODE_M = 16: a
//     decode step, an MoE bucket at C = 1 or at a 32-token prefill's C = 5)
//     are bound by reading the weights once (9.4 MB of bf16 at K = 768,
//     N = 3072: ~2.8 us at 3.35 TB/s; olmoe's 537 MB of expert weights,
//     ~160 us, or the non-empty buckets' share of it).  They run the same
//     kernel in a decode configuration (tc::Decode, tc::DecodeWide): one m16
//     row tile (rows >= M zero-filled in shared memory, not read), more warps
//     copying than multiplying (on an H100 the copies in flight a warp, not
//     the ring's depth, held the rate), 32-column strips where the grid is
//     narrow (96 blocks at N = 3072) and 128-column strips (256-byte rows)
//     across many experts; and the empty-bucket skip above.  So a decode
//     row is bitwise the same row of a prefill's launch.
//   * f32 keeps the CUDA-core kernel at every M (glu_pwl_kernel: Tiny,
//     Small, Large; f32 FMAs, the chain decode), bit for bit as before.
//   * Ragged M, N and K edges are masked (zero-filled) in the kernel; nothing
//     is padded or copied.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "mma.cuh"

namespace {

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16_rn(0.0f); }

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
    cp_async16(dst, in ? base + (size_t)row * cols + col : base, in);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i)
      dst[i] = (row < rows && col + i < cols) ? base[(size_t)row * cols + col + i] : zero<T>();
  }
}

// The decode of an epilogue, as the kernels hand it to the epilogue functors:
// value(x) for the forward, value_and_slope(x) for the backward.  The f32
// CUDA-core kernel decodes by the linear chain over its shared-memory copy of
// the table; the bf16 tensor-core kernel by the search over the prefix table
// (pwl_decode.cuh), which gives the same bits for ascending breakpoints.
template <int TABLE>
struct ChainDecode {
  const float* s_bp;
  const float* s_dmq;
  Epilogue ep;
  __device__ __forceinline__ float value(float x) const {
    return epi_value<TABLE>(ep, x, s_bp, s_dmq);
  }
  __device__ __forceinline__ float2 value_and_slope(float x) const {
    return epi_value_and_slope<TABLE>(ep, x, s_bp, s_dmq);
  }
};

template <int TABLE>
struct SearchDecode {
  const SearchTable<TABLE>* t;
  float3 piv;
  Epilogue ep;
  __device__ __forceinline__ float value(float x) const {
    if constexpr (TABLE != TABLE_NONE) return pwl_search_value_and_slope(x, *t, piv).x;
    return epi_value<TABLE_NONE>(ep, x, nullptr, nullptr);
  }
  __device__ __forceinline__ float2 value_and_slope(float x) const {
    return epi_search_value_and_slope<TABLE>(ep, x, *t, piv);
  }
};

// The two epilogues on one output element (gm, gn), gm counting the rows of
// all experts (e * M + m), with its gate and up accumulators, each a template
// argument of the kernels (their own symbol names, no branch in the store
// loop): the forward's act(zg) * zu in T, and the backward's
// (g * zu * act'(zg), g * act(zg)) in f32, act the launch's epilogue
// (epilogue.cuh: the PWL table, an exact function or the identity; TABLE
// selects the table's instantiation) as the kernel's decode evaluates it.
template <typename T, int TABLE>
struct ForwardEpi {
  static constexpr int kTable = TABLE;
  T* out;
  int N;
  template <class D>
  __device__ __forceinline__ void operator()(int gm, int gn, float zg, float zu,
                                             const D& dec) const {
    store(dec.value(zg) * zu, out + (size_t)gm * N + gn);
  }
};

template <typename T, int TABLE>
struct BackwardEpi {
  static constexpr int kTable = TABLE;
  const T* g;
  float* dzg;
  float* dzu;
  int N;
  template <class D>
  __device__ __forceinline__ void operator()(int gm, int gn, float zg, float zu,
                                             const D& dec) const {
    const size_t o = (size_t)gm * N + gn;
    const float2 vs = dec.value_and_slope(zg);
    const float gf = to_f32(g[o]);
    dzg[o] = gf * zu * vs.y;
    dzu[o] = gf * vs.x;
  }
};

// The linear layer's two epilogues (NW = 1: one accumulator, the up slot
// unused): the bias, when there is one, is added to the f32 accumulator
// after the last K tile, as the JAX kernel adds it, then the forward's
// act(z) in T, or the backward's dz = g * act'(z) in f32.
template <typename T, int TABLE>
struct LinearForwardEpi {
  static constexpr int kTable = TABLE;
  T* out;
  const T* bias;  // (N,) or nullptr
  int N;
  template <class D>
  __device__ __forceinline__ void operator()(int gm, int gn, float z, float,
                                             const D& dec) const {
    if (bias != nullptr) z += to_f32(bias[gn]);
    store(dec.value(z), out + (size_t)gm * N + gn);
  }
};

template <typename T, int TABLE>
struct LinearBackwardEpi {
  static constexpr int kTable = TABLE;
  const T* g;
  const T* bias;  // (N,) or nullptr
  float* dz;
  int N;
  template <class D>
  __device__ __forceinline__ void operator()(int gm, int gn, float z, float,
                                             const D& dec) const {
    if (bias != nullptr) z += to_f32(bias[gn]);
    const size_t o = (size_t)gm * N + gn;
    dz[o] = to_f32(g[o]) * dec.value_and_slope(z).y;
  }
};

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// ---------------------------------------------------------------------------
// The CUDA-core kernel: f32 at every M.

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
  __shared__ ChainTable<Epi::kTable> chain;
  float* const s_bp = chain.bp(bp);
  float* const s_dmq = chain.dmq(dmq);

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
  const ChainDecode<Epi::kTable> dec{s_bp, s_dmq, ep};

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
      epi(row0 + gm, gn, g, u, dec);
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
      epi(row0 + gm, gn, accg[i][j], accu[i][j], dec);
    }
  }
}

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

// f32, M <= 4 (a decode step; an MoE bucket at decode holds one row): 4 x 16
// output tiles, 4 K groups of 64 threads, 4-deep ring of 64-deep K tiles
template <int NW>
using Tiny = Cfg<float, 4, 16, 64, 1, 1, 4, 4, NW>;
// f32, M <= 64: 8 x 16 output tiles, otherwise as Tiny
template <int NW>
using Small = Cfg<float, 8, 16, 64, 2, 1, 4, 4, NW>;
// f32, large M: 64 x 64 output tiles, 256 threads with 4 x 4 register tiles
template <int NW>
using Large = Cfg<float, 64, 64, 32, 4, 4, 3, 1, NW>;
constexpr int TINY_M = 4, SMALL_M = 64;

// ---------------------------------------------------------------------------
// The tensor-core kernel: bf16 at every M.

namespace tc {

using bf16 = __nv_bfloat16;

// A BM x BN output tile of WM x WN warps, each warp a (BM / WM) x (BN / WN)
// block of 16 x 8 mma tiles, over a STAGES-deep ring of BK-deep K tiles.
// Shared-memory rows are padded by 8 elements (16 bytes), so the eight rows
// an ldmatrix reads fall in eight different bank groups.  SKIP: in a launch
// of several experts, a block whose x rows are all +-0 reads no weights (the
// decode configurations).  WARPS warps issue the ring's copies, the first
// WM x WN of them also multiply.
template <int BM_, int BN_, int WM_, int WN_, int BK_, int STAGES_, int NW_, bool SKIP_ = false,
          int WARPS_ = WM_ * WN_>
struct TcCfg {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_, BK = BK_, STAGES = STAGES_;
  static constexpr int NW = NW_;
  static constexpr bool SKIP = SKIP_;
  static constexpr int WARPS = WARPS_;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int WTM = BM / WM, WTN = BN / WN;  // a warp's rows and columns
  static constexpr int MI = WTM / 16, NI = WTN / 8;    // its mma tiles
  static constexpr int XS = BK + 8, WS = BN + 8;       // padded rows (elements)
  static constexpr int X_ELEMS = BM * XS, W_ELEMS = BK * WS;
  static constexpr int STAGE_ELEMS = X_ELEMS + NW * W_ELEMS;
  static constexpr size_t SMEM = (size_t)STAGES * STAGE_ELEMS * sizeof(bf16);
  static_assert(NW == 1 || NW == 2, "one or two weight matrices");
  static_assert(WTM % 16 == 0 && WTN % 16 == 0 && BK % 16 == 0, "whole 16-wide fragments");
  static_assert(WARPS >= WM * WN, "every multiplying warp also copies");
  static_assert(SMEM <= 227 * 1024, "the ring must fit in shared memory");
};

template <class C, class Epi>
__global__ void __launch_bounds__(C::THREADS)
glu_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wg,
              const bf16* __restrict__ wu, const float* __restrict__ bp,
              const float* __restrict__ mq, Epilogue ep, Epi epi, int M, int N, int K,
              bool vec_x, bool vec_w) {
  constexpr int BM = C::BM, BN = C::BN, BK = C::BK, STAGES = C::STAGES, NW = C::NW;
  constexpr int XS = C::XS, WS = C::WS, MI = C::MI, NI = C::NI;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const ring = reinterpret_cast<bf16*>(smem_raw);
  __shared__ SearchTable<Epi::kTable> s_tab;

  const size_t e = blockIdx.z;
  x += e * M * K;
  wg += e * K * N;
  if constexpr (NW == 2) wu += e * K * N;
  const int row0 = static_cast<int>(e) * M;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = (warp / C::WN) * C::WTM;  // the warp's first row and column in the tile
  const int wc = (warp % C::WN) * C::WTN;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  epi_load_search<Epi::kTable>(&s_tab, bp, mq, ep);
  // With SKIP, in a launch of several experts, the bits of this block's x
  // rows (sign bits masked), read while the table loads: if all are 0 no K
  // tile is summed and the epilogue sees the +0 accumulators a zero row sums
  // to.  Rows m0 .. m0 + BM of the bucket are contiguous; vec_x: K % 8 == 0
  // and x 16-byte aligned.  (One expert, the dense GLU or the linear layer,
  // does not check: its rows are tokens, and the check's read would delay
  // every weight request by one round trip.)
  int nk = (K + BK - 1) / BK;
  if (C::SKIP && gridDim.z > 1) {
    const size_t n = (size_t)min(BM, M - m0) * K;
    const bf16* xb = x + (size_t)m0 * K;
    uint32_t bits = 0;
    if (vec_x) {
      const uint4* v = reinterpret_cast<const uint4*>(xb);
#pragma unroll 4
      for (size_t i = tid; i < n / 8; i += C::THREADS) {
        const uint4 a = v[i];
        bits |= a.x | a.y | a.z | a.w;
      }
    } else {
      const uint16_t* h = reinterpret_cast<const uint16_t*>(xb);
      for (size_t i = tid; i < n; i += C::THREADS) bits |= h[i];
    }
    if (!__syncthreads_or((bits & 0x7fff7fffu) != 0)) nk = 0;
  }

  auto load_stage = [&](int stage, int k0) {
    bf16* xs = ring + stage * C::STAGE_ELEMS;
    bf16* gs = xs + C::X_ELEMS;
    bf16* us = gs + C::W_ELEMS;
    for (int i = tid; i < BM * (BK / 8); i += C::THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      load_vec<bf16>(xs + r * XS + c, x, m0 + r, k0 + c, M, K, vec_x);
    }
    for (int i = tid; i < BK * (BN / 8); i += C::THREADS) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      load_vec<bf16>(gs + r * WS + c, wg, k0 + r, n0 + c, K, N, vec_w);
      if constexpr (NW == 2) load_vec<bf16>(us + r * WS + c, wu, k0 + r, n0 + c, K, N, vec_w);
    }
  };

  float accg[MI][NI][4], accu[NW == 2 ? MI : 1][NW == 2 ? NI : 1][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        accg[i][j][r] = 0.0f;
        if constexpr (NW == 2) accu[i][j][r] = 0.0f;
      }

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

    const bf16* xs = ring + (kt % STAGES) * C::STAGE_ELEMS;
    const bf16* gs = xs + C::X_ELEMS;
    const bf16* us = gs + C::W_ELEMS;
    // chunks wholly past K are not summed, so every tile shape sums the same
    // chunks 0, 16, 32, ... in that order
    auto chunk = [&](int kk) {
      uint32_t a[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) ldsm_x4(a[i], a_addr(xs, XS, wr + i * 16, kk * 16, lane));
#pragma unroll
      for (int jp = 0; jp < NI / 2; ++jp) {
        uint32_t b[4];
        ldsm_x4_t(b, bk_addr(gs, WS, kk * 16, wc + jp * 16, lane));
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          mma_bf16(accg[i][2 * jp], a[i], b[0], b[1]);
          mma_bf16(accg[i][2 * jp + 1], a[i], b[2], b[3]);
        }
        if constexpr (NW == 2) {
          uint32_t u[4];
          ldsm_x4_t(u, bk_addr(us, WS, kk * 16, wc + jp * 16, lane));
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            mma_bf16(accu[i][2 * jp], a[i], u[0], u[1]);
            mma_bf16(accu[i][2 * jp + 1], a[i], u[2], u[3]);
          }
        }
      }
    };
    const int left = (K - kt * BK + 15) / 16;  // chunks of this tile inside K
    if constexpr (C::WARPS > C::WM * C::WN) {
      if (warp >= C::WM * C::WN) continue;  // a copying warp only
    }
    if (left >= BK / 16) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) chunk(kk);
    } else {
      for (int kk = 0; kk < left; ++kk) chunk(kk);
    }
  }
  cp_async_wait<0>();
  if constexpr (C::WARPS > C::WM * C::WN) {
    if (warp >= C::WM * C::WN) return;
  }

  // epilogue: each thread's C-fragment elements (rows g and g + 8 of a tile,
  // columns 2c and 2c + 1), decoded and stored where they lie in the output
  const SearchDecode<Epi::kTable> dec{&s_tab, epi_search_pivots<Epi::kTable>(s_tab), ep};
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + wr + i * 16 + g + 8 * h;
      if (gm >= M) continue;
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int gn = n0 + wc + j * 8 + 2 * c + q;
          if (gn >= N) continue;
          float zu = 0.0f;
          if constexpr (NW == 2) zu = accu[i][j][2 * h + q];
          epi(row0 + gm, gn, accg[i][j][2 * h + q], zu, dec);
        }
    }
}

// The configurations, widest first: 128 x 128 tiles of 8 warps (64 x 32 a
// warp) for the training shapes, 64-deep K tiles in a 3-deep ring (on an
// H100, the GLU forward at M = 4096 took 218.6 us so against 237.9 with
// 32-deep tiles in a 4-deep ring, 223.6 with 64-deep in a 4-deep ring); 64 x
// 64 of 4 warps; 32 x 32 of 4 warps; and the two decode configurations, one
// m16 row tile that skips blocks of zero rows: 16 x 32 tiles (96 blocks at
// N = 3072) multiplied by 2 warps and copied by 8, over a 3-deep ring of
// 256-deep K tiles (64 KB of a GLU's weights in flight a block); 16 x 128
// tiles (256-byte rows, for grids of many experts) multiplied by 4 warps and
// copied by 16, over a 3-deep ring of 128-deep tiles (222 KB of shared
// memory, one block an SM).  `ab_flash.py --decode-configs` times both
// against Small and against other strips, depths and counts of copying
// warps (PERF.md, PR 23).
template <int NW>
using Wide = TcCfg<128, 128, 2, 4, 64, 3, NW>;
template <int NW>
using Mid = TcCfg<64, 64, 2, 2, 32, 4, NW>;
template <int NW>
using Small = TcCfg<32, 32, 2, 2, 64, 4, NW>;
template <int NW>
using Decode = TcCfg<16, 32, 1, 2, 256, 3, NW, true, 8>;
template <int NW>
using DecodeWide = TcCfg<16, 128, 1, 4, 128, 3, NW, true, 16>;
constexpr int DECODE_M = 16;

template <class C>
long blocks(int E, int M, int N) {
  return (long)E * ((M + C::BM - 1) / C::BM) * ((N + C::BN - 1) / C::BN);
}

constexpr long SMS = 132;  // H100 SXM

// The configuration for (E, M, N): at M <= DECODE_M (one m16 tile) 4
// (DecodeWide) when it gives two blocks an SM, else 3 (Decode); above it 0
// (Wide) when M > 64 and it gives two blocks an SM, 1 (Mid) when M > 32 and
// it gives one, else 2 (Small).  On an H100 (NVIDIA H100 80GB HBM3, 700 W)
// the decode configurations beat Small at each M <= 16 timed (the dense GLU
// at M = 4, 8 and 16, olmoe's C = 1 and 5; `ab_flash.py --decode-configs`).
// A 32 x 16 tile of 2 warps, which gives a dense prefill at M = 32 192
// blocks where Small gives 96, took 18.1 us there against Small's 13.5, and
// is gone.  GLU_TC_FORCE (a compile-time define) forces one, for timing and
// for holding every configuration's bits equal; the library's build defines
// none.
template <int NW>
int pick(int E, int M, int N) {
#ifdef GLU_TC_FORCE
  (void)E, (void)M, (void)N;
  return GLU_TC_FORCE;
#else
  if (M <= DECODE_M) return blocks<DecodeWide<NW>>(E, M, N) >= 2 * SMS ? 4 : 3;
  if (M > 64 && blocks<Wide<NW>>(E, M, N) >= 2 * SMS) return 0;
  if (M > 32 && blocks<Mid<NW>>(E, M, N) >= SMS) return 1;
  return 2;
#endif
}

template <class C, class Epi>
int launch(const void* x, const void* wg, const void* wu, const void* bp, const void* mq,
           Epilogue ep, Epi epi, int E, int M, int N, int K, cudaStream_t stream) {
  const bool vec_x = K % 8 == 0 && aligned16(x);
  const bool vec_w = N % 8 == 0 && aligned16(wg) && aligned16(wu);
  if ((M + C::BM - 1) / C::BM > 65535 || E > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = glu_tc_kernel<C, Epi>;
  if (C::SMEM > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::SMEM));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((N + C::BN - 1) / C::BN, (M + C::BM - 1) / C::BM, E);
  kern<<<grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wg), static_cast<const bf16*>(wu),
      static_cast<const float*>(bp), static_cast<const float*>(mq), ep, epi, M, N, K, vec_x,
      vec_w);
  return static_cast<int>(cudaGetLastError());
}

template <int NW, class Epi>
int dispatch(const void* x, const void* wg, const void* wu, const void* bp, const void* mq,
             Epilogue ep, Epi epi, int E, int M, int N, int K, cudaStream_t s) {
  switch (pick<NW>(E, M, N)) {
    case 0:
      return launch<Wide<NW>>(x, wg, wu, bp, mq, ep, epi, E, M, N, K, s);
    case 1:
      return launch<Mid<NW>>(x, wg, wu, bp, mq, ep, epi, E, M, N, K, s);
    case 3:
      return launch<Decode<NW>>(x, wg, wu, bp, mq, ep, epi, E, M, N, K, s);
    case 4:
      return launch<DecodeWide<NW>>(x, wg, wu, bp, mq, ep, epi, E, M, N, K, s);
    default:
      return launch<Small<NW>>(x, wg, wu, bp, mq, ep, epi, E, M, N, K, s);
  }
}

}  // namespace tc

// bp, dmq: the table's delta-layout operands (the CUDA-core kernel's chain);
// mq: its prefix table (the tensor-core kernel's search).
template <typename T, int NW, class Epi>
int dispatch(const void* x, const void* wg, const void* wu, const void* bp, const void* dmq,
             const void* mq, Epilogue ep, Epi epi, int E, int M, int N, int K, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value) {
    if (M <= TINY_M) return launch<T, Tiny<NW>>(x, wg, wu, bp, dmq, ep, epi, E, M, N, K, s);
    if (M <= SMALL_M) return launch<T, Small<NW>>(x, wg, wu, bp, dmq, ep, epi, E, M, N, K, s);
    return launch<T, Large<NW>>(x, wg, wu, bp, dmq, ep, epi, E, M, N, K, s);
  } else {
    return tc::dispatch<NW>(x, wg, wu, bp, mq, ep, epi, E, M, N, K, s);
  }
}

template <typename T>
int forward(const void* x, const void* wg, const void* wu, const void* bp, const void* dmq,
            const void* mq, Epilogue ep, void* out, int E, int M, int N, int K, cudaStream_t s) {
  return with_table(ep, [&](auto table) {
    const ForwardEpi<T, decltype(table)::value> epi{static_cast<T*>(out), N};
    return dispatch<T, 2>(x, wg, wu, bp, dmq, mq, ep, epi, E, M, N, K, s);
  });
}

template <typename T>
int backward(const void* x, const void* wg, const void* wu, const void* g, const void* bp,
             const void* dmq, const void* mq, Epilogue ep, void* dzg, void* dzu, int E, int M,
             int N, int K, cudaStream_t s) {
  return with_table(ep, [&](auto table) {
    const BackwardEpi<T, decltype(table)::value> epi{
        static_cast<const T*>(g), static_cast<float*>(dzg), static_cast<float*>(dzu), N};
    return dispatch<T, 2>(x, wg, wu, bp, dmq, mq, ep, epi, E, M, N, K, s);
  });
}

template <typename T>
int linear_forward(const void* x, const void* w, const void* b, const void* bp,
                   const void* dmq, const void* mq, Epilogue ep, void* out, int M, int N, int K,
                   cudaStream_t s) {
  return with_table(ep, [&](auto table) {
    const LinearForwardEpi<T, decltype(table)::value> epi{static_cast<T*>(out),
                                                          static_cast<const T*>(b), N};
    return dispatch<T, 1>(x, w, nullptr, bp, dmq, mq, ep, epi, 1, M, N, K, s);
  });
}

template <typename T>
int linear_backward(const void* x, const void* w, const void* b, const void* g,
                    const void* bp, const void* dmq, const void* mq, Epilogue ep, void* dz,
                    int M, int N, int K, cudaStream_t s) {
  return with_table(ep, [&](auto table) {
    const LinearBackwardEpi<T, decltype(table)::value> epi{
        static_cast<const T*>(g), static_cast<const T*>(b), static_cast<float*>(dz), N};
    return dispatch<T, 1>(x, w, nullptr, bp, dmq, mq, ep, epi, 1, M, N, K, s);
  });
}

// A PWL epilogue needs the prefix table in bf16 (the search decode).
bool operands_ok(const Epilogue& ep, int dtype, const void* mq) {
  return epilogue_ok(ep) && (dtype != 1 || !is_table(ep.kind) || mq != nullptr);
}

}  // namespace

// Every entry point takes the epilogue as (bp, dmq, n_bp, kind, fn, mq): kind
// EPI_PWL (at most PWL_MAX_BP breakpoints) or EPI_PWL_WIDE (any number) with
// the table's f32 delta operands, n_bp breakpoints and the search operand mq
// (epilogue.py:search_prefix: the (n_bp + 1) x 2 f32 prefix table, then the
// padded breakpoints EPI_PWL_WIDE reads, read by the bf16 tensor-core kernel;
// the host has checked that the breakpoints ascend), EPI_EXACT with exact
// function fn, or EPI_IDENTITY (bp, dmq and mq unread, may be null).

// x (E, M, K), wg/wu (E, K, N), out (E, M, N), all in dtype (0 = float32,
// 1 = bfloat16).  Returns the cudaError_t of the launch.
extern "C" int glu_pwl_forward(const void* x, const void* wg, const void* wu, const void* bp,
                               const void* dmq, int n_bp, int kind, int fn, const void* mq,
                               void* out, int E, int M, int N, int K, int dtype,
                               void* stream) {
  const Epilogue ep{kind, fn, n_bp};
  if (!operands_ok(ep, dtype, mq) || E <= 0 || M <= 0 || N <= 0 || K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return forward<float>(x, wg, wu, bp, dmq, mq, ep, out, E, M, N, K, s);
  if (dtype == 1)
    return forward<__nv_bfloat16>(x, wg, wu, bp, dmq, mq, ep, out, E, M, N, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x (E, M, K), wg/wu (E, K, N) and g (E, M, N) in dtype (0 = float32,
// 1 = bfloat16); dzg, dzu (E, M, N) float32.  Returns the cudaError_t of the
// launch.
extern "C" int glu_pwl_backward(const void* x, const void* wg, const void* wu, const void* g,
                                const void* bp, const void* dmq, int n_bp, int kind, int fn,
                                const void* mq, void* dzg, void* dzu, int E, int M, int N,
                                int K, int dtype, void* stream) {
  const Epilogue ep{kind, fn, n_bp};
  if (!operands_ok(ep, dtype, mq) || E <= 0 || M <= 0 || N <= 0 || K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return backward<float>(x, wg, wu, g, bp, dmq, mq, ep, dzg, dzu, E, M, N, K, s);
  if (dtype == 1)
    return backward<__nv_bfloat16>(x, wg, wu, g, bp, dmq, mq, ep, dzg, dzu, E, M, N, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The fused linear layer: x (M, K), w (K, N), b (N,) or null, out (M, N), all
// in dtype (0 = float32, 1 = bfloat16).  Returns the cudaError_t of the launch.
extern "C" int linear_pwl_forward(const void* x, const void* w, const void* b, const void* bp,
                                  const void* dmq, int n_bp, int kind, int fn, const void* mq,
                                  void* out, int M, int N, int K, int dtype, void* stream) {
  const Epilogue ep{kind, fn, n_bp};
  if (!operands_ok(ep, dtype, mq) || M <= 0 || N <= 0 || K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return linear_forward<float>(x, w, b, bp, dmq, mq, ep, out, M, N, K, s);
  if (dtype == 1)
    return linear_forward<__nv_bfloat16>(x, w, b, bp, dmq, mq, ep, out, M, N, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Its backward: x, w, b as above and g (M, N) in dtype; dz (M, N) float32.
// Returns the cudaError_t of the launch.
extern "C" int linear_pwl_backward(const void* x, const void* w, const void* b, const void* g,
                                   const void* bp, const void* dmq, int n_bp, int kind, int fn,
                                   const void* mq, void* dz, int M, int N, int K, int dtype,
                                   void* stream) {
  const Epilogue ep{kind, fn, n_bp};
  if (!operands_ok(ep, dtype, mq) || M <= 0 || N <= 0 || K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return linear_backward<float>(x, w, b, g, bp, dmq, mq, ep, dz, M, N, K, s);
  if (dtype == 1)
    return linear_backward<__nv_bfloat16>(x, w, b, g, bp, dmq, mq, ep, dz, M, N, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
