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
// What bounds it on an H100: one read of x where a score is kept (and of the
// mask) and one write of y, at most 8 bytes per score (12 with a mask, 6
// under a causal mask), against about 3 * n_bp f32 operations
// per score for the delta-accumulation decode (pwl_decode.cuh) -- 96 at the
// serving table's 32 breakpoints.  At 3.35 TB/s and 67 TFLOP/s outside the
// tensor cores the decode is the larger term: the kernel is bound by CUDA-core
// operations, not bytes.  The design keeps the row resident so x is read once:
//   * a row lives in shared memory (N * 4 bytes, 128 KB at the 32768-wide
//     limit the model dispatch keeps), written once with the masked scores and
//     overwritten in place with the probabilities, so the decode runs once per
//     score and y is written in one pass;
//   * rows up to 1024 wide take one warp each, 8 rows per 256-thread block,
//     and reduce with warp shuffles; wider rows take a whole block each and
//     reduce through shared memory;
//   * the causal/window mask is recomputed from the column index in each pass
//     rather than stored.
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
// dm is split equally.  The VJP needs x and g where a score is kept and writes
// dx in full (8 bytes per score under a causal mask, 12 without one; this
// kernel reads all of g, 10 bytes per causal score) and decodes each score
// once, so it is bound by bytes at the training rows.  The
// row's shared memory first holds the masked scores, then the product of
// the gates and the slope, then dt; x is read again for the tie test and g
// again for du, both from cache.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_WIDTH = 32768;
constexpr int NARROW_WIDTH = 1024;  // rows up to this wide take one warp each

struct Keep {
  const float* mask;  // row of the explicit mask, or nullptr
  int qpos;
  int causal;
  int has_window;
  int window;
  __device__ __forceinline__ float operator()(int c) const {
    if (mask != nullptr) return mask[c] > 0.0f ? 1.0f : 0.0f;
    bool k = true;
    if (causal) k = k && c <= qpos;
    if (has_window) k = k && (qpos - c) < window;
    return k ? 1.0f : 0.0f;
  }
};

// Reduction over the TPR threads of one row: warp shuffles, then (a row wider
// than a warp) the warps' partials through shared memory in warp order.
template <int TPR, bool IS_MAX>
__device__ __forceinline__ float row_reduce(float v, float* s_red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = IS_MAX ? fmaxf(v, w) : v + w;
  }
  if constexpr (TPR > 32) {
    __syncthreads();  // the previous reduction's readers are done with s_red
    if ((threadIdx.x & 31) == 0) s_red[threadIdx.x / 32] = v;
    __syncthreads();
    v = s_red[0];
#pragma unroll
    for (int i = 1; i < TPR / 32; ++i) v = IS_MAX ? fmaxf(v, s_red[i]) : v + s_red[i];
  }
  return v;
}

template <int RPB, bool TABLE>
__global__ void __launch_bounds__(THREADS)
softmax_kernel(const float* __restrict__ x, const float* __restrict__ mask,
               const float* __restrict__ bp, const float* __restrict__ dmq, Epilogue ep,
               float* __restrict__ out, int R, int N, int seq_len, int causal, int has_window,
               int window) {
  constexpr int TPR = THREADS / RPB;  // threads per row
  extern __shared__ __align__(16) float s_rows[];  // RPB rows of N floats
  __shared__ float s_bp[PWL_MAX_BP];
  __shared__ float s_dmq[2 * (PWL_MAX_BP + 1)];
  __shared__ float s_red[THREADS / 32];

  epi_load_table<TABLE>(s_bp, s_dmq, bp, dmq, ep);
  __syncthreads();

  const int sub = threadIdx.x / TPR;
  const int lane = threadIdx.x % TPR;
  const long long row = (long long)blockIdx.x * RPB + sub;
  const bool live = row < R;
  float* srow = s_rows + (size_t)sub * N;
  const size_t base = (size_t)row * N;
  Keep keep{(live && mask != nullptr) ? mask + base : nullptr,
            seq_len > 0 ? (int)(row % seq_len) : 0, causal, has_window, window};

  // masked scores into shared memory, and the row max
  float mx = -INFINITY;
  if (live) {
    for (int c = lane; c < N; c += TPR) {
      const float v = keep(c) > 0.0f ? x[base + c] : NEG_FILL;
      srow[c] = v;
      mx = fmaxf(mx, v);
    }
  }
  const float m = row_reduce<TPR, true>(mx, s_red);

  // PWL exp of the clamped shifted scores, masked, in place; the row sum
  float sum = 0.0f;
  if (live) {
    for (int c = lane; c < N; c += TPR) {
      const float p = epi_exp<TABLE>(ep, srow[c] - m, s_bp, s_dmq) * keep(c);
      srow[c] = p;
      sum += p;
    }
  }
  const float l = fmaxf(row_reduce<TPR, false>(sum, s_red), 1e-30f);

  if (live) {
    for (int c = lane; c < N; c += TPR) out[base + c] = srow[c] / l;
  }
}

// the 0 / 0.5 / 1 gradient gate of max(v, threshold), jnp's convention
__device__ __forceinline__ float max_gate(float v, float threshold) {
  return v > threshold ? 1.0f : (v == threshold ? 0.5f : 0.0f);
}

template <int RPB, bool TABLE>
__global__ void __launch_bounds__(THREADS)
softmax_bwd_kernel(const float* __restrict__ x, const float* __restrict__ mask,
                   const float* __restrict__ g, const float* __restrict__ bp,
                   const float* __restrict__ dmq, Epilogue ep, float* __restrict__ dx, int R,
                   int N, int seq_len, int causal, int has_window, int window) {
  constexpr int TPR = THREADS / RPB;  // threads per row
  extern __shared__ __align__(16) float s_rows[];  // RPB rows of N floats
  __shared__ float s_bp[PWL_MAX_BP];
  __shared__ float s_dmq[2 * (PWL_MAX_BP + 1)];
  __shared__ float s_red[THREADS / 32];

  epi_load_table<TABLE>(s_bp, s_dmq, bp, dmq, ep);
  __syncthreads();

  const int sub = threadIdx.x / TPR;
  const int lane = threadIdx.x % TPR;
  const long long row = (long long)blockIdx.x * RPB + sub;
  const bool live = row < R;
  float* srow = s_rows + (size_t)sub * N;
  const size_t base = (size_t)row * N;
  Keep keep{(live && mask != nullptr) ? mask + base : nullptr,
            seq_len > 0 ? (int)(row % seq_len) : 0, causal, has_window, window};

  // masked scores into shared memory, and the row max
  float mx = -INFINITY;
  if (live) {
    for (int c = lane; c < N; c += TPR) {
      const float v = keep(c) > 0.0f ? x[base + c] : NEG_FILL;
      srow[c] = v;
      mx = fmaxf(mx, v);
    }
  }
  const float m = row_reduce<TPR, true>(mx, s_red);

  // value and slope once per score: the sums l, sum(g * u) and the tie
  // count; the row keeps keep * gate_p * slope * gate_t (the gates are 0,
  // 0.5 or 1, so this product times du rounds as du * slope does)
  float l_part = 0.0f, gu_part = 0.0f, tie_part = 0.0f;
  if (live) {
    for (int c = lane; c < N; c += TPR) {
      const float xm = srow[c];
      const float t = xm - m;
      const float2 vs = epi_value_and_slope<TABLE>(ep, fmaxf(t, SHIFT_CLAMP), s_bp, s_dmq);
      const float k = keep(c);
      const float u = fmaxf(vs.x, 0.0f) * k;
      l_part += u;
      gu_part += g[base + c] * u;
      tie_part += xm == m ? 1.0f : 0.0f;
      srow[c] = k * max_gate(vs.x, 0.0f) * max_gate(t, SHIFT_CLAMP) * vs.y;
    }
  }
  const float l = row_reduce<TPR, false>(l_part, s_red);
  const float gu = row_reduce<TPR, false>(gu_part, s_red);
  const float ntie = row_reduce<TPR, false>(tie_part, s_red);
  const float L = fmaxf(l, 1e-30f);
  const float gl = max_gate(l, 1e-30f);
  const float shift = gl * gu / (L * L);

  // dt in place, and dm = -sum(dt)
  float dt_part = 0.0f;
  if (live) {
    for (int c = lane; c < N; c += TPR) {
      const float dt = (g[base + c] / L - shift) * srow[c];
      srow[c] = dt;
      dt_part += dt;
    }
  }
  const float dm = -row_reduce<TPR, false>(dt_part, s_red);

  // dx, with dm split over the argmax ties
  if (live) {
    for (int c = lane; c < N; c += TPR) {
      const float k = keep(c);
      const float xm = k > 0.0f ? x[base + c] : NEG_FILL;
      const float tie = xm == m ? dm / ntie : 0.0f;
      dx[base + c] = (srow[c] + tie) * k;
    }
  }
}

// Raise a kernel's dynamic shared memory limit to ``smem`` once per size, so
// a call inside a CUDA graph capture makes no attribute call.
template <typename Kern>
int allow_smem(Kern kern, size_t smem, size_t* allowed) {
  if (smem > *allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    *allowed = smem;
  }
  return 0;
}

int grid_of(int R, int rpb, unsigned* blocks) {
  const long long b = ((long long)R + rpb - 1) / rpb;
  if (b > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  *blocks = static_cast<unsigned>(b);
  return 0;
}

template <int RPB, bool TABLE>
int launch(const float* x, const float* mask, const float* bp, const float* dmq, Epilogue ep,
           float* out, int R, int N, int seq_len, int causal, int has_window, int window,
           cudaStream_t stream) {
  const size_t smem = (size_t)RPB * N * sizeof(float);
  auto kern = softmax_kernel<RPB, TABLE>;
  static size_t smem_allowed = 48 * 1024;
  unsigned blocks = 0;
  if (int e = allow_smem(kern, smem, &smem_allowed)) return e;
  if (int e = grid_of(R, RPB, &blocks)) return e;
  kern<<<blocks, THREADS, smem, stream>>>(
      x, mask, bp, dmq, ep, out, R, N, seq_len, causal, has_window, window);
  return static_cast<int>(cudaGetLastError());
}

template <int RPB, bool TABLE>
int launch_bwd(const float* x, const float* mask, const float* g, const float* bp,
               const float* dmq, Epilogue ep, float* dx, int R, int N, int seq_len, int causal,
               int has_window, int window, cudaStream_t stream) {
  const size_t smem = (size_t)RPB * N * sizeof(float);
  auto kern = softmax_bwd_kernel<RPB, TABLE>;
  static size_t smem_allowed = 48 * 1024;
  unsigned blocks = 0;
  if (int e = allow_smem(kern, smem, &smem_allowed)) return e;
  if (int e = grid_of(R, RPB, &blocks)) return e;
  kern<<<blocks, THREADS, smem, stream>>>(
      x, mask, g, bp, dmq, ep, dx, R, N, seq_len, causal, has_window, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (R, N) f32, contiguous; mask: (R, N) f32 in {0, 1} or null.
// seq_len: rows per query block for the synthesized causal/window mask.  The
// exp is the epilogue (bp, dmq, n_bp, kind, fn) of epilogue.cuh: the PWL
// table, or an exact function (exp).  Returns the cudaError_t of the launch.
extern "C" int pwl_softmax_forward(const void* x, const void* mask, const void* bp,
                                   const void* dmq, int n_bp, int kind, int fn, void* out,
                                   int R, int N, int seq_len, int causal, int has_window,
                                   int window, void* stream) {
  const Epilogue ep{kind, fn, n_bp};
  if (!epilogue_ok(ep) || R < 0 || N < 1 || N > MAX_WIDTH || seq_len < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* mf = static_cast<const float*>(mask);
  const float* bpf = static_cast<const float*>(bp);
  const float* dmqf = static_cast<const float*>(dmq);
  float* of = static_cast<float*>(out);
  return with_table(ep, [&](auto table) {
    constexpr bool TB = decltype(table)::value;
    if (N <= NARROW_WIDTH)
      return launch<8, TB>(xf, mf, bpf, dmqf, ep, of, R, N, seq_len, causal, has_window, window,
                           s);
    return launch<1, TB>(xf, mf, bpf, dmqf, ep, of, R, N, seq_len, causal, has_window, window,
                         s);
  });
}

// x, g, dx: (R, N) f32, contiguous; mask: (R, N) f32 in {0, 1} or null;
// seq_len, causal, window and the epilogue as for the forward.  Returns the
// cudaError_t of the launch.
extern "C" int pwl_softmax_backward(const void* x, const void* mask, const void* g,
                                    const void* bp, const void* dmq, int n_bp, int kind, int fn,
                                    void* dx, int R, int N, int seq_len, int causal,
                                    int has_window, int window, void* stream) {
  const Epilogue ep{kind, fn, n_bp};
  if (!epilogue_ok(ep) || R < 0 || N < 1 || N > MAX_WIDTH || seq_len < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* mf = static_cast<const float*>(mask);
  const float* gf = static_cast<const float*>(g);
  const float* bpf = static_cast<const float*>(bp);
  const float* dmqf = static_cast<const float*>(dmq);
  float* df = static_cast<float*>(dx);
  return with_table(ep, [&](auto table) {
    constexpr bool TB = decltype(table)::value;
    if (N <= NARROW_WIDTH)
      return launch_bwd<8, TB>(xf, mf, gf, bpf, dmqf, ep, df, R, N, seq_len, causal,
                               has_window, window, s);
    return launch_bwd<1, TB>(xf, mf, gf, bpf, dmqf, ep, df, R, N, seq_len, causal, has_window,
                             window, s);
  });
}
