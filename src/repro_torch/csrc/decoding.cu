// Split-KV flash decoding through a page table, with the PWL exp in the online
// softmax, and the merge of the splits' partials.
//
// Replaces repro/kernels/fused/decoding.py:_decode_kernel and its split merge
// merge_split_partials (decoding.py:133, plain jnp outside the pallas_call in
// the JAX package, a second kernel here).
//
// q is (B, 1, H, dh); the pools are (Hkv, P, ps, dh); page_table is
// (B, n_cols) int32 and kv_len (B,) int32, both read on the device.  The
// query heads fold as (Hkv major, G minor), so block a = b * Hkv + h owns the
// G grouped heads of KV head h as rows.  Split s of that row set walks pages
// s * pps .. s * pps + pps - 1 of the table in order, one page per chain step
// (a column past n_cols reads sentinel page 0, as the JAX package's padding of
// the table does); a page whose first position is at or past kv_len ends the
// walk.  Per page, in f32:
//
//   sc    = (q . k) * scale, masked to -1e30 past kv_len
//   m_new = max(m, max(sc))
//   p     = max(pwl(max(sc - m_new, -1e4)), 0) * keep
//   corr  = max(pwl(max(m - m_new, -1e4)), 0)
//   l     = l * corr + sum(p);   acc = acc * corr + p . v
//
// The page boundaries are part of the function: pwl(0) is not 1, so a chain
// with other steps gives other numbers.  The merge rescales split s by
// e_s = max(pwl(max(m_s - max_s m_s, -1e4)), 0) and returns
// sum(acc_s e_s) / max(sum(l_s e_s), 1e-30): empty splits have l = 0 and
// vanish, and a request with kv_len == 0 gives exact zeros.
//
// What bounds it on an H100: a decode step reads each live page once (2 * ps
// * dh elements per KV head) and does ~4 * ps * dh FMAs per query head on it,
// far below the tensor-core line, so bytes bound it -- 4 requests of ~40 keys
// are a few hundred KB per layer, under a microsecond at 3.35 TB/s, so launch
// latency is what it costs in practice.  The design reads the bf16 pools in
// place and widens them in shared memory (no f32 copy of the pool, no gather
// of pages into a dense cache), reads the page index and kv_len on the
// device (no host sync), skips pages past kv_len, and runs the merge as a
// second kernel of the same launch call.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pwl_decode.cuh"

namespace {

constexpr int THREADS = 128;

// floats of dynamic shared memory for one split block
size_t split_smem_floats(int ps, int dh, int G) {
  return (size_t)ps * (dh + 1) + (size_t)ps * dh + (size_t)G * (2 * dh + ps + 3);
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS)
split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp, const TKV* __restrict__ vp,
             const int* __restrict__ page_table, int n_cols, const int* __restrict__ kv_len,
             const float* __restrict__ bp, const float* __restrict__ dmq, int n_bp,
             float* __restrict__ m_out, float* __restrict__ l_out, float* __restrict__ acc_out,
             int Hkv, int P, int ps, int dh, int G, int pps, int n_splits, float scale) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_bp[PWL_MAX_BP];
  __shared__ float s_dmq[2 * (PWL_MAX_BP + 1)];
  const int a = blockIdx.x;  // b * Hkv + h
  const int s = blockIdx.y;  // split
  const int tid = threadIdx.x;
  const int b = a / Hkv, h = a % Hkv;
  const int KS = dh + 1;  // padded K row: the score loop reads K rows across threads
  float* sK = smem;
  float* sV = sK + (size_t)ps * KS;
  float* sQ = sV + (size_t)ps * dh;
  float* sS = sQ + (size_t)G * dh;
  float* sM = sS + (size_t)G * ps;
  float* sL = sM + G;
  float* sC = sL + G;
  float* sAcc = sC + G;

  pwl_load_table(s_bp, s_dmq, bp, dmq, n_bp);
  for (int e = tid; e < G * dh; e += THREADS) {
    sQ[e] = to_f32(q[(size_t)a * G * dh + e]);
    sAcc[e] = 0.0f;
  }
  for (int g = tid; g < G; g += THREADS) {
    sM[g] = NEG_FILL;
    sL[g] = 0.0f;
  }
  const int kvl = kv_len[b];

  for (int p = 0; p < pps; ++p) {
    const int col = s * pps + p;
    const long long page0 = (long long)col * ps;  // first key position of the page
    if (page0 >= kvl) break;                      // and every later page's too
    const int page = col < n_cols ? page_table[(size_t)b * n_cols + col] : 0;
    if (page < 0 || page >= P) continue;          // refused on the host; never read
    __syncthreads();  // the previous page is consumed (and the set-up is visible)
    const size_t base = ((size_t)h * P + page) * ps * dh;
    for (int e = tid; e < ps * dh; e += THREADS) {
      const int r = e / dh, c = e - r * dh;
      sK[r * KS + c] = to_f32(kp[base + e]);
      sV[e] = to_f32(vp[base + e]);
    }
    __syncthreads();
    for (int e = tid; e < G * ps; e += THREADS) {
      const int g = e / ps, k = e - g * ps;
      const float* qr = sQ + g * dh;
      const float* kr = sK + k * KS;
      float dot = 0.0f;
      for (int d = 0; d < dh; ++d) dot = fmaf(qr[d], kr[d], dot);
      sS[e] = page0 + k < kvl ? dot * scale : NEG_FILL;
    }
    __syncthreads();
    for (int g = tid; g < G; g += THREADS) {
      float mx = -INFINITY;
      for (int k = 0; k < ps; ++k) mx = fmaxf(mx, sS[g * ps + k]);
      const float m_prev = sM[g];
      const float m_new = fmaxf(m_prev, mx);
      sC[g] = pwl_exp(m_prev - m_new, s_bp, s_dmq, n_bp);
      sM[g] = m_new;
    }
    __syncthreads();
    for (int e = tid; e < G * ps; e += THREADS) {
      const int g = e / ps, k = e - g * ps;
      sS[e] = page0 + k < kvl ? pwl_exp(sS[e] - sM[g], s_bp, s_dmq, n_bp) : 0.0f;
    }
    __syncthreads();
    for (int g = tid; g < G; g += THREADS) {
      float sum = 0.0f;
      for (int k = 0; k < ps; ++k) sum += sS[g * ps + k];
      sL[g] = sL[g] * sC[g] + sum;
    }
    for (int o = tid; o < G * dh; o += THREADS) {
      const int g = o / dh, d = o - g * dh;
      float pv = 0.0f;
      for (int k = 0; k < ps; ++k) pv = fmaf(sS[g * ps + k], sV[k * dh + d], pv);
      sAcc[o] = sAcc[o] * sC[g] + pv;
    }
  }
  __syncthreads();
  const size_t part = (size_t)a * n_splits + s;
  for (int g = tid; g < G; g += THREADS) {
    m_out[part * G + g] = sM[g];
    l_out[part * G + g] = sL[g];
  }
  for (int o = tid; o < G * dh; o += THREADS) acc_out[part * G * dh + o] = sAcc[o];
}

template <typename TQ>
__global__ void __launch_bounds__(THREADS)
merge_kernel(const float* __restrict__ m_p, const float* __restrict__ l_p,
             const float* __restrict__ acc_p, const float* __restrict__ bp,
             const float* __restrict__ dmq, int n_bp, TQ* __restrict__ out, int G, int dh,
             int n_splits) {
  __shared__ float s_bp[PWL_MAX_BP];
  __shared__ float s_dmq[2 * (PWL_MAX_BP + 1)];
  pwl_load_table(s_bp, s_dmq, bp, dmq, n_bp);
  __syncthreads();
  const int a = blockIdx.x;
  const size_t p0 = (size_t)a * n_splits;
  for (int o = threadIdx.x; o < G * dh; o += THREADS) {
    const int g = o / dh, d = o - g * dh;
    float m_max = -INFINITY;
    for (int s = 0; s < n_splits; ++s) m_max = fmaxf(m_max, m_p[(p0 + s) * G + g]);
    float l = 0.0f, acc = 0.0f;
    for (int s = 0; s < n_splits; ++s) {
      const size_t i = (p0 + s) * G + g;
      const float e = pwl_exp(m_p[i] - m_max, s_bp, s_dmq, n_bp);
      l += l_p[i] * e;
      acc += acc_p[i * dh + d] * e;
    }
    store(acc / fmaxf(l, 1e-30f), out + ((size_t)a * G + g) * dh + d);
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* kp, const void* vp, const int* pt, int n_cols,
           const int* kv_len, const float* bp, const float* dmq, int n_bp, float* m_p,
           float* l_p, float* acc_p, void* out, int B, int Hkv, int P, int ps, int dh, int G,
           int pps, int n_splits, cudaStream_t stream) {
  const size_t smem = split_smem_floats(ps, dh, G) * sizeof(float);
  auto kern = split_kernel<TQ, TKV>;
  static size_t smem_allowed = 48 * 1024;  // raised once per size
  if (smem > smem_allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_allowed = smem;
  }
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(dh)));
  dim3 grid(B * Hkv, n_splits);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp), static_cast<const TKV*>(vp), pt,
      n_cols, kv_len, bp, dmq, n_bp, m_p, l_p, acc_p, Hkv, P, ps, dh, G, pps, n_splits, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  merge_kernel<TQ><<<B * Hkv, THREADS, 0, stream>>>(m_p, l_p, acc_p, bp, dmq, n_bp,
                                                     static_cast<TQ*>(out), G, dh, n_splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: (B, 1, H = Hkv * G, dh) in q_dtype; k/v pools: (Hkv, P, ps, dh) in
// kv_dtype; page_table: (B, n_cols) int32; kv_len: (B,) int32; m_p, l_p:
// (B * Hkv, n_splits, G) f32 and acc_p: (B * Hkv, n_splits, G, dh) f32 scratch
// for the partials.  Dtype codes: 0 = float32, 1 = bfloat16.  Launches the
// split kernel and the merge kernel on `stream`; returns the cudaError_t.
extern "C" int paged_decode_forward(const void* q, const void* kp, const void* vp,
                                    const void* page_table, int n_cols, const void* kv_len,
                                    const void* bp, const void* dmq, int n_bp, void* m_p,
                                    void* l_p, void* acc_p, void* out, int B, int Hkv, int P,
                                    int ps, int dh, int G, int pps, int n_splits, int q_dtype,
                                    int kv_dtype, void* stream) {
  if (n_bp < 1 || n_bp > PWL_MAX_BP || B < 0 || Hkv < 1 || P < 1 || ps < 1 || dh < 1 ||
      G < 1 || pps < 1 || n_splits < 1 || n_cols < 1 || B * Hkv > 0x7fffffff / 2 ||
      n_splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (split_smem_floats(ps, dh, G) * sizeof(float) > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pt = static_cast<const int*>(page_table);
  const int* lens = static_cast<const int*>(kv_len);
  const float* bpf = static_cast<const float*>(bp);
  const float* dmqf = static_cast<const float*>(dmq);
  float* mf = static_cast<float*>(m_p);
  float* lf = static_cast<float*>(l_p);
  float* af = static_cast<float*>(acc_p);
#define PAGED_DECODE_LAUNCH(TQ, TKV)                                                         \
  return launch<TQ, TKV>(q, kp, vp, pt, n_cols, lens, bpf, dmqf, n_bp, mf, lf, af, out, B,  \
                         Hkv, P, ps, dh, G, pps, n_splits, st)
  if (q_dtype == 0 && kv_dtype == 0) PAGED_DECODE_LAUNCH(float, float);
  if (q_dtype == 0 && kv_dtype == 1) PAGED_DECODE_LAUNCH(float, __nv_bfloat16);
  if (q_dtype == 1 && kv_dtype == 0) PAGED_DECODE_LAUNCH(__nv_bfloat16, float);
  if (q_dtype == 1 && kv_dtype == 1) PAGED_DECODE_LAUNCH(__nv_bfloat16, __nv_bfloat16);
#undef PAGED_DECODE_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
