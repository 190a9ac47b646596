// Flash attention forward with the PWL exp in the online softmax.
//
// Replaces repro/kernels/fused/attention.py:_flash_kernel (forward).  q is
// (B, S, H, dh), k/v are (B, T, Hkv, dh), out is (B, S, H, dh), all in T
// (bf16 or f32), read and written in place: query head hq uses KV head
// hq / G (GQA folded as Hkv major, G minor, as the JAX package folds it).
//
// The chain of the online softmax walks KV blocks of bkv = min(512,
// round_up(T, 128)) keys in order, as the JAX kernel's grid does, and for each
// row applies, in f32,
//
//   s     = (q . k) * scale, masked to -1e30
//   m_new = max(m, max over the whole block of s)
//   p     = max(pwl(max(s - m_new, -1e4)), 0) * keep
//   corr  = max(pwl(max(m - m_new, -1e4)), 0)
//   l     = l * corr + sum(p);   acc = acc * corr + p . v
//
// and finally out = acc / max(l, 1e-30); with m_out it also writes each row's
// final m, (B, H, S) f32, the residual of the backward (csrc/attention_bwd.cu).
// pwl(0) is not 1, so where the chain
// steps fall is part of the function: the block width and the per-block max
// are the JAX kernel's.  keep is (key < T), causal (key <= q_offset + row),
// window (q_offset + row - key < window) and (key as f32 < kv_valid_len[b]).
// A block that is masked for a whole row only scales that row's l and acc
// together, so the query tiling is free, and a block masked for every row of
// a tile is skipped.
//
// What bounds it on an H100: at the serving shape (S = T = 4096 causal, 12
// heads, dh 64, bf16) the call moves 25 MB but does ~13 GFLOP of products and
// decodes ~100 M scores at ~3 * n_bp f32 operations each, so it is bound by
// operations.  This first version runs the products as f32 FMAs on CUDA
// cores (tensor cores are later work).  The design: a block owns 64 query rows
// of one head, keeps their Q tile in shared memory, and for each 512-key block
// computes the whole 64 x 512 f32 score tile into shared memory (132 KB),
// 64 keys of K at a time; takes the per-row block max; decodes the
// probabilities in place; then multiplies them into V, 64 keys at a time, with
// a 4 x (dh / 16) register tile of the output per thread.  Rows are padded in
// shared memory so the three phases read without bank conflicts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pwl_decode.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BQ = 64;          // query rows per block
constexpr int KC = 64;          // keys per staged K or V chunk
constexpr int BKV_MAX = 512;    // the chain's block width
constexpr int SST = BKV_MAX + 4;  // score row stride (bank offset 4 per row)
constexpr int MAX_DH = 128;
constexpr int MAX_NJ = MAX_DH / 16;

size_t smem_bytes(int dh) {
  return ((size_t)BQ * (dh + 1) + (size_t)KC * (dh + 1) + (size_t)BQ * SST) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const float* __restrict__ valid_len, const float* __restrict__ bp,
             const float* __restrict__ dmq, int n_bp, T* __restrict__ out,
             float* __restrict__ m_out, int S, int Tk, int H,
             int Hkv, int dh, int bkv, float scale, int causal, int has_window, int window,
             int q_offset) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_bp[PWL_MAX_BP];
  __shared__ float s_dmq[2 * (PWL_MAX_BP + 1)];
  __shared__ float s_corr[BQ];
  __shared__ float s_l[BQ];
  const int DS = dh + 1;
  float* sQ = smem;              // BQ x DS
  float* sKV = sQ + BQ * DS;     // KC x DS: a K chunk, then a V chunk
  float* sS = sKV + KC * DS;     // BQ x SST: scores, then probabilities

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // products: rows ty*4 + i, columns tx + 16 j
  const int r = tid >> 2, l4 = tid & 3;    // row statistics: row r, 4 lanes per row
  const int bh = blockIdx.x;               // b * H + hq
  const int b = bh / H, hq = bh % H;
  const int hk = hq / (H / Hkv);
  const int q0 = blockIdx.y * BQ;
  const int nj = dh / 16;
  const bool has_vl = valid_len != nullptr;
  const float vl = has_vl ? valid_len[b] : 0.0f;

  auto keep = [&](int kpos, int qpos) -> bool {
    bool kp = kpos < Tk;
    if (causal) kp = kp && kpos <= qpos;
    if (has_window) kp = kp && (qpos - kpos) < window;
    if (has_vl) kp = kp && static_cast<float>(kpos) < vl;
    return kp;
  };

  pwl_load_table(s_bp, s_dmq, bp, dmq, n_bp);
  for (int e = tid; e < BQ * dh; e += THREADS) {
    const int rr = e / dh, d = e - rr * dh;
    const int sq = q0 + rr;
    sQ[rr * DS + d] = sq < S ? to_f32(q[(((size_t)b * S + sq) * H + hq) * dh + d]) : 0.0f;
  }

  float m_run = NEG_FILL, l_run = 0.0f;  // row r's chain state, on each of its 4 lanes
  float acc[4][MAX_NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < MAX_NJ; ++j) acc[i][j] = 0.0f;

  const int q_first = q0 + q_offset;
  const int q_last = min(q0 + BQ, S) - 1 + q_offset;
  const int qpos_r = q0 + r + q_offset;
  const int nkv = (Tk + bkv - 1) / bkv;
  for (int jb = 0; jb < nkv; ++jb) {
    const int j0 = jb * bkv;
    // blocks masked for every row of this tile
    if (causal && j0 > q_last) break;
    if (has_vl && static_cast<float>(j0) >= vl) break;
    if (has_window && q_first - (j0 + bkv - 1) >= window) continue;

    // scores of the whole block, KC keys at a time
    for (int kc = 0; kc < bkv; kc += KC) {
      __syncthreads();  // sKV and sS are free
      for (int e = tid; e < KC * dh; e += THREADS) {
        const int kr = e / dh, d = e - kr * dh;
        const int t = j0 + kc + kr;
        sKV[kr * DS + d] = t < Tk ? to_f32(k[(((size_t)b * Tk + t) * Hkv + hk) * dh + d]) : 0.0f;
      }
      __syncthreads();
      float sacc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sacc[i][j] = 0.0f;
      for (int d = 0; d < dh; ++d) {
        float qa[4], ka[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[i] = sQ[(ty * 4 + i) * DS + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) ka[j] = sKV[(tx + 16 * j) * DS + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sacc[i][j] = fmaf(qa[i], ka[j], sacc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = kc + tx + 16 * j;
          sS[row * SST + col] =
              keep(j0 + col, q0 + row + q_offset) ? sacc[i][j] * scale : NEG_FILL;
        }
      }
    }
    __syncthreads();

    // the row's block max, the correction, and the probabilities in place
    {
      float* srow = sS + r * SST;
      float mx = -INFINITY;
      for (int c = l4; c < bkv; c += 4) mx = fmaxf(mx, srow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      const float corr = pwl_exp(m_run - m_new, s_bp, s_dmq, n_bp);
      float sum = 0.0f;
      for (int c = l4; c < bkv; c += 4) {
        const float p = keep(j0 + c, qpos_r) ? pwl_exp(srow[c] - m_new, s_bp, s_dmq, n_bp)
                                             : 0.0f;
        srow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run = l_run * corr + sum;
      m_run = m_new;
      if (l4 == 0) s_corr[r] = corr;
    }

    // p . v over the block, KC keys at a time, then acc = acc * corr + p . v
    float pv[4][MAX_NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < MAX_NJ; ++j) pv[i][j] = 0.0f;
    for (int kc = 0; kc < bkv; kc += KC) {
      __syncthreads();  // probabilities done; the previous V chunk is consumed
      for (int e = tid; e < KC * dh; e += THREADS) {
        const int kr = e / dh, d = e - kr * dh;
        const int t = j0 + kc + kr;
        sKV[kr * DS + d] = t < Tk ? to_f32(v[(((size_t)b * Tk + t) * Hkv + hk) * dh + d]) : 0.0f;
      }
      __syncthreads();
      for (int kk = 0; kk < KC; ++kk) {
        float pa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pa[i] = sS[(ty * 4 + i) * SST + kc + kk];
#pragma unroll
        for (int j = 0; j < MAX_NJ; ++j) {
          if (j < nj) {
            const float vv = sKV[kk * DS + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) pv[i][j] = fmaf(pa[i], vv, pv[i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float c = s_corr[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < MAX_NJ; ++j) acc[i][j] = acc[i][j] * c + pv[i][j];
    }
  }

  if (l4 == 0) s_l[r] = l_run;
  if (m_out != nullptr && l4 == 0 && q0 + r < S) m_out[(size_t)bh * S + q0 + r] = m_run;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty * 4 + i;
    const int sq = q0 + row;
    if (sq >= S) continue;
    const float L = fmaxf(s_l[row], 1e-30f);
#pragma unroll
    for (int j = 0; j < MAX_NJ; ++j) {
      if (j < nj)
        store(acc[i][j] / L, out + (((size_t)b * S + sq) * H + hq) * dh + tx + 16 * j);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* valid_len,
           const float* bp, const float* dmq, int n_bp, void* out, float* m_out, int B, int S,
           int Tk, int H,
           int Hkv, int dh, int causal, int has_window, int window, int q_offset,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(dh);
  auto kern = flash_kernel<T>;
  static size_t smem_allowed = 48 * 1024;  // raised once per size
  if (smem > smem_allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_allowed = smem;
  }
  const int rounded = (Tk + 127) / 128 * 128;
  const int bkv = rounded < BKV_MAX ? rounded : BKV_MAX;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(dh)));
  dim3 grid(B * H, (S + BQ - 1) / BQ);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), valid_len,
      bp, dmq, n_bp, static_cast<T*>(out), m_out, S, Tk, H, Hkv, dh, bkv, scale, causal,
      has_window, window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: (B, S, H, dh); k, v: (B, T, Hkv, dh); all contiguous, in dtype
// (0 = float32, 1 = bfloat16).  valid_len: (B,) f32 or null.  m_out: (B, H, S)
// f32 for each row's final running max, or null (then nothing else
// changes: the output is the same either way).  dh must be a
// multiple of 16, at most 128; H a multiple of Hkv.  Returns the cudaError_t
// of the launch.
extern "C" int flash_pwl_forward(const void* q, const void* k, const void* v,
                                 const void* valid_len, const void* bp, const void* dmq,
                                 int n_bp, void* out, void* m_out, int B, int S, int T,
                                 int H, int Hkv,
                                 int dh, int causal, int has_window, int window, int q_offset,
                                 int dtype, void* stream) {
  if (n_bp < 1 || n_bp > PWL_MAX_BP || B < 0 || S < 0 || T < 1 || Hkv < 1 || H % Hkv != 0 ||
      dh < 16 || dh > MAX_DH || dh % 16 != 0 || (S + BQ - 1) / BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* vl = static_cast<const float*>(valid_len);
  const float* bpf = static_cast<const float*>(bp);
  const float* dmqf = static_cast<const float*>(dmq);
  float* mf = static_cast<float*>(m_out);
  if (dtype == 0)
    return launch<float>(q, k, v, vl, bpf, dmqf, n_bp, out, mf, B, S, T, H, Hkv, dh, causal,
                         has_window, window, q_offset, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, vl, bpf, dmqf, n_bp, out, mf, B, S, T, H, Hkv, dh,
                                 causal, has_window, window, q_offset, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
