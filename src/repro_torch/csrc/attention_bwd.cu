// Flash attention backward with the PWL exp: the gradient of the dense oracle.
//
// Replaces the four backward passes of repro/kernels/fused/attention.py:
// _flash_bwd_stats_kernel and _flash_bwd_dm_kernel (both in
// flash_bwd_stats_kernel below), _flash_bwd_dq_kernel (flash_bwd_dq_kernel)
// and _flash_bwd_dkv_kernel (flash_bwd_dkv_kernel).  q, dout, dq are
// (B, S, H, dh); k, v, dk, dv are (B, T, Hkv, dh), all in T (bf16 or f32),
// converted to f32 on load; query head hq uses KV head hq / G (GQA folded as
// Hkv major, G minor).  m is the forward's final running row max, (B, H, S)
// f32: bitwise the dense row max, since max telescopes.
//
// What is computed, per row i and key j, in f32 (s = (q_i . k_j) * scale,
// masked to -1e30; keep as in the forward: key < T, causal, window, and key
// as f32 < kv_valid_len[b]):
//
//   t  = s - m_i;   u = max(pwl(max(t, -1e4)), 0) * keep
//   gate = keep * gate(pwl > 0) * slope * gate(t > -1e4)   (1 above, 0.5 at, 0 below)
//   l_i = sum_j u;  L_i = max(l_i, 1e-30);  gl_i = gate(l_i > 1e-30)
//   delta_i = dout_i . (sum_j u v_j) / L_i;  dp = dout_i . v_j
//   du = (dp - gl delta) / L;  dt = du * gate;  dm_i = -sum_j dt
//   ds = (dt + dm * eq / ntie) * keep * scale   (eq: s == m_i, ntie their count, >= 1)
//   dq_i = sum_j ds k_j;  dk_j = sum_i ds q_i;  dv_j = sum_i (u / L) dout_i
//
// Three kernels on one stream:
//   stats: a block owns 64 query rows of one head and walks the key tiles;
//          it accumulates l, sum u v, ntie and the two sums that give dm
//          without a second walk, dm = -(sum dp gate - gl delta sum gate) / L,
//          and writes l, delta, ntie, dm ((4, B, H, S) f32).  This is the
//          JAX package's passes A and B in one recompute of the scores.
//   dq:    a block owns 64 query rows of one head and walks the key tiles.
//   dkv:   a block owns 64 keys of one KV head and walks the query tiles of
//          every query head of its group, so dk and dv are summed over G
//          inside the block.  No atomics: a second backward is bitwise the
//          first.
// Any tiling gives the same function (every term uses the final m and the row
// totals), so the tiles are 64 x 64, not the forward's 512-key chain steps.
// Tiles masked for every pair are skipped, as the forward skips them.  The
// scores are recomputed in the forward's order (fmaf over d from 0, then one
// rounded multiply by scale), so a score that was the row max in the forward
// is exactly equal to m here and the tie test is exact.
//
// What bounds it on an H100: at B = 1, S = T = 4096 causal, 12 heads, dh 64,
// bf16, the five products of the gradient over the ~1.01e8 causal pairs are
// 10 * dh * pairs ~ 64 GFLOP, ~65 us at the 989 TFLOP/s of the tensor cores,
// while q, k, v, dout read once and dq, dk, dv written once are ~44 MB,
// ~13 us: it is bound by operations.  This first version runs every product
// as f32 FMAs on CUDA cores (nine products, the scores and dout . v being
// recomputed by each kernel, plus three PWL value-and-slope decodes per
// pair), one thread computing a 4 x 4 patch of each 64 x 64 tile and a
// 4 x (dh / 16) patch of its output; tensor cores are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pwl_decode.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int TS = BK + 1;      // row stride of a 64 x 64 tile in shared memory
constexpr int MAX_DH = 128;
constexpr int MAX_NJ = MAX_DH / 16;

struct Problem {
  int S, Tk, H, Hkv, dh;
  float scale;
  int causal, has_window, window, q_offset;
  const float* valid_len;  // (B,) f32, or null
};

__device__ __forceinline__ bool keep_pair(const Problem& p, float vl, int kpos, int qpos) {
  bool kp = kpos < p.Tk;
  if (p.causal) kp = kp && kpos <= qpos;
  if (p.has_window) kp = kp && (qpos - kpos) < p.window;
  if (p.valid_len != nullptr) kp = kp && static_cast<float>(kpos) < vl;
  return kp;
}

// jnp's gradient of maximum(x, c) in x
__device__ __forceinline__ float max_gate(float x, float c) {
  return x > c ? 1.0f : (x == c ? 0.5f : 0.0f);
}

struct Terms {
  float u, gate, eq;
};

// The per-pair recompute of the JAX package's _bwd_keep_terms.  acc is the
// unscaled q . k, summed as the forward sums it.
__device__ __forceinline__ Terms pair_terms(float acc, bool kp, float m, float scale,
                                            const float* s_bp, const float* s_dmq, int n_bp) {
  const float s = kp ? __fmul_rn(acc, scale) : NEG_FILL;
  const float t = __fsub_rn(s, m);
  const float2 ps = pwl_value_and_slope(fmaxf(t, SHIFT_CLAMP), s_bp, s_dmq, n_bp);
  const float keepf = kp ? 1.0f : 0.0f;
  Terms r;
  r.eq = s == m ? 1.0f : 0.0f;
  r.u = fmaxf(ps.x, 0.0f) * keepf;
  r.gate = keepf * max_gate(ps.x, 0.0f) * ps.y * max_gate(t, SHIFT_CLAMP);
  return r;
}

size_t smem_bytes(int dh) {  // four 64-row operand tiles and two 64 x 64 tiles
  return ((size_t)4 * BQ * (dh + 1) + (size_t)2 * BK * TS) * sizeof(float);
}

// rows [r0, r0 + 64) of head h of a (B, N, heads, dh) tensor into a 64 x DS
// f32 tile, zero past N
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int b, int r0,
                                          int N, int heads, int h, int dh) {
  const int DS = dh + 1;
  for (int e = threadIdx.x; e < BQ * dh; e += THREADS) {
    const int rr = e / dh, d = e - rr * dh;
    const int n = r0 + rr;
    dst[rr * DS + d] = n < N ? to_f32(src[(((size_t)b * N + n) * heads + h) * dh + d]) : 0.0f;
  }
}

// Row reductions over the 16 threads (tx) that share a row (ty): they are 16
// neighbouring lanes of one warp.
__device__ __forceinline__ float sum16(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  return x;
}

// The 4 x 4 patches of the scores (before scale) and of dout . v^T that a
// thread owns: rows a0 + i of sA / sC against rows b0 + 16 j of sB / sD, each
// summed over d from 0 with fmaf, as the forward sums its scores (an fmaf
// is exact in the order of its two factors, so either operand may be q).
__device__ __forceinline__ void patch_products(const float* sA, const float* sB,
                                               const float* sC, const float* sD, int a0,
                                               int b0, int dh, float sacc[4][4],
                                               float dpacc[4][4]) {
  const int DS = dh + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sacc[i][j] = dpacc[i][j] = 0.0f;
  for (int d = 0; d < dh; ++d) {
    float a[4], c[4], bb[4], dd[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = sA[(a0 + i) * DS + d];
      c[i] = sC[(a0 + i) * DS + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bb[j] = sB[(b0 + 16 * j) * DS + d];
      dd[j] = sD[(b0 + 16 * j) * DS + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sacc[i][j] = fmaf(a[i], bb[j], sacc[i][j]);
        dpacc[i][j] = fmaf(c[i], dd[j], dpacc[i][j]);
      }
  }
}

// flash_bwd_stats_kernel: l, delta, ntie and dm of 64 query rows.
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_stats_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const T* __restrict__ dout, const float* __restrict__ m,
                       const float* __restrict__ bp, const float* __restrict__ dmq, int n_bp,
                       float* __restrict__ stats, int B, Problem p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_bp[PWL_MAX_BP];
  __shared__ float s_dmq[2 * (PWL_MAX_BP + 1)];
  __shared__ float s_m[BQ];
  const int dh = p.dh, DS = dh + 1, nj = dh / 16;
  float* sQ = smem;
  float* sDO = sQ + BQ * DS;
  float* sK = sDO + BQ * DS;
  float* sV = sK + BK * DS;
  float* sU = sV + BK * DS;  // BQ x TS: u of the tile

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.x, b = bh / p.H, hq = bh % p.H;
  const int hk = hq / (p.H / p.Hkv);
  const int q0 = blockIdx.y * BQ;
  const float vl = p.valid_len != nullptr ? p.valid_len[b] : 0.0f;

  pwl_load_table(s_bp, s_dmq, bp, dmq, n_bp);
  load_tile(sQ, q, b, q0, p.S, p.H, hq, dh);
  load_tile(sDO, dout, b, q0, p.S, p.H, hq, dh);
  for (int r = tid; r < BQ; r += THREADS)
    s_m[r] = q0 + r < p.S ? m[(size_t)bh * p.S + q0 + r] : 0.0f;
  __syncthreads();

  float acc_o[4][MAX_NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < MAX_NJ; ++j) acc_o[i][j] = 0.0f;
  float pl[4] = {0, 0, 0, 0}, pn[4] = {0, 0, 0, 0}, pdg[4] = {0, 0, 0, 0}, pg[4] = {0, 0, 0, 0};

#define QROW(i) (ty * 4 + (i))
#define KCOL(j) (tx + 16 * (j))
  const int q_first = q0 + p.q_offset;
  const int q_last = min(q0 + BQ, p.S) - 1 + p.q_offset;
  for (int j0 = 0; j0 < p.Tk; j0 += BK) {
    if (p.causal && j0 > q_last) break;
    if (p.valid_len != nullptr && static_cast<float>(j0) >= vl) break;
    if (p.has_window && q_first - (j0 + BK - 1) >= p.window) continue;
    __syncthreads();  // sK, sV and sU are free
    load_tile(sK, k, b, j0, p.Tk, p.Hkv, hk, dh);
    load_tile(sV, v, b, j0, p.Tk, p.Hkv, hk, dh);
    __syncthreads();
    float sacc[4][4], dpacc[4][4];
    patch_products(sQ, sK, sDO, sV, ty * 4, tx, dh, sacc, dpacc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = QROW(i);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = KCOL(j);
        const bool kp = keep_pair(p, vl, j0 + col, q0 + row + p.q_offset);
        const Terms tm = pair_terms(sacc[i][j], kp, s_m[row], p.scale, s_bp, s_dmq, n_bp);
        pl[i] += tm.u;
        pn[i] += tm.eq;
        pdg[i] = fmaf(dpacc[i][j], tm.gate, pdg[i]);
        pg[i] += tm.gate;
        sU[row * TS + col] = tm.u;
      }
    }
    __syncthreads();
    for (int kk = 0; kk < BK; ++kk) {
      float ua[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ua[i] = sU[QROW(i) * TS + kk];
#pragma unroll
      for (int j = 0; j < MAX_NJ; ++j) {
        if (j < nj) {
          const float vv = sV[kk * DS + KCOL(j)];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc_o[i][j] = fmaf(ua[i], vv, acc_o[i][j]);
        }
      }
    }
  }

  const size_t plane = (size_t)B * p.H * p.S;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = QROW(i);
    float pd = 0.0f;
#pragma unroll
    for (int j = 0; j < MAX_NJ; ++j)
      if (j < nj) pd = fmaf(sDO[row * DS + KCOL(j)], acc_o[i][j], pd);
    pd = sum16(pd);
    const float l = sum16(pl[i]), n = sum16(pn[i]);
    const float dpg = sum16(pdg[i]), g = sum16(pg[i]);
    if (tx == 0 && q0 + row < p.S) {
      const float L = fmaxf(l, 1e-30f);
      const float delta = pd / L;
      const float gl = max_gate(l, 1e-30f);
      const size_t at = (size_t)bh * p.S + q0 + row;
      stats[at] = l;
      stats[plane + at] = delta;
      stats[2 * plane + at] = fmaxf(n, 1.0f);
      stats[3 * plane + at] = -(dpg - gl * delta * g) / L;
    }
  }
#undef QROW
#undef KCOL
}

// Per-row terms of du and ds that the dq and dkv kernels load: L, gl * delta,
// dm / ntie (dm * eq / ntie is dm / ntie at a tie and 0 elsewhere), m.
struct RowStats {
  float L, gld, dmn, m;
};

__device__ __forceinline__ RowStats row_stats(const float* __restrict__ stats,
                                              const float* __restrict__ m, size_t plane,
                                              size_t at) {
  const float l = stats[at];
  RowStats r;
  r.L = fmaxf(l, 1e-30f);
  r.gld = max_gate(l, 1e-30f) * stats[plane + at];
  r.dmn = stats[3 * plane + at] / stats[2 * plane + at];
  r.m = m[at];
  return r;
}

__device__ __forceinline__ float pair_ds(const Terms& tm, float dp, bool kp, float L, float gld,
                                         float dmn, float scale) {
  const float du = (dp - gld) / L;
  const float dt = du * tm.gate;
  return (dt + (tm.eq != 0.0f ? dmn : 0.0f)) * (kp ? 1.0f : 0.0f) * scale;
}

// flash_bwd_dq_kernel: dq of 64 query rows, walking the key tiles.
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ m,
                    const float* __restrict__ bp, const float* __restrict__ dmq, int n_bp,
                    const float* __restrict__ stats, T* __restrict__ dq, int B, Problem p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_bp[PWL_MAX_BP];
  __shared__ float s_dmq[2 * (PWL_MAX_BP + 1)];
  __shared__ RowStats s_row[BQ];
  const int dh = p.dh, DS = dh + 1, nj = dh / 16;
  float* sQ = smem;
  float* sDO = sQ + BQ * DS;
  float* sK = sDO + BQ * DS;
  float* sV = sK + BK * DS;
  float* sDS = sV + BK * DS;  // BQ x TS: ds of the tile

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.x, b = bh / p.H, hq = bh % p.H;
  const int hk = hq / (p.H / p.Hkv);
  const int q0 = blockIdx.y * BQ;
  const float vl = p.valid_len != nullptr ? p.valid_len[b] : 0.0f;
  const size_t plane = (size_t)B * p.H * p.S;

  pwl_load_table(s_bp, s_dmq, bp, dmq, n_bp);
  load_tile(sQ, q, b, q0, p.S, p.H, hq, dh);
  load_tile(sDO, dout, b, q0, p.S, p.H, hq, dh);
  for (int r = tid; r < BQ; r += THREADS)
    s_row[r] = q0 + r < p.S ? row_stats(stats, m, plane, (size_t)bh * p.S + q0 + r)
                            : RowStats{1.0f, 0.0f, 0.0f, 0.0f};
  __syncthreads();

  float acc[4][MAX_NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < MAX_NJ; ++j) acc[i][j] = 0.0f;

#define QROW(i) (ty * 4 + (i))
#define KCOL(j) (tx + 16 * (j))
  const int q_first = q0 + p.q_offset;
  const int q_last = min(q0 + BQ, p.S) - 1 + p.q_offset;
  for (int j0 = 0; j0 < p.Tk; j0 += BK) {
    if (p.causal && j0 > q_last) break;
    if (p.valid_len != nullptr && static_cast<float>(j0) >= vl) break;
    if (p.has_window && q_first - (j0 + BK - 1) >= p.window) continue;
    __syncthreads();  // sK, sV and sDS are free
    load_tile(sK, k, b, j0, p.Tk, p.Hkv, hk, dh);
    load_tile(sV, v, b, j0, p.Tk, p.Hkv, hk, dh);
    __syncthreads();
    float sacc[4][4], dpacc[4][4];
    patch_products(sQ, sK, sDO, sV, ty * 4, tx, dh, sacc, dpacc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = QROW(i);
      const RowStats rs = s_row[row];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = KCOL(j);
        const bool kp = keep_pair(p, vl, j0 + col, q0 + row + p.q_offset);
        const Terms tm = pair_terms(sacc[i][j], kp, rs.m, p.scale, s_bp, s_dmq, n_bp);
        sDS[row * TS + col] = pair_ds(tm, dpacc[i][j], kp, rs.L, rs.gld, rs.dmn, p.scale);
      }
    }
    __syncthreads();
    for (int kk = 0; kk < BK; ++kk) {
      float da[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) da[i] = sDS[QROW(i) * TS + kk];
#pragma unroll
      for (int j = 0; j < MAX_NJ; ++j) {
        if (j < nj) {
          const float kv = sK[kk * DS + KCOL(j)];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(da[i], kv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int sq = q0 + QROW(i);
    if (sq >= p.S) continue;
#pragma unroll
    for (int j = 0; j < MAX_NJ; ++j)
      if (j < nj) store(acc[i][j], dq + (((size_t)b * p.S + sq) * p.H + hq) * dh + KCOL(j));
  }
#undef QROW
#undef KCOL
}

// flash_bwd_dkv_kernel: dk and dv of 64 keys of one KV head, walking the
// query tiles of each query head of its group.
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ m,
                     const float* __restrict__ bp, const float* __restrict__ dmq, int n_bp,
                     const float* __restrict__ stats, T* __restrict__ dk, T* __restrict__ dv,
                     int B, Problem p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_bp[PWL_MAX_BP];
  __shared__ float s_dmq[2 * (PWL_MAX_BP + 1)];
  __shared__ RowStats s_row[BQ];
  const int dh = p.dh, DS = dh + 1, nj = dh / 16;
  float* sQ = smem;
  float* sDO = sQ + BQ * DS;
  float* sK = sDO + BQ * DS;
  float* sV = sK + BK * DS;
  float* sDS = sV + BK * DS;  // BK x TS: ds of the tile, key-major
  float* sP = sDS + BK * TS;  // BK x TS: u / L of the tile, key-major

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.x / p.Hkv, hk = blockIdx.x % p.Hkv;
  const int G = p.H / p.Hkv;
  const int k0 = blockIdx.y * BK;
  const float vl = p.valid_len != nullptr ? p.valid_len[b] : 0.0f;
  const size_t plane = (size_t)B * p.H * p.S;

  pwl_load_table(s_bp, s_dmq, bp, dmq, n_bp);
  load_tile(sK, k, b, k0, p.Tk, p.Hkv, hk, dh);
  load_tile(sV, v, b, k0, p.Tk, p.Hkv, hk, dh);
  __syncthreads();

  float acc_k[4][MAX_NJ], acc_v[4][MAX_NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < MAX_NJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.0f;

#define QCOL(j) (tx + 16 * (j))
#define KROW(i) (ty * 4 + (i))
  const bool block_live = p.valid_len == nullptr || static_cast<float>(k0) < vl;
  for (int g = 0; g < G && block_live; ++g) {
    const int hq = hk * G + g;
    const int bh = b * p.H + hq;
    for (int i0 = 0; i0 < p.S; i0 += BQ) {
      const int q_first = i0 + p.q_offset;
      const int q_last = min(i0 + BQ, p.S) - 1 + p.q_offset;
      if (p.causal && k0 > q_last) continue;
      if (p.has_window && q_first - (k0 + BK - 1) >= p.window) break;
      __syncthreads();  // sQ, sDO, s_row, sDS and sP are free
      load_tile(sQ, q, b, i0, p.S, p.H, hq, dh);
      load_tile(sDO, dout, b, i0, p.S, p.H, hq, dh);
      for (int r = tid; r < BQ; r += THREADS)
        s_row[r] = i0 + r < p.S ? row_stats(stats, m, plane, (size_t)bh * p.S + i0 + r)
                                : RowStats{1.0f, 0.0f, 0.0f, 0.0f};
      __syncthreads();
      // patch rows are keys, columns queries
      float sacc[4][4], dpacc[4][4];
      patch_products(sK, sQ, sV, sDO, ty * 4, tx, dh, sacc, dpacc);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qr = QCOL(j);
        const RowStats rs = s_row[qr];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = KROW(i);
          const bool kp = i0 + qr < p.S && keep_pair(p, vl, k0 + key, i0 + qr + p.q_offset);
          const Terms tm = pair_terms(sacc[i][j], kp, rs.m, p.scale, s_bp, s_dmq, n_bp);
          sDS[key * TS + qr] = pair_ds(tm, dpacc[i][j], kp, rs.L, rs.gld, rs.dmn, p.scale);
          sP[key * TS + qr] = tm.u / rs.L;
        }
      }
      __syncthreads();
      for (int qq = 0; qq < BQ; ++qq) {
        float da[4], pa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          da[i] = sDS[KROW(i) * TS + qq];
          pa[i] = sP[KROW(i) * TS + qq];
        }
#pragma unroll
        for (int j = 0; j < MAX_NJ; ++j) {
          if (j < nj) {
            const float qv = sQ[qq * DS + QCOL(j)];
            const float ov = sDO[qq * DS + QCOL(j)];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc_k[i][j] = fmaf(da[i], qv, acc_k[i][j]);
              acc_v[i][j] = fmaf(pa[i], ov, acc_v[i][j]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + KROW(i);
    if (key >= p.Tk) continue;
    const size_t base = (((size_t)b * p.Tk + key) * p.Hkv + hk) * dh;
#pragma unroll
    for (int j = 0; j < MAX_NJ; ++j) {
      if (j < nj) {
        store(acc_k[i][j], dk + base + QCOL(j));
        store(acc_v[i][j], dv + base + QCOL(j));
      }
    }
  }
#undef QCOL
#undef KROW
}

// Raise a kernel's dynamic shared memory limit once per size it is launched at.
template <typename K>
cudaError_t allow_smem(K kern, size_t bytes, size_t* allowed) {
  if (bytes <= *allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(bytes));
  if (e == cudaSuccess) *allowed = bytes;
  return e;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* m,
           const float* bp, const float* dmq, int n_bp, float* stats, void* dq, void* dk,
           void* dv, int B, const Problem& p, cudaStream_t stream) {
  static size_t allowed[3] = {48 * 1024, 48 * 1024, 48 * 1024};
  const size_t smem = smem_bytes(p.dh);
  auto stats_k = flash_bwd_stats_kernel<T>;
  auto dq_k = flash_bwd_dq_kernel<T>;
  auto dkv_k = flash_bwd_dkv_kernel<T>;
  cudaError_t e;
  if ((e = allow_smem(stats_k, smem, &allowed[0])) != cudaSuccess) return static_cast<int>(e);
  if ((e = allow_smem(dq_k, smem, &allowed[1])) != cudaSuccess) return static_cast<int>(e);
  if ((e = allow_smem(dkv_k, smem, &allowed[2])) != cudaSuccess) return static_cast<int>(e);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  if (p.S > 0) {
    dim3 grid(B * p.H, (p.S + BQ - 1) / BQ);
    stats_k<<<grid, THREADS, smem, stream>>>(qt, kt, vt, dot, m, bp, dmq, n_bp, stats, B, p);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    dq_k<<<grid, THREADS, smem, stream>>>(qt, kt, vt, dot, m, bp, dmq, n_bp, stats,
                                          static_cast<T*>(dq), B, p);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(B * p.Hkv, (p.Tk + BK - 1) / BK);
  dkv_k<<<grid, THREADS, smem, stream>>>(qt, kt, vt, dot, m, bp, dmq, n_bp, stats,
                                         static_cast<T*>(dk), static_cast<T*>(dv), B, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, dout, dq: (B, S, H, dh); k, v, dk, dv: (B, T, Hkv, dh); all contiguous,
// in dtype (0 = float32, 1 = bfloat16).  valid_len: (B,) f32 or null.  m: the
// forward's row max, (B, H, S) f32.  stats: (4, B, H, S) f32 scratch (l,
// delta, ntie, dm).  dh a multiple of 16, at most 128; H a multiple of Hkv.
// Launches the three kernels on the stream and returns the first
// cudaError_t of a launch.
extern "C" int flash_pwl_backward(const void* q, const void* k, const void* v, const void* dout,
                                  const void* valid_len, const void* m, const void* bp,
                                  const void* dmq, int n_bp, void* stats, void* dq, void* dk,
                                  void* dv, int B, int S, int T, int H, int Hkv, int dh,
                                  int causal, int has_window, int window, int q_offset,
                                  int dtype, void* stream) {
  if (n_bp < 1 || n_bp > PWL_MAX_BP || B < 0 || S < 0 || T < 1 || Hkv < 1 || H % Hkv != 0 ||
      dh < 16 || dh > MAX_DH || dh % 16 != 0 || (S + BQ - 1) / BQ > 65535 ||
      (T + BK - 1) / BK > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  Problem p;
  p.S = S;
  p.Tk = T;
  p.H = H;
  p.Hkv = Hkv;
  p.dh = dh;
  p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(dh)));
  p.causal = causal;
  p.has_window = has_window;
  p.window = window;
  p.q_offset = q_offset;
  p.valid_len = static_cast<const float*>(valid_len);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* mf = static_cast<const float*>(m);
  const float* bpf = static_cast<const float*>(bp);
  const float* dmqf = static_cast<const float*>(dmq);
  float* sf = static_cast<float*>(stats);
  if (dtype == 0)
    return launch<float>(q, k, v, dout, mf, bpf, dmqf, n_bp, sf, dq, dk, dv, B, p, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, dout, mf, bpf, dmqf, n_bp, sf, dq, dk, dv, B, p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
