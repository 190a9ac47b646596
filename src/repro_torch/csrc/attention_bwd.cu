// Flash attention backward with the PWL exp: the gradient of the dense oracle.
//
// Replaces the four backward passes of repro/kernels/fused/attention.py:
// _flash_bwd_stats_kernel and _flash_bwd_dm_kernel (both in the stats
// kernel below), _flash_bwd_dq_kernel (the dq kernel) and
// _flash_bwd_dkv_kernel (the dkv kernel).  q, dout, dq are (B, S, H, dh);
// k, v, dk, dv are (B, T, Hkv, dh), all in T (bf16 or f32); query head hq
// uses KV head hq / G (GQA folded as Hkv major, G minor).  m is the forward's
// final running row max, (B, H, S) f32: bitwise the dense row max, since max
// telescopes.
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
//   stats: a block owns 64 query rows of one head (32 in the f32 design at
//          dh > 128) and walks the key tiles; it accumulates l, delta's sum,
//          the tie count and the two sums that give dm without a second walk,
//          dm = -(sum dp gate - gl delta sum gate) / L, and writes l, delta,
//          the raw tie count (clamped to 1 where it is read) and dm
//          ((4, B, H, S) f32).  This is the JAX package's passes A and B in
//          one recompute of the scores.
//   dq:    a block owns 64 query rows of one head and walks the key tiles.
//   dkv:   a block owns a tile of keys of one KV head and walks the query
//          tiles of every query head of its group, so dk and dv are summed
//          over G inside the block.  No atomics: a second backward is
//          bitwise the first.
// Any tiling gives the same function (every term uses the final m and the row
// totals), so the tiles are not the forward's 512-key chain steps.  Tiles
// masked for every pair are skipped, as the forward skips them.  Every score
// is recomputed as the forward computed it, so a score that was the row max
// in the forward is exactly equal to m here and the tie test is exact.
//
// What bounds it on an H100: at B = 1, S = T = 4096 causal, 12 heads, dh 64,
// the five products of the gradient over the ~1.01e8 causal pairs are
// 10 * dh * pairs ~ 64 GFLOP, ~65 us at the 989 TFLOP/s of the tensor cores,
// while q, k, v, dout read once and dq, dk, dv written once are ~44 MB,
// ~13 us: it is bound by operations, and most of them are the three
// value-and-slope decodes of each pair (one a kernel) on CUDA cores.  Two
// designs, chosen by dtype:
//
// bf16 (tc:: below): tensor-core products (mma.sync m16n8k16 bf16 -> f32,
// mma.cuh) and the breakpoint search (pwl_decode.cuh).  Each score is summed
// over d in 16-wide steps from 0 with Q as the A operand and K as B, then
// rounded once by scale, exactly as the forward's, in all three kernels.  The
// stats and dq kernels: four warps of 16 query rows against key tiles of 64
// (32 at dh > 128), K and V double-buffered in shared memory with cp.async,
// the scores and dout . v in registers; delta's sum is taken as sum u dp (the
// same sum in another order, so no u . v product); dq += ds . k takes ds from
// the accumulators as the A operand, split into hi and lo bf16 (two products
// that keep ~16 bits of each f32 value).  The dkv kernel: eight warps; each
// computes the scores of 16 queries against half the key tile, as above, and
// writes u / L and ds to shared memory as hi and lo bf16; ldmatrix.trans reads
// them back transposed as the A operand of dv += (u / L)^T dout and dk +=
// ds^T q, each warp owning 16 keys and a slice of d.  Q and dout tiles are
// double-buffered.  A pair multiplies by a row's 1 / L where the f32 design
// divides.  Twelve bf16 products a pair in all: two in stats, four in dq,
// six in dkv.
//
// f32 (the first design, kept as it was): every product as f32 FMAs on CUDA
// cores (nine products, the scores and dout . v being recomputed by each
// kernel, plus three linear value-and-slope decodes per pair), one thread
// computing a 4 x 4 patch of each 64 x 64 tile and a 4 x (dh / 16) patch of
// its output (at dh > 128: 2 x 2 of 32 x 32 tiles, 2 x (dh / 16)).  pwl is
// the launch's epilogue (epilogue.cuh): the exp table, or the exact exp, with
// its slope.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "mma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_DH = 256;
constexpr int SMALL_DH = 128;  // up to here: 64 x 64 tiles

// Two tilings, one instantiation each: dh <= 128 keeps 64 x 64 tiles and 4 x 4
// patches (every sum in the order it had), dh up to 256 takes 32 x 32 tiles
// and 2 x 2 patches, so that four operand tiles and two score tiles fit the
// 227 KB of shared memory a block may hold (64 x 64 at dh 256 would need
// 296,448 bytes).  A score is the same fmaf chain over d in both, so the tie
// test against the forward's m stays exact.
// BT rows (queries or keys) per tile, RI = BT / 16 rows and columns of a
// thread's patch, MAX_NJ = dh / 16 output columns a thread owns at most.
template <int BT, int MAX_NJ_>
struct Tile {
  static constexpr int B = BT;
  static constexpr int RI = BT / 16;
  static constexpr int TS = BT + 1;  // row stride of a BT x BT tile in shared memory
  static constexpr int MAX_NJ = MAX_NJ_;
  static size_t smem_bytes(int dh) {  // four operand tiles and two BT x BT tiles
    return ((size_t)4 * BT * (dh + 1) + (size_t)2 * BT * TS) * sizeof(float);
  }
};
using SmallTile = Tile<64, SMALL_DH / 16>;
using LargeTile = Tile<32, MAX_DH / 16>;

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
template <int TABLE>
__device__ __forceinline__ Terms pair_terms(float acc, bool kp, float m, float scale,
                                            const float* s_bp, const float* s_dmq,
                                            const Epilogue& ep) {
  const float s = kp ? __fmul_rn(acc, scale) : NEG_FILL;
  const float t = __fsub_rn(s, m);
  const float2 ps = epi_value_and_slope<TABLE>(ep, fmaxf(t, SHIFT_CLAMP), s_bp, s_dmq);
  const float keepf = kp ? 1.0f : 0.0f;
  Terms r;
  r.eq = s == m ? 1.0f : 0.0f;
  r.u = fmaxf(ps.x, 0.0f) * keepf;
  r.gate = keepf * max_gate(ps.x, 0.0f) * ps.y * max_gate(t, SHIFT_CLAMP);
  return r;
}

// rows [r0, r0 + BT) of head h of a (B, N, heads, dh) tensor into a BT x DS
// f32 tile, zero past N
template <int BT, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int b, int r0,
                                          int N, int heads, int h, int dh) {
  const int DS = dh + 1;
  for (int e = threadIdx.x; e < BT * dh; e += THREADS) {
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

// The RI x RI patches of the scores (before scale) and of dout . v^T that a
// thread owns: rows a0 + i of sA / sC against rows b0 + 16 j of sB / sD, each
// summed over d from 0 with fmaf, as the forward sums its scores (an fmaf
// is exact in the order of its two factors, so either operand may be q).
template <int RI>
__device__ __forceinline__ void patch_products(const float* sA, const float* sB,
                                               const float* sC, const float* sD, int a0,
                                               int b0, int dh, float sacc[RI][RI],
                                               float dpacc[RI][RI]) {
  const int DS = dh + 1;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RI; ++j) sacc[i][j] = dpacc[i][j] = 0.0f;
  for (int d = 0; d < dh; ++d) {
    float a[RI], c[RI], bb[RI], dd[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      a[i] = sA[(a0 + i) * DS + d];
      c[i] = sC[(a0 + i) * DS + d];
    }
#pragma unroll
    for (int j = 0; j < RI; ++j) {
      bb[j] = sB[(b0 + 16 * j) * DS + d];
      dd[j] = sD[(b0 + 16 * j) * DS + d];
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        sacc[i][j] = fmaf(a[i], bb[j], sacc[i][j]);
        dpacc[i][j] = fmaf(c[i], dd[j], dpacc[i][j]);
      }
  }
}

// flash_bwd_stats_kernel: l, delta, ntie and dm of BT query rows.
template <typename T, class TL, int TABLE>
__global__ void __launch_bounds__(THREADS)
flash_bwd_stats_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const T* __restrict__ dout, const float* __restrict__ m,
                       const float* __restrict__ bp, const float* __restrict__ dmq, Epilogue ep,
                       float* __restrict__ stats, int B, Problem p) {
  constexpr int BQ = TL::B, BK = TL::B, RI = TL::RI, TS = TL::TS, MAX_NJ = TL::MAX_NJ;
  extern __shared__ __align__(16) float smem[];
  __shared__ ChainTable<TABLE> chain;
  float* const s_bp = chain.bp(bp);
  float* const s_dmq = chain.dmq(dmq);
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

  epi_load_table<TABLE>(s_bp, s_dmq, bp, dmq, ep);
  load_tile<BQ>(sQ, q, b, q0, p.S, p.H, hq, dh);
  load_tile<BQ>(sDO, dout, b, q0, p.S, p.H, hq, dh);
  for (int r = tid; r < BQ; r += THREADS)
    s_m[r] = q0 + r < p.S ? m[(size_t)bh * p.S + q0 + r] : 0.0f;
  __syncthreads();

  float acc_o[RI][MAX_NJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < MAX_NJ; ++j) acc_o[i][j] = 0.0f;
  float pl[RI], pn[RI], pdg[RI], pg[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) pl[i] = pn[i] = pdg[i] = pg[i] = 0.0f;

#define QROW(i) (ty * RI + (i))
#define KCOL(j) (tx + 16 * (j))
  const int q_first = q0 + p.q_offset;
  const int q_last = min(q0 + BQ, p.S) - 1 + p.q_offset;
  for (int j0 = 0; j0 < p.Tk; j0 += BK) {
    if (p.causal && j0 > q_last) break;
    if (p.valid_len != nullptr && static_cast<float>(j0) >= vl) break;
    if (p.has_window && q_first - (j0 + BK - 1) >= p.window) continue;
    __syncthreads();  // sK, sV and sU are free
    load_tile<BK>(sK, k, b, j0, p.Tk, p.Hkv, hk, dh);
    load_tile<BK>(sV, v, b, j0, p.Tk, p.Hkv, hk, dh);
    __syncthreads();
    float sacc[RI][RI], dpacc[RI][RI];
    patch_products<RI>(sQ, sK, sDO, sV, ty * RI, tx, dh, sacc, dpacc);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = QROW(i);
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int col = KCOL(j);
        const bool kp = keep_pair(p, vl, j0 + col, q0 + row + p.q_offset);
        const Terms tm = pair_terms<TABLE>(sacc[i][j], kp, s_m[row], p.scale, s_bp, s_dmq, ep);
        pl[i] += tm.u;
        pn[i] += tm.eq;
        pdg[i] = fmaf(dpacc[i][j], tm.gate, pdg[i]);
        pg[i] += tm.gate;
        sU[row * TS + col] = tm.u;
      }
    }
    __syncthreads();
    for (int kk = 0; kk < BK; ++kk) {
      float ua[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) ua[i] = sU[QROW(i) * TS + kk];
#pragma unroll
      for (int j = 0; j < MAX_NJ; ++j) {
        if (j < nj) {
          const float vv = sV[kk * DS + KCOL(j)];
#pragma unroll
          for (int i = 0; i < RI; ++i) acc_o[i][j] = fmaf(ua[i], vv, acc_o[i][j]);
        }
      }
    }
  }

  const size_t plane = (size_t)B * p.H * p.S;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
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
      stats[2 * plane + at] = n;  // raw: a live row re-finds its max at least once
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
  r.dmn = stats[3 * plane + at] / fmaxf(stats[2 * plane + at], 1.0f);
  r.m = m[at];
  return r;
}

__device__ __forceinline__ float pair_ds(const Terms& tm, float dp, bool kp, float L, float gld,
                                         float dmn, float scale) {
  const float du = (dp - gld) / L;
  const float dt = du * tm.gate;
  return (dt + (tm.eq != 0.0f ? dmn : 0.0f)) * (kp ? 1.0f : 0.0f) * scale;
}

// flash_bwd_dq_kernel: dq of BT query rows, walking the key tiles.
template <typename T, class TL, int TABLE>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ m,
                    const float* __restrict__ bp, const float* __restrict__ dmq, Epilogue ep,
                    const float* __restrict__ stats, T* __restrict__ dq, int B, Problem p) {
  constexpr int BQ = TL::B, BK = TL::B, RI = TL::RI, TS = TL::TS, MAX_NJ = TL::MAX_NJ;
  extern __shared__ __align__(16) float smem[];
  __shared__ ChainTable<TABLE> chain;
  float* const s_bp = chain.bp(bp);
  float* const s_dmq = chain.dmq(dmq);
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

  epi_load_table<TABLE>(s_bp, s_dmq, bp, dmq, ep);
  load_tile<BQ>(sQ, q, b, q0, p.S, p.H, hq, dh);
  load_tile<BQ>(sDO, dout, b, q0, p.S, p.H, hq, dh);
  for (int r = tid; r < BQ; r += THREADS)
    s_row[r] = q0 + r < p.S ? row_stats(stats, m, plane, (size_t)bh * p.S + q0 + r)
                            : RowStats{1.0f, 0.0f, 0.0f, 0.0f};
  __syncthreads();

  float acc[RI][MAX_NJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < MAX_NJ; ++j) acc[i][j] = 0.0f;

#define QROW(i) (ty * RI + (i))
#define KCOL(j) (tx + 16 * (j))
  const int q_first = q0 + p.q_offset;
  const int q_last = min(q0 + BQ, p.S) - 1 + p.q_offset;
  for (int j0 = 0; j0 < p.Tk; j0 += BK) {
    if (p.causal && j0 > q_last) break;
    if (p.valid_len != nullptr && static_cast<float>(j0) >= vl) break;
    if (p.has_window && q_first - (j0 + BK - 1) >= p.window) continue;
    __syncthreads();  // sK, sV and sDS are free
    load_tile<BK>(sK, k, b, j0, p.Tk, p.Hkv, hk, dh);
    load_tile<BK>(sV, v, b, j0, p.Tk, p.Hkv, hk, dh);
    __syncthreads();
    float sacc[RI][RI], dpacc[RI][RI];
    patch_products<RI>(sQ, sK, sDO, sV, ty * RI, tx, dh, sacc, dpacc);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = QROW(i);
      const RowStats rs = s_row[row];
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int col = KCOL(j);
        const bool kp = keep_pair(p, vl, j0 + col, q0 + row + p.q_offset);
        const Terms tm = pair_terms<TABLE>(sacc[i][j], kp, rs.m, p.scale, s_bp, s_dmq, ep);
        sDS[row * TS + col] = pair_ds(tm, dpacc[i][j], kp, rs.L, rs.gld, rs.dmn, p.scale);
      }
    }
    __syncthreads();
    for (int kk = 0; kk < BK; ++kk) {
      float da[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) da[i] = sDS[QROW(i) * TS + kk];
#pragma unroll
      for (int j = 0; j < MAX_NJ; ++j) {
        if (j < nj) {
          const float kv = sK[kk * DS + KCOL(j)];
#pragma unroll
          for (int i = 0; i < RI; ++i) acc[i][j] = fmaf(da[i], kv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int sq = q0 + QROW(i);
    if (sq >= p.S) continue;
#pragma unroll
    for (int j = 0; j < MAX_NJ; ++j)
      if (j < nj) store(acc[i][j], dq + (((size_t)b * p.S + sq) * p.H + hq) * dh + KCOL(j));
  }
#undef QROW
#undef KCOL
}

// flash_bwd_dkv_kernel: dk and dv of BT keys of one KV head, walking the
// query tiles of each query head of its group.
template <typename T, class TL, int TABLE>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ m,
                     const float* __restrict__ bp, const float* __restrict__ dmq, Epilogue ep,
                     const float* __restrict__ stats, T* __restrict__ dk, T* __restrict__ dv,
                     int B, Problem p) {
  constexpr int BQ = TL::B, BK = TL::B, RI = TL::RI, TS = TL::TS, MAX_NJ = TL::MAX_NJ;
  extern __shared__ __align__(16) float smem[];
  __shared__ ChainTable<TABLE> chain;
  float* const s_bp = chain.bp(bp);
  float* const s_dmq = chain.dmq(dmq);
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

  epi_load_table<TABLE>(s_bp, s_dmq, bp, dmq, ep);
  load_tile<BK>(sK, k, b, k0, p.Tk, p.Hkv, hk, dh);
  load_tile<BK>(sV, v, b, k0, p.Tk, p.Hkv, hk, dh);
  __syncthreads();

  float acc_k[RI][MAX_NJ], acc_v[RI][MAX_NJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < MAX_NJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.0f;

#define QCOL(j) (tx + 16 * (j))
#define KROW(i) (ty * RI + (i))
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
      load_tile<BQ>(sQ, q, b, i0, p.S, p.H, hq, dh);
      load_tile<BQ>(sDO, dout, b, i0, p.S, p.H, hq, dh);
      for (int r = tid; r < BQ; r += THREADS)
        s_row[r] = i0 + r < p.S ? row_stats(stats, m, plane, (size_t)bh * p.S + i0 + r)
                                : RowStats{1.0f, 0.0f, 0.0f, 0.0f};
      __syncthreads();
      // patch rows are keys, columns queries
      float sacc[RI][RI], dpacc[RI][RI];
      patch_products<RI>(sK, sQ, sV, sDO, ty * RI, tx, dh, sacc, dpacc);
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int qr = QCOL(j);
        const RowStats rs = s_row[qr];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const int key = KROW(i);
          const bool kp = i0 + qr < p.S && keep_pair(p, vl, k0 + key, i0 + qr + p.q_offset);
          const Terms tm = pair_terms<TABLE>(sacc[i][j], kp, rs.m, p.scale, s_bp, s_dmq, ep);
          sDS[key * TS + qr] = pair_ds(tm, dpacc[i][j], kp, rs.L, rs.gld, rs.dmn, p.scale);
          sP[key * TS + qr] = tm.u / rs.L;
        }
      }
      __syncthreads();
      for (int qq = 0; qq < BQ; ++qq) {
        float da[RI], pa[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          da[i] = sDS[KROW(i) * TS + qq];
          pa[i] = sP[KROW(i) * TS + qq];
        }
#pragma unroll
        for (int j = 0; j < MAX_NJ; ++j) {
          if (j < nj) {
            const float qv = sQ[qq * DS + QCOL(j)];
            const float ov = sDO[qq * DS + QCOL(j)];
#pragma unroll
            for (int i = 0; i < RI; ++i) {
              acc_k[i][j] = fmaf(da[i], qv, acc_k[i][j]);
              acc_v[i][j] = fmaf(pa[i], ov, acc_v[i][j]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
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

template <typename T, class TL, int TABLE>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* m,
           const float* bp, const float* dmq, Epilogue ep, float* stats, void* dq, void* dk,
           void* dv, int B, const Problem& p, cudaStream_t stream) {
  constexpr int BT = TL::B;
  if ((p.S + BT - 1) / BT > 65535 || (p.Tk + BT - 1) / BT > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  static size_t allowed[3] = {48 * 1024, 48 * 1024, 48 * 1024};
  const size_t smem = TL::smem_bytes(p.dh);
  auto stats_k = flash_bwd_stats_kernel<T, TL, TABLE>;
  auto dq_k = flash_bwd_dq_kernel<T, TL, TABLE>;
  auto dkv_k = flash_bwd_dkv_kernel<T, TL, TABLE>;
  cudaError_t e;
  if ((e = allow_smem(stats_k, smem, &allowed[0])) != cudaSuccess) return static_cast<int>(e);
  if ((e = allow_smem(dq_k, smem, &allowed[1])) != cudaSuccess) return static_cast<int>(e);
  if ((e = allow_smem(dkv_k, smem, &allowed[2])) != cudaSuccess) return static_cast<int>(e);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  if (p.S > 0) {
    dim3 grid(B * p.H, (p.S + BT - 1) / BT);
    stats_k<<<grid, THREADS, smem, stream>>>(qt, kt, vt, dot, m, bp, dmq, ep, stats, B, p);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    dq_k<<<grid, THREADS, smem, stream>>>(qt, kt, vt, dot, m, bp, dmq, ep, stats,
                                          static_cast<T*>(dq), B, p);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(B * p.Hkv, (p.Tk + BT - 1) / BT);
  dkv_k<<<grid, THREADS, smem, stream>>>(qt, kt, vt, dot, m, bp, dmq, ep, stats,
                                         static_cast<T*>(dk), static_cast<T*>(dv), B, p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The bf16 design: tensor-core products and the search decode.

namespace tc {

constexpr int BQ = 64;  // query rows a tile: 16 a warp in the stats and dq kernels

// DHM: the largest head dim of an instantiation (64, 128 or 256).  BK keys a
// tile.  The dkv kernel's eight warps split each tile twice: for the scores,
// warp w takes query rows 16 (w % 4) .. and half the keys; for dk and dv,
// key rows 16 (w % KM) .. and one of DSPLIT slices of d.
template <int DHM>
struct Bwd {
  static constexpr int BK = DHM <= 128 ? 64 : 32;
  static constexpr int NTK = BK / 8;     // score n-tiles a warp (stats, dq)
  static constexpr int NO = DHM / 8;     // dq n-tiles, at most
  static constexpr int NTA = BK / 16;    // score n-tiles a warp (dkv: BK / 2 keys)
  static constexpr int KM = BK / 16;     // key m-tiles (dkv)
  static constexpr int DSPLIT = 8 / KM;  // d slices (dkv)
  static constexpr int NTB = NO / DSPLIT;  // dk and dv n-tiles a warp (dkv), at most
  static constexpr int LDP = BK + 8;       // row stride of the dkv kernel's P and dS tiles
  // Blocks an SM should hold at dh <= 64 (the register cap that follows: 170
  // and 128 a thread), so that barriers and the search's shared-memory
  // latency are hidden by other blocks; larger head dims take what fits.
  // The stats kernel runs faster uncapped.
  static constexpr int MIN_BLOCKS_DQ = DHM == 64 ? 3 : 1;
  static constexpr int MIN_BLOCKS_DKV = DHM == 64 ? 2 : 1;
  // Q and dout, then two stages of a K tile and a V tile
  static constexpr size_t smem_rows() {
    return (size_t)(2 * BQ + 4 * BK) * (DHM + 8) * sizeof(__nv_bfloat16);
  }
  // K and V, two stages of a Q tile and a dout tile, P and dS as hi and lo
  static constexpr size_t smem_cols() {
    return (size_t)(2 * BK + 4 * BQ) * (DHM + 8) * sizeof(__nv_bfloat16) +
           (size_t)4 * BQ * LDP * sizeof(__nv_bfloat16);
  }
};

// The key tiles of BK keys live for some query position in [q_first,
// q_last]: [lo, hi).  The others are masked for every pair and skipped.
__device__ __forceinline__ void live_key_tiles(const Problem& p, float vl, int q_first,
                                               int q_last, int BK, int& lo, int& hi) {
  int lim = p.Tk;
  if (p.causal) lim = min(lim, q_last + 1);
  if (p.valid_len != nullptr)
    lim = vl > 0.0f ? min(lim, static_cast<int>(ceilf(fminf(vl, (float)p.Tk)))) : 0;
  hi = lim > 0 ? (lim + BK - 1) / BK : 0;
  lo = 0;
  if (p.has_window) {
    const int first = q_first - p.window - BK + 2;  // a live tile starts here or later
    lo = first > 0 ? (first + BK - 1) / BK : 0;
  }
}

// Every pair of query rows [qa, qa + 16) (positions) and keys [ka, ka + nkeys)
// is kept: the mask need not be evaluated.
__device__ __forceinline__ bool all_kept(const Problem& p, float vl, int qa, int ka, int nkeys) {
  const int kb = ka + nkeys - 1;
  return kb < p.Tk && (!p.causal || kb <= qa) && (!p.has_window || qa + 15 - ka < p.window) &&
         (p.valid_len == nullptr || static_cast<float>(kb) < vl);
}

// The per-row terms of the bf16 design: row_stats with 1 / L, so that a pair
// multiplies where the f32 design divides (the same function, rounded
// otherwise).
struct RowTerms {
  float rL, gld, dmn, m;
};

__device__ __forceinline__ RowTerms row_terms(const float* __restrict__ stats,
                                              const float* __restrict__ m, size_t plane,
                                              int row, int S, size_t bhS) {
  if (row >= S) return RowTerms{1.0f, 0.0f, 0.0f, 0.0f};
  const RowStats r = row_stats(stats, m, plane, bhS + row);
  return RowTerms{1.0f / r.L, r.gld, r.dmn, r.m};
}

__device__ __forceinline__ float pair_ds_tc(const Terms& tm, float dp, bool kp,
                                            const RowTerms& rt, float scale) {
  const float dt = (dp - rt.gld) * rt.rL * tm.gate;
  return kp ? (dt + (tm.eq != 0.0f ? rt.dmn : 0.0f)) * scale : 0.0f;
}

// pair_terms with the search decode.
template <int TABLE>
__device__ __forceinline__ Terms pair_terms_tc(float acc, bool kp, float m, float scale,
                                               const SearchTable<TABLE>& tab, float3 piv,
                                               const Epilogue& ep) {
  const float s = kp ? __fmul_rn(acc, scale) : NEG_FILL;
  const float t = __fsub_rn(s, m);
  const float2 ps = epi_search_value_and_slope<TABLE>(ep, fmaxf(t, SHIFT_CLAMP), tab, piv);
  const float keepf = kp ? 1.0f : 0.0f;
  Terms r;
  r.eq = s == m ? 1.0f : 0.0f;
  r.u = fmaxf(ps.x, 0.0f) * keepf;
  r.gate = keepf * max_gate(ps.x, 0.0f) * ps.y * max_gate(t, SHIFT_CLAMP);
  return r;
}

// The scores (before scale) and dout . v of a warp's 16 query rows (rows r0..
// of sA and sC) against 8 NT keys (rows n0.. of sB and sD): q . k with Q as
// A and K as B over d from 0 in 16-wide steps, as every flash kernel sums it.
template <int DHM, int NT>
__device__ __forceinline__ void warp_products(const __nv_bfloat16* sA, const __nv_bfloat16* sB,
                                              const __nv_bfloat16* sC, const __nv_bfloat16* sD,
                                              int ld, int r0, int n0, int nk, int lane,
                                              float sacc[NT][4], float dpacc[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[j][e] = dpacc[j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < DHM / 16; ++kk) {
    if (kk < nk) {
      uint32_t aq[4], ado[4];
      ldsm_x4(aq, a_addr(sA, ld, r0, kk * 16, lane));
      ldsm_x4(ado, a_addr(sC, ld, r0, kk * 16, lane));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, bn_addr(sB, ld, n0 + np * 16, kk * 16, lane));
        ldsm_x4(bv, bn_addr(sD, ld, n0 + np * 16, kk * 16, lane));
        mma_bf16(sacc[2 * np], aq, bk[0], bk[1]);
        mma_bf16(sacc[2 * np + 1], aq, bk[2], bk[3]);
        mma_bf16(dpacc[2 * np], ado, bv[0], bv[1]);
        mma_bf16(dpacc[2 * np + 1], ado, bv[2], bv[3]);
      }
    }
  }
}

// Stats: l, delta, the raw tie count and dm of 64 query rows, walking the
// live key tiles.  delta = dout . (sum u v) / L is summed as sum u dp / L
// (dp = dout . v, already at hand): the same sum in another order, and no
// u . v product.
template <int DHM, int TABLE>
__global__ void __launch_bounds__(128)
flash_bwd_stats_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ m, const float* __restrict__ bp,
                       const float* __restrict__ mqp, Epilogue ep, float* __restrict__ stats, int B,
                       Problem p) {
  using C = Bwd<DHM>;
  constexpr int BK = C::BK, NT = C::NTK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ SearchTable<TABLE> tab;
  constexpr int ld = DHM + 8;
  const int dh = p.dh, nk = dh / 16;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sDO = sQ + BQ * ld;
  __nv_bfloat16* sStage = sDO + BQ * ld;  // stage s: K at sStage + 2 s BK ld, V after it

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c4 = lane & 3;
  const int bh = blockIdx.x, b = bh / p.H, hq = bh % p.H;
  const int hk = hq / (p.H / p.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the longest walks first
  const float vl = p.valid_len != nullptr ? p.valid_len[b] : 0.0f;

  epi_load_search<TABLE>(&tab, bp, mqp, ep);
  tile_async<BQ, 128, DHM>(sQ, q, b, q0, p.S, p.H, hq, dh);
  tile_async<BQ, 128, DHM>(sDO, dout, b, q0, p.S, p.H, hq, dh);
  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0 and row0 + 8
  float mrow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    mrow[r] = row0 + 8 * r < p.S ? m[(size_t)bh * p.S + row0 + 8 * r] : 0.0f;

  int t_lo, t_hi;
  live_key_tiles(p, vl, q0 + p.q_offset, min(q0 + BQ, p.S) - 1 + p.q_offset, BK, t_lo, t_hi);
  auto stage_load = [&](int t, int buf) {
    __nv_bfloat16* sk = sStage + buf * 2 * BK * ld;
    tile_async<BK, 128, DHM>(sk, k, b, t * BK, p.Tk, p.Hkv, hk, dh);
    tile_async<BK, 128, DHM>(sk + BK * ld, v, b, t * BK, p.Tk, p.Hkv, hk, dh);
  };
  if (t_lo < t_hi) stage_load(t_lo, 0);
  cp_async_commit();

  float pl[2] = {0.0f, 0.0f}, pn[2] = {0.0f, 0.0f}, pdg[2] = {0.0f, 0.0f},
        pg[2] = {0.0f, 0.0f}, pd[2] = {0.0f, 0.0f};
  const int qa = q0 + warp * 16 + p.q_offset;
  for (int t = t_lo, buf = 0; t < t_hi; ++t, buf ^= 1) {
    if (t + 1 < t_hi) stage_load(t + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float3 piv = epi_search_pivots<TABLE>(tab);
    const __nv_bfloat16* sk = sStage + buf * 2 * BK * ld;
    float sacc[NT][4], dpacc[NT][4];
    warp_products<DHM, NT>(sQ, sk, sDO, sk + BK * ld, ld, warp * 16, 0, nk, lane, sacc, dpacc);
    const int j0 = t * BK;
    auto elements = [&](auto unmasked) {  // without the mask where the tile is all kept
      constexpr bool ALL = decltype(unmasked)::value;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const bool kp = ALL || keep_pair(p, vl, j0 + j * 8 + 2 * c4 + (e & 1), qa + g + 8 * r);
          const Terms tm = pair_terms_tc<TABLE>(sacc[j][e], kp, mrow[r], p.scale, tab, piv, ep);
          pl[r] += tm.u;
          pn[r] += tm.eq;
          pdg[r] = fmaf(dpacc[j][e], tm.gate, pdg[r]);
          pg[r] += tm.gate;
          pd[r] = fmaf(tm.u, dpacc[j][e], pd[r]);
        }
      }
    };
    if (all_kept(p, vl, qa, j0, BK))
      elements(std::true_type{});
    else
      elements(std::false_type{});
    __syncthreads();  // the stage is consumed
  }
  cp_async_wait<0>();

  const size_t plane = (size_t)B * p.H * p.S;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(pl[r]), n = quad_sum(pn[r]);
    const float dpg = quad_sum(pdg[r]), gs = quad_sum(pg[r]), ud = quad_sum(pd[r]);
    const int row = row0 + 8 * r;
    if (c4 == 0 && row < p.S) {
      const float L = fmaxf(l, 1e-30f);
      const float delta = ud / L;
      const float gl = max_gate(l, 1e-30f);
      const size_t at = (size_t)bh * p.S + row;
      stats[at] = l;
      stats[plane + at] = delta;
      stats[2 * plane + at] = n;  // raw: a live row re-finds its max at least once
      stats[3 * plane + at] = -(dpg - gl * delta * gs) / L;
    }
  }
}

// dq of 64 query rows, walking the live key tiles: dq += ds . k, ds split
// into two bf16 products (hi and lo) straight from the accumulators.
template <int DHM, int TABLE>
__global__ void __launch_bounds__(128, Bwd<DHM>::MIN_BLOCKS_DQ)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ m, const float* __restrict__ bp,
                    const float* __restrict__ mqp, Epilogue ep, const float* __restrict__ stats,
                    __nv_bfloat16* __restrict__ dq, int B, Problem p) {
  using C = Bwd<DHM>;
  constexpr int BK = C::BK, NT = C::NTK, NO = C::NO;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ SearchTable<TABLE> tab;
  constexpr int ld = DHM + 8;
  const int dh = p.dh, nk = dh / 16;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sDO = sQ + BQ * ld;
  __nv_bfloat16* sStage = sDO + BQ * ld;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c4 = lane & 3;
  const int bh = blockIdx.x, b = bh / p.H, hq = bh % p.H;
  const int hk = hq / (p.H / p.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the longest walks first
  const float vl = p.valid_len != nullptr ? p.valid_len[b] : 0.0f;
  const size_t plane = (size_t)B * p.H * p.S;

  epi_load_search<TABLE>(&tab, bp, mqp, ep);
  tile_async<BQ, 128, DHM>(sQ, q, b, q0, p.S, p.H, hq, dh);
  tile_async<BQ, 128, DHM>(sDO, dout, b, q0, p.S, p.H, hq, dh);
  const int row0 = q0 + warp * 16 + g;
  RowTerms rs[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    rs[r] = row_terms(stats, m, plane, row0 + 8 * r, p.S, (size_t)bh * p.S);

  int t_lo, t_hi;
  live_key_tiles(p, vl, q0 + p.q_offset, min(q0 + BQ, p.S) - 1 + p.q_offset, BK, t_lo, t_hi);
  auto stage_load = [&](int t, int buf) {
    __nv_bfloat16* sk = sStage + buf * 2 * BK * ld;
    tile_async<BK, 128, DHM>(sk, k, b, t * BK, p.Tk, p.Hkv, hk, dh);
    tile_async<BK, 128, DHM>(sk + BK * ld, v, b, t * BK, p.Tk, p.Hkv, hk, dh);
  };
  if (t_lo < t_hi) stage_load(t_lo, 0);
  cp_async_commit();

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  const int qa = q0 + warp * 16 + p.q_offset;
  for (int t = t_lo, buf = 0; t < t_hi; ++t, buf ^= 1) {
    if (t + 1 < t_hi) stage_load(t + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float3 piv = epi_search_pivots<TABLE>(tab);
    const __nv_bfloat16* sk = sStage + buf * 2 * BK * ld;
    float sacc[NT][4], dpacc[NT][4];
    warp_products<DHM, NT>(sQ, sk, sDO, sk + BK * ld, ld, warp * 16, 0, nk, lane, sacc, dpacc);
    const int j0 = t * BK;
    auto elements = [&](auto unmasked) {  // without the mask where the tile is all kept
      constexpr bool ALL = decltype(unmasked)::value;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const bool kp = ALL || keep_pair(p, vl, j0 + j * 8 + 2 * c4 + (e & 1), qa + g + 8 * r);
          const Terms tm = pair_terms_tc<TABLE>(sacc[j][e], kp, rs[r].m, p.scale, tab, piv, ep);
          sacc[j][e] = pair_ds_tc(tm, dpacc[j][e], kp, rs[r], p.scale);
        }
      }
    };
    if (all_kept(p, vl, qa, j0, BK))
      elements(std::true_type{});
    else
      elements(std::false_type{});
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ah[4], al[4];
      c_to_a(sacc[2 * kk], sacc[2 * kk + 1], ah, al);
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        if (dp < nk) {
          uint32_t bb[4];
          ldsm_x4_t(bb, bk_addr(sk, ld, kk * 16, dp * 16, lane));
          mma_bf16(acc[2 * dp], ah, bb[0], bb[1]);
          mma_bf16(acc[2 * dp + 1], ah, bb[2], bb[3]);
          mma_bf16(acc[2 * dp], al, bb[0], bb[1]);
          mma_bf16(acc[2 * dp + 1], al, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.S) continue;
    __nv_bfloat16* dst = dq + (((size_t)b * p.S + row) * p.H + hq) * dh + 2 * c4;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      if (n < dh / 8)
        *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
            __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// dk and dv of BK keys of one KV head, walking the live query tiles of each
// query head of its group (so dk and dv are summed over G inside the block).
// The scores are computed as everywhere (Q as A, K as B); u / L and ds go
// to shared memory as hi and lo bf16, and ldmatrix.trans reads them back as
// the A operand of dv += (u / L)^T dout and dk += ds^T q.
template <int DHM, int TABLE>
__global__ void __launch_bounds__(256, Bwd<DHM>::MIN_BLOCKS_DKV)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ m, const float* __restrict__ bp,
                     const float* __restrict__ mqp, Epilogue ep, const float* __restrict__ stats,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int B,
                     Problem p) {
  using C = Bwd<DHM>;
  constexpr int BK = C::BK, NTA = C::NTA, KM = C::KM, NTB = C::NTB, LDP = C::LDP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ SearchTable<TABLE> tab;
  constexpr int ld = DHM + 8;
  const int dh = p.dh, nk = dh / 16;
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + BK * ld;
  __nv_bfloat16* sStage = sV + BK * ld;  // stage s: Q at sStage + 2 s BQ ld, dout after it
  __nv_bfloat16* sPh = sStage + 4 * BQ * ld;  // BQ x LDP each, query-major
  __nv_bfloat16* sPl = sPh + BQ * LDP;
  __nv_bfloat16* sDh = sPl + BQ * LDP;
  __nv_bfloat16* sDl = sDh + BQ * LDP;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c4 = lane & 3;
  const int b = blockIdx.x / p.Hkv, hk = blockIdx.x % p.Hkv;
  const int G = p.H / p.Hkv;
  const int k0 = blockIdx.y * BK;
  const float vl = p.valid_len != nullptr ? p.valid_len[b] : 0.0f;
  const size_t plane = (size_t)B * p.H * p.S;
  const int mt = warp & 3, kh = warp >> 2;        // scores: query rows 16 mt.., keys kh BK / 2..
  const int km = warp % KM, dsl = warp / KM;      // dk, dv: key rows 16 km.., d slice dsl

  epi_load_search<TABLE>(&tab, bp, mqp, ep);
  tile_async<BK, 256, DHM>(sK, k, b, k0, p.Tk, p.Hkv, hk, dh);
  tile_async<BK, 256, DHM>(sV, v, b, k0, p.Tk, p.Hkv, hk, dh);

  // the live query tiles, the same for every head of the group
  const int nq = (p.S + BQ - 1) / BQ;
  int t_lo = nq, t_hi = 0;
  if (p.valid_len == nullptr || static_cast<float>(k0) < vl) {
    for (int t = 0; t < nq; ++t) {
      const int q_first = t * BQ + p.q_offset;
      const int q_last = min(t * BQ + BQ, p.S) - 1 + p.q_offset;
      if (p.causal && k0 > q_last) continue;
      if (p.has_window && q_first - (k0 + BK - 1) >= p.window) continue;
      t_lo = min(t_lo, t);
      t_hi = t + 1;
    }
  }
  const int nt = t_hi > t_lo ? t_hi - t_lo : 0;
  const int steps = G * nt;
  auto stage_load = [&](int st, int buf) {
    const int hq = hk * G + st / nt, i0 = (t_lo + st % nt) * BQ;
    __nv_bfloat16* sq = sStage + buf * 2 * BQ * ld;
    tile_async<BQ, 256, DHM>(sq, q, b, i0, p.S, p.H, hq, dh);
    tile_async<BQ, 256, DHM>(sq + BQ * ld, dout, b, i0, p.S, p.H, hq, dh);
  };
  if (steps > 0) stage_load(0, 0);
  cp_async_commit();

  float acc_k[NTB][4], acc_v[NTB][4];
#pragma unroll
  for (int n = 0; n < NTB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.0f;

  const int ka = k0 + kh * (BK / 2);  // this warp's first key in the scores
  for (int st = 0, buf = 0; st < steps; ++st, buf ^= 1) {
    if (st + 1 < steps) stage_load(st + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float3 piv = epi_search_pivots<TABLE>(tab);
    const __nv_bfloat16* sq = sStage + buf * 2 * BQ * ld;
    const __nv_bfloat16* sdo = sq + BQ * ld;
    const int hq = hk * G + st / nt, i0 = (t_lo + st % nt) * BQ;
    const int bh = b * p.H + hq;

    // the scores and dout . v of 16 queries x BK / 2 keys; u / L and ds
    {
      const int row0 = i0 + mt * 16 + g;
      RowTerms rs[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        rs[r] = row_terms(stats, m, plane, row0 + 8 * r, p.S, (size_t)bh * p.S);
      float sacc[NTA][4], dpacc[NTA][4];
      warp_products<DHM, NTA>(sq, sK, sdo, sV, ld, mt * 16, kh * (BK / 2), nk, lane, sacc,
                              dpacc);
      const int qa = i0 + mt * 16 + p.q_offset;
      auto elements = [&](auto unmasked) {  // without the mask where the tile is all kept
        constexpr bool ALL = decltype(unmasked)::value;
#pragma unroll
        for (int j = 0; j < NTA; ++j) {
          float pu[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const bool kp =
                ALL || (row0 + 8 * r < p.S &&
                        keep_pair(p, vl, ka + j * 8 + 2 * c4 + (e & 1), qa + g + 8 * r));
            const Terms tm =
                pair_terms_tc<TABLE>(sacc[j][e], kp, rs[r].m, p.scale, tab, piv, ep);
            ds[e] = pair_ds_tc(tm, dpacc[j][e], kp, rs[r], p.scale);
            pu[e] = tm.u * rs[r].rL;
          }
          const int col = kh * (BK / 2) + j * 8 + 2 * c4;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int at = (mt * 16 + g + 8 * r) * LDP + col;
            uint32_t hi, lo;
            split_bf16(pu[2 * r], pu[2 * r + 1], hi, lo);
            *reinterpret_cast<uint32_t*>(sPh + at) = hi;
            *reinterpret_cast<uint32_t*>(sPl + at) = lo;
            split_bf16(ds[2 * r], ds[2 * r + 1], hi, lo);
            *reinterpret_cast<uint32_t*>(sDh + at) = hi;
            *reinterpret_cast<uint32_t*>(sDl + at) = lo;
          }
        }
      };
      if (i0 + mt * 16 + 15 < p.S && all_kept(p, vl, qa, ka, BK / 2))
        elements(std::true_type{});
      else
        elements(std::false_type{});
    }
    __syncthreads();

    // dv += (u / L)^T dout and dk += ds^T q over the tile's 64 queries
#pragma unroll
    for (int kq = 0; kq < BQ / 16; ++kq) {
      uint32_t aph[4], apl[4], adh[4], adl[4];
      ldsm_x4_t(aph, at_addr(sPh, LDP, kq * 16, km * 16, lane));
      ldsm_x4_t(apl, at_addr(sPl, LDP, kq * 16, km * 16, lane));
      ldsm_x4_t(adh, at_addr(sDh, LDP, kq * 16, km * 16, lane));
      ldsm_x4_t(adl, at_addr(sDl, LDP, kq * 16, km * 16, lane));
#pragma unroll
      for (int np = 0; np < NTB / 2; ++np) {
        const int n0 = dsl * NTB * 8 + np * 16;
        if (n0 < dh) {
          uint32_t bo[4], bq[4];
          ldsm_x4_t(bo, bk_addr(sdo, ld, kq * 16, n0, lane));
          ldsm_x4_t(bq, bk_addr(sq, ld, kq * 16, n0, lane));
          mma_bf16(acc_v[2 * np], aph, bo[0], bo[1]);
          mma_bf16(acc_v[2 * np + 1], aph, bo[2], bo[3]);
          mma_bf16(acc_v[2 * np], apl, bo[0], bo[1]);
          mma_bf16(acc_v[2 * np + 1], apl, bo[2], bo[3]);
          mma_bf16(acc_k[2 * np], adh, bq[0], bq[1]);
          mma_bf16(acc_k[2 * np + 1], adh, bq[2], bq[3]);
          mma_bf16(acc_k[2 * np], adl, bq[0], bq[1]);
          mma_bf16(acc_k[2 * np + 1], adl, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // the stage and the P and dS tiles are consumed
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + km * 16 + g + 8 * r;
    if (key >= p.Tk) continue;
    const size_t base = (((size_t)b * p.Tk + key) * p.Hkv + hk) * dh + 2 * c4;
#pragma unroll
    for (int n = 0; n < NTB; ++n) {
      const int d0 = dsl * NTB * 8 + n * 8;
      if (d0 < dh) {
        *reinterpret_cast<__nv_bfloat162*>(dk + base + d0) =
            __floats2bfloat162_rn(acc_k[n][2 * r], acc_k[n][2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + base + d0) =
            __floats2bfloat162_rn(acc_v[n][2 * r], acc_v[n][2 * r + 1]);
      }
    }
  }
}

template <int DHM, int TABLE>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* m,
           const float* bp, const float* mq, Epilogue ep, float* stats, void* dq, void* dk,
           void* dv, int B, const Problem& p, cudaStream_t stream) {
  using C = Bwd<DHM>;
  if ((p.S + BQ - 1) / BQ > 65535 || (p.Tk + C::BK - 1) / C::BK > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  static size_t allowed[3] = {48 * 1024, 48 * 1024, 48 * 1024};
  const size_t rows = C::smem_rows(), cols = C::smem_cols();
  auto stats_k = flash_bwd_stats_kernel<DHM, TABLE>;
  auto dq_k = flash_bwd_dq_kernel<DHM, TABLE>;
  auto dkv_k = flash_bwd_dkv_kernel<DHM, TABLE>;
  cudaError_t e;
  if ((e = allow_smem(stats_k, rows, &allowed[0])) != cudaSuccess) return static_cast<int>(e);
  if ((e = allow_smem(dq_k, rows, &allowed[1])) != cudaSuccess) return static_cast<int>(e);
  if ((e = allow_smem(dkv_k, cols, &allowed[2])) != cudaSuccess) return static_cast<int>(e);
  using bf = __nv_bfloat16;
  const bf* qt = static_cast<const bf*>(q);
  const bf* kt = static_cast<const bf*>(k);
  const bf* vt = static_cast<const bf*>(v);
  const bf* dot = static_cast<const bf*>(dout);
  if (p.S > 0) {
    dim3 grid(B * p.H, (p.S + BQ - 1) / BQ);
    stats_k<<<grid, 128, rows, stream>>>(qt, kt, vt, dot, m, bp, mq, ep, stats, B, p);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    dq_k<<<grid, 128, rows, stream>>>(qt, kt, vt, dot, m, bp, mq, ep, stats,
                                      static_cast<bf*>(dq), B, p);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(B * p.Hkv, (p.Tk + C::BK - 1) / C::BK);
  dkv_k<<<grid, 256, cols, stream>>>(qt, kt, vt, dot, m, bp, mq, ep, stats, static_cast<bf*>(dk),
                                     static_cast<bf*>(dv), B, p);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, const void* dout, const float* m,
             const float* bp, const float* mq, Epilogue ep, float* stats, void* dq, void* dk,
             void* dv, int B, const Problem& p, cudaStream_t stream) {
  return with_table(ep, [&](auto table) {
    constexpr int TB = decltype(table)::value;
    if (p.dh <= 64)
      return launch<64, TB>(q, k, v, dout, m, bp, mq, ep, stats, dq, dk, dv, B, p, stream);
    if (p.dh <= 128)
      return launch<128, TB>(q, k, v, dout, m, bp, mq, ep, stats, dq, dk, dv, B, p, stream);
    return launch<256, TB>(q, k, v, dout, m, bp, mq, ep, stats, dq, dk, dv, B, p, stream);
  });
}

}  // namespace tc

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* dout, const float* m,
             const float* bp, const float* dmq, Epilogue ep, float* stats, void* dq, void* dk,
             void* dv, int B, const Problem& p, cudaStream_t stream) {
  return with_table(ep, [&](auto table) {
    constexpr int TB = decltype(table)::value;
    if (p.dh <= SMALL_DH)
      return launch<T, SmallTile, TB>(q, k, v, dout, m, bp, dmq, ep, stats, dq, dk, dv, B, p,
                                      stream);
    return launch<T, LargeTile, TB>(q, k, v, dout, m, bp, dmq, ep, stats, dq, dk, dv, B, p,
                                    stream);
  });
}

}  // namespace

// q, dout, dq: (B, S, H, dh); k, v, dk, dv: (B, T, Hkv, dh); all contiguous,
// in dtype (0 = float32: the CUDA-core design; 1 = bfloat16: the tensor-core
// design, every pointer 16-byte aligned).  valid_len: (B,) f32 or null.  m:
// the forward's row max, (B, H, S) f32.  The exp is the epilogue (bp, dmq,
// n_bp, kind, fn) of epilogue.cuh; mq the prefix table of the search decode,
// read by the bf16 design only.  stats: (4, B, H, S) f32 scratch (l, delta,
// the raw tie count, dm).  dh a multiple of 16, at most 256; H a multiple of
// Hkv.  Launches the three kernels on the stream and returns the first
// cudaError_t of a launch.
extern "C" int flash_pwl_backward(const void* q, const void* k, const void* v, const void* dout,
                                  const void* valid_len, const void* m, const void* bp,
                                  const void* dmq, int n_bp, int kind, int fn, const void* mq,
                                  void* stats, void* dq, void* dk, void* dv, int B, int S, int T,
                                  int H, int Hkv, int dh, int causal, int has_window, int window,
                                  int q_offset, int dtype, void* stream) {
  const Epilogue ep{kind, fn, n_bp};
  if (!epilogue_ok(ep) || B < 0 || S < 0 || T < 1 || Hkv < 1 || H % Hkv != 0 || dh < 16 ||
      dh > MAX_DH || dh % 16 != 0 || (dtype == 1 && is_table(kind) && mq == nullptr))
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
    return dispatch<float>(q, k, v, dout, mf, bpf, dmqf, ep, sf, dq, dk, dv, B, p, st);
  if (dtype == 1)
    return tc::dispatch(q, k, v, dout, mf, bpf, static_cast<const float*>(mq), ep, sf, dq, dk,
                        dv, B, p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
