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
// together, so the query tiling is free, and keys masked for every row of a
// tile are skipped.  pwl is the launch's epilogue (epilogue.cuh): the exp
// table, or the exact exp (act="exp", the default of the JAX op without a
// table) inside the same clamps.
//
// What bounds it on an H100: at S = T = 4096 causal, 12 heads, dh 64 the
// call moves 25 MB, does 4 dh flops of products a causal pair (~26 GFLOP,
// 26 us at the 989 TFLOP/s of bf16 tensor cores) and decodes ~1e8 scores on
// CUDA cores, so it is bound by operations, and the decode is the larger
// share: it is what the paper's SFU puts in hardware.  Two designs, chosen
// by dtype:
//
// bf16 (tc:: below, the training and serving dtype): tensor-core products
// (mma.sync m16n8k16 bf16 -> f32, mma.cuh; wgmma would speed the products,
// but the decode, not the products, sets the pace) and the breakpoint search
// (pwl_decode.cuh: seven branch-free steps and one table read a score, where
// the linear decode makes n_bp).  A block of four warps owns 64 query rows
// of one head, each warp 16 rows whose scores and 16 x dh output accumulator
// stay in registers (FA2's layout, rather than a 64 x 512 score tile in
// shared memory: it needs no block-wide max and no shared-memory round trip
// of p).  For each 512-key chain step, pass 0 computes Q . K^T chunk by
// chunk (64 keys, 32 at dh > 128) for the row max alone (a shuffle across
// the four lanes of a row), then pass 1 recomputes the same chunks bitwise,
// decodes p, sums l and multiplies p into V with p taken from the
// accumulators as the A operand, split into hi = bf16(p) and lo = bf16(p -
// hi), two products that keep ~16 bits of each probability (the JAX
// reference multiplies in f32).  K and V chunks are staged as bf16 in shared
// memory, double-buffered with cp.async.  Every score is summed over d in
// 16-wide steps from 0 with Q as the A operand and K as B, then rounded once
// by scale, as in each backward kernel, so the backward re-finds this row
// max bitwise.  The query tiles with the longest causal walks launch first.
//
// f32 (the first design, kept as it was: no model path runs f32 attention,
// and the integer-grid and JAX-parity checks hold it bitwise): products as
// f32 FMAs on CUDA cores and the linear decode.  A block owns 64 query rows
// of one head (32 at dh > 128), keeps their Q tile in shared memory, and for
// each 512-key block computes the whole 64 x 512 f32 score tile into shared
// memory (132 KB), 64 keys of K at a time; takes the per-row block max;
// decodes the probabilities in place; then multiplies them into V, 64 keys at
// a time, with a 4 x (dh / 16) register tile of the output per thread (2 x
// (dh / 16) at dh > 128).  Rows are padded in shared memory so the three
// phases read without bank conflicts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "mma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int KC = 64;          // keys per staged K or V chunk
constexpr int BKV_MAX = 512;    // the chain's block width
constexpr int SST = BKV_MAX + 4;  // score row stride (bank offset 4 per row)
constexpr int MAX_DH = 256;
constexpr int SMALL_DH = 128;   // up to here: 64 query rows a block

// Two tilings, one instantiation each: dh <= 128 keeps 64 query rows a block
// (the order of every sum as before), dh up to 256 takes 32, so that its
// Q, K/V and score tiles fit the 227 KB of shared memory a block may hold
// (64 rows at dh 256 would need 263,680 bytes).  Each score is the same fmaf
// chain over d from 0 in both, so the row max is bitwise the plain chain's.
size_t smem_bytes(int bq, int dh) {
  return ((size_t)bq * (dh + 1) + (size_t)KC * (dh + 1) + (size_t)bq * SST) * sizeof(float);
}

template <typename T, int BQ, int MAX_NJ, bool TABLE>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const float* __restrict__ valid_len, const float* __restrict__ bp,
             const float* __restrict__ dmq, Epilogue ep, T* __restrict__ out,
             float* __restrict__ m_out, int S, int Tk, int H,
             int Hkv, int dh, int bkv, float scale, int causal, int has_window, int window,
             int q_offset) {
  constexpr int RI = BQ / 16;        // query rows per thread in the products
  constexpr int LPR = THREADS / BQ;  // lanes per row in the row statistics
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
  const int tx = tid % 16, ty = tid / 16;  // products: rows ty*RI + i, columns tx + 16 j
  const int r = tid / LPR, lr = tid % LPR;  // row statistics: row r, LPR lanes per row
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

  epi_load_table<TABLE>(s_bp, s_dmq, bp, dmq, ep);
  for (int e = tid; e < BQ * dh; e += THREADS) {
    const int rr = e / dh, d = e - rr * dh;
    const int sq = q0 + rr;
    sQ[rr * DS + d] = sq < S ? to_f32(q[(((size_t)b * S + sq) * H + hq) * dh + d]) : 0.0f;
  }

  float m_run = NEG_FILL, l_run = 0.0f;  // row r's chain state, on each of its lanes
  float acc[RI][MAX_NJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
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
      float sacc[RI][4];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sacc[i][j] = 0.0f;
      for (int d = 0; d < dh; ++d) {
        float qa[RI], ka[4];
#pragma unroll
        for (int i = 0; i < RI; ++i) qa[i] = sQ[(ty * RI + i) * DS + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) ka[j] = sKV[(tx + 16 * j) * DS + d];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sacc[i][j] = fmaf(qa[i], ka[j], sacc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int row = ty * RI + i;
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
      for (int c = lr; c < bkv; c += LPR) mx = fmaxf(mx, srow[c]);
#pragma unroll
      for (int o = 1; o < LPR; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_run, mx);
      const float corr = epi_exp<TABLE>(ep, m_run - m_new, s_bp, s_dmq);
      float sum = 0.0f;
      for (int c = lr; c < bkv; c += LPR) {
        const float p =
            keep(j0 + c, qpos_r) ? epi_exp<TABLE>(ep, srow[c] - m_new, s_bp, s_dmq) : 0.0f;
        srow[c] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 1; o < LPR; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l_run = l_run * corr + sum;
      m_run = m_new;
      if (lr == 0) s_corr[r] = corr;
    }

    // p . v over the block, KC keys at a time, then acc = acc * corr + p . v
    float pv[RI][MAX_NJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
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
        float pa[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i) pa[i] = sS[(ty * RI + i) * SST + kc + kk];
#pragma unroll
        for (int j = 0; j < MAX_NJ; ++j) {
          if (j < nj) {
            const float vv = sKV[kk * DS + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < RI; ++i) pv[i][j] = fmaf(pa[i], vv, pv[i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const float c = s_corr[ty * RI + i];
#pragma unroll
      for (int j = 0; j < MAX_NJ; ++j) acc[i][j] = acc[i][j] * c + pv[i][j];
    }
  }

  if (lr == 0) s_l[r] = l_run;
  if (m_out != nullptr && lr == 0 && q0 + r < S) m_out[(size_t)bh * S + q0 + r] = m_run;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = ty * RI + i;
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

template <typename T, int BQ, int MAX_NJ, bool TABLE>
int launch(const void* q, const void* k, const void* v, const float* valid_len,
           const float* bp, const float* dmq, Epilogue ep, void* out, float* m_out, int B,
           int S, int Tk, int H, int Hkv, int dh, int causal, int has_window, int window,
           int q_offset, cudaStream_t stream) {
  if ((S + BQ - 1) / BQ > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(BQ, dh);
  auto kern = flash_kernel<T, BQ, MAX_NJ, TABLE>;
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
      bp, dmq, ep, static_cast<T*>(out), m_out, S, Tk, H, Hkv, dh, bkv, scale, causal,
      has_window, window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The bf16 design: tensor-core products and the search decode.

namespace tc {

constexpr int WARPS = 4;
constexpr int NTHR = 32 * WARPS;
constexpr int BQ = 16 * WARPS;  // query rows a block, 16 a warp

// DHM: the largest head dim of an instantiation (64, 128 or 256; dh is any
// multiple of 16 up to it).  KC keys a staged chunk: 64, or 32 at DHM 256 so
// that the 16 x 256 output accumulator and a chunk's scores stay in registers.
template <int DHM>
struct Fwd {
  static constexpr int KC = DHM <= 128 ? 64 : 32;
  static constexpr int NT = KC / 8;   // score n-tiles a chunk
  static constexpr int NO = DHM / 8;  // output n-tiles, at most
  // Q, then two stages of a K chunk and a V chunk, rows padded by 8 so that
  // ldmatrix reads them without bank conflicts
  static constexpr size_t smem_bytes() {
    return (size_t)(BQ + 4 * KC) * (DHM + 8) * sizeof(__nv_bfloat16);
  }
};

template <int DHM, bool TABLE>
__global__ void __launch_bounds__(NTHR)
flash_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, const float* __restrict__ valid_len,
             const float* __restrict__ bp, const float* __restrict__ mqp, Epilogue ep,
             __nv_bfloat16* __restrict__ out, float* __restrict__ m_out, int S, int Tk, int H,
             int Hkv, int dh, int bkv, float scale, int causal, int has_window, int window,
             int q_offset) {
  using C = Fwd<DHM>;
  constexpr int KC = C::KC, NT = C::NT, NO = C::NO;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ PwlSearch tab;
  constexpr int ld = DHM + 8;  // row stride of the operand tiles
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sStage = sQ + BQ * ld;  // stage s: K at sStage + 2 s KC ld, V after it

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c4 = lane & 3;
  const int bh = blockIdx.x, b = bh / H, hq = bh % H;
  const int hk = hq / (H / Hkv);
  // the last query tiles first: under a causal mask they walk the most keys
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int nk = dh / 16;
  const bool has_vl = valid_len != nullptr;
  const float vl = has_vl ? valid_len[b] : 0.0f;

  epi_load_search<TABLE>(&tab, bp, mqp, ep);
  tile_async<BQ, NTHR, DHM>(sQ, q, b, q0, S, H, hq, dh);

  // the chunks live for some row of the tile, [c_lo, c_hi) in units of KC
  // keys; the rest are masked for every row, and skipping them changes no
  // row max and no sum
  const int q_first = q0 + q_offset;
  const int q_last = min(q0 + BQ, S) - 1 + q_offset;
  int lim = Tk;
  if (causal) lim = min(lim, q_last + 1);
  if (has_vl) lim = vl > 0.0f ? min(lim, static_cast<int>(ceilf(fminf(vl, (float)Tk)))) : 0;
  const int c_hi = lim > 0 ? (lim + KC - 1) / KC : 0;
  int c_lo = 0;
  if (has_window) {
    const int lo = q_first - window - KC + 2;  // a live chunk starts here or later
    c_lo = lo > 0 ? (lo + KC - 1) / KC : 0;
  }
  const int cpb = bkv / KC;  // chunks a chain step
  auto block_begin = [&](int cc) { return max(c_lo, cc / cpb * cpb); };
  auto block_end = [&](int cc) { return min(c_hi, (cc / cpb + 1) * cpb); };

  const int wq_first = q_first + warp * 16;  // this warp's rows
  const int qpos0 = wq_first + g;            // and this lane's two, qpos0 and qpos0 + 8
  auto keep = [&](int kpos, int qpos) -> bool {
    bool kp = kpos < Tk;
    if (causal) kp = kp && kpos <= qpos;
    if (has_window) kp = kp && (qpos - kpos) < window;
    if (has_vl) kp = kp && static_cast<float>(kpos) < vl;
    return kp;
  };

  float m_run[2] = {NEG_FILL, NEG_FILL}, l_run[2] = {0.0f, 0.0f};
  float m_new[2] = {NEG_FILL, NEG_FILL}, corr[2] = {0.0f, 0.0f};
  float mx[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.0f, 0.0f};
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;

  auto stage_load = [&](int cc, int ps, int buf) {
    __nv_bfloat16* sk = sStage + buf * 2 * KC * ld;
    tile_async<KC, NTHR, DHM>(sk, k, b, cc * KC, Tk, Hkv, hk, dh);
    if (ps == 1) tile_async<KC, NTHR, DHM>(sk + KC * ld, v, b, cc * KC, Tk, Hkv, hk, dh);
  };

  // Steps: for each chain step, pass 0 over its live chunks (the row max),
  // then pass 1 over the same chunks (the probabilities, l and p . v); the
  // next step's K (and V) chunk loads while this one computes.
  int c = c_lo, pass = 0, buf = 0;
  bool have = c_lo < c_hi;
  if (have) stage_load(c, 0, 0);
  cp_async_commit();
  float3 piv = make_float3(0.0f, 0.0f, 0.0f);  // the search's pivots, after the first barrier
  while (have) {
    int nc = c + 1, npass = pass;
    if (nc == block_end(c)) {
      if (pass == 0) {
        npass = 1;
        nc = block_begin(c);
      } else {
        npass = 0;
      }
    }
    const bool have_next = nc < c_hi;
    if (have_next) stage_load(nc, npass, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    piv = epi_search_pivots<TABLE>(tab);

    const __nv_bfloat16* sk = sStage + buf * 2 * KC * ld;
    const int start = c * KC;
    // the scores of the chunk: Q as A, K as B, d in 16-wide steps from 0
    float sacc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DHM / 16; ++kk) {
      if (kk < nk) {
        uint32_t a[4];
        ldsm_x4(a, a_addr(sQ, ld, warp * 16, kk * 16, lane));
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bb[4];
          ldsm_x4(bb, bn_addr(sk, ld, np * 16, kk * 16, lane));
          mma_bf16(sacc[2 * np], a, bb[0], bb[1]);
          mma_bf16(sacc[2 * np + 1], a, bb[2], bb[3]);
        }
      }
    }
    const int end = start + KC - 1;
    const bool full = end < Tk && (!causal || end <= wq_first) &&
                      (!has_window || wq_first + 15 - start < window) &&
                      (!has_vl || static_cast<float>(end) < vl);
    // the element loops twice over: without the mask where the whole chunk
    // is kept for the warp's rows, with it elsewhere
    auto elements = [&](auto unmasked) {
      constexpr bool ALL = decltype(unmasked)::value;
      if (pass == 0) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool kp = ALL || keep(start + j * 8 + 2 * c4 + (e & 1), qpos0 + 8 * (e >> 1));
            mx[e >> 1] = fmaxf(mx[e >> 1], kp ? __fmul_rn(sacc[j][e], scale) : NEG_FILL);
          }
      } else {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const bool kp = ALL || keep(start + j * 8 + 2 * c4 + (e & 1), qpos0 + 8 * r);
            // decoded for every element, then selected: no branch keeps a
            // warp's searches apart
            const float pr =
                epi_search_exp<TABLE>(ep, __fmul_rn(sacc[j][e], scale) - m_new[r], tab, piv);
            sacc[j][e] = kp ? pr : 0.0f;
            lsum[r] += sacc[j][e];
          }
      }
    };
    if (full)
      elements(std::true_type{});
    else
      elements(std::false_type{});
    if (pass == 0) {
      if (c + 1 == block_end(c)) {  // the block max: the new running max and the correction
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          m_new[r] = fmaxf(m_run[r], quad_max(mx[r]));
          corr[r] = epi_search_exp<TABLE>(ep, m_run[r] - m_new[r], tab, piv);
          mx[r] = -INFINITY;
          lsum[r] = 0.0f;
        }
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          o[n][0] *= corr[0];
          o[n][1] *= corr[0];
          o[n][2] *= corr[1];
          o[n][3] *= corr[1];
        }
      }
    } else {
      // p . v, p split into two bf16 products (hi and lo)
      const __nv_bfloat16* sv = sk + KC * ld;
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        uint32_t ah[4], al[4];
        c_to_a(sacc[2 * kk], sacc[2 * kk + 1], ah, al);
#pragma unroll
        for (int dp = 0; dp < NO / 2; ++dp) {
          if (dp < nk) {
            uint32_t bb[4];
            ldsm_x4_t(bb, bk_addr(sv, ld, kk * 16, dp * 16, lane));
            mma_bf16(o[2 * dp], ah, bb[0], bb[1]);
            mma_bf16(o[2 * dp + 1], ah, bb[2], bb[3]);
            mma_bf16(o[2 * dp], al, bb[0], bb[1]);
            mma_bf16(o[2 * dp + 1], al, bb[2], bb[3]);
          }
        }
      }
      if (c + 1 == block_end(c)) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l_run[r] = l_run[r] * corr[r] + quad_sum(lsum[r]);
          m_run[r] = m_new[r];
        }
      }
    }
    __syncthreads();  // the stage is consumed
    c = nc;
    pass = npass;
    buf ^= 1;
    have = have_next;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= S) continue;
    const float L = fmaxf(l_run[r], 1e-30f);
    __nv_bfloat16* dst = out + (((size_t)b * S + row) * H + hq) * dh + 2 * c4;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      if (n < dh / 8)
        *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
            __floats2bfloat162_rn(o[n][2 * r] / L, o[n][2 * r + 1] / L);
    }
    if (m_out != nullptr && c4 == 0) m_out[(size_t)bh * S + row] = m_run[r];
  }
}

template <int DHM, bool TABLE>
int launch(const void* q, const void* k, const void* v, const float* valid_len, const float* bp,
           const float* mq, Epilogue ep, void* out, float* m_out, int B, int S, int Tk, int H,
           int Hkv, int dh, int causal, int has_window, int window, int q_offset,
           cudaStream_t stream) {
  if ((S + BQ - 1) / BQ > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = Fwd<DHM>::smem_bytes();
  auto kern = flash_kernel<DHM, TABLE>;
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
  kern<<<grid, NTHR, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), valid_len, bp, mq, ep,
      static_cast<__nv_bfloat16*>(out), m_out, S, Tk, H, Hkv, dh, bkv, scale, causal, has_window,
      window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, const float* valid_len,
             const float* bp, const float* mq, Epilogue ep, void* out, float* m_out, int B,
             int S, int Tk, int H, int Hkv, int dh, int causal, int has_window, int window,
             int q_offset, cudaStream_t stream) {
  return with_table(ep, [&](auto table) {
    constexpr bool TB = decltype(table)::value;
    if (dh <= 64)
      return launch<64, TB>(q, k, v, valid_len, bp, mq, ep, out, m_out, B, S, Tk, H, Hkv, dh,
                            causal, has_window, window, q_offset, stream);
    if (dh <= 128)
      return launch<128, TB>(q, k, v, valid_len, bp, mq, ep, out, m_out, B, S, Tk, H, Hkv, dh,
                             causal, has_window, window, q_offset, stream);
    return launch<256, TB>(q, k, v, valid_len, bp, mq, ep, out, m_out, B, S, Tk, H, Hkv, dh,
                           causal, has_window, window, q_offset, stream);
  });
}

}  // namespace tc

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const float* valid_len,
             const float* bp, const float* dmq, Epilogue ep, void* out, float* m_out, int B,
             int S, int Tk, int H, int Hkv, int dh, int causal, int has_window, int window,
             int q_offset, cudaStream_t stream) {
  return with_table(ep, [&](auto table) {
    constexpr bool TB = decltype(table)::value;
    if (dh <= SMALL_DH)
      return launch<T, 64, SMALL_DH / 16, TB>(q, k, v, valid_len, bp, dmq, ep, out, m_out, B, S,
                                              Tk, H, Hkv, dh, causal, has_window, window,
                                              q_offset, stream);
    return launch<T, 32, MAX_DH / 16, TB>(q, k, v, valid_len, bp, dmq, ep, out, m_out, B, S,
                                          Tk, H, Hkv, dh, causal, has_window, window, q_offset,
                                          stream);
  });
}

}  // namespace

// q, out: (B, S, H, dh); k, v: (B, T, Hkv, dh); all contiguous, in dtype
// (0 = float32: the CUDA-core design; 1 = bfloat16: the tensor-core design,
// every pointer 16-byte aligned).  valid_len: (B,) f32 or null.  The exp is
// the epilogue (bp, dmq, n_bp, kind, fn) of epilogue.cuh; mq is the
// (n_bp + 1) x 2 prefix table of the search decode (kernels/fused/
// epilogue.py:search_prefix), read by the bf16 design only.  m_out:
// (B, H, S) f32 for each row's final running max, or null (then nothing else
// changes: the output is the same either way).  dh must be a multiple of 16,
// at most 256; H a multiple of Hkv.  Returns the cudaError_t of the launch.
extern "C" int flash_pwl_forward(const void* q, const void* k, const void* v,
                                 const void* valid_len, const void* bp, const void* dmq,
                                 int n_bp, int kind, int fn, const void* mq, void* out,
                                 void* m_out, int B, int S, int T, int H, int Hkv, int dh,
                                 int causal, int has_window, int window, int q_offset, int dtype,
                                 void* stream) {
  const Epilogue ep{kind, fn, n_bp};
  if (!epilogue_ok(ep) || B < 0 || S < 0 || T < 1 || Hkv < 1 || H % Hkv != 0 || dh < 16 ||
      dh > MAX_DH || dh % 16 != 0 || (dtype == 1 && kind == EPI_PWL && mq == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* vl = static_cast<const float*>(valid_len);
  const float* bpf = static_cast<const float*>(bp);
  const float* dmqf = static_cast<const float*>(dmq);
  float* mf = static_cast<float*>(m_out);
  if (dtype == 0)
    return dispatch<float>(q, k, v, vl, bpf, dmqf, ep, out, mf, B, S, T, H, Hkv, dh, causal,
                           has_window, window, q_offset, st);
  if (dtype == 1)
    return tc::dispatch(q, k, v, vl, bpf, static_cast<const float*>(mq), ep, out, mf, B, S, T,
                        H, Hkv, dh, causal, has_window, window, q_offset, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
