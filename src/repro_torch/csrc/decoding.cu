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
// pwl is the launch's epilogue (epilogue.cuh): the table, or the exact exp.
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
// latency is what it costs in practice.  A long request is different: a
// split of up to 2,048 keys walked by one block a page at a time (five
// barriers a page, no page in flight while one is computed, a few of the
// block's threads busy) costs far more than its bytes.  Only the
// recurrence needs the page before, so the design computes everything else
// for many pages at once:
//   * a split of at most one chunk of pages (the serving shapes) runs whole
//     in one block: its K and V in by cp.async, then every (head, key)
//     score, every page maximum, every p and correction, one step each over
//     all its pages, then the recurrence, one thread a (head, d);
//   * a longer split runs as three kernels over all of its pages, a chunk a
//     block: the scores and page maxima; then p, the corrections, p . v and
//     sum(p) of every page from the running maximum of the pages before it;
//     then the recurrence, one thread a (head, d) walking the split's pages.
// Pools are read in their own type and widened in registers (no f32 copy
// of the pool, no gather into a dense cache), kv_len and the page index on
// the device (no host sync); pages past kv_len are never loaded, and the
// merge runs as the last kernel of the same launch call.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "mma.cuh"

namespace {

constexpr int THREADS = 128;                   // the merge and recurrence kernels'
constexpr size_t KV_SMEM_BUDGET = 160 * 1024;  // K/V chunk buffers, at most

// The split kernels' threads: 128 up to dh 128, then 256.
int split_threads(int dh) { return dh <= 128 ? 128 : 256; }

// K and V rows in shared memory are padded by 16 bytes, so the 16-byte
// reads of eight threads on eight rows fall in eight bank groups.
int padded_dh(int dh, size_t kv_bytes) { return dh + 16 / (int)kv_bytes; }

// Pages a chunk holds: enough for one (head, key) score a thread, as far as
// the split's pages and `buffers` page buffers of the pools' type allow.
int chunk_pages(int ps, int dh, int G, int pps, size_t kv_bytes, int buffers) {
  const size_t page_bytes = (size_t)buffers * ps * padded_dh(dh, kv_bytes) * kv_bytes;
  int ch = split_threads(dh) / (G * ps);
  ch = ch < 1 ? 1 : ch;
  ch = ch > pps ? pps : ch;
  while (ch > 1 && ch * page_bytes > KV_SMEM_BUDGET) --ch;
  return ch;
}

// A split fits one chunk (K and V): the one-block path.
bool short_splits(int ps, int dh, int G, int pps, size_t kv_bytes) {
  return chunk_pages(ps, dh, G, pps, kv_bytes, 2) >= pps;
}

// f32 scratch a launch needs for its long splits' pages (PageScratch); none
// when the splits are short.
size_t scratch_floats_needed(int B, int Hkv, int ps, int dh, int G, int pps, int n_splits,
                             size_t kv_bytes) {
  if (short_splits(ps, dh, G, pps, kv_bytes)) return 0;
  return (size_t)B * Hkv * n_splits * pps * G * (ps + dh + 3);
}

// Dynamic shared memory of a block that holds `buffers` chunks of pages in
// the pools' type, then f32 q, scores, page maxima, corrections and the
// carried maximum, then the chunk's page indices (ChunkSmem).
size_t chunk_smem_bytes(int ps, int dh, int G, int ch, size_t kv_bytes, int buffers) {
  return (size_t)buffers * ch * ps * padded_dh(dh, kv_bytes) * kv_bytes +
         sizeof(float) * ((size_t)G * dh + (size_t)G * ch * ps + 2 * (size_t)G * ch + G) +
         sizeof(int) * (size_t)ch;
}

// A block's split: a = b * Hkv + h (blockIdx.x), s (blockIdx.y), its first
// table column, and its live pages -- those before the first whose first key
// is at or past kv_len, where the parent walk stops.
struct Split {
  int a, b, h, s, col0, n_live;
  long long kvl;
};

__device__ __forceinline__ Split split_of(const int* __restrict__ kv_len, int Hkv, int ps,
                                          int pps) {
  Split t;
  t.a = blockIdx.x;
  t.s = blockIdx.y;
  t.b = t.a / Hkv;
  t.h = t.a % Hkv;
  t.kvl = kv_len[t.b];
  t.col0 = t.s * pps;
  const long long left = t.kvl - (long long)t.col0 * ps;
  t.n_live = left <= 0 ? 0 : (int)(left < (long long)pps * ps ? (left + ps - 1) / ps : pps);
  return t;
}

// The page of table column col (a column past n_cols reads sentinel page 0),
// or -1 for one outside [0, P): refused on the host, it takes no chain step,
// as the parent walk skips it.
__device__ __forceinline__ int page_at(const int* __restrict__ pt, int n_cols, int P, int b,
                                       int col) {
  const int page = col < n_cols ? pt[(size_t)b * n_cols + col] : 0;
  return page < 0 || page >= P ? -1 : page;
}

// The rows of np pages of one pool (from column col) into dst, row r at
// r * DP; 16-byte cp.async copies (part of the caller's group) when vec.
template <typename TKV, int NT>
__device__ __forceinline__ void load_pages(TKV* dst, const TKV* __restrict__ pool,
                                           const int* pg, int h, int P, int np, int ps,
                                           int dh, int DP, bool vec) {
  constexpr int V = 16 / sizeof(TKV);
  const int rv = vec ? dh / V : dh;  // copies a row
  for (int i = threadIdx.x; i < np * ps * rv; i += NT) {
    const int r = i / rv, o = (i - r * rv) * (vec ? V : 1);
    const int page = pg[r / ps];
    if (page < 0) continue;
    const size_t src = (((size_t)h * P + page) * ps + r % ps) * dh + o;
    if (vec)
      cp_async16(dst + (size_t)r * DP + o, pool + src, true);
    else
      dst[(size_t)r * DP + o] = pool[src];
  }
}

// The f32 score chain: fmaf over d from 0 on q and the widened K row.
template <typename TKV>
__device__ __forceinline__ float score_dot(const float* qr, const TKV* kr, int dh, bool vec) {
  constexpr int V = 16 / sizeof(TKV);
  float dot = 0.0f;
  if (vec) {
    for (int d = 0; d < dh; d += V) {
      const uint4 raw = *reinterpret_cast<const uint4*>(kr + d);
      const TKV* kv = reinterpret_cast<const TKV*>(&raw);
#pragma unroll
      for (int i = 0; i < V; i += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(qr + d + i);
        dot = fmaf(qv.x, to_f32(kv[i]), dot);
        dot = fmaf(qv.y, to_f32(kv[i + 1]), dot);
        dot = fmaf(qv.z, to_f32(kv[i + 2]), dot);
        dot = fmaf(qv.w, to_f32(kv[i + 3]), dot);
      }
    }
  } else {
    for (int d = 0; d < dh; ++d) dot = fmaf(qr[d], to_f32(kr[d]), dot);
  }
  return dot;
}

// Step 1 on a chunk: every (head, key) score of its np pages, one thread
// each, times scale, -1e30 past kv_len; into sS [G][CK] and, when given, S.
template <typename TKV, int NT>
__device__ __forceinline__ void chunk_scores(float* sS, float* S, const float* sQ, const TKV* kd,
                                             const int* pg, int np, int ps, int dh, int DP,
                                             int G, int CK, long long key0, long long kvl,
                                             float scale, bool vec) {
  for (int e = threadIdx.x; e < G * np * ps; e += NT) {
    const int g = e / (np * ps), kk = e - g * (np * ps);
    if (pg[kk / ps] < 0) continue;
    const float dot = score_dot(sQ + g * dh, kd + (size_t)kk * DP, dh, vec);
    const float sc = key0 + kk < kvl ? dot * scale : NEG_FILL;
    sS[g * CK + kk] = sc;
    if (S != nullptr) S[((size_t)(kk / ps) * G + g) * ps + kk % ps] = sc;
  }
}

// Step 2: every (head, page) maximum over the page's keys.
template <int NT>
__device__ __forceinline__ void chunk_maxima(float* sMx, const float* sS, int np, int ps, int G,
                                             int CK, int CH) {
  for (int e = threadIdx.x; e < G * np; e += NT) {
    const int g = e / np, p = e - g * np;
    float mx = -INFINITY;
    for (int k = 0; k < ps; ++k) mx = fmaxf(mx, sS[g * CK + p * ps + k]);
    sMx[g * CH + p] = mx;
  }
}

// Step 3: every (head, key) p = exp(s - m_page) in place of its score and
// every (head, page) corr = exp(m_before - m_page), m_page the running
// maximum after the page: a prefix max over the chunk's page maxima from the
// carried maximum sM.
template <bool TABLE, int NT>
__device__ __forceinline__ void chunk_probs(float* sS, float* sC, const float* sMx,
                                            const float* sM, const int* pg, int np, int ps,
                                            int G, int CK, int CH, long long key0,
                                            long long kvl, const Epilogue& ep,
                                            const float* s_bp, const float* s_dmq) {
  for (int e = threadIdx.x; e < G * np * ps; e += NT) {
    const int g = e / (np * ps), kk = e - g * (np * ps), p = kk / ps;
    if (pg[p] < 0) continue;
    float m = sM[g], m_prev = m;
    for (int j = 0; j <= p; ++j) {
      if (pg[j] < 0) continue;
      m_prev = m;
      m = fmaxf(m, sMx[g * CH + j]);
    }
    if (kk == p * ps) sC[g * CH + p] = epi_exp<TABLE>(ep, m_prev - m, s_bp, s_dmq);
    const int i = g * CK + kk;
    sS[i] = key0 + kk < kvl ? epi_exp<TABLE>(ep, sS[i] - m, s_bp, s_dmq) : 0.0f;
  }
}

// A page's p . v for (head row pr, column d of the V rows vr) in key order;
// column dh is sum(p), the same adds (fmaf(p, 1, sum) is sum + p).
template <typename TKV>
__device__ __forceinline__ float page_pv(const float* pr, const TKV* vr, int d, int dh, int ps,
                                         int DP) {
  float pv = 0.0f;
  if (d < dh) {
    for (int k = 0; k < ps; ++k) pv = fmaf(pr[k], to_f32(vr[(size_t)k * DP + d]), pv);
  } else {
    for (int k = 0; k < ps; ++k) pv += pr[k];
  }
  return pv;
}

// The shared-memory carve of a chunk block (chunk_smem_bytes).
template <typename TKV>
struct ChunkSmem {
  TKV* kv;     // [buffers][CK][DP]: K, or K and V
  float* q;    // [G][dh]
  float* s;    // [G][CK] scores, then p
  float* mx;   // [G][CH] page maxima
  float* c;    // [G][CH] corrections
  float* m;    // [G] carried maximum
  int* pg;     // [CH] page indices
  __device__ ChunkSmem(unsigned char* raw, int buffers, int CK, int DP, int G, int dh, int CH) {
    kv = reinterpret_cast<TKV*>(raw);
    q = reinterpret_cast<float*>(kv + (size_t)buffers * CK * DP);
    s = q + (size_t)G * dh;
    mx = s + (size_t)G * CK;
    c = mx + (size_t)G * CH;
    m = c + (size_t)G * CH;
    pg = reinterpret_cast<int*>(m + G);
  }
};

// The page chain, per split, in f32 (pwl the launch's epilogue):
//   sc    = (q . k) * scale, masked to -1e30 past kv_len
//   m_new = max(m, max(sc))
//   p     = max(pwl(max(sc - m_new, -1e4)), 0) * keep
//   corr  = max(pwl(max(m - m_new, -1e4)), 0)
//   l     = l * corr + sum(p);   acc = acc * corr + p . v
// Only the last line needs the page before.  A short split (at most one
// chunk of pages) runs whole in one block, split_kernel; a longer one in
// three kernels over all its pages: page_scores_kernel (steps 1-2 of every
// chunk in a block of its own), page_pv_kernel (step 3 from the maxima of
// the pages before, then every page's p . v and sum(p)), and
// recurrence_kernel (the recurrence over the split's pages, one thread a
// (head, d)).  Each f32 operation keeps its operands and its order in both.

// A split of at most one chunk of pages, whole in one block: its K and V
// rows in by cp.async, steps 1-3, then the recurrence, one thread a
// (head, d) and one a head for l.
template <typename TQ, typename TKV, bool TABLE, int NT>
__global__ void __launch_bounds__(NT)
split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp, const TKV* __restrict__ vp,
             const int* __restrict__ page_table, int n_cols, const int* __restrict__ kv_len,
             const float* __restrict__ bp, const float* __restrict__ dmq, Epilogue ep,
             float* __restrict__ m_out, float* __restrict__ l_out, float* __restrict__ acc_out,
             int Hkv, int P, int ps, int dh, int G, int pps, int n_splits, bool vec,
             float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float s_bp[PWL_MAX_BP];
  __shared__ float s_dmq[2 * (PWL_MAX_BP + 1)];
  const int tid = threadIdx.x;
  const Split t = split_of(kv_len, Hkv, ps, pps);
  const int DP = dh + 16 / (int)sizeof(TKV);
  const int CH = pps, CK = CH * ps, np = t.n_live;
  const ChunkSmem<TKV> sm(smem_raw, 2, CK, DP, G, dh, CH);
  const TKV* kd = sm.kv;
  const TKV* vd = sm.kv + (size_t)CK * DP;

  epi_load_table<TABLE>(s_bp, s_dmq, bp, dmq, ep);
  for (int p = tid; p < np; p += NT)
    sm.pg[p] = page_at(page_table, n_cols, P, t.b, t.col0 + p);
  for (int e = tid; e < G * dh; e += NT) sm.q[e] = to_f32(q[(size_t)t.a * G * dh + e]);
  for (int g = tid; g < G; g += NT) sm.m[g] = NEG_FILL;
  __syncthreads();
  load_pages<TKV, NT>(sm.kv, kp, sm.pg, t.h, P, np, ps, dh, DP, vec);
  load_pages<TKV, NT>(sm.kv + (size_t)CK * DP, vp, sm.pg, t.h, P, np, ps, dh, DP, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const long long key0 = (long long)t.col0 * ps;
  chunk_scores<TKV, NT>(sm.s, nullptr, sm.q, kd, sm.pg, np, ps, dh, DP, G, CK, key0, t.kvl,
                        scale, vec);
  __syncthreads();
  chunk_maxima<NT>(sm.mx, sm.s, np, ps, G, CK, CH);
  __syncthreads();
  chunk_probs<TABLE, NT>(sm.s, sm.c, sm.mx, sm.m, sm.pg, np, ps, G, CK, CH, key0, t.kvl, ep,
                         s_bp, s_dmq);
  __syncthreads();
  // the recurrence; column dh of head g is l
  const size_t part = (size_t)t.a * n_splits + t.s;
  for (int o = tid; o < G * (dh + 1); o += NT) {
    const int g = o / (dh + 1), d = o - g * (dh + 1);
    float acc = 0.0f, m = NEG_FILL;
    for (int p = 0; p < np; ++p) {
      if (sm.pg[p] < 0) continue;
      const float pv = page_pv(sm.s + g * CK + p * ps, vd + (size_t)p * ps * DP, d, dh, ps, DP);
      acc = fmaf(acc, sm.c[g * CH + p], pv);
      m = fmaxf(m, sm.mx[g * CH + p]);
    }
    if (d < dh) {
      acc_out[part * G * dh + g * dh + d] = acc;
    } else {
      l_out[part * G + g] = acc;
      m_out[part * G + g] = m;
    }
  }
}

// The scratch of a long split's pages, page slot (a * n_splits + s) * pps + p:
// S scores [slot][G][ps], MX page maxima [slot][G], CR corrections
// [slot][G], PV p . v and sum(p) [slot][G][dh + 1].  A page outside the
// pool takes no chain step: its maximum is -inf, its correction 1 and its
// p . v and sum 0, so the running maximum and the recurrence pass it by
// unchanged (acc is never -0: every p . v chain starts from +0).
struct PageScratch {
  float *S, *MX, *CR, *PV;
};

// The maximum of MX[(slot0 + j) * G + g] over j < n, by one warp (a max
// in any order is the same value; a maximum of +-0 meets the chain only as
// m - m' and exp(+-0), which do not see the sign).
__device__ __forceinline__ float warp_max_pages(const float* __restrict__ MX, size_t slot0,
                                                int n, int G, int g) {
  const int lane = threadIdx.x & 31;
  float m = NEG_FILL;
  for (int j = lane; j < n; j += 32) m = fmaxf(m, MX[(slot0 + j) * G + g]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

__device__ __forceinline__ size_t slot_of(const Split& t, int n_splits, int pps, int p) {
  return ((size_t)t.a * n_splits + t.s) * pps + p;
}

// Steps 1-2 on chunk blockIdx.z of a long split: its scores and page maxima
// into the scratch.
template <typename TQ, typename TKV, int NT>
__global__ void __launch_bounds__(NT)
page_scores_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                   const int* __restrict__ page_table, int n_cols,
                   const int* __restrict__ kv_len, PageScratch w, int Hkv, int P, int ps, int dh,
                   int G, int pps, int n_splits, int CH, bool vec, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const Split t = split_of(kv_len, Hkv, ps, pps);
  const int p0 = blockIdx.z * CH;
  if (p0 >= t.n_live) return;
  const int np = min(CH, t.n_live - p0);
  const int DP = dh + 16 / (int)sizeof(TKV);
  const int CK = CH * ps;
  const ChunkSmem<TKV> sm(smem_raw, 1, CK, DP, G, dh, CH);
  for (int p = tid; p < np; p += NT)
    sm.pg[p] = page_at(page_table, n_cols, P, t.b, t.col0 + p0 + p);
  for (int e = tid; e < G * dh; e += NT) sm.q[e] = to_f32(q[(size_t)t.a * G * dh + e]);
  __syncthreads();
  load_pages<TKV, NT>(sm.kv, kp, sm.pg, t.h, P, np, ps, dh, DP, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const size_t slot = slot_of(t, n_splits, pps, p0);
  chunk_scores<TKV, NT>(sm.s, w.S + slot * G * ps, sm.q, sm.kv, sm.pg, np, ps, dh, DP, G, CK,
                        (long long)(t.col0 + p0) * ps, t.kvl, scale, vec);
  __syncthreads();
  chunk_maxima<NT>(sm.mx, sm.s, np, ps, G, CK, CH);
  __syncthreads();
  for (int e = tid; e < G * np; e += NT) {
    const int p = e / G, g = e - p * G;
    w.MX[(slot + p) * G + g] = sm.pg[p] < 0 ? -INFINITY : sm.mx[g * CH + p];
  }
}

// Step 3 on chunk blockIdx.z of a long split, from the running maximum of
// the split's pages before it, then every page's p . v and sum(p) into the
// scratch.
template <typename TKV, bool TABLE, int NT>
__global__ void __launch_bounds__(NT)
page_pv_kernel(const TKV* __restrict__ vp, const int* __restrict__ page_table, int n_cols,
               const int* __restrict__ kv_len, const float* __restrict__ bp,
               const float* __restrict__ dmq, Epilogue ep, PageScratch w, int Hkv, int P, int ps,
               int dh, int G, int pps, int n_splits, int CH, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float s_bp[PWL_MAX_BP];
  __shared__ float s_dmq[2 * (PWL_MAX_BP + 1)];
  const int tid = threadIdx.x;
  const Split t = split_of(kv_len, Hkv, ps, pps);
  const int p0 = blockIdx.z * CH;
  if (p0 >= t.n_live) return;
  const int np = min(CH, t.n_live - p0);
  const int DP = dh + 16 / (int)sizeof(TKV);
  const int CK = CH * ps;
  const ChunkSmem<TKV> sm(smem_raw, 1, CK, DP, G, dh, CH);
  epi_load_table<TABLE>(s_bp, s_dmq, bp, dmq, ep);
  for (int p = tid; p < np; p += NT)
    sm.pg[p] = page_at(page_table, n_cols, P, t.b, t.col0 + p0 + p);
  __syncthreads();
  load_pages<TKV, NT>(sm.kv, vp, sm.pg, t.h, P, np, ps, dh, DP, vec);
  cp_async_commit();
  const size_t slot0 = slot_of(t, n_splits, pps, 0);  // the split's first page slot
  const size_t slot = slot0 + p0;
  // the running maximum before the chunk, over the split's earlier pages
  for (int g = tid >> 5; g < G; g += NT / 32) {
    const float m = warp_max_pages(w.MX, slot0, p0, G, g);
    if ((tid & 31) == 0) sm.m[g] = m;
  }
  for (int e = tid; e < G * np; e += NT) {
    const int p = e / G, g = e - p * G;
    sm.mx[g * CH + p] = w.MX[(slot + p) * G + g];
  }
  for (int e = tid; e < G * np * ps; e += NT) {
    const int p = e / (G * ps), r = e - p * G * ps, g = r / ps, k = r - g * ps;
    sm.s[g * CK + p * ps + k] = w.S[(slot + p) * G * ps + r];
  }
  cp_async_wait<0>();
  __syncthreads();
  chunk_probs<TABLE, NT>(sm.s, sm.c, sm.mx, sm.m, sm.pg, np, ps, G, CK, CH,
                         (long long)(t.col0 + p0) * ps, t.kvl, ep, s_bp, s_dmq);
  __syncthreads();
  for (int e = tid; e < G * np; e += NT) {
    const int p = e / G, g = e - p * G;
    w.CR[(slot + p) * G + g] = sm.pg[p] < 0 ? 1.0f : sm.c[g * CH + p];
  }
  for (int o = tid; o < np * G * (dh + 1); o += NT) {
    const int p = o / (G * (dh + 1)), r = o - p * G * (dh + 1), g = r / (dh + 1),
              d = r - g * (dh + 1);
    w.PV[(slot + p) * G * (dh + 1) + r] =
        sm.pg[p] < 0 ? 0.0f
                     : page_pv(sm.s + g * CK + p * ps, sm.kv + (size_t)p * ps * DP, d, dh, ps, DP);
  }
}

// The recurrence of a long split over its pages, one thread a (head, d)
// item of block blockIdx.z's THREADS, column dh of a head its l; block 0
// also takes the split's running maximum: the split's (m, l, acc) partials
// for the merge.
__global__ void __launch_bounds__(THREADS)
recurrence_kernel(const int* __restrict__ kv_len, PageScratch w, float* __restrict__ m_out,
                  float* __restrict__ l_out, float* __restrict__ acc_out, int Hkv, int ps,
                  int dh, int G, int pps, int n_splits) {
  const int tid = threadIdx.x;
  const Split t = split_of(kv_len, Hkv, ps, pps);
  const size_t slot0 = slot_of(t, n_splits, pps, 0);
  const size_t part = (size_t)t.a * n_splits + t.s;
  if (blockIdx.z == 0) {
    for (int g = tid >> 5; g < G; g += THREADS / 32) {
      const float m = warp_max_pages(w.MX, slot0, t.n_live, G, g);
      if ((tid & 31) == 0) m_out[part * G + g] = m;
    }
  }
  const int o = blockIdx.z * THREADS + tid;
  if (o >= G * (dh + 1)) return;
  const int g = o / (dh + 1), d = o - g * (dh + 1);
  const float* cr = w.CR + slot0 * G + g;
  const float* pv = w.PV + slot0 * G * (dh + 1) + o;
  const size_t cs = G, vs = (size_t)G * (dh + 1);  // page strides
  float acc = 0.0f;
  int p = 0;
  for (; p + 8 <= t.n_live; p += 8) {  // the loads of 8 pages ahead of their FMAs
    float c[8], v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      c[i] = cr[(p + i) * cs];
      v[i] = pv[(p + i) * vs];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) acc = fmaf(acc, c[i], v[i]);
  }
  for (; p < t.n_live; ++p) acc = fmaf(acc, cr[p * cs], pv[p * vs]);
  if (d < dh)
    acc_out[part * G * dh + g * dh + d] = acc;
  else
    l_out[part * G + g] = acc;
}

template <typename TQ, bool TABLE>
__global__ void __launch_bounds__(THREADS)
merge_kernel(const float* __restrict__ m_p, const float* __restrict__ l_p,
             const float* __restrict__ acc_p, const float* __restrict__ bp,
             const float* __restrict__ dmq, Epilogue ep, TQ* __restrict__ out, int G, int dh,
             int n_splits) {
  __shared__ float s_bp[PWL_MAX_BP];
  __shared__ float s_dmq[2 * (PWL_MAX_BP + 1)];
  epi_load_table<TABLE>(s_bp, s_dmq, bp, dmq, ep);
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
      const float e = epi_exp<TABLE>(ep, m_p[i] - m_max, s_bp, s_dmq);
      l += l_p[i] * e;
      acc += acc_p[i * dh + d] * e;
    }
    store(acc / fmaxf(l, 1e-30f), out + ((size_t)a * G + g) * dh + d);
  }
}

// Raises a kernel's dynamic shared memory limit to smem where it is above
// the default 48 KB (once per size: *allowed remembers the largest).
template <class Kern>
int allow_smem(Kern kern, size_t smem, size_t* allowed) {
  if (smem <= *allowed) return 0;
  const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  *allowed = smem;
  return 0;
}

template <typename TQ, typename TKV, bool TABLE, int NT>
int launch_splits(const void* q, const void* kp, const void* vp, const int* pt, int n_cols,
                  const int* kv_len, const float* bp, const float* dmq, Epilogue ep, float* m_p,
                  float* l_p, float* acc_p, float* scratch, size_t scratch_floats, int B,
                  int Hkv, int P, int ps, int dh, int G, int pps, int n_splits,
                  cudaStream_t stream) {
  const bool vec = ((size_t)dh * sizeof(TKV)) % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(kp) & 15u) == 0 &&
                   (reinterpret_cast<uintptr_t>(vp) & 15u) == 0;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(dh)));
  const TQ* qt = static_cast<const TQ*>(q);
  const TKV* kt = static_cast<const TKV*>(kp);
  const TKV* vt = static_cast<const TKV*>(vp);
  if (short_splits(ps, dh, G, pps, sizeof(TKV))) {  // the whole split in one block
    const size_t smem = chunk_smem_bytes(ps, dh, G, pps, sizeof(TKV), 2);
    auto kern = split_kernel<TQ, TKV, TABLE, NT>;
    static size_t allowed = 48 * 1024;
    const int e = allow_smem(kern, smem, &allowed);
    if (e != 0) return e;
    kern<<<dim3(B * Hkv, n_splits), NT, smem, stream>>>(
        qt, kt, vt, pt, n_cols, kv_len, bp, dmq, ep, m_p, l_p, acc_p, Hkv, P, ps, dh, G, pps,
        n_splits, vec, scale);
    return static_cast<int>(cudaGetLastError());
  }
  const int ch = chunk_pages(ps, dh, G, pps, sizeof(TKV), 1);
  const size_t pages = (size_t)B * Hkv * n_splits * pps;
  if (scratch == nullptr ||
      scratch_floats < scratch_floats_needed(B, Hkv, ps, dh, G, pps, n_splits, sizeof(TKV)))
    return static_cast<int>(cudaErrorInvalidValue);
  const PageScratch w{scratch, scratch + pages * G * ps, scratch + pages * G * (ps + 1),
                      scratch + pages * G * (ps + 2)};
  const size_t smem = chunk_smem_bytes(ps, dh, G, ch, sizeof(TKV), 1);
  const dim3 grid(B * Hkv, n_splits, (pps + ch - 1) / ch);
  auto scores = page_scores_kernel<TQ, TKV, NT>;
  auto pv = page_pv_kernel<TKV, TABLE, NT>;
  static size_t allowed_scores = 48 * 1024, allowed_pv = 48 * 1024;
  int e = allow_smem(scores, smem, &allowed_scores);
  if (e == 0) e = allow_smem(pv, smem, &allowed_pv);
  if (e != 0) return e;
  scores<<<grid, NT, smem, stream>>>(qt, kt, pt, n_cols, kv_len, w, Hkv, P, ps, dh, G, pps,
                                     n_splits, ch, vec, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pv<<<grid, NT, smem, stream>>>(vt, pt, n_cols, kv_len, bp, dmq, ep, w, Hkv, P, ps, dh, G, pps,
                                 n_splits, ch, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  recurrence_kernel<<<dim3(B * Hkv, n_splits, (G * (dh + 1) + THREADS - 1) / THREADS), THREADS,
                      0, stream>>>(kv_len, w, m_p, l_p, acc_p, Hkv, ps, dh, G, pps, n_splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV, bool TABLE>
int launch(const void* q, const void* kp, const void* vp, const int* pt, int n_cols,
           const int* kv_len, const float* bp, const float* dmq, Epilogue ep, float* m_p,
           float* l_p, float* acc_p, float* scratch, size_t scratch_floats, void* out, int B,
           int Hkv, int P, int ps, int dh, int G, int pps, int n_splits, cudaStream_t stream) {
  const int err = split_threads(dh) == 128
      ? launch_splits<TQ, TKV, TABLE, 128>(q, kp, vp, pt, n_cols, kv_len, bp, dmq, ep, m_p, l_p,
                                           acc_p, scratch, scratch_floats, B, Hkv, P, ps, dh, G,
                                           pps, n_splits, stream)
      : launch_splits<TQ, TKV, TABLE, 256>(q, kp, vp, pt, n_cols, kv_len, bp, dmq, ep, m_p, l_p,
                                           acc_p, scratch, scratch_floats, B, Hkv, P, ps, dh, G,
                                           pps, n_splits, stream);
  if (err != 0) return err;
  merge_kernel<TQ, TABLE><<<B * Hkv, THREADS, 0, stream>>>(m_p, l_p, acc_p, bp, dmq, ep,
                                                     static_cast<TQ*>(out), G, dh, n_splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: (B, 1, H = Hkv * G, dh) in q_dtype; k/v pools: (Hkv, P, ps, dh) in
// kv_dtype; page_table: (B, n_cols) int32; kv_len: (B,) int32; m_p, l_p:
// (B * Hkv, n_splits, G) f32 and acc_p: (B * Hkv, n_splits, G, dh) f32 scratch
// for the partials; scratch: paged_decode_scratch_floats(...) f32 for the
// pages of long splits (PageScratch), null when that is 0.  The exp is
// the epilogue (bp, dmq, n_bp, kind, fn) of epilogue.cuh.  Dtype codes:
// 0 = float32, 1 = bfloat16.  Launches the split kernels and the merge
// kernel on `stream`; returns the cudaError_t.
extern "C" int paged_decode_forward(const void* q, const void* kp, const void* vp,
                                    const void* page_table, int n_cols, const void* kv_len,
                                    const void* bp, const void* dmq, int n_bp, int kind,
                                    int fn, void* m_p, void* l_p, void* acc_p,
                                    void* scratch, long long scratch_floats, void* out,
                                    int B, int Hkv, int P, int ps, int dh, int G, int pps,
                                    int n_splits, int q_dtype, int kv_dtype, void* stream) {
  const Epilogue ep{kind, fn, n_bp};
  if (!epilogue_ok(ep) || B < 0 || Hkv < 1 || P < 1 || ps < 1 || dh < 1 ||
      G < 1 || pps < 1 || n_splits < 1 || n_cols < 1 || B * Hkv > 0x7fffffff / 2 ||
      n_splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t kv_bytes = kv_dtype == 0 ? 4 : 2;
  const bool whole = short_splits(ps, dh, G, pps, kv_bytes);
  const int ch = whole ? pps : chunk_pages(ps, dh, G, pps, kv_bytes, 1);
  if (chunk_smem_bytes(ps, dh, G, ch, kv_bytes, whole ? 2 : 1) > 227 * 1024 || scratch_floats < 0)
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
  float* sf = static_cast<float*>(scratch);
  const size_t sn = static_cast<size_t>(scratch_floats);
  return with_table(ep, [&](auto table) {
    constexpr bool TB = decltype(table)::value;
#define PAGED_DECODE_LAUNCH(TQ, TKV)                                                           \
  return launch<TQ, TKV, TB>(q, kp, vp, pt, n_cols, lens, bpf, dmqf, ep, mf, lf, af, sf, sn, \
                             out, B, Hkv, P, ps, dh, G, pps, n_splits, st)
    if (q_dtype == 0 && kv_dtype == 0) PAGED_DECODE_LAUNCH(float, float);
    if (q_dtype == 0 && kv_dtype == 1) PAGED_DECODE_LAUNCH(float, __nv_bfloat16);
    if (q_dtype == 1 && kv_dtype == 0) PAGED_DECODE_LAUNCH(__nv_bfloat16, float);
    if (q_dtype == 1 && kv_dtype == 1) PAGED_DECODE_LAUNCH(__nv_bfloat16, __nv_bfloat16);
#undef PAGED_DECODE_LAUNCH
    return static_cast<int>(cudaErrorInvalidValue);
  });
}

// *floats: the f32 scratch paged_decode_forward needs for these shapes, 0
// when every split fits one chunk of pages (the one-block path reads no
// scratch).  Returns 0.
extern "C" int paged_decode_scratch_floats(int B, int Hkv, int ps, int dh, int G, int pps,
                                           int n_splits, int kv_dtype, long long* floats) {
  *floats = static_cast<long long>(
      scratch_floats_needed(B, Hkv, ps, dh, G, pps, n_splits, kv_dtype == 0 ? 4 : 2));
  return 0;
}
