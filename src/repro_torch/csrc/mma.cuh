// Warp-level bf16 tensor-core products (mma.sync m16n8k16, f32 accumulate),
// ldmatrix fragment loads and cp.async tile copies: the building blocks of the
// flash kernels' bf16 design (attention.cu, attention_bwd.cu).
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, c = lane % 4; each register
// holds two bf16, the lower column in the low half):
//   A 16 x 16 (row major): a0 (g, 2c..2c+1), a1 (g+8, 2c..), a2 (g, 2c+8..),
//                          a3 (g+8, 2c+8..)
//   B 16 x 8  (k x n):     b0 (k 2c..2c+1, n g), b1 (k 2c+8..2c+9, n g)
//   C 16 x 8  (f32):       c0, c1 (g, 2c..2c+1), c2, c3 (g+8, 2c..2c+1)
// so two neighbouring C tiles, rounded to bf16, are an A fragment: a product
// whose left operand was just computed in registers (P . V) needs no trip
// through shared memory.
//
// Each output element of one mma is a function of its row of A, its column of
// B and its accumulator alone, so a score summed over d in 16-wide chunks from
// 0 with Q as A and K as B is bitwise the same in whatever tile and kernel it
// is computed: the backward kernels re-find the forward's row max.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (src is
// then not read but must be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most N of this thread's groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// The same, each matrix transposed.
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a . b
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) as hi = bf16(x) and lo = bf16(x - hi): hi + lo keeps ~16 bits of
// each f32 value, so a product with a computed f32 left operand runs as two
// bf16 products (x - hi is exact in f32).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// A fragments (hi and lo) of the 16 x 16 block made of C tiles t0 (columns
// 0..7) and t1 (columns 8..15).
__device__ __forceinline__ void c_to_a(const float t0[4], const float t1[4], uint32_t hi[4],
                                       uint32_t lo[4]) {
  split_bf16(t0[0], t0[1], hi[0], lo[0]);
  split_bf16(t0[2], t0[3], hi[1], lo[1]);
  split_bf16(t1[0], t1[1], hi[2], lo[2]);
  split_bf16(t1[2], t1[3], hi[3], lo[3]);
}

// Quad reductions: the four lanes (c = 0..3) that hold one row of a C tile.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows [r0, r0 + R) of head h of a (B, N, heads, dh) bf16 tensor into an
// R x (DHM + 8) bf16 tile in shared memory (dh <= DHM columns used), zero past
// row N; NT threads, 16 bytes each per copy.  Part of the caller's current
// cp.async group.  The row stride is a constant of the instantiation, so
// every shared-memory address the kernels form is an offset they know at
// compile time.
template <int R, int NT, int DHM>
__device__ __forceinline__ void tile_async(__nv_bfloat16* dst,
                                           const __nv_bfloat16* __restrict__ src, int b, int r0,
                                           int N, int heads, int h, int dh) {
  constexpr int CPR = DHM / 8;  // 16-byte chunks a row, at most
#pragma unroll
  for (int i = 0; i < (R * CPR + NT - 1) / NT; ++i) {
    const int e = threadIdx.x + i * NT;
    const int rr = e / CPR, cc = e % CPR;
    if (e < R * CPR && cc * 8 < dh) {
      const int n = r0 + rr;
      const bool ok = n < N;
      const __nv_bfloat16* g = src + (((size_t)b * N + (ok ? n : 0)) * heads + h) * dh + cc * 8;
      cp_async16(dst + rr * (DHM + 8) + cc * 8, g, ok);
    }
  }
}

// Address of lane's row for ldsm_x4 of the 16 x 16 A block at (row r0, col k0)
// of a row-major tile: matrices (r0, k0), (r0 + 8, k0), (r0, k0 + 8), (r0 + 8, k0 + 8).
__device__ __forceinline__ const __nv_bfloat16* a_addr(const __nv_bfloat16* t, int ld, int r0,
                                                       int k0, int lane) {
  return t + (r0 + (lane & 15)) * ld + k0 + ((lane >> 4) << 3);
}
// B fragments of two n-tiles from a tile stored n-major (row n, column k):
// K for q . k, V for dout . v.  r[0], r[1] are b0, b1 of rows n0..n0+7 and
// r[2], r[3] of rows n0+8..n0+15, over columns k0..k0+15.
__device__ __forceinline__ const __nv_bfloat16* bn_addr(const __nv_bfloat16* t, int ld, int n0,
                                                        int k0, int lane) {
  return t + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + (((lane >> 3) & 1) << 3);
}
// B fragments of two n-tiles from a tile stored k-major (row k, column n),
// loaded with ldsm_x4_t: V for p . v, K for ds . k, dout and q for the dkv
// products.  r[0], r[1] are b0, b1 of columns n0..n0+7, r[2], r[3] of n0+8..
// n0+15, over rows k0..k0+15.
__device__ __forceinline__ const __nv_bfloat16* bk_addr(const __nv_bfloat16* t, int ld, int k0,
                                                        int n0, int lane) {
  return t + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld + n0 + ((lane >> 4) << 3);
}
// The transposed A block: rows m0..m0+15 of A are columns of a tile stored
// (k, m) row-major (the dkv kernel's P and dS, stored query-major), loaded
// with ldsm_x4_t.
__device__ __forceinline__ const __nv_bfloat16* at_addr(const __nv_bfloat16* t, int ld, int k0,
                                                        int m0, int lane) {
  const int mi = lane >> 3;
  return t + (k0 + (lane & 7) + ((mi >> 1) << 3)) * ld + m0 + ((mi & 1) << 3);
}
