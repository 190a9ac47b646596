// In-place page writes into the paged KV pools (Hkv, P, ps, dh).
//
// Replaces repro/serving/kv_cache.py:_prompt_write_kernel and :_append_kernel.
// Those are Pallas kernels with input_output_aliases; here the pools are
// written in place and nothing else of them is touched.
//
// * prompt write: K/V of a prefill, (B, S, Hkv, dh), go to page
//   page_table[b, s / ps], slot s % ps.
// * append: the one decode token per request, (B, 1, Hkv, dh), goes to row
//   kv_len[b] % ps of page page_table[b, kv_len[b] / ps].  Only that row is
//   written; the TPU kernel's copy of the whole page came from its block
//   granularity and is not carried over.
//
// Inactive slots and pad positions carry page 0, the sentinel: several threads
// may race on it, and it is never read as valid.  A target outside the pools
// (a page id outside [0, P), or an append past the table's last column) is
// skipped rather than written out of bounds; a kernel cannot raise, so the
// host refuses such a table before the launch (serving/kv_cache.py
// check_targets, called by the engine on its host mirrors every step).
//
// What bounds them: a 32-token prefill moves ~98 KB per layer, a decode step
// ~12 KB per layer, so both are bound by launch latency, not by bytes.  The
// design is one launch for K and V together, one thread per element, the page
// index read on the device (no host sync), and elements copied as raw bits of
// their width.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <typename E>
__global__ void __launch_bounds__(THREADS)
prompt_write_kernel(const E* __restrict__ kn, const E* __restrict__ vn, E* __restrict__ kp,
                    E* __restrict__ vp, const int* __restrict__ page_table, int pt_cols,
                    int B, int S, int Hkv, int dh, int P, int ps) {
  const size_t n = (size_t)B * S * Hkv * dh;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int d = idx % dh;
    size_t r = idx / dh;
    const int h = r % Hkv;
    r /= Hkv;
    const int s = r % S;
    const int b = r / S;
    const int page = page_table[(size_t)b * pt_cols + s / ps];
    if (page < 0 || page >= P) continue;
    const size_t dst = (((size_t)h * P + page) * ps + s % ps) * dh + d;
    kp[dst] = kn[idx];
    vp[dst] = vn[idx];
  }
}

template <typename E>
__global__ void __launch_bounds__(THREADS)
append_kernel(const E* __restrict__ kn, const E* __restrict__ vn, E* __restrict__ kp,
              E* __restrict__ vp, const int* __restrict__ page_table, int pt_cols,
              const int* __restrict__ kv_len, int B, int Hkv, int dh, int P, int ps) {
  const size_t n = (size_t)B * Hkv * dh;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int d = idx % dh;
    const size_t r = idx / dh;
    const int h = r % Hkv;
    const int b = r / Hkv;
    const int len = kv_len[b];
    if (len < 0 || len / ps >= pt_cols) continue;
    const int page = page_table[(size_t)b * pt_cols + len / ps];
    if (page < 0 || page >= P) continue;
    const size_t dst = (((size_t)h * P + page) * ps + len % ps) * dh + d;
    kp[dst] = kn[idx];
    vp[dst] = vn[idx];
  }
}

int grid_for(size_t n) {
  size_t blocks = (n + THREADS - 1) / THREADS;
  return static_cast<int>(blocks < 65535 * 16 ? blocks : 65535 * 16);
}

}  // namespace

// elem_bytes: 2 (bf16/f16) or 4 (f32).  Returns the cudaError_t of the launch.
extern "C" int kv_write_prompt(const void* kn, const void* vn, void* kp, void* vp,
                               const void* page_table, int pt_cols, int B, int S, int Hkv,
                               int dh, int P, int ps, int elem_bytes, void* stream) {
  const size_t n = (size_t)B * S * Hkv * dh;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pt = static_cast<const int*>(page_table);
  if (elem_bytes == 2) {
    prompt_write_kernel<uint16_t><<<grid_for(n), THREADS, 0, st>>>(
        static_cast<const uint16_t*>(kn), static_cast<const uint16_t*>(vn),
        static_cast<uint16_t*>(kp), static_cast<uint16_t*>(vp), pt, pt_cols, B, S, Hkv, dh, P, ps);
  } else if (elem_bytes == 4) {
    prompt_write_kernel<uint32_t><<<grid_for(n), THREADS, 0, st>>>(
        static_cast<const uint32_t*>(kn), static_cast<const uint32_t*>(vn),
        static_cast<uint32_t*>(kp), static_cast<uint32_t*>(vp), pt, pt_cols, B, S, Hkv, dh, P, ps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kv_append(const void* kn, const void* vn, void* kp, void* vp,
                         const void* page_table, int pt_cols, const void* kv_len, int B, int Hkv,
                         int dh, int P, int ps, int elem_bytes, void* stream) {
  const size_t n = (size_t)B * Hkv * dh;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pt = static_cast<const int*>(page_table);
  const int* lens = static_cast<const int*>(kv_len);
  if (elem_bytes == 2) {
    append_kernel<uint16_t><<<grid_for(n), THREADS, 0, st>>>(
        static_cast<const uint16_t*>(kn), static_cast<const uint16_t*>(vn),
        static_cast<uint16_t*>(kp), static_cast<uint16_t*>(vp), pt, pt_cols, lens, B, Hkv, dh, P,
        ps);
  } else if (elem_bytes == 4) {
    append_kernel<uint32_t><<<grid_for(n), THREADS, 0, st>>>(
        static_cast<const uint32_t*>(kn), static_cast<const uint32_t*>(vn),
        static_cast<uint32_t*>(kp), static_cast<uint32_t*>(vp), pt, pt_cols, lens, B, Hkv, dh, P,
        ps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
