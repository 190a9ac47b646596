// The standalone PWL activation: one elementwise pass y = pwl(x), with a
// non-uniform table (the paper's Flex-SFU decode) or a uniform one (the
// prior-work baseline the paper compares against).
//
// Replaces repro/kernels/pwl_act.py:_pwl_nonuniform_kernel (the
// impl="kernel" activation of a plan site: the strict compare-count delta
// decode of pwl_decode.cuh, then m * x + q in f32, cast to x's type) and
// _pwl_uniform_kernel (idx = clip(floor((x - lo) * inv_h) + 1, 0, n_seg - 1),
// then that segment's (m, q) fetched by delta accumulation over the n_seg - 1
// segment edges, as the TPU kernel fetches it, and m * x + q).
//
// Both compute the value with the product and the sum rounded apart
// (__fmul_rn, __fadd_rn), as the plain versions in kernels/pwl_act.py do, so
// each kernel is bitwise its plain version.  The uniform kernel forms its
// deltas (m_i - m_{i-1}, q_i - q_{i-1}) once per block with the same f32
// subtraction as the plain version's loop.  The index is computed in f32
// and clipped before it is compared; the TPU kernel converts floor(...) to
// int32 first, which only differs for |x - lo| beyond 2^31 segment widths.
//
// What bounds them on an H100: each element is read once and written once
// (4 bytes in bf16, 8 in f32), against ~3 f32 operations per breakpoint for
// the decode (96 at 32 breakpoints), so at 32 breakpoints the decode on the
// CUDA cores (67 TFLOP/s) is the larger term.  The design: the table lives
// in shared memory, loaded once per block and read as a broadcast; a
// grid-stride loop walks the flat tensor with no padding (the TPU kernel's
// 8 x 128 tiles and their padding are gone); x is bf16, f16 or f32.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "pwl_decode.cuh"

#define PWL_MAX_SEG (PWL_MAX_BP + 1)

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;  // 16 blocks per SM of an H100

template <typename T>
__global__ void __launch_bounds__(THREADS)
pwl_nonuniform_kernel(const T* __restrict__ x, const float* __restrict__ bp,
                      const float* __restrict__ dmq, int n_bp, T* __restrict__ out,
                      long long n) {
  __shared__ float s_bp[PWL_MAX_BP];
  __shared__ float s_dmq[2 * (PWL_MAX_BP + 1)];
  pwl_load_table(s_bp, s_dmq, bp, dmq, n_bp);
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    store(pwl_value(to_f32(x[i]), s_bp, s_dmq, n_bp), out + i);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
pwl_uniform_kernel(const T* __restrict__ x, const float* __restrict__ mq, int n_seg,
                   float lo, float inv_h, T* __restrict__ out, long long n) {
  // row 0 = (m_0, q_0), row i = (m_i - m_{i-1}, q_i - q_{i-1})
  __shared__ float s_d[2 * PWL_MAX_SEG];
  for (int i = threadIdx.x; i < 2 * n_seg; i += blockDim.x)
    s_d[i] = i < 2 ? mq[i] : __fsub_rn(mq[i], mq[i - 2]);
  __syncthreads();
  const float last = static_cast<float>(n_seg - 1);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float xf = to_f32(x[i]);
    const float t = floorf(__fmul_rn(__fsub_rn(xf, lo), inv_h));
    const float idx = fminf(fmaxf(__fadd_rn(t, 1.0f), 0.0f), last);
    float m = s_d[0];
    float q = s_d[1];
    for (int j = 0; j < n_seg - 1; ++j) {
      const float c = idx > static_cast<float>(j) ? 1.0f : 0.0f;
      m = fmaf(c, s_d[2 * j + 2], m);
      q = fmaf(c, s_d[2 * j + 3], q);
    }
    store(__fadd_rn(__fmul_rn(m, xf), q), out + i);
  }
}

int blocks_for(long long n) {
  const long long b = (n + THREADS - 1) / THREADS;
  return static_cast<int>(b < MAX_BLOCKS ? b : MAX_BLOCKS);
}

}  // namespace

// x and out hold n elements of dtype (0 = float32, 1 = bfloat16, 2 =
// float16); bp (n_bp) and dmq (2 * (n_bp + 1)) the f32 delta layout.
// Returns the cudaError_t of the launch.
extern "C" int pwl_nonuniform_forward(const void* x, const void* bp, const void* dmq, int n_bp,
                                      void* out, long long n, int dtype, void* stream) {
  if (n_bp < 1 || n_bp > PWL_MAX_BP || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bp);
  const float* d = static_cast<const float*>(dmq);
  const int g = blocks_for(n);
  if (dtype == 0)
    pwl_nonuniform_kernel<float><<<g, THREADS, 0, s>>>(
        static_cast<const float*>(x), b, d, n_bp, static_cast<float*>(out), n);
  else if (dtype == 1)
    pwl_nonuniform_kernel<__nv_bfloat16><<<g, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), b, d, n_bp, static_cast<__nv_bfloat16*>(out), n);
  else if (dtype == 2)
    pwl_nonuniform_kernel<__half><<<g, THREADS, 0, s>>>(
        static_cast<const __half*>(x), b, d, n_bp, static_cast<__half*>(out), n);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// x and out as above; mq (n_seg, 2) f32 per-segment (m, q); lo and inv_h the
// f32 constants of the affine address decode.  Returns the cudaError_t of
// the launch.
extern "C" int pwl_uniform_forward(const void* x, const void* mq, int n_seg, float lo,
                                   float inv_h, void* out, long long n, int dtype,
                                   void* stream) {
  if (n_seg < 3 || n_seg > PWL_MAX_SEG || n <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(mq);
  const int g = blocks_for(n);
  if (dtype == 0)
    pwl_uniform_kernel<float><<<g, THREADS, 0, s>>>(
        static_cast<const float*>(x), t, n_seg, lo, inv_h, static_cast<float*>(out), n);
  else if (dtype == 1)
    pwl_uniform_kernel<__nv_bfloat16><<<g, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), t, n_seg, lo, inv_h,
        static_cast<__nv_bfloat16*>(out), n);
  else if (dtype == 2)
    pwl_uniform_kernel<__half><<<g, THREADS, 0, s>>>(
        static_cast<const __half*>(x), t, n_seg, lo, inv_h, static_cast<__half*>(out), n);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
