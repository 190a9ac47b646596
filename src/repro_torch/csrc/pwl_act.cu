// The standalone PWL activation: one elementwise pass y = pwl(x), with a
// non-uniform table (the paper's Flex-SFU decode) or a uniform one (the
// prior-work baseline the paper compares against).
//
// Replaces repro/kernels/pwl_act.py:_pwl_nonuniform_kernel (the
// impl="kernel" activation of a plan site: the strict compare-count delta
// decode of pwl_decode.cuh, then m * x + q in f32, cast to x's type) and
// _pwl_uniform_kernel (idx = clip(int32(floor((x - lo) * inv_h)) + 1, 0,
// n_seg - 1),
// then that segment's (m, q) fetched by delta accumulation over the n_seg - 1
// segment edges, as the TPU kernel fetches it, and m * x + q).
//
// Both compute the value with the product and the sum rounded apart
// (__fmul_rn, __fadd_rn), as the plain versions in kernels/pwl_act.py do, so
// each kernel is bitwise its plain version.  The non-uniform kernel finds
// the chain's (m, q) by the breakpoint search of pwl_decode.cuh
// (pwl_search_mq) from the host-built prefix table, which gives the chain's
// bits for ascending breakpoints (the wrapper refuses others).  The uniform
// kernel builds each segment's (m, q) once a block, by the delta loop the
// TPU kernel runs per element (fmaf(idx > j, d_j, m) over the n_seg - 1
// deltas, each delta the same f32 subtraction as the plain version's), so
// every entry has the bits of that per-element accumulation, signed zeros
// included; an element then costs its index and one shared-memory fetch.
// Past PWL_MAX_SEG segments (Uniform<TABLE_WIDE>) one small kernel first
// accumulates every segment so into device memory, and an element fetches
// its own from there; the non-uniform table past PWL_MAX_BP breakpoints is
// searched where it lies (pwl_decode.cuh, PwlSearchWide).
// The index takes the TPU kernel's int32 steps: a saturating conversion, a
// +1 that wraps, then the clip, so |x - lo| beyond 2^31 segment widths lands
// in segment 0 there too.
//
// What bounds them on an H100: each element is read once and written once
// (4 bytes in bf16 and f16, 8 in f32): 50.3 MB at 4096 x 3072 bf16, 15.0 us
// at 3.35 TB/s, against ~9 operations of the search (or ~6 of the uniform
// index) an element.  The design: one 16-byte load and store a thread (8
// bf16 or f16, 4 f32), the load issued before the block loads its table, so
// the two latencies overlap; one block per THREADS vectors, the grid sized by
// the tensor; the elements before the first 16-byte boundary of x and after
// its last whole vector (fewer than 8 each) taken one by one in block 0.  x
// and out must share their address modulo 16 (the wrapper allocates out so).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pwl_decode.cuh"

#define PWL_MAX_SEG (PWL_MAX_BP + 1)

namespace {

constexpr int THREADS = 256;

// The non-uniform table: the padded breakpoints and the prefix table of the
// search, in shared memory (TABLE_SHARED), or where they lie (TABLE_WIDE).
template <int TABLE>
struct NonUniform {
  const float* bp;
  const float* mq;
  int n_bp;
  struct Shared {
    SearchTable<TABLE> t;
  };
  struct Dec {
    const SearchTable<TABLE>* t;
    float3 piv;
    __device__ __forceinline__ float operator()(float x) const {
      const float2 mq = pwl_search_mq(x, *t, piv);
      return __fadd_rn(__fmul_rn(mq.x, x), mq.y);
    }
  };
  __device__ __forceinline__ void load(Shared& s) const { pwl_search_load(&s.t, bp, mq, n_bp); }
  __device__ __forceinline__ Dec decoder(const Shared& s) const {
    return Dec{&s.t, pwl_search_pivots(s.t)};
  }
};

// The uniform table: each segment's (m, q) by the delta loop, once a block.
template <int TABLE>
struct Uniform {
  const float* mq;
  int n_seg;
  float lo, inv_h;
  struct Shared {
    float d[2 * PWL_MAX_SEG];  // row 0 = (m_0, q_0), row i = (m_i - m_{i-1}, q_i - q_{i-1})
    float2 seg[PWL_MAX_SEG];
  };
  struct Dec {
    const float2* seg;
    int last;
    float lo, inv_h;
    __device__ __forceinline__ float operator()(float x) const {
      // int32(floor(t)) + 1 as XLA computes it: the conversion saturates (NaN
      // to 0) and the +1 wraps (done unsigned), so t >= 2^31 lands in segment 0
      const float t = floorf(__fmul_rn(__fsub_rn(x, lo), inv_h));
      const int step = static_cast<int>(static_cast<unsigned>(__float2int_rz(t)) + 1u);
      const float2 mq = seg[step < 0 ? 0 : (step > last ? last : step)];
      return __fadd_rn(__fmul_rn(mq.x, x), mq.y);
    }
  };
  __device__ __forceinline__ void load(Shared& s) const {
    for (int i = threadIdx.x; i < 2 * n_seg; i += blockDim.x)
      s.d[i] = i < 2 ? mq[i] : __fsub_rn(mq[i], mq[i - 2]);
    __syncthreads();
    for (int k = threadIdx.x; k < n_seg; k += blockDim.x) {
      float m = s.d[0];
      float q = s.d[1];
      for (int j = 0; j < n_seg - 1; ++j) {
        const float c = k > j ? 1.0f : 0.0f;
        m = fmaf(c, s.d[2 * j + 2], m);
        q = fmaf(c, s.d[2 * j + 3], q);
      }
      s.seg[k] = make_float2(m, q);
    }
  }
  __device__ __forceinline__ Dec decoder(const Shared& s) const {
    return Dec{s.seg, n_seg - 1, lo, inv_h};
  }
};

// The uniform table past PWL_MAX_SEG segments: seg holds every segment's
// (m, q), built by uniform_segments_kernel before the launch, and an element
// fetches its segment's from device memory.
template <>
struct Uniform<TABLE_WIDE> {
  const float* seg;
  int n_seg;
  float lo, inv_h;
  struct Shared {};
  using Dec = Uniform<TABLE_SHARED>::Dec;
  __device__ __forceinline__ void load(Shared&) const {}
  __device__ __forceinline__ Dec decoder(const Shared&) const {
    return Dec{reinterpret_cast<const float2*>(seg), n_seg - 1, lo, inv_h};
  }
};

// Segment k's (m, q) into seg[k], one thread a segment: the delta loop of
// Uniform<TABLE_SHARED>::load over mq in device memory, the same f32
// subtractions and fmaf in the same order, so the same bits.
__global__ void uniform_segments_kernel(const float* __restrict__ mq, float2* __restrict__ seg,
                                        int n_seg) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n_seg) return;
  float m = mq[0];
  float q = mq[1];
  for (int j = 0; j < n_seg - 1; ++j) {
    const float c = k > j ? 1.0f : 0.0f;
    m = fmaf(c, __fsub_rn(mq[2 * j + 2], mq[2 * j]), m);
    q = fmaf(c, __fsub_rn(mq[2 * j + 3], mq[2 * j + 1]), q);
  }
  seg[k] = make_float2(m, q);
}

// A 32-bit word of x's elements through the decode: one f32, or two bf16 or
// f16 (exactly widened; the results rounded to nearest, as store() rounds).
template <class D>
__device__ __forceinline__ uint32_t apply_word(const float*, uint32_t w, const D& d) {
  return __float_as_uint(d(__uint_as_float(w)));
}
template <class D>
__device__ __forceinline__ uint32_t apply_word(const __nv_bfloat16*, uint32_t w, const D& d) {
  const float xl = __uint_as_float(w << 16), xh = __uint_as_float(w & 0xffff0000u);
  const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(d(xl)));
  const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(d(xh)));
  return lo | (hi << 16);
}
template <class D>
__device__ __forceinline__ uint32_t apply_word(const __half*, uint32_t w, const D& d) {
  const float xl = __half2float(__ushort_as_half(static_cast<unsigned short>(w & 0xffffu)));
  const float xh = __half2float(__ushort_as_half(static_cast<unsigned short>(w >> 16)));
  const uint32_t lo = __half_as_ushort(__float2half_rn(d(xl)));
  const uint32_t hi = __half_as_ushort(__float2half_rn(d(xh)));
  return lo | (hi << 16);
}

// n elements of x into out; head: the elements before x's first 16-byte
// boundary (at most n).  Thread t of block b takes vector b * THREADS + t of
// the aligned part; threads of block 0 also the head and the tail.
template <typename T, class Table>
__global__ void __launch_bounds__(THREADS)
pwl_kernel(const T* __restrict__ x, T* __restrict__ out, long long n, int head, Table tab) {
  constexpr int V = 16 / sizeof(T);
  __shared__ typename Table::Shared s;
  const long long nv = (n - head) / V;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  uint4 a;
  if (i < nv) a = reinterpret_cast<const uint4*>(x + head)[i];
  long long si = -1;  // this thread's scalar element, if any
  T sx;
  if (blockIdx.x == 0) {
    const long long tail = head + nv * V;
    const int t = threadIdx.x;
    if (t < head)
      si = t;
    else if (t >= 8 && tail + (t - 8) < n)
      si = tail + (t - 8);
    if (si >= 0) sx = x[si];
  }
  tab.load(s);
  __syncthreads();
  const typename Table::Dec dec = tab.decoder(s);
  const T* tag = nullptr;
  if (i < nv) {
    uint4 r;
    r.x = apply_word(tag, a.x, dec);
    r.y = apply_word(tag, a.y, dec);
    r.z = apply_word(tag, a.z, dec);
    r.w = apply_word(tag, a.w, dec);
    reinterpret_cast<uint4*>(out + head)[i] = r;
  }
  if (si >= 0) store(dec(to_f32(sx)), out + si);
}

template <typename T, class Table>
int launch_typed(const void* x, void* out, long long n, const Table& tab, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x), oa = reinterpret_cast<uintptr_t>(out);
  if (((xa ^ oa) & 15u) != 0 || xa % sizeof(T) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const long long to_edge = static_cast<long long>(((16u - (xa & 15u)) & 15u) / sizeof(T));
  const int head = static_cast<int>(to_edge < n ? to_edge : n);
  const long long nv = (n - head) / V;
  const long long blocks = nv > 0 ? (nv + THREADS - 1) / THREADS : 1;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  pwl_kernel<T, Table><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, head, tab);
  return static_cast<int>(cudaGetLastError());
}

template <class Table>
int launch(const void* x, void* out, long long n, int dtype, const Table& tab, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_typed<float>(x, out, n, tab, s);
  if (dtype == 1) return launch_typed<__nv_bfloat16>(x, out, n, tab, s);
  if (dtype == 2) return launch_typed<__half>(x, out, n, tab, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x and out hold n elements of dtype (0 = float32, 1 = bfloat16, 2 =
// float16), at addresses equal modulo 16; bp (n_bp) the ascending
// breakpoints and mq the search operand (kernels/fused/epilogue.py:
// search_operand: the (n_bp + 1) x 2 prefix table, then the padded
// breakpoints the wide search reads); wide: the TABLE_WIDE instantiation
// (any n_bp), else the table goes to shared memory (at most PWL_MAX_BP).
// Returns the cudaError_t of the launch.
extern "C" int pwl_nonuniform_forward(const void* x, const void* bp, const void* mq, int n_bp,
                                      int wide, void* out, long long n, int dtype,
                                      void* stream) {
  if (n_bp < 1 || (!wide && n_bp > PWL_MAX_BP) || n <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* bpf = static_cast<const float*>(bp);
  const float* mqf = static_cast<const float*>(mq);
  if (wide) return launch(x, out, n, dtype, NonUniform<TABLE_WIDE>{bpf, mqf, n_bp}, stream);
  return launch(x, out, n, dtype, NonUniform<TABLE_SHARED>{bpf, mqf, n_bp}, stream);
}

// x and out as above; mq (n_seg, 2) f32 per-segment (m, q); lo and inv_h
// the f32 constants of the affine address decode; wide: the TABLE_WIDE
// instantiation (any n_seg), which first builds every segment's accumulated
// (m, q) into seg ((n_seg, 2) f32 scratch, unread otherwise), else the
// segments are built in shared memory (at most PWL_MAX_SEG).  Returns the
// cudaError_t of the launches.
extern "C" int pwl_uniform_forward(const void* x, const void* mq, int n_seg, int wide, void* seg,
                                   float lo, float inv_h, void* out, long long n, int dtype,
                                   void* stream) {
  if (n_seg < 3 || (!wide && n_seg > PWL_MAX_SEG) || (wide && seg == nullptr) || n <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* mqf = static_cast<const float*>(mq);
  if (!wide) return launch(x, out, n, dtype, Uniform<TABLE_SHARED>{mqf, n_seg, lo, inv_h}, stream);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uniform_segments_kernel<<<(n_seg + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      mqf, static_cast<float2*>(seg), n_seg);
  const Uniform<TABLE_WIDE> tab{static_cast<const float*>(seg), n_seg, lo, inv_h};
  return launch(x, out, n, dtype, tab, stream);
}
