// In-place page writes into the paged KV pools (Hkv, P, ps, dh), and the same
// writes carrying the rotary embedding of q and k, in one launch a layer.
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
// * with the rotation (kv_rope_write_prompt, kv_rope_append): the same writes
//   of the rotated k and the plain v, and in the same launch the rotated q
//   (B, S, H, dh) into an output of its own (and for a prefill the rotated k,
//   which the in-flight attention reads).  The JAX package rotates q and k in
//   the XLA fusion before its write kernel; eagerly that rotation was 16
//   launches for each of q and k, so the write carries it here.
//
// Inactive slots and pad positions carry page 0, the sentinel: several threads
// may race on it, and it is never read as valid.  A target outside the pools
// (a page id outside [0, P), or an append past the table's last column) is
// skipped rather than written out of bounds; a kernel cannot raise, so the
// host refuses such a table before the launch (serving/kv_cache.py
// check_targets, called by the engine on its host mirrors every step).  The
// rotated q is written whatever the page.
//
// What bounds them: with the rotation, repro-100m's decode step moves ~38 KB
// a layer and a 32-token prefill ~0.35 MB, so both sit at the launch floor
// (~2 us); what the design removes is the launches around them.  A 2 x 4096 prefill moves ~90 MB and is bound by
// bytes, so every thread moves 16-byte vectors: a work item is one piece of
// a head row, or for the rotation the pair of pieces x[i..i+V) and
// x[half+i..half+i+V), which the rotation mixes.  The page index is read on
// the device (no host sync), one broadcast load for the threads of a token.
//
// The rotation is models/layers.py apply_rope's arithmetic in its order and
// roundings, on the cos/sin tables that torch computed (rope_tables):
// y1 = x1*c - x2*s, y2 = x2*c + x1*s in f32, each product and the sum rounded
// on its own (the __f*_rn intrinsics keep nvcc from contracting them into an
// FMA), then rounded to the element type to nearest even.  So its bits are
// the plain version's by construction.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// element formats: a raw copy (no rotation), or the float type the rotation reads
enum Fmt { RAW = 0, BF16 = 1, F16 = 2, F32 = 3 };

struct WriteArgs {
  const void* q;  // (B, S, H, dh), strides q_s*; rotation only
  const void* k;  // (B, S, Hkv, dh), strides k_s*
  const void* v;  // (B, S, Hkv, dh), strides v_s*
  void* q_out;    // (B, S, H, dh) contiguous; rotation only
  void* k_out;    // (B, S, Hkv, dh) contiguous; a rotating prompt write only
  void* kp;       // (Hkv, P, ps, dh) contiguous
  void* vp;
  const int* page_table;  // (B, pt_cols)
  const int* kv_len;      // (B,); an append only
  const float* cos;       // (B, S, dh / 2), strides c_sb, c_ss, last dim contiguous
  const float* sin;       // the same strides
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, c_sb, c_ss;
  int B, S, H, Hkv, dh, P, ps, pt_cols;
};

// V elements of bits T, moved as 16-byte words where they fill them
template <typename T, int V>
struct Piece {
  static constexpr int WORDS = (V * sizeof(T)) % 16 == 0 ? V * (int)sizeof(T) / 16 : 0;
  union {
    T e[V];
    uint4 w[WORDS ? WORDS : 1];
  };
  __device__ void load(const T* p) {
    if constexpr (WORDS) {
#pragma unroll
      for (int j = 0; j < WORDS; ++j) w[j] = reinterpret_cast<const uint4*>(p)[j];
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) e[j] = p[j];
    }
  }
  __device__ void store(T* p) const {
    if constexpr (WORDS) {
#pragma unroll
      for (int j = 0; j < WORDS; ++j) reinterpret_cast<uint4*>(p)[j] = w[j];
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) p[j] = e[j];
    }
  }
};

template <int F, typename T>
__device__ __forceinline__ float widen(T bits) {
  if constexpr (F == BF16) return __uint_as_float(static_cast<uint32_t>(bits) << 16);
  else if constexpr (F == F16) return __half2float(__ushort_as_half(bits));
  else return __uint_as_float(bits);
}

template <int F, typename T>
__device__ __forceinline__ T narrow(float x) {
  if constexpr (F == BF16) return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  else if constexpr (F == F16) return __half_as_ushort(__float2half_rn(x));
  else return __float_as_uint(x);
}

// One thread a work item: the items of a token are its q rows (rotation
// only), then its k rows, then its v rows, each row dh / V pieces, or
// (dh / 2) / V piece pairs under the rotation.
template <typename T, int F, bool Decode, int V>
__global__ void __launch_bounds__(THREADS) page_write_kernel(const WriteArgs a) {
  constexpr bool Rope = F != RAW;
  const int half = a.dh / 2;
  const int per_row = (Rope ? half : a.dh) / V;
  const int q_rows = Rope ? a.H : 0;
  const int per_token = (q_rows + 2 * a.Hkv) * per_row;
  const int n = a.B * (Decode ? 1 : a.S) * per_token;  // the host keeps it below 2^31
  for (long long it = (long long)blockIdx.x * blockDim.x + threadIdx.x; it < n;
       it += (long long)gridDim.x * blockDim.x) {
    const int idx = static_cast<int>(it);
    const int t = idx / per_token;  // the token, b * S + s
    const int rem = idx - t * per_token;
    const int r = rem / per_row;
    const int i = (rem - r * per_row) * V;
    const int b = Decode ? t : t / a.S;
    const int s = Decode ? 0 : t - b * a.S;
    const bool is_q = r < q_rows;
    const bool is_k = !is_q && r < q_rows + a.Hkv;
    const int h = is_q ? r : is_k ? r - q_rows : r - q_rows - a.Hkv;

    const T* src;
    T* out = nullptr;   // the rotated row's own output
    T* pool = nullptr;  // the row in the pool, or none
    if (is_q) {
      src = static_cast<const T*>(a.q) + b * a.q_sb + s * a.q_ss + h * a.q_sh;
      out = static_cast<T*>(a.q_out) + ((size_t)t * a.H + h) * a.dh;
    } else {
      const int pos = Decode ? a.kv_len[b] : s;
      int page = -1;
      if (pos >= 0 && pos / a.ps < a.pt_cols)
        page = a.page_table[(size_t)b * a.pt_cols + pos / a.ps];
      const size_t row = (((size_t)h * a.P + page) * a.ps + pos % a.ps) * a.dh;
      const bool in_pool = page >= 0 && page < a.P;
      if (is_k) {
        src = static_cast<const T*>(a.k) + b * a.k_sb + s * a.k_ss + h * a.k_sh;
        if (Rope && !Decode) out = static_cast<T*>(a.k_out) + ((size_t)t * a.Hkv + h) * a.dh;
        if (in_pool) pool = static_cast<T*>(a.kp) + row;
      } else {
        src = static_cast<const T*>(a.v) + b * a.v_sb + s * a.v_ss + h * a.v_sh;
        if (in_pool) pool = static_cast<T*>(a.vp) + row;
      }
    }

    if constexpr (!Rope) {
      Piece<T, V> x;
      x.load(src + i);
      if (pool != nullptr) x.store(pool + i);
    } else {
      Piece<T, V> x1, x2;
      x1.load(src + i);
      x2.load(src + half + i);
      if (is_q || is_k) {
        Piece<uint32_t, V> c, sn;
        c.load(reinterpret_cast<const uint32_t*>(a.cos + b * a.c_sb + s * a.c_ss + i));
        sn.load(reinterpret_cast<const uint32_t*>(a.sin + b * a.c_sb + s * a.c_ss + i));
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float cj = __uint_as_float(c.e[j]), sj = __uint_as_float(sn.e[j]);
          const float u = widen<F>(x1.e[j]), w = widen<F>(x2.e[j]);
          x1.e[j] = narrow<F, T>(__fsub_rn(__fmul_rn(u, cj), __fmul_rn(w, sj)));
          x2.e[j] = narrow<F, T>(__fadd_rn(__fmul_rn(w, cj), __fmul_rn(u, sj)));
        }
      }
      if (out != nullptr) {
        x1.store(out + i);
        x2.store(out + half + i);
      }
      if (pool != nullptr) {
        x1.store(pool + i);
        x2.store(pool + half + i);
      }
    }
  }
}

int grid_for(long long n) {
  const long long blocks = (n + THREADS - 1) / THREADS;
  return static_cast<int>(blocks < 65535 * 16 ? blocks : 65535 * 16);
}

long long n_items(const WriteArgs& a, bool rope, bool decode, int v) {
  const long long per_row = (rope ? a.dh / 2 : a.dh) / v;
  return (long long)a.B * (decode ? 1 : a.S) * ((rope ? a.H : 0) + 2 * a.Hkv) * per_row;
}

// vec: 1 for one element an item, else 16 bytes of elements (the host checks
// the alignment of every row and piece)
template <typename T, int F, bool Decode>
int launch(const WriteArgs& a, int vec, cudaStream_t st) {
  constexpr int W = 16 / sizeof(T);
  if (vec != 1 && vec != W) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = n_items(a, F != RAW, Decode, vec);
  if (n == 0) return 0;
  if (n >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (vec == 1)
    page_write_kernel<T, F, Decode, 1><<<grid_for(n), THREADS, 0, st>>>(a);
  else
    page_write_kernel<T, F, Decode, W><<<grid_for(n), THREADS, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool Decode>
int dispatch(const WriteArgs& a, int fmt, int elem_bytes, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case RAW:
      if (elem_bytes == 2) return launch<uint16_t, RAW, Decode>(a, vec, st);
      if (elem_bytes == 4) return launch<uint32_t, RAW, Decode>(a, vec, st);
      break;
    case BF16: return launch<uint16_t, BF16, Decode>(a, vec, st);
    case F16: return launch<uint16_t, F16, Decode>(a, vec, st);
    case F32: return launch<uint32_t, F32, Decode>(a, vec, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

WriteArgs plain_args(const void* kn, const void* vn, void* kp, void* vp, const void* page_table,
                     int pt_cols, const void* kv_len, int B, int S, int Hkv, int dh, int P,
                     int ps) {
  WriteArgs a{};
  a.k = kn;
  a.v = vn;
  a.kp = kp;
  a.vp = vp;
  a.page_table = static_cast<const int*>(page_table);
  a.kv_len = static_cast<const int*>(kv_len);
  a.k_sh = a.v_sh = dh;
  a.k_ss = a.v_ss = (long long)Hkv * dh;
  a.k_sb = a.v_sb = (long long)S * Hkv * dh;
  a.B = B;
  a.S = S;
  a.Hkv = Hkv;
  a.dh = dh;
  a.P = P;
  a.ps = ps;
  a.pt_cols = pt_cols;
  return a;
}

// strides: q (b, s, h), k (b, s, h), v (b, s, h), cos and sin (b, s), in elements
WriteArgs rope_args(const void* q, const void* k, const void* v, void* q_out, void* k_out,
                    void* kp, void* vp, const void* page_table, int pt_cols, const void* kv_len,
                    const void* cos, const void* sin, const long long* st, int B, int S, int H,
                    int Hkv, int dh, int P, int ps) {
  WriteArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.q_out = q_out;
  a.k_out = k_out;
  a.kp = kp;
  a.vp = vp;
  a.page_table = static_cast<const int*>(page_table);
  a.kv_len = static_cast<const int*>(kv_len);
  a.cos = static_cast<const float*>(cos);
  a.sin = static_cast<const float*>(sin);
  a.q_sb = st[0], a.q_ss = st[1], a.q_sh = st[2];
  a.k_sb = st[3], a.k_ss = st[4], a.k_sh = st[5];
  a.v_sb = st[6], a.v_ss = st[7], a.v_sh = st[8];
  a.c_sb = st[9], a.c_ss = st[10];
  a.B = B;
  a.S = S;
  a.H = H;
  a.Hkv = Hkv;
  a.dh = dh;
  a.P = P;
  a.ps = ps;
  a.pt_cols = pt_cols;
  return a;
}

}  // namespace

// The writes alone, k/v contiguous.  elem_bytes: 2 (bf16/f16) or 4 (f32);
// vec: 1, or 16 / elem_bytes.  Returns the cudaError_t of the launch.
extern "C" int kv_write_prompt(const void* kn, const void* vn, void* kp, void* vp,
                               const void* page_table, int pt_cols, int B, int S, int Hkv,
                               int dh, int P, int ps, int elem_bytes, int vec, void* stream) {
  const WriteArgs a = plain_args(kn, vn, kp, vp, page_table, pt_cols, nullptr, B, S, Hkv, dh, P, ps);
  return dispatch<false>(a, RAW, elem_bytes, vec, stream);
}

extern "C" int kv_append(const void* kn, const void* vn, void* kp, void* vp,
                         const void* page_table, int pt_cols, const void* kv_len, int B, int Hkv,
                         int dh, int P, int ps, int elem_bytes, int vec, void* stream) {
  const WriteArgs a = plain_args(kn, vn, kp, vp, page_table, pt_cols, kv_len, B, 1, Hkv, dh, P, ps);
  return dispatch<true>(a, RAW, elem_bytes, vec, stream);
}

// The writes with the rotation.  fmt: 1 bf16, 2 f16, 3 f32; vec as above.
extern "C" int kv_rope_write_prompt(const void* q, const void* k, const void* v, void* q_out,
                                    void* k_out, void* kp, void* vp, const void* page_table,
                                    int pt_cols, const void* cos, const void* sin,
                                    const long long* strides, int B, int S, int H, int Hkv,
                                    int dh, int P, int ps, int fmt, int vec, void* stream) {
  if (fmt == RAW || dh % 2) return static_cast<int>(cudaErrorInvalidValue);
  const WriteArgs a = rope_args(q, k, v, q_out, k_out, kp, vp, page_table, pt_cols, nullptr, cos,
                                sin, strides, B, S, H, Hkv, dh, P, ps);
  return dispatch<false>(a, fmt, fmt == F32 ? 4 : 2, vec, stream);
}

extern "C" int kv_rope_append(const void* q, const void* k, const void* v, void* q_out,
                              void* kp, void* vp, const void* page_table, int pt_cols,
                              const void* kv_len, const void* cos, const void* sin,
                              const long long* strides, int B, int H, int Hkv, int dh, int P,
                              int ps, int fmt, int vec, void* stream) {
  if (fmt == RAW || dh % 2) return static_cast<int>(cudaErrorInvalidValue);
  const WriteArgs a = rope_args(q, k, v, q_out, nullptr, kp, vp, page_table, pt_cols, kv_len, cos,
                                sin, strides, B, 1, H, Hkv, dh, P, ps);
  return dispatch<true>(a, fmt, fmt == F32 ? 4 : 2, vec, stream);
}
