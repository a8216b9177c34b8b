// Fused degree-1 one-hot share generation over F_p, p = 2^31 - 1: the
// user-side sharing step of the oblivious embedding lookup (paper §3.2.1 as
// an LM layer). For c clouds, M token rows and a vocabulary of V ids,
//
//     out[k, i, v] = [v == tok_i] + a1[i, v] * (k + 1)        (mod p)
//
// the share at x_k = k + 1 of the degree-1 polynomial onehot_i + a1_i * x.
// A token outside [0, V) (the -1 padding, or any int64 id past V) gives an
// all-zero one-hot row. The plaintext one-hot never reaches device memory.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ss_matmul.py:186
// share_onehot_pallas (_share_onehot_kernel).
//
// What bounds it on an H100: device-memory bytes. It reads a1 once
// (4 M V bytes) and writes c times as much, with one add per output word
// and nothing reused, so the only gains are fewer transactions and fewer
// launches.
//
// Design. Each cloud's output plane out[k] is one flat run of n = M V
// words, and so is a1 when it is contiguous. The launch plan
// (kernels/ss_matmul.py onehot_plan) picks one of two routes:
//   * quad (every main-path shape): a1 contiguous, both bases 16-byte
//     aligned, n % 4 == 0. Thread q owns words 4q..4q+3 of the flat plane
//     whatever the row: one 16-byte load of a1, the one-hot bits from the
//     rows the quad touches (one division for the first word's row; a
//     quad crosses into the next row when V % 4 != 0, and spans several
//     rows when V < 4), then c 16-byte stores with s += a1 (mod p) between
//     clouds. Neighbouring threads take neighbouring 16-byte quads, so a
//     warp's load or store is 512 contiguous bytes for any V. One quad a
//     thread and streaming (evict-first) stores measured fastest on the
//     H100 at M = 256 and 2,048 (PERF.md §6), against 2 or 4 quads a
//     thread and plain stores.
//   * word (anything else: a strided or offset a1 view, n % 4 != 0, an
//     unaligned base): one word a thread, consecutive threads on
//     consecutive words, kWords words a thread unrolled; a1 is read
//     through both strides, so no view is copied.
// Token ids are read as int64 in the kernel and range-tested there: in
// flat addressing a token equal to V or -1 would otherwise mark a word of
// the next or the previous row. Word indices are 64-bit (c M V passes
// 2^31); while a plane holds under 2^32 words the row is a 32-bit
// division.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kP = 2147483647u;
constexpr int kThreads = 256;
constexpr int kWords = 4;

__device__ __forceinline__ uint32_t add_p(uint32_t x, uint32_t y) {
  const uint32_t s = x + y;  // < 2^32 for x, y < p
  return s >= kP ? s - kP : s;
}

__device__ __forceinline__ uint4 add_p4(uint4 x, uint4 y) {
  return make_uint4(add_p(x.x, y.x), add_p(x.y, y.y), add_p(x.z, y.z),
                    add_p(x.w, y.w));
}

__device__ __forceinline__ long long row_of(long long w, long long v,
                                            bool narrow) {
  return narrow ? static_cast<long long>(static_cast<uint32_t>(w) /
                                         static_cast<uint32_t>(v))
                : w / v;
}

// Bit j set iff word w + j of the flat plane is its row's hot word: every
// row whose span meets [w, w + 4) is tested (one or two rows for V >= 4).
__device__ __forceinline__ uint32_t hot_bits(const long long* __restrict__ tok,
                                             long long tok_stride, long long w,
                                             long long v, bool narrow) {
  long long r = row_of(w, v, narrow);
  uint32_t bits = 0;
  for (long long start = r * v; start < w + 4; start += v, ++r) {
    const long long t = __ldg(tok + r * tok_stride);
    if (t >= 0 && t < v) {
      const long long h = start + t - w;  // t's word, relative to w
      if (h >= 0 && h < 4) bits |= 1u << h;
    }
  }
  return bits;
}

__global__ void __launch_bounds__(kThreads)
onehot_quad_kernel(const long long* __restrict__ tok, long long tok_stride,
                   const uint4* __restrict__ a1, uint4* __restrict__ out,
                   long long n, long long v, int c, bool narrow) {
  const long long nq = n / 4;
  const long long q =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (q >= nq) return;
  const uint4 a = __ldg(a1 + q);
  const uint32_t b = hot_bits(tok, tok_stride, 4 * q, v, narrow);
  uint4 s = make_uint4(add_p(a.x, b & 1u), add_p(a.y, (b >> 1) & 1u),
                       add_p(a.z, (b >> 2) & 1u), add_p(a.w, b >> 3));
  for (int k = 0; k < c; ++k) {
    __stcs(out + k * nq + q, s);  // streamed: nothing here is read again
    s = add_p4(s, a);
  }
}

__global__ void __launch_bounds__(kThreads)
onehot_word_kernel(const long long* __restrict__ tok, long long tok_stride,
                   const uint32_t* __restrict__ a1, long long row_stride,
                   long long col_stride, uint32_t* __restrict__ out,
                   long long n, long long v, int c, bool narrow) {
  const long long w0 =
      static_cast<long long>(blockIdx.x) * (kThreads * kWords) + threadIdx.x;
  uint32_t a[kWords];
  long long col[kWords], row[kWords];
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const long long w = w0 + j * kThreads;
    row[j] = row_of(w < n ? w : 0, v, narrow);
    col[j] = w - row[j] * v;
    if (w < n) a[j] = __ldg(a1 + row[j] * row_stride + col[j] * col_stride);
  }
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const long long w = w0 + j * kThreads;
    if (w < n) {
      const long long t = __ldg(tok + row[j] * tok_stride);
      uint32_t s = add_p(a[j], t == col[j] ? 1u : 0u);  // col in [0, V)
      for (int k = 0; k < c; ++k) {
        __stcs(out + k * n + w, s);
        s = add_p(s, a[j]);
      }
    }
  }
}

}  // namespace

// tok: device int64 token ids, element stride tok_stride (outside [0, v)
//      -> a zero one-hot row)
// a1: device uint32 (m, v) coefficients in [0, p), element strides
//     (a1_row_stride, a1_col_stride)
// out: device uint32[c, m, v] contiguous
// route: 1 quad (a1 flat-contiguous, a1 and out 16-byte aligned,
//        m v % 4 == 0; cudaErrorInvalidValue otherwise), 0 word
extern "C" int share_onehot_u32(const void* tok, long long tok_stride,
                                const void* a1, long long a1_row_stride,
                                long long a1_col_stride, void* out, int m,
                                long long v, int c, int route, void* stream) {
  if (m <= 0 || v <= 0 || c <= 0) return 0;
  const long long n = static_cast<long long>(m) * v;
  const bool narrow = n <= 0xFFFFFFFFLL;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const long long*>(tok);
  if (route == 1) {
    const bool flat = (m == 1 || a1_row_stride == v) &&
                      (v == 1 || a1_col_stride == 1);
    if (!flat || n % 4 != 0 || reinterpret_cast<uintptr_t>(a1) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(out) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const long long blocks = (n / 4 + kThreads - 1) / kThreads;
    if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
    onehot_quad_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        t, tok_stride, static_cast<const uint4*>(a1),
        static_cast<uint4*>(out), n, v, c, narrow);
  } else {
    const long long blocks = (n + kThreads * kWords - 1) / (kThreads * kWords);
    if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
    onehot_word_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        t, tok_stride, static_cast<const uint32_t*>(a1), a1_row_stride,
        a1_col_stride, static_cast<uint32_t*>(out), n, v, c, narrow);
  }
  return static_cast<int>(cudaGetLastError());
}
