// Fused degree-1 one-hot share generation over F_p, p = 2^31 - 1: the
// user-side sharing step of the oblivious embedding lookup (paper §3.2.1 as
// an LM layer). For c clouds, M token rows and a vocabulary of V ids,
//
//     out[k, i, v] = [v == tok_i] + a1[i, v] * (k + 1)        (mod p)
//
// the share at x_k = k + 1 of the degree-1 polynomial onehot_i + a1_i * x.
// A token outside [0, V) (the -1 padding) gives an all-zero one-hot row.
// The plaintext one-hot never reaches device memory.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ss_matmul.py:186
// share_onehot_pallas (_share_onehot_kernel).
//
// What bounds it on an H100: device-memory bytes. It reads a1 once
// (4 M V bytes) and writes c times as much, with one add per output word.
//
// Design (simple and right first): one block per (token row, vocabulary
// tile) and four consecutive vocabulary ids per thread. The token is read
// once per block; a1[i, v:v+4] comes in one 16-byte load where the row is
// 16-byte aligned and V % 4 == 0, else in scalar loads. The shares follow
// without a multiply: s = onehot + a1, then s += a1 (mod p) for each
// further cloud, every step one coalesced 16-byte store to
// out[k, i, v:v+4]. The Pallas grid's (bm, bv) blocks are not carried over.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kP = 2147483647u;
constexpr int kThreads = 256;
constexpr long long kMaxBlocksY = 65535;

__device__ __forceinline__ uint32_t add_p(uint32_t x, uint32_t y) {
  const uint32_t s = x + y;  // < 2^32 for x, y < p
  return s >= kP ? s - kP : s;
}

__global__ void __launch_bounds__(kThreads)
share_onehot_kernel(const int* __restrict__ tok,
                    const uint32_t* __restrict__ a1, long long a1_stride,
                    uint32_t* __restrict__ out, int m, long long v, int c,
                    int vec) {
  const long long v0 =
      4 * (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x);
  if (v0 >= v) return;
  const long long cloud_stride = static_cast<long long>(m) * v;
  for (long long i = blockIdx.y; i < m; i += gridDim.y) {
    const long long t = __ldg(tok + i);
    const uint32_t* a_row = a1 + i * a1_stride + v0;
    uint32_t* o = out + i * v + v0;
    if (vec && v0 + 4 <= v) {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(a_row));
      uint4 s;
      s.x = add_p(a.x, t == v0 ? 1u : 0u);
      s.y = add_p(a.y, t == v0 + 1 ? 1u : 0u);
      s.z = add_p(a.z, t == v0 + 2 ? 1u : 0u);
      s.w = add_p(a.w, t == v0 + 3 ? 1u : 0u);
      for (int k = 0; k < c; ++k) {
        *reinterpret_cast<uint4*>(o + k * cloud_stride) = s;
        s.x = add_p(s.x, a.x);
        s.y = add_p(s.y, a.y);
        s.z = add_p(s.z, a.z);
        s.w = add_p(s.w, a.w);
      }
    } else {
      const int len = v - v0 < 4 ? static_cast<int>(v - v0) : 4;
      for (int j = 0; j < len; ++j) {
        const uint32_t a = __ldg(a_row + j);
        uint32_t s = add_p(a, t == v0 + j ? 1u : 0u);
        for (int k = 0; k < c; ++k) {
          o[k * cloud_stride + j] = s;
          s = add_p(s, a);
        }
      }
    }
  }
}

}  // namespace

// tok: device int32[m] token ids (outside [0, v) -> a zero one-hot row)
// a1: device uint32 rows of v coefficients in [0, p), row stride a1_stride
//     elements (unit stride along v)
// out: device uint32[c, m, v] contiguous
extern "C" int share_onehot_u32(const void* tok, const void* a1,
                                long long a1_stride, void* out, int m,
                                long long v, int c, void* stream) {
  if (m <= 0 || v <= 0 || c <= 0) return 0;
  const bool vec = v % 4 == 0 && a1_stride % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(a1) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long quads = (v + 3) / 4;
  const long long bx = (quads + kThreads - 1) / kThreads;
  const long long by = m < kMaxBlocksY ? m : kMaxBlocksY;
  dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(by));
  share_onehot_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tok), static_cast<const uint32_t*>(a1),
      a1_stride, static_cast<uint32_t*>(out), m, v, c, vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}
