// SS-SUB ripple over secret-shared bit planes, F_p with p = 2^31 - 1
// (paper §3.4, Algorithm 6). For every lane (one share of one subtraction
// of one tuple) k consecutive bit positions chain in registers:
//
//     ai = 1 - a_j          ab = ai * b_j          s = ai + b_j
//     x  = s - 2 ab         cx = carry * x
//     rb = x + carry - 2 cx             carry' = ab + cx          (mod p)
//
// With init set, step 0 is the LSB two's-complement step instead:
// carry = s - ab, rb = s - 2 carry (the incoming carry is not read). Only
// the final (rb, carry') pair is written.
//
// Replaces the Pallas TPU kernels src/repro/kernels/ripple.py:113
// ripple_segment_pallas (_ripple_segment_kernel) and, at k = 1,
// src/repro/kernels/ripple.py:66 ripple_carry_pallas (_ripple_kernel).
//
// What bounds it on an H100: device-memory bytes. A lane reads 2k + 1
// words and writes 2, and does about 15 integer operations per bit step,
// far below the card's operations-per-byte line.
//
// Design (simple and right first): one thread per lane. Lanes are a
// (d0, d1, d2) grid and every operand is read through its own strides --
// three lane strides and a bit stride -- so a per-segment slice
// [..., s0:s1], a per-shard slice of the tuple axis and a column broadcast
// across the batch (stride 0) reach the kernel without a copy. blockIdx.y
// walks the (d0, d1) rows, x-blocks and threads the d2 (tuple) axis; both
// loops are grid-stride with 64-bit indices. The carry stays in a register
// across the k steps; rb and carry' are written contiguous, in lane order.
//
// Arithmetic: the TPU kernel splits operands into 16-bit limbs for its
// 32-bit lanes. Hopper multiplies 32x32->64 natively; the product folds
// twice (Mersenne) and one conditional subtract makes it canonical, as the
// plain version's field ops do, so the results are bit-identical.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kP = 2147483647u;
constexpr int kThreads = 256;
constexpr long long kMaxBlocksX = 1ll << 20;
constexpr long long kMaxBlocksY = 65535;

__device__ __forceinline__ uint32_t add_p(uint32_t x, uint32_t y) {
  const uint32_t s = x + y;  // < 2^32 for x, y < p
  return s >= kP ? s - kP : s;
}

__device__ __forceinline__ uint32_t sub_p(uint32_t x, uint32_t y) {
  return x >= y ? x - y : x + (kP - y);
}

__device__ __forceinline__ uint32_t mul_p(uint32_t x, uint32_t y) {
  uint64_t v = static_cast<uint64_t>(x) * y;  // < 2^62
  v = (v & kP) + (v >> 31);                   // < 2^32
  v = (v & kP) + (v >> 31);                   // <= p + 1
  return static_cast<uint32_t>(v >= kP ? v - kP : v);
}

struct Operand {
  const uint32_t* ptr;
  long long s0, s1, s2, sk;  // lane strides (d0, d1, d2) and bit stride
};

__global__ void __launch_bounds__(kThreads)
ripple_segment_kernel(Operand a, Operand b, Operand c,
                      uint32_t* __restrict__ rb_out,
                      uint32_t* __restrict__ carry_out,
                      long long d1, long long d2, long long rows, int k,
                      int init) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const long long i0 = r / d1;
    const long long i1 = r - i0 * d1;
    const uint32_t* a_row = a.ptr + i0 * a.s0 + i1 * a.s1;
    const uint32_t* b_row = b.ptr + i0 * b.s0 + i1 * b.s1;
    const uint32_t* c_row = init ? nullptr : c.ptr + i0 * c.s0 + i1 * c.s1;
    for (long long i2 = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
         i2 < d2; i2 += step) {
      const uint32_t* pa = a_row + i2 * a.s2;
      const uint32_t* pb = b_row + i2 * b.s2;
      uint32_t carry = init ? 0u : __ldg(c_row + i2 * c.s2);
      uint32_t rb = carry;
      for (int j = 0; j < k; ++j) {
        const uint32_t bv = __ldg(pb + j * b.sk);
        const uint32_t ai = sub_p(1u, __ldg(pa + j * a.sk));
        const uint32_t ab = mul_p(ai, bv);
        const uint32_t s = add_p(ai, bv);
        if (init && j == 0) {
          carry = sub_p(s, ab);
          rb = sub_p(s, add_p(carry, carry));
        } else {
          const uint32_t x = sub_p(s, add_p(ab, ab));
          const uint32_t cx = mul_p(carry, x);
          rb = sub_p(add_p(x, carry), add_p(cx, cx));
          carry = add_p(ab, cx);
        }
      }
      const long long o = r * d2 + i2;
      rb_out[o] = rb;
      carry_out[o] = carry;
    }
  }
}

}  // namespace

// dims:      host int64[3], the lane grid (d0, d1, d2)
// a_strides, b_strides, c_strides: host int64[4], (s0, s1, s2, bit stride)
//            in elements; c (the incoming carry) is not read when init != 0
// rb, carry_out: device uint32[d0 * d1 * d2], written in lane order
extern "C" int ripple_segment_u32(const void* a, const long long* a_strides,
                                  const void* b, const long long* b_strides,
                                  const void* c, const long long* c_strides,
                                  void* rb, void* carry_out,
                                  const long long* dims, int k, int init,
                                  void* stream) {
  const long long rows = dims[0] * dims[1];
  if (rows <= 0 || dims[2] <= 0 || k <= 0) return 0;
  const Operand oa{static_cast<const uint32_t*>(a), a_strides[0],
                   a_strides[1], a_strides[2], a_strides[3]};
  const Operand ob{static_cast<const uint32_t*>(b), b_strides[0],
                   b_strides[1], b_strides[2], b_strides[3]};
  const Operand oc{static_cast<const uint32_t*>(c), c_strides[0],
                   c_strides[1], c_strides[2], c_strides[3]};
  long long bx = (dims[2] + kThreads - 1) / kThreads;
  if (bx > kMaxBlocksX) bx = kMaxBlocksX;
  const long long by = rows < kMaxBlocksY ? rows : kMaxBlocksY;
  dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(by));
  ripple_segment_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      oa, ob, oc, static_cast<uint32_t*>(rb),
      static_cast<uint32_t*>(carry_out), dims[1], dims[2], rows, k, init);
  return static_cast<int>(cudaGetLastError());
}
