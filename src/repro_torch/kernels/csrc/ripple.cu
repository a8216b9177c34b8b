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
// The TPU kernels take (k, N) planes: the reference moveaxis-es the bit
// position onto the sublane axis before the call (repro/kernels/ops.py).
//
// What bounds it on an H100: device-memory bytes. A lane reads 2k + 1
// words and writes 2, and does about 15 integer operations per bit step,
// far below the card's operations-per-byte line. So the design is about
// how the planes lie in memory. Lanes are a (d0, d1, d2) grid, every
// operand read through its own strides (a per-segment slice [..., s0:s1],
// a per-shard slice of the tuple axis, a column broadcast across the
// batch with stride 0 reach the kernel without a copy). The launcher's
// pure-Python plan (kernels/ripple.py::plan) picks one of two routes:
//
// * bit-major (lane stride 1, every bit plane and row 16-byte aligned):
//   the layout the range engine and the MIN/MAX tournament build
//   (ripple.py::bit_major, the reference's moveaxis). A thread covers 4
//   consecutive lanes of one row and issues all 2k 16-byte plane loads
//   before the carry chain (k a template parameter for the paths' k = 1,
//   5, 8, 13; a loop otherwise). Blocks walk (row, 1,024-lane tile) pairs
//   in a persistent grid; the ragged end of a row loads and stores 4-byte
//   words. Every byte loaded is a byte the bound counts, so the floor is
//   the bound itself. A carry or output row that is not 16-byte aligned
//   (an odd tournament level) moves in 4-byte words, still coalesced.
// * strided (anything else: interleaved (..., t) rows, bases, strides or
//   shard offsets off 16-byte bounds): one thread per lane, each bit a
//   4-byte __ldg through the strides. Lanes a row of t words apart put
//   each word of a warp's load in its own sector, so on interleaved rows
//   its floor is the rows' footprint, not the counted bytes. The plan
//   picks it openly; it is not a failover.
//
// Arithmetic: the TPU kernel splits operands into 16-bit limbs for its
// 32-bit lanes. Hopper multiplies 32x32->64 natively; the product folds
// twice (Mersenne) and one conditional subtract makes it canonical, as the
// plain version's field ops do, so the results are bit-identical on every
// route.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kP = 2147483647u;
constexpr int kThreads = 256;
constexpr int kVecLanes = 4;           // lanes a bit-major thread covers
constexpr long long kVecTile = kThreads * kVecLanes;
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

// One bit step of one lane; lsb selects the two's-complement first step.
__device__ __forceinline__ void step(uint32_t av, uint32_t bv, bool lsb,
                                     uint32_t& carry, uint32_t& rb) {
  const uint32_t ai = sub_p(1u, av);
  const uint32_t ab = mul_p(ai, bv);
  const uint32_t s = add_p(ai, bv);
  if (lsb) {
    carry = sub_p(s, ab);
    rb = sub_p(s, add_p(carry, carry));
  } else {
    const uint32_t x = sub_p(s, add_p(ab, ab));
    const uint32_t cx = mul_p(carry, x);
    rb = sub_p(add_p(x, carry), add_p(cx, cx));
    carry = add_p(ab, cx);
  }
}

struct Operand {
  const uint32_t* ptr;
  long long s0, s1, s2, sk;  // lane strides (d0, d1, d2) and bit stride
};

__device__ __forceinline__ const uint32_t* row_ptr(const Operand& o,
                                                   long long i0,
                                                   long long i1) {
  return o.ptr + i0 * o.s0 + i1 * o.s1;
}

// ---------------------------------------------------------------------------
// strided route: one thread per lane, 4-byte loads through the strides
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
ripple_strided_kernel(Operand a, Operand b, Operand c,
                      uint32_t* __restrict__ rb_out,
                      uint32_t* __restrict__ carry_out,
                      long long d1, long long d2, long long rows, int k,
                      int init) {
  const long long step_x = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const long long i0 = r / d1;
    const long long i1 = r - i0 * d1;
    const uint32_t* a_row = row_ptr(a, i0, i1);
    const uint32_t* b_row = row_ptr(b, i0, i1);
    const uint32_t* c_row = init ? nullptr : row_ptr(c, i0, i1);
    for (long long i2 = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
         i2 < d2; i2 += step_x) {
      const uint32_t* pa = a_row + i2 * a.s2;
      const uint32_t* pb = b_row + i2 * b.s2;
      uint32_t carry = init ? 0u : __ldg(c_row + i2 * c.s2);
      uint32_t rb = carry;
      for (int j = 0; j < k; ++j)
        step(__ldg(pa + j * a.sk), __ldg(pb + j * b.sk), init && j == 0,
             carry, rb);
      const long long o = r * d2 + i2;
      rb_out[o] = rb;
      carry_out[o] = carry;
    }
  }
}

// ---------------------------------------------------------------------------
// bit-major route: 4 lanes a thread, 16-byte plane loads, all issued first
// ---------------------------------------------------------------------------

struct Lanes4 {
  uint32_t v[4];
};

// `valid` lanes from p (at most 4): one 16-byte load when all 4 are valid
// and vec is set, else 4-byte loads (zeros past the end).
__device__ __forceinline__ Lanes4 load4(const uint32_t* p, long long valid,
                                        bool vec) {
  Lanes4 r;
  if (vec && valid >= kVecLanes) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    r.v[0] = q.x;
    r.v[1] = q.y;
    r.v[2] = q.z;
    r.v[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < kVecLanes; ++i) r.v[i] = i < valid ? __ldg(p + i) : 0u;
  }
  return r;
}

__device__ __forceinline__ void store4(uint32_t* p, const Lanes4& x,
                                       long long valid, bool vec) {
  if (vec && valid >= kVecLanes) {
    *reinterpret_cast<uint4*>(p) = make_uint4(x.v[0], x.v[1], x.v[2], x.v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < kVecLanes; ++i)
      if (i < valid) p[i] = x.v[i];
  }
}

__device__ __forceinline__ void step4(const Lanes4& av, const Lanes4& bv,
                                      bool lsb, Lanes4& carry, Lanes4& rb) {
#pragma unroll
  for (int i = 0; i < kVecLanes; ++i)
    step(av.v[i], bv.v[i], lsb, carry.v[i], rb.v[i]);
}

// K > 0: k == K, loads unrolled and issued before the chain; K == 0: any k.
template <int K>
__global__ void __launch_bounds__(kThreads)
ripple_bit_major_kernel(Operand a, Operand b, Operand c,
                        uint32_t* __restrict__ rb_out,
                        uint32_t* __restrict__ carry_out,
                        long long d1, long long d2, long long rows, int k,
                        int init, int vec_c, int vec_out) {
  const long long per_row = (d2 + kVecTile - 1) / kVecTile;
  const long long tiles = rows * per_row;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long r = tile / per_row;
    const long long l0 =
        (tile - r * per_row) * kVecTile + kVecLanes * threadIdx.x;
    const long long valid = d2 - l0;
    if (valid <= 0) continue;
    const long long i0 = r / d1;
    const long long i1 = r - i0 * d1;
    const uint32_t* pa = row_ptr(a, i0, i1) + l0;
    const uint32_t* pb = row_ptr(b, i0, i1) + l0;
    Lanes4 carry = {{0u, 0u, 0u, 0u}};
    if (!init) carry = load4(row_ptr(c, i0, i1) + l0, valid, vec_c);
    Lanes4 rb = carry;
    if constexpr (K > 0) {
      Lanes4 av[K], bv[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        av[j] = load4(pa + j * a.sk, valid, true);
        bv[j] = load4(pb + j * b.sk, valid, true);
      }
#pragma unroll
      for (int j = 0; j < K; ++j)
        step4(av[j], bv[j], init && j == 0, carry, rb);
    } else {
      for (int j = 0; j < k; ++j)
        step4(load4(pa + j * a.sk, valid, true),
              load4(pb + j * b.sk, valid, true), init && j == 0, carry, rb);
    }
    const long long o = r * d2 + l0;
    store4(rb_out + o, rb, valid, vec_out);
    store4(carry_out + o, carry, valid, vec_out);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

struct Args {
  Operand a, b, c;
  uint32_t* rb;
  uint32_t* carry;
  long long d1, d2, rows;
  int k, init;
  cudaStream_t stream;
};

// A persistent grid: as many blocks as fit on the current device at once
// (its SM count asked at each launch, the occupancy calculator once per
// kernel and device: the launcher makes the operands' device current, and
// a host may hold several cards), at most one a tile.
long long persistent_blocks(const void* kernel, long long tiles) {
  struct Seen {
    const void* kernel;
    int dev;
    int per_sm;
  };
  static Seen seen[64];
  static int n_seen = 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].kernel == kernel && seen[i].dev == dev)
      per_sm = seen[i].per_sm;
  if (per_sm == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                  0);
    if (per_sm < 1) per_sm = 1;
    if (n_seen < 64) seen[n_seen++] = {kernel, dev, per_sm};
  }
  const long long cap = static_cast<long long>(sms) * per_sm;
  return tiles < cap ? tiles : cap;
}

int launch_strided(const Args& x) {
  long long bx = (x.d2 + kThreads - 1) / kThreads;
  if (bx > kMaxBlocksX) bx = kMaxBlocksX;
  const long long by = x.rows < kMaxBlocksY ? x.rows : kMaxBlocksY;
  dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(by));
  ripple_strided_kernel<<<grid, kThreads, 0, x.stream>>>(
      x.a, x.b, x.c, x.rb, x.carry, x.d1, x.d2, x.rows, x.k, x.init);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_bit_major(const Args& x, int vec_c, int vec_out) {
  const long long tiles = x.rows * ((x.d2 + kVecTile - 1) / kVecTile);
  const long long blocks = persistent_blocks(
      reinterpret_cast<const void*>(ripple_bit_major_kernel<K>), tiles);
  ripple_bit_major_kernel<K>
      <<<static_cast<unsigned>(blocks), kThreads, 0, x.stream>>>(
      x.a, x.b, x.c, x.rb, x.carry, x.d1, x.d2, x.rows, x.k, x.init, vec_c,
      vec_out);
  return static_cast<int>(cudaGetLastError());
}

int launch_bit_major_k(const Args& x, int vec_c, int vec_out) {
  switch (x.k) {
    case 1: return launch_bit_major<1>(x, vec_c, vec_out);
    case 5: return launch_bit_major<5>(x, vec_c, vec_out);
    case 8: return launch_bit_major<8>(x, vec_c, vec_out);
    case 13: return launch_bit_major<13>(x, vec_c, vec_out);
    default: return launch_bit_major<0>(x, vec_c, vec_out);
  }
}

Operand operand(const void* p, const long long* s) {
  return {static_cast<const uint32_t*>(p), s[0], s[1], s[2], s[3]};
}

}  // namespace

// dims:      host int64[3], the lane grid (d0, d1, d2)
// a_strides, b_strides, c_strides: host int64[4], (s0, s1, s2, bit stride)
//            in elements; c (the incoming carry) is not read when init != 0
// rb, carry_out: device uint32[d0 * d1 * d2], written in lane order
// route:     0 strided, 1 bit-major (the launch plan of kernels/ripple.py
//            checks the bit-major route's conditions)
// vec_c, vec_out: bit-major route: the carry rows, the output rows are
//            16-byte aligned (else they move in 4-byte words)
extern "C" int ripple_segment_u32(const void* a, const long long* a_strides,
                                  const void* b, const long long* b_strides,
                                  const void* c, const long long* c_strides,
                                  void* rb, void* carry_out,
                                  const long long* dims, int k, int init,
                                  int route, int vec_c, int vec_out,
                                  void* stream) {
  const long long rows = dims[0] * dims[1];
  if (rows <= 0 || dims[2] <= 0 || k <= 0) return 0;
  const Args x{operand(a, a_strides), operand(b, b_strides),
               operand(c, c_strides), static_cast<uint32_t*>(rb),
               static_cast<uint32_t*>(carry_out), dims[1], dims[2], rows, k,
               init, static_cast<cudaStream_t>(stream)};
  switch (route) {
    case 0: return launch_strided(x);
    case 1: return launch_bit_major_k(x, vec_c, vec_out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
