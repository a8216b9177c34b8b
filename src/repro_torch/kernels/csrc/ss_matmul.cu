// Share-space matrix product over F_p, p = 2^31 - 1, on Hopper's int8
// tensor cores:
//
//     out[z] = a[z] (M x K) @ b[z] (K x N)  mod p,   z < batch (the clouds)
//
// Two entry points share one device body. ss_matmul_u32 replaces the Pallas
// TPU kernel src/repro/kernels/ss_matmul.py:87 ss_matmul_pallas
// (_ss_matmul_kernel :66); ss_matmul_tall_u32 replaces its tall-skinny
// tiling ss_matmul_tall_pallas (:145) and takes every shape that
// is_tall_skinny accepts (M <= 256, K >= 1024, K >= 8 max(M, N)).
//
// What bounds it on an H100. On the paths B is the whole share relation
// viewed as (c, n, m·W·A) = 28.9 GB of int32, or the (4, 151,936, 2,560)
// embedding table (6.22 GB), and M is a fetch's rows or a step's tokens.
// An exact modular product costs 16 int8 products (4 x 4 byte limbs, below),
// so the work is 32·c·M·K·N int8 operations at 1,979 TOP/s against the
// bytes at 3.35 TB/s: a few rows (R = 3, a decode step of 8 tokens) are
// bound by the bytes of B, about 70 rows and more by the tensor cores
// (the R = 256 fetch, the 256-token prefill, the l = 1,000 fetch).
//
// Arithmetic. Each operand x < 2^31 splits into u8 limbs
// x = x0 + 2^8 x1 + 2^16 x2 + 2^24 x3 (x3 < 128). The 16 limb products
// a_j·b_i group by diagonal d = i + j (d = 0..6); a diagonal holds at most
// 4 products of at most 255^2, so its s32 sum stays exact for a K-chunk of
// up to 8,256 terms (the wrapper passes 8,192: 4·255^2·8,192 < 2^31). As
// 2^31 = 1 (mod p), the diagonal weight 2^(8d) is a 31-bit rotation by
// 8d mod 31 (0, 8, 16, 24, 1, 9, 17); after each chunk the 7 rotated sums
// and the running residue fold into one residue < p. K split over blocks
// adds its per-split residues in ss_matmul_reduce_kernel. Exact mod p, so
// bit-identical to the plain version and to the reference.
//
// Design (Cᵀ = Bᵀ·Aᵀ, so the long N fills wgmma's 64-row side and the few
// rows of A its N side):
// - wgmma.mma_async m64nRk32 .s32.u8.u8, R = NR in {8, 16, 24, 32} rows of
//   A per warpgroup. Both 8-bit operands must be K-major. B's tile is not
//   (N is its contiguous axis), so it is the register operand: each thread
//   reads its fragment's int32 words of B from shared memory, once for the
//   4 limbs, and byte-transposes them (__byte_perm) into 4 limb fragments.
//   A's rows are K-major already: each warpgroup splits its NR rows into 4
//   u8 planes in shared memory, read by descriptor (no swizzle; 8-row x
//   16-byte core matrices). 16 wgmma per 32 k feed 7 diagonal accumulators
//   of NR/2 registers each.
// - A block stages, with cp.async (16-byte copies where the operands are
//   aligned, 4-byte ones otherwise: strided views, B-stride 0, vocab-shard
//   slices at any offset), a (64 k, 64 column) tile of B and the same 64 k
//   of its rows of A in a 4-stage ring. WGS = 1 or 2 warpgroups share the
//   B tile over different row slices; blocks that cover the other row
//   slices of the same B tile are adjacent in the grid, so they run
//   together and take B from L2. Registers bind: 7·NR/2 accumulators cap
//   NR at 32 (about 240 registers a thread), so a B tile serves 64 rows a
//   block and one such block fills an SM.
// - The next stage's copies are issued while the first 32 k of the current
//   stage multiply; one wgmma group stays in flight (wait_group 1), and the
//   accumulators are read only after wait_group 0, at a chunk's fold (a
//   read while a group is in flight makes ptxas serialize every wgmma).
// - Nothing is copied ahead: no pre-pass over A, no copy of B.
//
// As measured on the card (PERF.md), the shapes bound by the tensor cores
// run at about a third of that bound: the products and the staging of A
// and B through shared memory do not overlap. A warp-specialized variant
// (a producer warpgroup with mbarriers), A pre-split into limb planes in
// device memory and a cluster pair sharing A's rows were each no faster.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kP32 = 0x7fffffffu;
constexpr uint64_t kP = 2147483647ull;
constexpr int kCols = 64;      // columns of B a block: wgmma's M
constexpr int kKT = 64;        // K per pipeline stage
constexpr int kStages = 4;     // cp.async ring depth
constexpr int kAStride = kKT + 4;  // words a staged row of A (16-B rows,
                                   // conflict-free 16-B reads across rows)
constexpr int kMaxChunk = 8256;  // K terms a diagonal's s32 sum holds

__device__ __forceinline__ uint64_t fold(uint64_t x) {
  return (x & kP) + (x >> 31);
}

__device__ __forceinline__ uint32_t mod_p(uint64_t x) {
  x = fold(x);
  x = fold(x);
  return static_cast<uint32_t>(x >= kP ? x - kP : x);
}

// v·2^e mod p (up to a final reduction) for v < 2^31: a 31-bit rotation.
__device__ __forceinline__ uint32_t rot31(uint32_t v, int e) {
  return ((v << e) & kP32) | (v >> (31 - e));
}

// Asynchronous global -> shared copies of 4 or 16 bytes, of which the first
// `valid` bytes are read and the rest zero-filled.
__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src,
                                          int valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const size_t g = __cvta_generic_to_global(src);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(g), "r"(valid));
}

__device__ __forceinline__ void cp_async16(uint32_t* dst, const uint32_t* src,
                                           int valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const size_t g = __cvta_generic_to_global(src);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(g), "r"(valid));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ int clamp4(int v) {
  return v < 0 ? 0 : (v > 4 ? 4 : v);
}

// Word (k, col) of a staged B tile. Rows are 64 words; 16-byte chunks are
// XOR-swizzled by k so that a warp's fragment reads (4 k apart, 8 columns)
// hit 32 distinct banks.
__device__ __forceinline__ int b_pos(int k, int col) {
  return k * kCols + (((col >> 2) ^ (((k >> 2) & 3) << 1)) << 2) + (col & 3);
}

// Four words w0..w3 (consecutive k) -> four registers, one per byte limb,
// each holding that limb of w0..w3 in bytes 0..3.
__device__ __forceinline__ void limbs4(uint32_t w0, uint32_t w1, uint32_t w2,
                                       uint32_t w3, uint32_t (&l)[4]) {
  const uint32_t lo01 = __byte_perm(w0, w1, 0x5140);
  const uint32_t hi01 = __byte_perm(w0, w1, 0x7362);
  const uint32_t lo23 = __byte_perm(w2, w3, 0x5140);
  const uint32_t hi23 = __byte_perm(w2, w3, 0x7362);
  l[0] = __byte_perm(lo01, lo23, 0x5410);
  l[1] = __byte_perm(lo01, lo23, 0x7632);
  l[2] = __byte_perm(hi01, hi23, 0x5410);
  l[3] = __byte_perm(hi01, hi23, 0x7632);
}

// K-major shared-memory operand without swizzle: 8-row x 16-byte core
// matrices, `lbo` bytes apart along K and `sbo` bytes apart along the rows.
__device__ __forceinline__ uint64_t kmajor_desc(const void* p, uint32_t lbo,
                                                uint32_t sbo) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((s & 0x3ffffu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// d (64 x NR, s32) += a (64 x 32 u8, registers) · b (32 x NR u8, shared)
template <int NR> struct Mma;

template <> struct Mma<8> {
  static __device__ __forceinline__ void run(uint32_t (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.u8.u8 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct Mma<16> {
  static __device__ __forceinline__ void run(uint32_t (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.u8.u8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct Mma<24> {
  static __device__ __forceinline__ void run(uint32_t (&d)[12],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k32.s32.u8.u8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
        "{%12, %13, %14, %15}, %16, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct Mma<32> {
  static __device__ __forceinline__ void run(uint32_t (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.u8.u8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, {%16, %17, %18, %19}, %20, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <int NR, int WGS>
constexpr size_t smem_bytes() {
  // the stage ring (B tile, then the block's rows of A at kAStride words),
  // then per warpgroup two buffers of 4 limb planes of its NR rows
  return static_cast<size_t>(kStages) * (kKT * kCols + NR * WGS * kAStride) *
             4 +
         static_cast<size_t>(WGS) * 2 * 4 * NR * kKT;
}

// grid: x = blocks of NR·WGS rows of A (adjacent blocks share a B tile),
// y = 64-column tiles of B, z = split * batch + cloud.
template <int NR, int WGS>
__global__ void __launch_bounds__(128 * WGS, WGS == 1 ? 2 : 1)
ss_matmul_kernel(const uint32_t* __restrict__ a, long long a_sb,
                 long long a_sm, const uint32_t* __restrict__ b,
                 long long b_sb, long long b_sk, uint32_t* __restrict__ out,
                 int batch, int m, int k, int n, int k_per_split,
                 int chunk_stages, int a_vec, int b_vec) {
  constexpr int kThreads = 128 * WGS;
  constexpr int kRows = NR * WGS;
  constexpr int kBWords = kKT * kCols;
  constexpr int kStageWords = kBWords + kRows * kAStride;
  constexpr int kPlane = NR * kKT;               // bytes of one limb plane
  constexpr int kAcc = NR / 2;                   // accumulators a diagonal
  constexpr int kBChunks = kKT * kCols / 4 / kThreads;  // 16-B copies a thread
  constexpr int kAChunks = kRows * kKT / 4 / kThreads;
  constexpr int kStep = kThreads / 16;           // k (or rows) between them
  extern __shared__ __align__(128) uint32_t smem[];
  unsigned char* planes =
      reinterpret_cast<unsigned char*>(smem + kStages * kStageWords);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int row_blk = blockIdx.x * kRows;
  const int row0 = row_blk + wg * NR;
  const int n0 = blockIdx.y * kCols;
  const int z = blockIdx.z;
  const int bz = z % batch;
  const int split = z / batch;
  const int k_lo = split * k_per_split;
  const int k_hi = min(k, k_lo + k_per_split);
  const int n_st = k_hi > k_lo ? (k_hi - k_lo + kKT - 1) / kKT : 0;
  const uint32_t* a_z = a + bz * a_sb + static_cast<long long>(row_blk) * a_sm;
  const uint32_t* b_z = b + bz * b_sb;

  // 16-byte copies: thread tid takes column chunk tid % 16 of B's k rows
  // tid / 16 + i·kStep, and k chunk tid % 16 of A's rows tid / 16 + i·kStep.
  const int c16 = tid & 15;
  const int r16 = tid >> 4;
  const int b_valid = clamp4(n - n0 - 4 * c16);
  const uint32_t* b_src = b_z + (k_lo + r16) * b_sk + n0 + 4 * c16;

  auto issue = [&](int st) {                     // stage st into its slot
    uint32_t* bs = smem + (st % kStages) * kStageWords;
    uint32_t* as = bs + kBWords;
    const int k0 = k_lo + st * kKT;
    const int kc = min(kKT, k_hi - k0);
    if (b_vec) {
      const uint32_t* src = b_src + static_cast<long long>(st) * kKT * b_sk;
#pragma unroll
      for (int i = 0; i < kBChunks; ++i) {
        const int kk = r16 + i * kStep;
        const int v = kk < kc ? b_valid : 0;
        cp_async16(bs + b_pos(kk, 4 * c16),
                   v ? src + static_cast<long long>(i) * kStep * b_sk : b,
                   4 * v);
      }
    } else {
      for (int e = tid; e < kKT * kCols; e += kThreads) {
        const int kk = e / kCols;
        const int c = e % kCols;
        const bool ok = kk < kc && n0 + c < n;
        cp_async4(bs + b_pos(kk, c),
                  ok ? b_z + static_cast<long long>(k0 + kk) * b_sk + n0 + c
                     : b, ok ? 4 : 0);
      }
    }
    if (a_vec) {
      const int v = clamp4(kc - 4 * c16);
#pragma unroll
      for (int i = 0; i < kAChunks; ++i) {
        const int r = r16 + i * kStep;
        const bool ok = row_blk + r < m && v > 0;
        cp_async16(as + r * kAStride + 4 * c16,
                   ok ? a_z + r * a_sm + k0 + 4 * c16 : a, ok ? 4 * v : 0);
      }
    } else {
      for (int e = tid; e < kRows * kKT; e += kThreads) {
        const int r = e / kKT;
        const int kk = e % kKT;
        const bool ok = row_blk + r < m && kk < kc;
        cp_async4(as + r * kAStride + kk, ok ? a_z + r * a_sm + k0 + kk : a,
                  ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  // this thread's B fragment words: rows (columns of B) 16·warp + g (+8),
  // k = 4t + i (+16); the swizzle term of every such k is 2t
  int fb[2];
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int c = 16 * warp + g + 8 * rh;
    fb[rh] = 4 * t * kCols + (((c >> 2) ^ (2 * t)) << 2) + (c & 3);
  }

  uint32_t acc[7][kAcc];
  uint32_t res[kAcc];
#pragma unroll
  for (int q = 0; q < kAcc; ++q) {
    res[q] = 0;
#pragma unroll
    for (int d = 0; d < 7; ++d) acc[d][q] = 0;
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_st) issue(s);
    else cp_async_commit();
  }
  // Every warpgroup runs the tensor-core path, also over a slice past M
  // (zero rows): a wgmma under a branch that is not uniform to ptxas runs
  // serialized.
  for (int st = 0; st < n_st; ++st) {
    cp_async_wait<kStages - 2>();                // stage st has landed
    __syncthreads();                             // and slot st-1 is free
    const uint32_t* bs = smem + (st % kStages) * kStageWords;
    const uint32_t* as = bs + kBWords + wg * NR * kAStride;
    unsigned char* pl = planes + (wg * 2 + (st & 1)) * 4 * kPlane;
    // this warpgroup's rows -> 4 u8 planes, [k/16][row][16 bytes] each
    for (int e = tid & 127; e < NR * (kKT / 16); e += 128) {
      const int r = e % NR;
      const int k16 = e / NR;
      uint32_t l[4][4];                          // [k quad][limb]
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint4 w = *reinterpret_cast<const uint4*>(
            as + r * kAStride + 16 * k16 + 4 * u);
        limbs4(w.x, w.y, w.z, w.w, l[u]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint4*>(pl + j * kPlane + k16 * NR * 16 + r * 16) =
            make_uint4(l[0][j], l[1][j], l[2][j], l[3][j]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kKT / 32; ++s) {
      uint32_t frag[4][4];                       // [limb][2·khalf + rowhalf]
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const uint32_t* w = bs + fb[rh] + (32 * s + 16 * h) * kCols;
          uint32_t l[4];
          limbs4(w[0], w[kCols], w[2 * kCols], w[3 * kCols], l);
#pragma unroll
          for (int i = 0; i < 4; ++i) frag[i][2 * h + rh] = l[i];
        }
      }
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint64_t desc = kmajor_desc(pl + j * kPlane + 2 * s * NR * 16,
                                          NR * 16, 128);
#pragma unroll
        for (int i = 0; i < 4; ++i) Mma<NR>::run(acc[i + j], frag[i], desc);
      }
      wgmma_commit();
      // the next stage's copies go out while this step's products run
      if (s == 0) {
        if (st + kStages - 1 < n_st) issue(st + kStages - 1);
        else cp_async_commit();
      }
      wgmma_wait<1>();   // reading acc here would make ptxas wait for all
    }
    if ((st + 1) % chunk_stages == 0 || st + 1 == n_st) {
      wgmma_wait<0>();                           // fold this K-chunk
#pragma unroll
      for (int d = 0; d < 7; ++d) fence_regs(acc[d]);
#pragma unroll
      for (int q = 0; q < kAcc; ++q) {
        uint64_t x = res[q];
#pragma unroll
        for (int d = 0; d < 7; ++d) {
          x += rot31(acc[d][q], (8 * d) % 31);   // 2^(8d) mod p
          acc[d][q] = 0;
        }
        res[q] = mod_p(x);
      }
    }
  }
  // accumulator q of this thread: column 16·warp + g + 8·((q >> 1) & 1) of
  // the tile, row 8·(q >> 2) + 2t + (q & 1) of this warpgroup's slice
  uint32_t* o = out + static_cast<long long>(z) * m * n;
#pragma unroll
  for (int q = 0; q < kAcc; ++q) {
    const int row = row0 + 8 * (q >> 2) + 2 * t + (q & 1);
    const int col = n0 + 16 * warp + g + 8 * ((q >> 1) & 1);
    if (row < m && col < n) o[static_cast<long long>(row) * n + col] = res[q];
  }
}

__global__ void ss_matmul_reduce_kernel(const uint32_t* __restrict__ part,
                                        uint32_t* __restrict__ out,
                                        long long per_split, int ksplit) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (t >= per_split) return;
  uint64_t s = 0;
  for (int q = 0; q < ksplit; ++q) s += part[q * per_split + t];
  out[t] = mod_p(s);
}

template <int NR, int WGS>
int launch(const uint32_t* a, long long a_sb, long long a_sm,
           const uint32_t* b, long long b_sb, long long b_sk, uint32_t* dst,
           int batch, int m, int k, int n, int ksplit, int k_per_split,
           int chunk_stages, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<NR, WGS>();
  cudaError_t err = cudaFuncSetAttribute(
      ss_matmul_kernel<NR, WGS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte copies need 16-byte aligned sources at every step
  const auto aligned = [](const uint32_t* p, long long s0, long long s1) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s0 % 4 == 0 &&
           s1 % 4 == 0;
  };
  dim3 grid((m + NR * WGS - 1) / (NR * WGS), (n + kCols - 1) / kCols,
            batch * ksplit);
  ss_matmul_kernel<NR, WGS><<<grid, 128 * WGS, smem, stream>>>(
      a, a_sb, a_sm, b, b_sb, b_sk, dst, batch, m, k, n, k_per_split,
      chunk_stages, aligned(a, a_sb, a_sm), aligned(b, b_sb, b_sk));
  return 0;
}

int run(const void* a, long long a_sb, long long a_sm, const void* b,
        long long b_sb, long long b_sk, void* partial, void* out, int batch,
        int m, int k, int n, int ksplit, int nr, int wgs, int k_chunk,
        void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return 0;
  if (ksplit < 1 || k_chunk < kKT || k_chunk > kMaxChunk ||
      k_chunk % kKT != 0 || (n + kCols - 1) / kCols > 65535 ||
      static_cast<long long>(batch) * ksplit > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int k_per_split =
      ((k + ksplit - 1) / ksplit + kKT - 1) / kKT * kKT;
  const int chunk_stages = k_chunk / kKT;
  uint32_t* dst = static_cast<uint32_t*>(ksplit > 1 ? partial : out);
  const uint32_t* ap = static_cast<const uint32_t*>(a);
  const uint32_t* bp = static_cast<const uint32_t*>(b);
  int err;
#define SS_LAUNCH(NR, WGS)                                                  \
  launch<NR, WGS>(ap, a_sb, a_sm, bp, b_sb, b_sk, dst, batch, m, k, n,      \
                  ksplit, k_per_split, chunk_stages, st)
  switch (nr * 10 + wgs) {
    case 81: err = SS_LAUNCH(8, 1); break;
    case 161: err = SS_LAUNCH(16, 1); break;
    case 241: err = SS_LAUNCH(24, 1); break;
    case 242: err = SS_LAUNCH(24, 2); break;
    case 321: err = SS_LAUNCH(32, 1); break;
    case 322: err = SS_LAUNCH(32, 2); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SS_LAUNCH
  if (err != 0) return err;
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || ksplit <= 1) return static_cast<int>(e);
  const long long per_split = static_cast<long long>(batch) * m * n;
  const int threads = 256;
  const long long blocks = (per_split + threads - 1) / threads;
  ss_matmul_reduce_kernel<<<static_cast<unsigned>(blocks), threads, 0, st>>>(
      dst, static_cast<uint32_t*>(out), per_split, ksplit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a: rows of A with element strides a_sb (batch) and a_sm (row); unit K stride
// b: rows of B with element strides b_sb (batch, 0 = shared) and b_sk (row)
// partial: device (ksplit, batch, M, N) scratch, used when ksplit > 1
// out: device (batch, M, N) contiguous
// (nr, wgs): rows of A a warpgroup and warpgroups a block, one of (8, 1),
// (16, 1), (24, 1), (24, 2), (32, 1), (32, 2) (row_layout in ss_matmul.py);
// k_chunk: K terms a diagonal sum takes before it folds (a multiple of 64,
// at most 8,256).
extern "C" int ss_matmul_u32(const void* a, long long a_sb, long long a_sm,
                             const void* b, long long b_sb, long long b_sk,
                             void* partial, void* out, int batch, int m,
                             int k, int n, int ksplit, int nr, int wgs,
                             int k_chunk, void* stream) {
  return run(a, a_sb, a_sm, b, b_sb, b_sk, partial, out, batch, m, k, n,
             ksplit, nr, wgs, k_chunk, stream);
}

// The tall-skinny form (M <= 256), same operands and scratch.
extern "C" int ss_matmul_tall_u32(const void* a, long long a_sb,
                                  long long a_sm, const void* b,
                                  long long b_sb, long long b_sk,
                                  void* partial, void* out, int batch, int m,
                                  int k, int n, int ksplit, int nr, int wgs,
                                  int k_chunk, void* stream) {
  if (m > 256) return static_cast<int>(cudaErrorInvalidValue);
  return run(a, a_sb, a_sm, b, b_sb, b_sk, partial, out, batch, m, k, n,
             ksplit, nr, wgs, k_chunk, stream);
}
