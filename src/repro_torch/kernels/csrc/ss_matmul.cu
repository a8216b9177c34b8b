// Share-space matrix product over F_p, p = 2^31 - 1:
//
//     out[z] = a[z] (M x K) @ b[z] (K x N)  mod p,   z < batch (the clouds)
//
// Replaces the Pallas TPU kernel src/repro/kernels/ss_matmul.py:87
// ss_matmul_pallas (_ss_matmul_kernel :66). The second entry,
// ss_matmul_tall_u32 (below), replaces its tall-skinny tiling
// ss_matmul_tall_pallas (:145); the wrapper routes every shape that
// is_tall_skinny accepts (M <= 256, K >= 1024, K >= 8 max(M, N)) there.
//
// What bounds it on an H100: device-memory bytes. On the slice's path B is
// the whole share relation viewed as (c, n, m·W·A) = 28.9 GB of int32 and
// M is small (the fetch rows, or the B match-bit rows of one_tuple), so
// each B element is read once for 2·M operations.
//
// Design: one thread per output column (threads along N read consecutive B
// elements, coalesced), TM output rows per thread held in 64-bit register
// accumulators, and the K loop inside the thread, so B is read once for up
// to TM rows. The (TM, TK) slice of A for the current K-chunk is staged in
// shared memory and read as a broadcast. TM is a template over {1,2,4,8,16}
// chosen from M so a small M does no padded work. The K axis may split over
// `ksplit` blocks to fill the card; the wrapper then passes a scratch
// buffer and a second pass adds the per-split residues mod p.
//
// Arithmetic: the TPU kernel splits operands into 16-bit limbs because its
// vector unit has 32-bit lanes. Hopper multiplies 32x32->64 natively: the
// 62-bit product folds once to < 2^32 ((x & p) + (x >> 31)), the 64-bit
// accumulator stays exact for up to 2^32 terms, and one final fold +
// conditional subtract per output reduces mod p. Exact mod p, hence
// bit-identical to the limb version.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint64_t kP = 2147483647ull;
constexpr int kTN = 128;   // threads per block: output columns
constexpr int kTK = 128;   // K-chunk of A staged in shared memory

__device__ __forceinline__ uint64_t fold(uint64_t x) {
  return (x & kP) + (x >> 31);
}

__device__ __forceinline__ uint32_t mod_p(uint64_t x) {
  x = fold(x);
  x = fold(x);
  return static_cast<uint32_t>(x >= kP ? x - kP : x);
}

template <int TM>
__global__ void __launch_bounds__(kTN)
ss_matmul_kernel(const uint32_t* __restrict__ a, long long a_sb,
                 long long a_sm, const uint32_t* __restrict__ b,
                 long long b_sb, long long b_sk, uint32_t* __restrict__ out,
                 int batch, int m, int k, int n, int k_per_split) {
  __shared__ uint32_t a_s[TM][kTK];
  const int col = blockIdx.x * kTN + threadIdx.x;
  const int m0 = blockIdx.y * TM;
  const int z = blockIdx.z;                  // split * batch + cloud
  const int bz = z % batch;
  const int split = z / batch;
  const int k_lo = split * k_per_split;
  const int k_hi = min(k, k_lo + k_per_split);
  const int rows = min(TM, m - m0);
  const uint32_t* a_z = a + bz * a_sb;
  const uint32_t* b_z = b + bz * b_sb;

  uint64_t acc[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) acc[r] = 0;

  for (int k0 = k_lo; k0 < k_hi; k0 += kTK) {
    const int kc = min(kTK, k_hi - k0);
    __syncthreads();
    for (int e = threadIdx.x; e < TM * kTK; e += kTN) {
      const int r = e / kTK;
      const int kk = e % kTK;
      a_s[r][kk] = (r < rows && kk < kc)
          ? a_z[static_cast<long long>(m0 + r) * a_sm + k0 + kk] : 0u;
    }
    __syncthreads();
    if (col < n) {
      const uint32_t* bp = b_z + static_cast<long long>(k0) * b_sk + col;
#pragma unroll 4
      for (int kk = 0; kk < kc; ++kk) {
        const uint64_t bv = __ldg(bp + static_cast<long long>(kk) * b_sk);
#pragma unroll
        for (int r = 0; r < TM; ++r) acc[r] += fold(bv * a_s[r][kk]);
      }
    }
  }
  if (col < n) {
    uint32_t* o = out + (static_cast<long long>(z) * m + m0) * n + col;
#pragma unroll
    for (int r = 0; r < TM; ++r)
      if (r < rows) o[static_cast<long long>(r) * n] = mod_p(acc[r]);
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

// ---------------------------------------------------------------------------
// Tall-skinny form: M <= 256 rows of A, K streamed, one pass over B.
//
// What bounds it on an H100: at the fetch's shape (c = 20, K = n = 131,072,
// N = m·W·A = 2,760) B is the 28.9 GB relation. A few rows are bound by
// those bytes (R = 3: 8.6 ms); tens of rows by the operations, 2 per
// multiply-accumulate at the card's int32 rate (R = 69: 29.8 ms).
//
// Design: every block holds the K-chunk of A for ALL rows (padded to
// WR·RW >= M) in shared memory and one (TK, 32·WC) tile of B, so each B
// element comes from device memory once per launch. The block's WR·WC
// warps split the rows (WR groups of RW rows) and the columns (WC groups
// of 32); a thread keeps RW 64-bit accumulators for one column, reads its
// column's TK values of B once per chunk and each A row's TK values as
// 16-byte broadcasts. Chunks are staged with cp.async (16-byte copies
// where the operands are aligned, 4-byte ones otherwise) into two
// buffers, the next chunk in flight while the current one is multiplied.
// K splits over blocks when the N tiles do not fill the card;
// ss_matmul_reduce_kernel adds the per-split residues mod p.
//
// Arithmetic: products accumulate unfolded, one 32x32+64 multiply-add
// each, and after every third the accumulator folds with one more
// (hi·2^32 + lo ≡ 2·hi + lo mod p, < 2^34): 2^34 + 3 (2^31 - 1)^2 < 2^64,
// exact for any operands < 2^31. Exact mod p, so bit-identical to the
// plain version.
// ---------------------------------------------------------------------------

constexpr int kTallTK = 16;          // K per pipeline stage
constexpr int kAStride = kTallTK + 4;  // words per staged A row (16-B rows)
constexpr int kTallThreads = 256;

// Asynchronous global -> shared copies (sm_80+) of 4 or 16 bytes, of which
// the first `valid` bytes are read and the rest zero-filled. A stage's
// copies stay in flight while the previous stage is multiplied.
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

// x = hi·2^32 + lo ≡ 2·hi + lo (mod p): one 32x32+64 multiply-add, < 2^34.
__device__ __forceinline__ uint64_t fold32(uint64_t x) {
  uint64_t r;
  asm("mad.wide.u32 %0, %1, 2, %2;"
      : "=l"(r) : "r"(static_cast<uint32_t>(x >> 32)), "l"(x & 0xffffffffull));
  return r;
}

__device__ __forceinline__ int clamp4(int v) {
  return v < 0 ? 0 : (v > 4 ? 4 : v);
}

template <int RW>
__global__ void __launch_bounds__(kTallThreads)
ss_matmul_tall_kernel(const uint32_t* __restrict__ a, long long a_sb,
                      long long a_sm, const uint32_t* __restrict__ b,
                      long long b_sb, long long b_sk,
                      uint32_t* __restrict__ out, int batch, int m, int k,
                      int n, int k_per_split, int wr, int wc, int a_vec,
                      int b_vec) {
  extern __shared__ uint32_t smem[];
  const int rows_pad = (wr * RW + 3) & ~3;
  const int cols = 32 * wc;
  // two stages, each [rows_pad][kAStride] of A then [kTallTK][cols] of B
  const int stage = rows_pad * kAStride + kTallTK * cols;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wrow = warp % wr;
  const int wcol = warp / wr;
  const int c0 = blockIdx.x * cols;
  const int col = c0 + wcol * 32 + lane;
  const int z = blockIdx.y;                      // split * batch + cloud
  const int bz = z % batch;
  const int split = z / batch;
  const int k_lo = split * k_per_split;
  const int k_hi = min(k, k_lo + k_per_split);
  const uint32_t* a_z = a + bz * a_sb;
  const uint32_t* b_z = b + bz * b_sb;

  auto issue = [&](int k0, uint32_t* a_s) {      // stage chunk k0
    uint32_t* b_s = a_s + rows_pad * kAStride;
    const int kc = min(kTallTK, k_hi - k0);
    if (a_vec) {                                 // 4 k of one row a copy
      for (int e = threadIdx.x; e < rows_pad * (kTallTK / 4);
           e += blockDim.x) {
        const int r = e / (kTallTK / 4);
        const int kk = 4 * (e % (kTallTK / 4));
        const int v = r < m ? clamp4(kc - kk) : 0;
        cp_async16(a_s + r * kAStride + kk, v ? a_z + r * a_sm + k0 + kk : a,
                   4 * v);
      }
    } else {
      for (int e = threadIdx.x; e < rows_pad * kTallTK; e += blockDim.x) {
        const int r = e / kTallTK;
        const int kk = e % kTallTK;
        const bool ok = r < m && kk < kc;
        cp_async4(a_s + r * kAStride + kk, ok ? a_z + r * a_sm + k0 + kk : a,
                  ok ? 4 : 0);
      }
    }
    if (b_vec) {                                 // 4 columns a copy
      const int c4 = cols / 4;
      for (int e = threadIdx.x; e < kTallTK * c4; e += blockDim.x) {
        const int kk = e / c4;
        const int cc = 4 * (e - kk * c4);
        const int v = kk < kc ? clamp4(n - c0 - cc) : 0;
        cp_async16(b_s + kk * cols + cc,
                   v ? b_z + static_cast<long long>(k0 + kk) * b_sk + c0 + cc
                     : b, 4 * v);
      }
    } else {
      for (int e = threadIdx.x; e < kTallTK * cols; e += blockDim.x) {
        const int kk = e / cols;
        const int cc = e - kk * cols;
        const bool ok = kk < kc && c0 + cc < n;
        cp_async4(b_s + e,
                  ok ? b_z + static_cast<long long>(k0 + kk) * b_sk + c0 + cc
                     : b, ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  uint64_t acc[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) acc[r] = 0;

  int cur = 0;
  if (k_lo < k_hi) issue(k_lo, smem);
  for (int k0 = k_lo; k0 < k_hi; k0 += kTallTK) {
    if (k0 + kTallTK < k_hi) {
      issue(k0 + kTallTK, smem + (cur ^ 1) * stage);
      cp_async_wait<1>();                        // this stage has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t* a_s = smem + cur * stage;
    const uint32_t* b_s = a_s + rows_pad * kAStride;
    uint32_t bv[kTallTK];
#pragma unroll
    for (int kk = 0; kk < kTallTK; ++kk)
      bv[kk] = b_s[kk * cols + wcol * 32 + lane];
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const uint4* ar = reinterpret_cast<const uint4*>(
          a_s + (wrow * RW + r) * kAStride);
      uint64_t x = acc[r];
#pragma unroll
      for (int q = 0; q < kTallTK / 4; ++q) {
        const uint4 v = ar[q];                   // a broadcast to the warp
        const uint32_t av[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kk = 4 * q + j;
          x += static_cast<uint64_t>(bv[kk]) * static_cast<uint64_t>(av[j]);
          if (kk % 3 == 2 || kk == kTallTK - 1) x = fold32(x);
        }
      }
      acc[r] = x;
    }
    __syncthreads();                             // stage free for reuse
    cur ^= 1;
  }
  if (col < n) {
    uint32_t* o = out + static_cast<long long>(z) * m * n + col;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int row = wrow * RW + r;
      if (row < m) o[static_cast<long long>(row) * n] = mod_p(acc[r]);
    }
  }
}

template <int RW>
void launch_tall(const uint32_t* a, long long a_sb, long long a_sm,
                 const uint32_t* b, long long b_sb, long long b_sk,
                 uint32_t* dst, int batch, int m, int k, int n, int ksplit,
                 int k_per_split, int wr, int wc, cudaStream_t stream) {
  const int rows_pad = (wr * RW + 3) & ~3;
  const int cols = 32 * wc;
  const size_t smem = 2 * static_cast<size_t>(rows_pad * kAStride +
                                              kTallTK * cols) *
                      sizeof(uint32_t);
  // 16-byte copies need 16-byte aligned sources at every step
  const auto aligned = [](const uint32_t* p, long long s0, long long s1) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s0 % 4 == 0 &&
           s1 % 4 == 0;
  };
  dim3 grid((n + cols - 1) / cols, batch * ksplit);
  ss_matmul_tall_kernel<RW><<<grid, 32 * wr * wc, smem, stream>>>(
      a, a_sb, a_sm, b, b_sb, b_sk, dst, batch, m, k, n, k_per_split, wr, wc,
      aligned(a, a_sb, a_sm), aligned(b, b_sb, b_sk));
}

template <int TM>
void launch(const uint32_t* a, long long a_sb, long long a_sm,
            const uint32_t* b, long long b_sb, long long b_sk, uint32_t* dst,
            int batch, int m, int k, int n, int ksplit, int k_per_split,
            cudaStream_t stream) {
  dim3 grid((n + kTN - 1) / kTN, (m + TM - 1) / TM, batch * ksplit);
  ss_matmul_kernel<TM><<<grid, kTN, 0, stream>>>(
      a, a_sb, a_sm, b, b_sb, b_sk, dst, batch, m, k, n, k_per_split);
}

int reduce_splits(const void* partial, void* out, int batch, int m, int n,
                  int ksplit, cudaStream_t st) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ksplit <= 1) return static_cast<int>(err);
  const long long per_split = static_cast<long long>(batch) * m * n;
  const int threads = 256;
  const long long blocks = (per_split + threads - 1) / threads;
  ss_matmul_reduce_kernel<<<static_cast<unsigned>(blocks), threads, 0, st>>>(
      static_cast<const uint32_t*>(partial), static_cast<uint32_t*>(out),
      per_split, ksplit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a: rows of A with element strides a_sb (batch) and a_sm (row); unit K stride
// b: rows of B with element strides b_sb (batch, 0 = shared) and b_sk (row)
// partial: device (ksplit, batch, M, N) scratch, used when ksplit > 1
// out: device (batch, M, N) contiguous
extern "C" int ss_matmul_u32(const void* a, long long a_sb, long long a_sm,
                             const void* b, long long b_sb, long long b_sk,
                             void* partial, void* out, int batch, int m,
                             int k, int n, int ksplit, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int k_per_split =
      ((k + ksplit - 1) / ksplit + kTK - 1) / kTK * kTK;
  uint32_t* dst = static_cast<uint32_t*>(ksplit > 1 ? partial : out);
  const uint32_t* ap = static_cast<const uint32_t*>(a);
  const uint32_t* bp = static_cast<const uint32_t*>(b);
  if (m <= 1) {
    launch<1>(ap, a_sb, a_sm, bp, b_sb, b_sk, dst, batch, m, k, n, ksplit,
              k_per_split, st);
  } else if (m <= 2) {
    launch<2>(ap, a_sb, a_sm, bp, b_sb, b_sk, dst, batch, m, k, n, ksplit,
              k_per_split, st);
  } else if (m <= 4) {
    launch<4>(ap, a_sb, a_sm, bp, b_sb, b_sk, dst, batch, m, k, n, ksplit,
              k_per_split, st);
  } else if (m <= 8) {
    launch<8>(ap, a_sb, a_sm, bp, b_sb, b_sk, dst, batch, m, k, n, ksplit,
              k_per_split, st);
  } else {
    launch<16>(ap, a_sb, a_sm, bp, b_sb, b_sk, dst, batch, m, k, n, ksplit,
               k_per_split, st);
  }
  return reduce_splits(partial, out, batch, m, n, ksplit, st);
}

// The tall-skinny form, same operands and scratch as ss_matmul_u32;
// rw in {1, 2, 4, 8, 16, 32} rows per warp, wr row warps with wr·rw >= m,
// wc column warps, wr·wc <= 8.
extern "C" int ss_matmul_tall_u32(const void* a, long long a_sb,
                                  long long a_sm, const void* b,
                                  long long b_sb, long long b_sk,
                                  void* partial, void* out, int batch, int m,
                                  int k, int n, int ksplit, int rw, int wr,
                                  int wc, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return 0;
  if (wr < 1 || wc < 1 || wr * wc * 32 > kTallThreads || wr * rw < m)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int k_per_split =
      ((k + ksplit - 1) / ksplit + kTallTK - 1) / kTallTK * kTallTK;
  uint32_t* dst = static_cast<uint32_t*>(ksplit > 1 ? partial : out);
  const uint32_t* ap = static_cast<const uint32_t*>(a);
  const uint32_t* bp = static_cast<const uint32_t*>(b);
  switch (rw) {
    case 1: launch_tall<1>(ap, a_sb, a_sm, bp, b_sb, b_sk, dst, batch, m, k,
                           n, ksplit, k_per_split, wr, wc, st); break;
    case 2: launch_tall<2>(ap, a_sb, a_sm, bp, b_sb, b_sk, dst, batch, m, k,
                           n, ksplit, k_per_split, wr, wc, st); break;
    case 4: launch_tall<4>(ap, a_sb, a_sm, bp, b_sb, b_sk, dst, batch, m, k,
                           n, ksplit, k_per_split, wr, wc, st); break;
    case 8: launch_tall<8>(ap, a_sb, a_sm, bp, b_sb, b_sk, dst, batch, m, k,
                           n, ksplit, k_per_split, wr, wc, st); break;
    case 16: launch_tall<16>(ap, a_sb, a_sm, bp, b_sb, b_sk, dst, batch, m,
                             k, n, ksplit, k_per_split, wr, wc, st); break;
    case 32: launch_tall<32>(ap, a_sb, a_sm, bp, b_sb, b_sk, dst, batch, m,
                             k, n, ksplit, k_per_split, wr, wc, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return reduce_splits(partial, out, batch, m, n, ksplit, st);
}
