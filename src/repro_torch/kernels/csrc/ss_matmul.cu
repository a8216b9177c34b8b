// Share-space matrix product over F_p, p = 2^31 - 1:
//
//     out[z] = a[z] (M x K) @ b[z] (K x N)  mod p,   z < batch (the clouds)
//
// Replaces the Pallas TPU kernel src/repro/kernels/ss_matmul.py:87
// ss_matmul_pallas (_ss_matmul_kernel :66). Its tall-skinny tiling
// ss_matmul_tall_pallas (:145) computes the same function and is served by
// this kernel too; a shape-tuned variant is later work.
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

template <int TM>
void launch(const uint32_t* a, long long a_sb, long long a_sm,
            const uint32_t* b, long long b_sb, long long b_sk, uint32_t* dst,
            int batch, int m, int k, int n, int ksplit, int k_per_split,
            cudaStream_t stream) {
  dim3 grid((n + kTN - 1) / kTN, (m + TM - 1) / TM, batch * ksplit);
  ss_matmul_kernel<TM><<<grid, kTN, 0, stream>>>(
      a, a_sb, a_sm, b, b_sb, b_sk, dst, batch, m, k, n, k_per_split);
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
