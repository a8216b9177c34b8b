// Accumulating-automata word match over F_p, p = 2^31 - 1 (paper §3.1,
// Table 3), for a stack of B predicates against c clouds' share columns:
//
//     out[z, b, i] = prod_{j<W} ( sum_{a<A} col[z, b, i, j, a] * pat[z, b, j, a] )  mod p
//
// Replaces the Pallas TPU kernel src/repro/kernels/aa_match.py:81
// aa_match_batch_pallas (body _aa_body, cell _aa_batch_kernel); its B = 1
// case aa_match_pallas (aa_match.py:58) is the same launch with one row.
//
// What bounds it on an H100: device-memory bytes. Each share element is
// read once and takes one 32x32->64 multiply, one Mersenne fold and one
// 64-bit add, so at the slice's shapes (n = 131072 tuples, W·A = 552
// int32 per tuple, c = 20 clouds) the kernel moves 5.8 GB per column for
// a few operations per 4 bytes -- far below the card's ops-per-byte line.
//
// Design: one warp per tuple row (each warp walks ROWS_PER_WARP rows).
// The row's W·A elements are contiguous; lanes stride the alphabet axis of
// each position, so a warp reads consecutive 4-byte words. The (W, A)
// pattern tile of the block's (cloud, batch row) sits in shared memory.
// Per position the lanes' partial sums meet in a warp shuffle reduction,
// fold once to [0, p), and the W-chain multiplies in registers; only the
// (c, B, n) match shares are written.
//
// Rows are addressed by strides, never copied: the base pointer plus a
// per-batch-row element offset (column and first tuple) and the cloud and
// tuple strides. A column broadcast across B (stride 0), distinct columns
// of the relation, and tree blocks (a start and a length per row) are all
// the same launch. Rows at or past a batch row's length read nothing and
// write 0.
//
// Arithmetic: the TPU kernel splits operands into 16-bit limbs because
// its vector unit has 32-bit lanes. Hopper multiplies 32x32->64 natively;
// the 62-bit product folds once to < 2^32 ((x & p) + (x >> 31)) and sums
// exactly in 64 bits, and one final fold + conditional subtract per
// output reduces mod p. Both are exact mod p, hence bit-identical.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint64_t kP = 2147483647ull;
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;

__device__ __forceinline__ uint64_t fold(uint64_t x) {
  return (x & kP) + (x >> 31);
}

__device__ __forceinline__ uint32_t mod_p(uint64_t x) {
  x = fold(x);
  x = fold(x);
  return static_cast<uint32_t>(x >= kP ? x - kP : x);
}

__global__ void __launch_bounds__(kWarps * 32)
aa_match_rows_kernel(const uint32_t* __restrict__ base,
                     const long long* __restrict__ offsets,
                     const int* __restrict__ lengths,
                     long long stride_c, long long stride_n,
                     const uint32_t* __restrict__ pat,
                     uint32_t* __restrict__ out,
                     int n_batch, int height, int w, int a) {
  extern __shared__ uint32_t pat_s[];
  const int b = blockIdx.y;
  const int z = blockIdx.z;
  const int wa = w * a;
  const long long zb = static_cast<long long>(z) * n_batch + b;

  const uint32_t* pat_g = pat + zb * wa;
  for (int e = threadIdx.x; e < wa; e += blockDim.x) pat_s[e] = pat_g[e];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int len = lengths[b];
  const uint32_t* col = base + z * stride_c + offsets[b];
  uint32_t* out_zb = out + zb * height;

  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp + r;
    if (i >= height) break;                    // warp-uniform
    if (i >= len) {
      if (lane == 0) out_zb[i] = 0u;
      continue;
    }
    const uint32_t* row = col + static_cast<long long>(i) * stride_n;
    uint32_t acc = 0u;
    for (int j = 0; j < w; ++j) {
      uint64_t s = 0;
      for (int al = lane; al < a; al += 32) {
        const int e = j * a + al;
        s += fold(static_cast<uint64_t>(__ldg(row + e)) * pat_s[e]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      const uint32_t v = mod_p(s);
      acc = (j == 0) ? v : mod_p(static_cast<uint64_t>(acc) * v);
    }
    if (lane == 0) out_zb[i] = acc;
  }
}

}  // namespace

// base:    first share element of the strided column source
// offsets: device int64[B], element offset of batch row b's tuple 0
// lengths: device int32[B], tuples of batch row b (<= height)
// pat:     device (c, B, W, A) contiguous
// out:     device (c, B, height) contiguous
extern "C" int aa_match_rows_u32(const void* base, const void* offsets,
                                 const void* lengths, long long stride_c,
                                 long long stride_n, const void* pat,
                                 void* out, int n_clouds, int n_batch,
                                 int height, int w, int a, void* stream) {
  if (n_clouds <= 0 || n_batch <= 0 || height <= 0) return 0;
  dim3 grid((height + kRowsPerBlock - 1) / kRowsPerBlock, n_batch, n_clouds);
  const size_t smem = static_cast<size_t>(w) * a * sizeof(uint32_t);
  aa_match_rows_kernel<<<grid, kWarps * 32, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(base),
      static_cast<const long long*>(offsets),
      static_cast<const int*>(lengths), stride_c, stride_n,
      static_cast<const uint32_t*>(pat), static_cast<uint32_t*>(out),
      n_batch, height, w, a);
  return static_cast<int>(cudaGetLastError());
}
