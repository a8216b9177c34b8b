// Accumulating-automata matches over F_p, p = 2^31 - 1 (paper §3.1,
// Table 3), for a stack of B predicates against c clouds' share columns.
// One device body serves two entries:
//
// aa_match_rows_u32, the word match,
//
//     out[z, b, i] = prod_{j<W} ( sum_{a<A} col[z, b, i, j, a] * pat[z, b, j, a] )
//
// replaces the Pallas TPU kernel src/repro/kernels/aa_match.py:81
// aa_match_batch_pallas (its B = 1 case aa_match_pallas, :58, is the same
// launch with one row). aa_slide_rows_u32, the sliding-window match of
// suffix and substring predicates, a (k, A) tile against every window of
// M = W - k + 1 positions,
//
//     out[z, b, i, o] = prod_{r<k} ( sum_{a<A} col[z, b, i, o+r, a] * pat[z, b, r, a] )
//
// replaces aa_match.py:146 aa_slide_batch_pallas. The word match is the
// slide at k = W (M = 1), so both run one kernel.
//
// What bounds it on an H100: device-memory bytes. Each share word is read
// once and takes one 32x32->64 multiply-add; at the Employee shapes
// (n = 131,072 tuples, W·A = 552 words a tuple, c = 20 clouds) a column is
// 5.8 GB for a few operations per 4 bytes, far below the card's
// operations-per-byte line.
//
// Design:
// - Rows are addressed by strides, never copied: the base pointer, a
//   cloud and a tuple stride, and per source an element offset and a
//   length. The launcher groups the batch rows that read the same source
//   (equal offset and length: every B-stride-0 stack is one group) and
//   cuts each group into chunks of at most `patterns` rows. A tile is
//   `rows` consecutive tuples of one (cloud, chunk); each tuple of a
//   source is staged once per launch and every pattern of its chunk runs
//   over it.
// - A persistent grid (as many blocks as fit on the SMs) walks contiguous
//   ranges of tiles. Tiles are staged in two shared-memory buffers by
//   cp.async: 16-byte copies where the base, the offsets and the strides
//   are 16-byte aligned (a row's W·A words are contiguous; a tail shorter
//   than 16 bytes, as in prefix views of k·A words, is a partial copy
//   that reads only its own bytes), 4-byte copies otherwise. The next
//   tile's copies are in flight while the block computes the current one.
//   Rows at or past a source's length are neither read nor computed and
//   write 0.
// - No cross-lane reduction: one thread per (tuple, position) sums its A
//   products serially in registers, once for each (pattern, tile row) pair
//   that meets the position (up to kDots = 4 sums a pass, each staged word
//   read once for all of them, with the same pass count in every lane),
//   and writes the dots to shared memory; then a thread per (pattern,
//   tuple, window) chains its k dots and writes the (c, B, height[, M])
//   output, coalesced. Where one tuple's dots do not fit (words of
//   hundreds of positions over a tiny alphabet), a tile's rows go in
//   passes of k_pass tile rows and each window's running product carries
//   between them. The staged row pitch is padded (by the launcher) so a
//   warp's (tuple, position) lanes hit distinct banks, and the dot
//   scratch's odd stride keeps the chain reads apart.
//
// Arithmetic: the TPU kernel splits operands into 16-bit limbs because its
// vector unit has 32-bit lanes. Here each 62-bit product is added to a
// 64-bit sum, which folds ((x & p) + (x >> 31), < 2^34) after every
// kFoldEvery = 3 products: 2^34 + 3·(2^31 - 1)^2 < 2^64. One final
// reduction gives the dot mod p, and the chain multiplies mod p. All of it
// is exact mod p, hence bit-identical to the plain version.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint64_t kP = 2147483647ull;
constexpr int kThreads = 256;
constexpr int kFoldEvery = 3;    // keep equal to FOLD_EVERY
constexpr int kDots = 4;         // dots a thread sums together

__device__ __forceinline__ uint64_t fold(uint64_t x) {
  return (x & kP) + (x >> 31);
}

__device__ __forceinline__ uint32_t mod_p(uint64_t x) {
  x = fold(x);
  x = fold(x);
  return static_cast<uint32_t>(x >= kP ? x - kP : x);
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
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Dots first + d (d < N) of a list of `valid` dots of one staged row
// segment x, dot i against the pattern row y + i·ys and stored at
// dst[i·ds]: sum_{e<n} x[e]·y[i·ys + e] mod p. Each x[e] is read once for
// the N sums, which fold after every kFoldEvery products. Dots past
// `valid` repeat the last one and are not stored, so every lane of a warp
// runs the same N whatever its count.
template <int N>
__device__ __forceinline__ void dots(const uint32_t* x, const uint32_t* y,
                                     int ys, int n, uint32_t* dst, int ds,
                                     int first, int valid) {
  const uint32_t* yd[N];
#pragma unroll
  for (int d = 0; d < N; ++d) yd[d] = y + min(first + d, valid - 1) * ys;
  uint64_t s[N];
#pragma unroll
  for (int d = 0; d < N; ++d) s[d] = 0;
  int e = 0;
  for (; e + kFoldEvery <= n; e += kFoldEvery) {
#pragma unroll
    for (int f = 0; f < kFoldEvery; ++f) {
      const uint64_t xv = x[e + f];
#pragma unroll
      for (int d = 0; d < N; ++d) s[d] += xv * yd[d][e + f];
    }
#pragma unroll
    for (int d = 0; d < N; ++d) s[d] = fold(s[d]);
  }
  for (; e < n; ++e) {
    const uint64_t xv = x[e];
#pragma unroll
    for (int d = 0; d < N; ++d) s[d] += xv * yd[d][e];
  }
#pragma unroll
  for (int d = 0; d < N; ++d)
    if (first + d < valid) dst[(first + d) * ds] = mod_p(s[d]);
}

struct Args {
  const uint32_t* base;    // first share element of the strided source
  const long long* desc;   // chunks: offsets, lengths, firsts, counts, rows
  long long stride_c, stride_n;
  const uint32_t* pat;     // (c, B, k, A) contiguous
  uint32_t* out;           // (c, B, height, M) contiguous
  int n_chunks, n_batch, height, w, a, k;
  int rows, pitch, patterns;  // tuples a tile, staged row pitch, chunk size
  int k_pass;                 // tile rows whose dots one pass holds
  int vec16;                  // 16-byte copies (else 4-byte)
};

// One block an SM: the staged tiles take most of its shared memory, and a
// thread may then keep the unrolled dots' sums and pointers in registers.
__global__ void __launch_bounds__(kThreads, 1)
aa_tile_kernel(const Args g, long long n_tiles, int tiles_per_src) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int m = g.w - g.k + 1;
  const int ks = g.k_pass | 1;              // odd dot-scratch stride
  const int kmax = min(g.k_pass, m);        // most tile rows a position meets
  const int ka = g.k * g.a;
  const int wa = g.w * g.a;
  const int nq = g.n_chunks;
  uint32_t* const stage0 = smem;
  uint32_t* const stage1 = smem + g.rows * g.pitch;
  uint32_t* const pat_s = smem + 2 * g.rows * g.pitch;
  uint32_t* const vals = pat_s + g.patterns * ka;
  uint32_t* const acc = vals + g.patterns * g.rows * m * ks;  // k_pass < k
  int* const member_s = reinterpret_cast<int*>(
      acc + (g.k_pass < g.k ? g.patterns * g.rows * m : 0));
  const long long lo = n_tiles * blockIdx.x / gridDim.x;
  const long long hi = n_tiles * (blockIdx.x + 1) / gridDim.x;

  // tile t -> source index (cloud z, chunk q) and first tuple i0
  auto decode = [&](long long t, int& z, int& q, int& i0) {
    const long long src = t / tiles_per_src;
    i0 = static_cast<int>(t - src * tiles_per_src) * g.rows;
    z = static_cast<int>(src / nq);
    q = static_cast<int>(src - static_cast<long long>(z) * nq);
  };

  auto issue = [&](long long t, uint32_t* buf) {
    int z, q, i0;
    decode(t, z, q, i0);
    const int len = static_cast<int>(g.desc[nq + q]);
    const int rows = min(g.rows, len - i0);
    if (rows > 0) {
      const uint32_t* src = g.base + z * g.stride_c + g.desc[q]
                            + static_cast<long long>(i0) * g.stride_n;
      if (g.vec16) {
        const int nch = (wa + 3) >> 2;
        for (int e = threadIdx.x; e < rows * nch; e += kThreads) {
          const int r = e / nch, ch = e - r * nch;
          cp_async16(buf + r * g.pitch + 4 * ch, src + r * g.stride_n + 4 * ch,
                     min(16, 4 * (wa - 4 * ch)));
        }
      } else {
        for (int e = threadIdx.x; e < rows * wa; e += kThreads) {
          const int r = e / wa, x = e - r * wa;
          cp_async4(buf + r * g.pitch + x, src + r * g.stride_n + x, 4);
        }
      }
    }
    cp_async_commit();
  };

  long long loaded = -1;                    // source whose patterns are staged
  if (lo < hi) issue(lo, stage0);
  for (long long t = lo; t < hi; ++t) {
    const bool odd = ((t - lo) & 1) != 0;
    uint32_t* const buf = odd ? stage1 : stage0;
    if (t + 1 < hi) issue(t + 1, odd ? stage0 : stage1);
    else cp_async_commit();
    cp_async_wait<1>();                     // tile t has landed
    __syncthreads();

    int z, q, i0;
    decode(t, z, q, i0);
    const int len = static_cast<int>(g.desc[nq + q]);
    const int first = static_cast<int>(g.desc[2 * nq + q]);
    const int count = static_cast<int>(g.desc[3 * nq + q]);
    const long long src = t / tiles_per_src;
    if (src != loaded) {                    // block-uniform
      loaded = src;
      for (int e = threadIdx.x; e < count; e += kThreads)
        member_s[e] = static_cast<int>(g.desc[4 * nq + first + e]);
      for (int e = threadIdx.x; e < count * ka; e += kThreads) {
        const int gi = e / ka, x = e - gi * ka;
        const long long b = g.desc[4 * nq + first + gi];
        pat_s[e] = g.pat[(static_cast<long long>(z) * g.n_batch + b) * ka + x];
      }
      __syncthreads();
    }

    const int live = min(g.rows, len - i0);  // tuples with data
    // tile rows r0 .. r0 + k_pass - 1 a pass (one pass unless the dots of
    // a whole tile do not fit); a window's chain carries over in acc
    for (int r0 = 0; r0 < g.k; r0 += g.k_pass) {
      for (int e = threadIdx.x; e < g.rows * g.w; e += kThreads) {
        const int row = e / g.w, p = e - row * g.w;
        const int r_lo = max(max(0, p - (m - 1)), r0);
        const int nr = min(min(p, g.k - 1), r0 + g.k_pass - 1) - r_lo + 1;
        if (row >= live || nr <= 0) continue;
        const uint32_t* x = buf + row * g.pitch + p * g.a;
        // the dots of position p: tile rows r_lo .. r_lo + nr - 1 against
        // each pattern of the chunk. Where a position meets one tile row
        // (the word match, k = 1), a pass takes up to kDots patterns; else
        // up to kDots tile rows of one pattern. Trip counts are
        // block-uniform.
        const int outer = kmax == 1 ? 1 : count;
        const int inner = kmax == 1 ? count : kmax;
        const int ys = kmax == 1 ? ka : g.a;
        const int ds = kmax == 1 ? g.rows * m * ks : 1 - ks;
        const int valid = kmax == 1 ? count : nr;
        for (int go = 0; go < outer; ++go) {
          const uint32_t* y = pat_s + (go * g.k + r_lo) * g.a;
          uint32_t* dst = vals + ((go * g.rows + row) * m + p - r_lo) * ks
                          + r_lo - r0;
          for (int j = 0; j < inner; j += kDots) {
            switch (min(kDots, inner - j)) {
              case 1: dots<1>(x, y, ys, g.a, dst, ds, j, valid); break;
              case 2: dots<2>(x, y, ys, g.a, dst, ds, j, valid); break;
              case 3: dots<3>(x, y, ys, g.a, dst, ds, j, valid); break;
              default: dots<4>(x, y, ys, g.a, dst, ds, j, valid); break;
            }
          }
        }
      }
      __syncthreads();

      const bool last = r0 + g.k_pass >= g.k;
      const int n_pass = min(g.k_pass, g.k - r0);
      const int rm = g.rows * m;
      for (int e = threadIdx.x; e < count * rm; e += kThreads) {
        const int gi = e / rm, rest = e - gi * rm;
        const int row = rest / m, o = rest - row * m;
        const int i = i0 + row;
        if (i >= g.height) continue;
        uint32_t v = 0u;
        if (row < live) {
          const uint32_t* d = vals + ((gi * g.rows + row) * m + o) * ks;
          v = r0 == 0 ? d[0] : acc[e];
          for (int r = r0 == 0 ? 1 : 0; r < n_pass; ++r)
            v = mod_p(static_cast<uint64_t>(v) * d[r]);
        }
        if (last)
          g.out[((static_cast<long long>(z) * g.n_batch + member_s[gi])
                 * g.height + i) * m + o] = v;
        else
          acc[e] = v;
      }
      __syncthreads();                      // buf, vals and acc are reused
    }
  }
  cp_async_wait<0>();
}

int launch(const void* base, const void* desc, int n_chunks,
           long long stride_c, long long stride_n, const void* pat, void* out,
           int n_clouds, int n_batch, int height, int w, int a, int k,
           int rows, int pitch, int patterns, int k_pass, int vec16,
           void* stream) {
  if (n_clouds <= 0 || n_batch <= 0 || height <= 0 || n_chunks <= 0)
    return 0;
  if (k < 1 || k > w || a < 1 || rows < 1 || patterns < 1 ||
      k_pass < 1 || k_pass > k || pitch < w * a || pitch % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int m = w - k + 1;
  const size_t smem = sizeof(uint32_t) *
      (2 * static_cast<size_t>(rows) * pitch +
       static_cast<size_t>(patterns) *
           (static_cast<size_t>(k) * a + static_cast<size_t>(rows) * m *
            ((k_pass | 1) + (k_pass < k ? 1 : 0)) + 1));
  cudaError_t err = cudaFuncSetAttribute(
      aa_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, aa_tile_kernel, kThreads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int tiles_per_src = (height + rows - 1) / rows;
  const long long n_tiles =
      static_cast<long long>(n_clouds) * n_chunks * tiles_per_src;
  const long long slots = static_cast<long long>(per_sm) * sms;
  const unsigned grid =
      static_cast<unsigned>(n_tiles < slots ? n_tiles : slots);
  const Args args{static_cast<const uint32_t*>(base),
                  static_cast<const long long*>(desc), stride_c, stride_n,
                  static_cast<const uint32_t*>(pat),
                  static_cast<uint32_t*>(out), n_chunks, n_batch, height, w,
                  a, k, rows, pitch, patterns, k_pass, vec16};
  aa_tile_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      args, n_tiles, tiles_per_src);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// base:     first share element of the strided source
// desc:     device int64[4·n_chunks + B'] chunk table (aa_match.py
//           pack_chunks): element offset, length, first index into the
//           trailing batch-row list, and count of each chunk
// stride_c, stride_n: element strides of the cloud and tuple axes
// pat:      device (c, B, W, A) contiguous
// out:      device (c, B, height) contiguous, 0 past each row's length
// k:        unused (the slide entry's tile height; one argument list)
// rows, pitch, patterns, k_pass: tuples a tile, staged row pitch in words
//           (a multiple of 4, >= W·A), batch rows a chunk at most, pattern
//           rows whose dots one pass holds (W for the match, as a rule)
// vec16:    1 for 16-byte copies (base, offsets and strides 16-byte
//           aligned), 0 for 4-byte copies
extern "C" int aa_match_rows_u32(const void* base, const void* desc,
                                 int n_chunks, long long stride_c,
                                 long long stride_n, const void* pat,
                                 void* out, int n_clouds, int n_batch,
                                 int height, int w, int a, int k, int rows,
                                 int pitch, int patterns, int k_pass,
                                 int vec16, void* stream) {
  (void)k;
  return launch(base, desc, n_chunks, stride_c, stride_n, pat, out, n_clouds,
                n_batch, height, w, a, w, rows, pitch, patterns, k_pass,
                vec16, stream);
}

// As aa_match_rows_u32, with pat a device (c, B, k, A) tile stack and out a
// device (c, B, height, W - k + 1) tensor, 1 <= k <= W.
extern "C" int aa_slide_rows_u32(const void* base, const void* desc,
                                 int n_chunks, long long stride_c,
                                 long long stride_n, const void* pat,
                                 void* out, int n_clouds, int n_batch,
                                 int height, int w, int a, int k, int rows,
                                 int pitch, int patterns, int k_pass,
                                 int vec16, void* stream) {
  return launch(base, desc, n_chunks, stride_c, stride_n, pat, out, n_clouds,
                n_batch, height, w, a, k, rows, pitch, patterns, k_pass,
                vec16, stream);
}
