// K2: stable compaction of the masked rows of feature-major GBDT data.
//
// Replaces the TPU kernel mmlspark_tpu/gbdt/pallas_select.py:_select_kernel
// (driven by _select_rows / select_rows). The TPU kernel compacts each row
// tile with one-hot MXU contractions and lands it with an offset DMA into a
// [cap, 128-lane] buffer that XLA then transposes back to feature-major and
// scrubs past the count. Here the output is written feature-major [F, cap]
// directly, and the kernel writes every output element exactly once: the
// selected rows, then zeros from the count to cap.
//
//   bins_out[f, p] = bins[f, r_p],  grad_out[p] = grad[r_p],
//   hess_out[p] = hess[r_p]         for the p-th selected row r_p, p < cap,
//   and 0 for count <= p < cap
//
// Bit-exact: values are copied, never computed, and selected rows keep their
// order, so a histogram of the compacted rows sums in the same order as a
// histogram of the masked full width.
//
// Bound on the H100: bytes. It must read the mask (N bytes) and, for the
// selected rows, their bins and grad/hess (4*(F+2) bytes each), and write
// the [F+2, cap] outputs once: at N = 2M, F = 28, 30% of the rows selected
// and cap = 1M, about 204 MB, ~61 us against 3.35 TB/s. The memory moves
// 32-byte sectors, 8 rows of a feature, and at that density 94% of them
// hold a selected row (1 - 0.7^8), so the reads of bins cost nearly all
// of [F, N] (235 MB): ~0.11 ms is what the copy can reach there.
//
// Design: two launches, each row block (a whole number of 2048-row chunks,
// at most kMaxBlocks blocks; the caller sizes them) handled by one CTA of
// 256 threads:
//   1. select_count_kernel: the block's count of selected rows;
//   2. select_scatter_kernel: the block sums the counts of the blocks before
//      it and of all blocks (at most 1024 ints, from L2), so it knows where
//      its rows go and where the zero tail starts; then per chunk a stable
//      compaction of the chunk's selected row indices into shared memory
//      (one warp ballot per 256 rows, one scan of the 64 warp counts), and
//      the copies by the whole block from that index list: grad and hess by
//      all threads, each feature's row by one warp (eight loads in flight a
//      lane), so reads and writes run along consecutive addresses; last, the
//      block's share of the zero tail [min(count, cap), cap) of every
//      output row. Nothing is written at or past cap.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 8;                  // 256-row rounds per chunk
constexpr int kChunk = kThreads * kRounds;  // rows per chunk
constexpr int kMaxBlocks = 1024;

// sum of one value over the block, returned to every thread; ``red`` holds
// kWarps values and is free again when it returns
__device__ __forceinline__ long long block_sum(long long v, long long* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  long long total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += red[w];
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kThreads)
select_count_kernel(const uint8_t* __restrict__ mask, int64_t n,
                    int64_t rows_per_block, int32_t* __restrict__ counts) {
  __shared__ long long red[kWarps];
  const int64_t lo = (int64_t)blockIdx.x * rows_per_block;
  const int64_t hi = min(n, lo + rows_per_block);
  int c = 0;
#pragma unroll 8
  for (int64_t r = lo + threadIdx.x; r < hi; r += kThreads) c += mask[r] != 0;
  const long long total = block_sum(c, red);
  if (threadIdx.x == 0) counts[blockIdx.x] = (int32_t)total;
}

__global__ void __launch_bounds__(kThreads)
select_scatter_kernel(const int32_t* __restrict__ bins,
                      const float* __restrict__ grad,
                      const float* __restrict__ hess,
                      const uint8_t* __restrict__ mask,
                      const int32_t* __restrict__ counts, int64_t n, int num_f,
                      int64_t cap, int64_t rows_per_block, int n_blocks,
                      int32_t* __restrict__ bins_out,
                      float* __restrict__ grad_out,
                      float* __restrict__ hess_out) {
  __shared__ int32_t idx[kChunk];            // the chunk's selected rows
  __shared__ int32_t offs[kRounds * kWarps];  // per (round, warp) offsets
  __shared__ int32_t n_sel;
  __shared__ long long red[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // where this block's rows go, and the total count
  long long before = 0, all = 0;
  for (int i = tid; i < n_blocks; i += kThreads) {
    const int c = counts[i];
    all += c;
    before += i < (int)blockIdx.x ? c : 0;
  }
  before = block_sum(before, red);
  all = block_sum(all, red);

  const int64_t lo = (int64_t)blockIdx.x * rows_per_block;
  const int64_t hi = min(n, lo + rows_per_block);
  int64_t pos = before;
  for (int64_t c0 = lo; c0 < hi && pos < cap; c0 += kChunk) {
    // stable compaction of the chunk's selected rows into idx
    unsigned ballots[kRounds];
#pragma unroll
    for (int i = 0; i < kRounds; ++i) {
      const int64_t r = c0 + i * kThreads + tid;
      ballots[i] = __ballot_sync(0xffffffffu, r < hi && mask[r]);
      if (lane == 0) offs[i * kWarps + warp] = __popc(ballots[i]);
    }
    __syncthreads();
    if (warp == 0) {  // exclusive scan of the 64 counts, two per lane
      const int a = offs[2 * lane];
      const int b = offs[2 * lane + 1];
      int incl = a + b;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      const int excl = incl - a - b;
      offs[2 * lane] = excl;
      offs[2 * lane + 1] = excl + a;
      if (lane == 31) n_sel = incl;
    }
    __syncthreads();
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int i = 0; i < kRounds; ++i) {
      if (ballots[i] >> lane & 1u) {
        idx[offs[i * kWarps + warp] + __popc(ballots[i] & below)] =
            (int32_t)(c0 + i * kThreads + tid);
      }
    }
    __syncthreads();
    const int m = (int)min((int64_t)n_sel, cap - pos);
    for (int p = tid; p < m; p += kThreads) {
      const int r = idx[p];
      grad_out[pos + p] = grad[r];
      hess_out[pos + p] = hess[r];
    }
    for (int f = warp; f < num_f; f += kWarps) {
      const int32_t* src = bins + (int64_t)f * n;
      int32_t* dst = bins_out + (int64_t)f * cap + pos;
#pragma unroll 8
      for (int p = lane; p < m; p += 32) dst[p] = src[idx[p]];
    }
    pos += n_sel;
    __syncthreads();  // idx, offs and n_sel are rewritten by the next chunk
  }

  // this block's share of the zero tail of every output row
  const int64_t z0 = min((int64_t)all, cap);
  const int64_t per = (cap - z0 + n_blocks - 1) / n_blocks;
  const int64_t t0 = z0 + (int64_t)blockIdx.x * per;
  const int64_t t1 = min(cap, t0 + per);
  for (int f = 0; f < num_f + 2; ++f) {
    uint32_t* dst = f < num_f ? reinterpret_cast<uint32_t*>(bins_out) +
                                    (int64_t)f * cap
                    : f == num_f ? reinterpret_cast<uint32_t*>(grad_out)
                                 : reinterpret_cast<uint32_t*>(hess_out);
#pragma unroll 4
    for (int64_t p = t0 + tid; p < t1; p += kThreads) dst[p] = 0u;
  }
}

}  // namespace

// bins int32 [F, n], grad/hess f32 [n], mask bool [n] (all contiguous);
// counts: int32 scratch of n_blocks; outputs int32 [F, cap], f32 [cap] x 2,
// every element written. Row block b covers rows [b * rows_per_block,
// (b + 1) * rows_per_block): rows_per_block is a multiple of 2048 and
// n_blocks (1..1024) covers n. Two launches. Returns a cudaError_t code.
extern "C" int mmlspark_select(const void* bins, const void* grad,
                               const void* hess, const void* mask,
                               void* counts, void* bins_out, void* grad_out,
                               void* hess_out, int64_t n, int num_f,
                               int64_t cap, int64_t rows_per_block,
                               int n_blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cap <= 0) return (int)cudaGetLastError();
  if (n < 0 || n >= (1ll << 31) || num_f < 0 || rows_per_block <= 0 ||
      rows_per_block % kChunk || n_blocks < 1 || n_blocks > kMaxBlocks ||
      rows_per_block * n_blocks < n) {
    return (int)cudaErrorInvalidValue;
  }
  select_count_kernel<<<n_blocks, kThreads, 0, s>>>(
      static_cast<const uint8_t*>(mask), n, rows_per_block,
      static_cast<int32_t*>(counts));
  select_scatter_kernel<<<n_blocks, kThreads, 0, s>>>(
      static_cast<const int32_t*>(bins), static_cast<const float*>(grad),
      static_cast<const float*>(hess), static_cast<const uint8_t*>(mask),
      static_cast<const int32_t*>(counts), n, num_f, cap, rows_per_block,
      n_blocks, static_cast<int32_t*>(bins_out),
      static_cast<float*>(grad_out), static_cast<float*>(hess_out));
  return (int)cudaGetLastError();
}
