// K4: flat ragged-bin histogram of masked (grad, hess, count), f64-accumulated.
//
// Replaces the TPU kernel mmlspark_tpu/gbdt/pallas_sparse.py:_sparse_hist_kernel
// (driven by sparse_histogram_mxu / flat_hist_dispatch). On the TPU the sums
// are a one-hot MXU contraction per nnz chunk into a VMEM accumulator, which
// caps the flat bin space at 128k bins; the reference's default is instead a
// scatter-free prefix sum, because the TPU has no scatter hardware. Neither
// reason holds here, so this kernel computes the bin sums directly:
//
//   out[c, b] = sum_{j in [bin_end[b-1], bin_end[b])} data[c, j]   (c = g, h, count)
//
// Entries arrive bin-sorted, so each bin is one contiguous segment of the
// entry stream and bin_end (exclusive end offsets, bin_end[-1] = nnz) is the
// whole layout; empty bins have bin_end[b] == bin_end[b-1]. Sums accumulate
// in f64 and the wrapper rounds each cell to f32 once (as K1): the result
// does not depend on the order partial sums land in, so the card and the
// plain version on the CPU build the same histogram up to a double-rounding
// tie, and the grower's sibling subtraction inherits no order-dependent
// error. The count channel is exact.
//
// Inputs: data f32 [3, nnz] (row stride nnz: masked g, h, mask), bin_end
// int32 [TB]. Output: f64 [3, TB] accumulator, zeroed by the caller on the
// same stream.
//
// Bound on the H100: bytes. It must read 12*nnz bytes of stats and 4*TB of
// offsets and write 12*TB: at 49.7M entries and 1.31M bins about 0.62 GB, or
// 0.19 ms against 3.35 TB/s. The arithmetic (3 adds per entry) is nothing.
//
// Design against skew (one bin of a text-shaped dataset can hold 10^5 or
// more entries): the grid tiles the ENTRY stream, never the bins. Each block
// stages a tile of 2048 entries (3 channels) in shared memory with coalesced
// loads and finds the tile's bin range with two binary searches over
// bin_end. Each thread then walks 8 consecutive entries, skipping empty
// bins, keeps one f64 partial per segment run and adds finished runs into
// the output with f64 atomics; the run it ends on is combined across the
// warp by a segmented shuffle scan (keys are non-decreasing across lanes),
// so a bin spanning many tiles costs one atomic per warp and channel, not
// one per entry or per thread. nnz = 0 launches nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
// one padding word per 32 keeps a warp's stride-8 reads of the staged tile
// on 32 distinct banks
constexpr int kTilePadded = kTile + kTile / 32;

__device__ __forceinline__ int pad_index(int i) { return i + (i >> 5); }

// first b in [lo, hi) with bin_end[b] > e, or hi if there is none
__device__ __forceinline__ int upper_bin(const int32_t* __restrict__ bin_end,
                                         int lo, int hi, int64_t e) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if ((int64_t)bin_end[mid] > e) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

__device__ __forceinline__ void add_cell(double* __restrict__ out, int64_t tb,
                                         int b, double g, double h,
                                         double c) {
  atomicAdd(out + b, g);
  atomicAdd(out + tb + b, h);
  atomicAdd(out + 2 * tb + b, c);
}

__global__ void __launch_bounds__(kThreads)
sparse_hist_kernel(const float* __restrict__ data,
                   const int32_t* __restrict__ bin_end,
                   double* __restrict__ out, int64_t nnz, int tb) {
  __shared__ float s_data[3][kTilePadded];
  __shared__ int s_range[2];

  const int64_t tile0 = (int64_t)blockIdx.x * kTile;
  const int64_t tile1 = tile0 + kTile < nnz ? tile0 + kTile : nnz;
  const int count = (int)(tile1 - tile0);

  // the tile's bin range [lo, hi): two independent searches, issued while
  // the other threads stage the tile
  if (threadIdx.x == 0) s_range[0] = upper_bin(bin_end, 0, tb, tile0);
  if (threadIdx.x == 32) {
    const int last = upper_bin(bin_end, 0, tb, tile1 - 1);
    s_range[1] = last < tb ? last + 1 : tb;
  }
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const int p = pad_index(i);
    s_data[0][p] = data[tile0 + i];
    s_data[1][p] = data[nnz + tile0 + i];
    s_data[2][p] = data[2 * nnz + tile0 + i];
  }
  __syncthreads();
  const int lo = s_range[0];
  const int hi = s_range[1];

  // this thread's run of entries [i0, i1) within the tile; `key` is the bin
  // of the segment it carries (tb = none)
  const int i0 = threadIdx.x * kItems;
  const int i1 = i0 + kItems < count ? i0 + kItems : count;
  int key = tb;
  double g = 0.0, h = 0.0, c = 0.0;
  if (i0 < i1) {
    int b = upper_bin(bin_end, lo, hi, tile0 + i0);
    key = b;
    for (int i = i0; i < i1 && b < tb; ++i) {
      const int64_t e = tile0 + i;
      while (b < tb && (int64_t)bin_end[b] <= e) ++b;  // skip empty bins
      if (b >= tb) break;  // past the last bin: not part of the layout
      if (b != key) {
        add_cell(out, tb, key, g, h, c);
        key = b;
        g = h = c = 0.0;
      }
      const int p = pad_index(i);
      g += (double)s_data[0][p];
      h += (double)s_data[1][p];
      c += (double)s_data[2][p];
    }
  }

  // segmented inclusive scan of the carried runs across the warp; the last
  // lane of each key adds the combined run
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  for (int d = 1; d < 32; d <<= 1) {
    const int k_up = __shfl_up_sync(full, key, d);
    const double g_up = __shfl_up_sync(full, g, d);
    const double h_up = __shfl_up_sync(full, h, d);
    const double c_up = __shfl_up_sync(full, c, d);
    if (lane >= d && k_up == key) {
      g += g_up;
      h += h_up;
      c += c_up;
    }
  }
  const int k_next = __shfl_down_sync(full, key, 1);
  if (key < tb && (lane == 31 || k_next != key)) {
    add_cell(out, tb, key, g, h, c);
  }
}

}  // namespace

extern "C" int mmlspark_sparse_hist(const void* data, const void* bin_end,
                                    void* out, int64_t nnz, int tb,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nnz <= 0 || tb <= 0) return (int)cudaGetLastError();
  const int64_t blocks = (nnz + kTile - 1) / kTile;
  sparse_hist_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const float*>(data), static_cast<const int32_t*>(bin_end),
      static_cast<double*>(out), nnz, tb);
  return (int)cudaGetLastError();
}
