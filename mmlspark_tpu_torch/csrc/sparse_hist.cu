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
// entry stream and bin_end (exclusive end offsets) is the whole layout;
// empty bins have bin_end[b] == bin_end[b-1]. The stream's valid length is
// nnz = bin_end[-1], read on the device: the stats may be wider (a static
// width, their row stride), as a stream compacted to a subset of its rows
// is, whose length only the device knows. Entries at or past bin_end[-1]
// are neither read nor written. Each bin is
// summed in f64 in one fixed order and rounded to f32 once: the result is
// bitwise the same from run to run, and equal to the plain version's on the
// CPU up to a double-rounding tie. The count channel is exact.
//
// Inputs: data f32 [3, width] (row stride width: masked g, h, mask), bin_end
// int32 [TB] with bin_end[-1] <= width, both 16-byte aligned. Output: f32
// [3, TB], every cell written once. Scratch: per share a head and a tail
// carry (int32 key, 3 f64).
//
// Bound on the H100: bytes. It must read 12*nnz bytes of stats and 4*TB of
// offsets and write 12*TB: at 49.7M entries and 1.31M bins about 0.62 GB, or
// 0.18 ms against 3.35 TB/s. The arithmetic (3 adds per entry) is nothing.
//
// Design: a load-balanced segmented reduction by merge path (Merrill and
// Garland's CSR SpMV). The merge of the TB bin-end markers with the nnz
// entries is a path of nnz + TB items (marker b comes before entry j when
// bin_end[b] <= j); the host (sparse_hist_kernel.shares) sizes the grid for
// the width, P persistent blocks (3 per SM), and each block cuts the path of
// the valid length into P equal shares and takes its own, however skewed the
// bins (one bin of a text-shaped dataset can hold 10^5 or more entries) or
// long the runs of empty bins. A block finds its share's start with a
// binary search of bin_end, then walks the share in tiles of up to 5,888
// items: 16-byte cp.async copies put the tile's entries and its next 738
// bin ends in shared memory, one thread finds the tile's end there (a run
// of empty bins longer than the staged ends cuts the tile short), and each
// thread searches there for its first of 23 items and walks them, summing
// runs of entries in f64. Three blocks share an SM, so one block's copies
// run while another reduces (a second stage a block, to overlap its own,
// measured slower: fewer blocks fit). A bin that ends within a thread is
// written straight to the f32 output; the partial runs that cross threads
// meet in a block-wide segmented scan in a fixed order, and a tile's open
// run carries to the next tile. The first bin a share ends and the run open at
// its end cross share boundaries: they go to the carry scratch, and a
// second launch of one block adds them up in share order and writes those
// bins. No memset, no global atomics, one global search per share.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kIpt = 23;  // odd: threads' runs of entries fall on distinct banks
constexpr int kTile = kThreads * kIpt;
// bin ends staged a tile: a tile takes at most kEndWin - 1 markers (it ends
// early when a run of empty bins would take more)
constexpr int kEndWin = kTile / 8 + 2;
// floats (ints) a channel (the bin ends) takes in shared memory: the
// values, the 0-3 before them that align the first 16-byte copy, rounded up
// to whole copies
constexpr int kStride = kTile + 8;
constexpr int kEndStride = (kEndWin + 6) / 4 * 4;
constexpr int kSmemBytes = (3 * kStride + kEndStride) * 4;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// values before p that align it down to 16 bytes
__device__ __forceinline__ int misalign(const void* p) {
  return (int)(((uintptr_t)p >> 2) & 3);
}

// Copy `count` 4-byte values from src (the first `valid` of them readable)
// into dst, 16 bytes at a time from src aligned down; value k lands at
// dst[misalign(src) + k]. Copies past `valid` are zero-filled, never read.
__device__ __forceinline__ void stage(float* dst, const float* src, int count,
                                      int64_t valid) {
  const int a = misalign(src);
  const float* base = src - a;
  const int chunks = (a + count + 3) / 4;
  const int64_t readable = valid + a;
  for (int k = threadIdx.x; k < chunks; k += kThreads) {
    const int64_t left = readable - 4 * (int64_t)k;
    if (left <= 0) break;
    cp_async16(dst + 4 * k, base + 4 * k, left >= 4 ? 16 : (int)left * 4);
  }
}

// Merge-path search: markers consumed in the first `diag` items of the path
// that starts at (ti, tj), over markers [ti, tb) and entries [tj, nnz), or
// `cap` if that many or more. end(x) is bin_end[ti + x].
template <typename End>
__device__ __forceinline__ int path_search(End end, int diag, int ti, int tj,
                                           int tb, int nnz, int cap) {
  int lo = max(0, diag - (nnz - tj));
  int hi = min(min(diag, tb - ti), cap);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (end(mid) <= tj + diag - mid - 1) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

struct Run {
  double v[3];
  bool cut;  // a bin ended in it: earlier runs do not add to it
};

// segmented combine: a then b
__device__ __forceinline__ Run combine(const Run& a, const Run& b) {
  Run r;
#pragma unroll
  for (int c = 0; c < 3; ++c) r.v[c] = b.cut ? b.v[c] : a.v[c] + b.v[c];
  r.cut = a.cut || b.cut;
  return r;
}

__device__ __forceinline__ Run shfl_up(const Run& x, int d) {
  Run r;
#pragma unroll
  for (int c = 0; c < 3; ++c) r.v[c] = __shfl_up_sync(0xffffffffu, x.v[c], d);
  r.cut = __shfl_up_sync(0xffffffffu, (int)x.cut, d) != 0;
  return r;
}

// OutT: float (the histogram) or double (its sums before the one rounding,
// for a sharded fit that adds them across processes first)
template <typename OutT>
__global__ void __launch_bounds__(kThreads)
sparse_hist_kernel(const float* __restrict__ data,
                   const int32_t* __restrict__ bin_end,
                   OutT* __restrict__ out, int32_t* __restrict__ carry_key,
                   double* __restrict__ carry_val, int width, int tb) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_coord[4];  // the share's start (i, j), a tile's end
  __shared__ Run s_warp[kWarps];
  __shared__ int s_head_key;
  __shared__ double s_head[3];

  // the valid length, and this grid's equal shares of its path
  const int nnz = min(width, max(0, (int)bin_end[tb - 1]));
  const int total = nnz + tb;
  const int share = (int)(((int64_t)total + gridDim.x - 1) / gridDim.x);
  const int p = blockIdx.x;
  const int d0 = (int)min((int64_t)p * share, (int64_t)total);
  const int d1 = (int)min((int64_t)(p + 1) * share, (int64_t)total);
  if (threadIdx.x == 0) {
    const int i = path_search([&](int x) { return bin_end[x]; }, d0, 0, 0,
                              tb, nnz, tb);
    s_coord[0] = i;
    s_coord[1] = d0 - i;
    s_head_key = -1;
  }
  __syncthreads();
  const int i0 = s_coord[0];
  int ti = s_coord[0], tj = s_coord[1];

  auto fetch_tile = [&](int ti_, int tj_) {
    float* st = smem;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      stage(st + c * kStride, data + (int64_t)c * width + tj_, kTile,
            (int64_t)nnz - tj_);
    }
    stage(st + 3 * kStride, reinterpret_cast<const float*>(bin_end + ti_),
          kEndWin, (int64_t)tb - ti_);
    cp_async_commit();
  };

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Run carry = {{0.0, 0.0, 0.0}, false};  // the open run before the tile
  if (d0 < d1) fetch_tile(ti, tj);
  for (int dt = d0; dt < d1;) {
    cp_async_wait_all();
    __syncthreads();
    const float* st = smem;
    const int ad[3] = {misalign(data + tj),
                       misalign(data + (int64_t)width + tj),
                       misalign(data + 2 * (int64_t)width + tj)};
    const int ae = misalign(bin_end + ti);
    const int32_t* s_end = reinterpret_cast<const int32_t*>(st + 3 * kStride) + ae;
    auto lend = [&](int x) { return s_end[x]; };
    // this thread's items [a, b) of the tile; the last thread also finds
    // where the tile ends (the next tile's start): after kTile items, or
    // after its last staged marker if the path reaches that first
    constexpr int kMarkers = kEndWin - 1;
    const int D = min(kTile, d1 - dt);
    const int a = min(D, (int)threadIdx.x * kIpt);
    const int x = path_search(lend, a, ti, tj, tb, nnz, kMarkers);
    if (threadIdx.x == kThreads - 1) {
      int xe = path_search(lend, D, ti, tj, tb, nnz, kMarkers);
      int je = tj + D - xe;
      if (xe >= kMarkers && kMarkers < min(D, tb - ti)) {
        xe = kMarkers;
        je = s_end[kMarkers - 1];
      }
      s_coord[2] = ti + xe;
      s_coord[3] = je;
    }
    __syncthreads();
    const int nti = s_coord[2], ntj = s_coord[3];
    const int De = nti - ti + ntj - tj;  // the tile's items
    const int b = min(De, a + kIpt);
    int i = ti + x, j = tj + a - x;
    Run run = {{0.0, 0.0, 0.0}, false};
    int head_key = -1;
    double head[3] = {0.0, 0.0, 0.0};
    for (int it = a; it < b; ++it) {
      if (i < tb && (j >= nnz || s_end[i - ti] <= j)) {  // bin i ends
        if (!run.cut) {
          head_key = i;
#pragma unroll
          for (int c = 0; c < 3; ++c) head[c] = run.v[c];
          run.cut = true;
        } else {
#pragma unroll
          for (int c = 0; c < 3; ++c) out[(int64_t)c * tb + i] = (OutT)run.v[c];
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) run.v[c] = 0.0;
        ++i;
      } else {  // entry j (of no bin once i == tb)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          run.v[c] += (double)st[c * kStride + ad[c] + (j - tj)];
        }
        ++j;
      }
    }

    // block-wide segmented scan of the runs, in thread order
    Run inc = run;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Run up = shfl_up(inc, d);
      if (lane >= d) inc = combine(up, inc);
    }
    if (lane == 31) s_warp[warp] = inc;
    __syncthreads();
    Run before = carry;  // the runs of the tile's earlier warps
    for (int w = 0; w < warp; ++w) before = combine(before, s_warp[w]);
    Run excl = shfl_up(inc, 1);
    if (lane > 0) before = combine(before, excl);
    if (head_key >= 0) {
      double v[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c] = before.v[c] + head[c];
      if (head_key == i0) {  // the share's first bin: it may start earlier
        s_head_key = head_key;
#pragma unroll
        for (int c = 0; c < 3; ++c) s_head[c] = v[c];
      } else {
#pragma unroll
        for (int c = 0; c < 3; ++c) out[(int64_t)c * tb + head_key] = (OutT)v[c];
      }
    }
    for (int w = 0; w < kWarps; ++w) carry = combine(carry, s_warp[w]);
    __syncthreads();  // the stage, s_warp and s_coord are free again
    if (dt + De < d1) fetch_tile(nti, ntj);
    ti = nti;
    tj = ntj;
    dt += De;
  }
  if (threadIdx.x == 0) {
    carry_key[p] = s_head_key;
    carry_key[gridDim.x + p] = ti;  // the bin open at the share's end
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      carry_val[3 * p + c] = s_head_key >= 0 ? s_head[c] : 0.0;
      carry_val[3 * (gridDim.x + p) + c] = carry.v[c];
    }
  }
}

// The bins that cross shares: share p's first bin gets the open runs of the
// shares before it that end in the same bin, added in share order.
template <typename OutT>
__global__ void sparse_hist_carry_kernel(const int32_t* __restrict__ carry_key,
                                         const double* __restrict__ carry_val,
                                         OutT* __restrict__ out, int shares,
                                         int tb) {
  for (int p = threadIdx.x; p < shares; p += blockDim.x) {
    const int key = carry_key[p];
    if (key < 0 || key >= tb) continue;
    int q = p;
    while (q > 0 && carry_key[shares + q - 1] == key) --q;
    double v[3] = {0.0, 0.0, 0.0};
    for (int r = q; r < p; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c] += carry_val[3 * (shares + r) + c];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      out[(int64_t)c * tb + key] = (OutT)(v[c] + carry_val[3 * p + c]);
    }
  }
}

template <typename OutT>
int launch(const void* data, const void* bin_end, void* out, void* carry_key,
           void* carry_val, int width, int tb, int shares, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      sparse_hist_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  sparse_hist_kernel<OutT><<<shares, kThreads, kSmemBytes, s>>>(
      static_cast<const float*>(data), static_cast<const int32_t*>(bin_end),
      static_cast<OutT*>(out), static_cast<int32_t*>(carry_key),
      static_cast<double*>(carry_val), width, tb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sparse_hist_carry_kernel<OutT><<<1, 256, 0, s>>>(
      static_cast<const int32_t*>(carry_key),
      static_cast<const double*>(carry_val), static_cast<OutT*>(out), shares,
      tb);
  return (int)cudaGetLastError();
}

}  // namespace

// `shares` blocks (sparse_hist_kernel.shares of the width); carry_key holds
// 2 * shares int32, carry_val 6 * shares doubles. out_f64 = 0: ``out`` is
// f32 [3, TB]; 1: the same sums unrounded, f64.
extern "C" int mmlspark_sparse_hist(const void* data, const void* bin_end,
                                    void* out, void* carry_key,
                                    void* carry_val, int width, int tb,
                                    int shares, int out_f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tb <= 0) return (int)cudaGetLastError();
  if (width < 0 || shares <= 0) return (int)cudaErrorInvalidValue;
  if (out_f64) {
    return launch<double>(data, bin_end, out, carry_key, carry_val, width, tb,
                          shares, s);
  }
  return launch<float>(data, bin_end, out, carry_key, carry_val, width, tb,
                       shares, s);
}
