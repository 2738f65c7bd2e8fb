// K1: masked per-feature bin histogram of (grad, hess, count), f64-accumulated.
//
// Replaces the TPU kernel mmlspark_tpu/gbdt/pallas_hist.py:_hist_kernel
// (driven by _hist_slab / compute_histogram_mxu). On the TPU the scatter is
// reformulated as a one-hot contraction on the MXU, by default with a bf16
// hi/lo split of grad/hess; that trick exists for the MXU and has nothing to
// do on this card. Sums accumulate in f64 and are rounded to f32 once, so
// each cell is the f32 rounding of its exact sum whatever order the adds
// land in: the CUDA result equals the plain version's on the CPU (which also
// accumulates in f64) up to a double-rounding tie. Plain f32 accumulation is
// not enough here: with the sibling-subtraction trick a small child inherits
// the rounding error of every ancestor's sum over millions of rows, and at
// 2M rows that error swamps the child's own sums (LightGBM keeps its
// histograms in double for the same reason). Counts are exact integers.
//
//   out[f, b, 0] = sum_n mask[n] * grad[n] * (bins[f, n] == b)
//   out[f, b, 1] = sum_n mask[n] * hess[n] * (bins[f, n] == b)
//   out[f, b, 2] = sum_n mask[n]           * (bins[f, n] == b)
//
// Inputs: bins int32 [F, N] (feature-major, row stride N), grad/hess f32
// [N], mask uint8 [N]. Output: f32 [F, B, 3], written once. Scratch: f64
// [row_blocks, F, B, 3] block partials (the global path: f64 [F, B, 3]).
//
// Bound on the H100: bytes. The function must read each selected row's
// bins (4*F bytes), grad, hess and its mask and write 12*F*B bytes: ~38 us
// at 1M selected of N = 2M rows, F = 28, against 3.35 TB/s. Memory moves
// 32-byte sectors of 8 rows, so at a random 50% mask nearly every sector of
// bins is read: ~70 us at that shape.
//
// Design (Hopper). The host (hist_kernel.launch_geometry) sizes the grid;
// every block owns a contiguous range of rows and a group of features whose
// whole histograms fit its dynamic shared memory (opted in up to 227 KB:
// at B = 256 all 28 features, 140 KB, so grad, hess and the mask are read
// once), as f64 grad and hess sums and u32 counts (native integer shared
// atomics; only grad and hess take f64 shared atomics). Each warp takes
// units of (feature, 128 rows): one 16-byte load of 4 bins a lane, the
// lane's 4 rows' mask, grad and hess (16-byte loads; the block's warps work
// on neighbouring rows at once, so these hit L1 after the first feature).
// f64 shared atomics compile to a compare-and-swap loop (ATOMS.CAST.SPIN.64
// on sm_90a), so they, and not the bytes, bound the kernel: a warp whose
// first row of a unit shows a bin held by 4 or more lanes (a feature of a
// few levels: the b-tags of HIGGS-shaped data hold three) aggregates the
// unit: lanes that share a bin find each other (__match_any_sync) and the
// lowest of them adds their grad and hess in lane order with one atomic a
// cell, where 32 lanes would otherwise retry on 3 cells. Epilogue: each
// block writes its f64 partial to scratch (no memset, no global atomics)
// and a second launch sums the partials in block order and writes the f32
// output once. The in-block f64 adds land in
// atomic order, so the result is not bitwise the same from run to run (a
// cell can differ in its last f32 bit at a rounding tie).
//
// When one feature's histogram does not fit (B > 11,622; the engine allows
// up to 65,535 bins) the kernel adds straight into a zeroed f64 [F, B, 3]
// with global atomics, and the second launch rounds it.
//
// The device-count entry (mmlspark_hist_count) serves the device-resident
// tree grower, which never reads a row count on the host: K2 compacts a
// small child into a buffer as wide as the largest tier, and this entry
// sums rows [0, *count) of it, *count an int32 in device memory, with no
// mask. Its grid is sized for the buffer; each block reads the count,
// takes the geometry the host's launch_geometry gives for the narrowest
// tier width that holds the count (a table the host passes by value), and
// returns at once when its rows start past the count. So each split
// streams only the child's rows, its partials group rows as a launch sized
// for that tier does, and the reduction sums only the blocks that held
// rows (the others' partials would be +0.0). A captured CUDA graph replays
// it unchanged for any count.

#include <cuda_runtime.h>
#include <stdint.h>

// The device-count entry's launch geometry: the host computes K1's grid
// (hist_kernel.launch_geometry) for each width a row count may be grouped
// by, widest first; the kernel picks the narrowest width that holds the
// count it reads, so its blocks take the rows a launch sized for that width
// would take.
constexpr int kMaxTiers = 8;
struct CountTiers {
  int32_t n;                             // entries; width[0] = buffer width
  int32_t row_blocks[kMaxTiers];
  int64_t width[kMaxTiers];
  int64_t rows_per_block[kMaxTiers];
};

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kUnitRows = 128;  // rows of a warp's unit: 4 a lane
// a unit aggregates when some bin holds this many of the warp's first rows
constexpr int kAggMinGroup = 4;

struct Quad {
  int b[4];
};

// the 4 bins of rows [r, r + 4) of one feature row (rows past n: -1)
__device__ __forceinline__ Quad load_bins(const int32_t* __restrict__ p,
                                          int64_t r, int64_t n) {
  Quad q;
  if (r + 4 <= n && ((uintptr_t)(p + r) & 15) == 0) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(p + r));
    q.b[0] = v.x, q.b[1] = v.y, q.b[2] = v.z, q.b[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) q.b[k] = r + k < n ? __ldg(p + r + k) : -1;
  }
  return q;
}

__device__ __forceinline__ float4 load_f4(const float* __restrict__ p,
                                          int64_t r, int64_t n) {
  if (r + 4 <= n && ((uintptr_t)(p + r) & 15) == 0) {
    return __ldg(reinterpret_cast<const float4*>(p + r));
  }
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = r + k < n ? __ldg(p + r + k) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// bit k set: row r + k is in range and selected
__device__ __forceinline__ unsigned load_sel(const uint8_t* __restrict__ m,
                                             int64_t r, int64_t n) {
  unsigned sel = 0;
  if (r + 4 <= n && ((uintptr_t)(m + r) & 3) == 0) {
    const unsigned v = __ldg(reinterpret_cast<const unsigned*>(m + r));
#pragma unroll
    for (int k = 0; k < 4; ++k) sel |= ((v >> (8 * k)) & 0xffu) ? 1u << k : 0u;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) sel |= (r + k < n && __ldg(m + r + k)) ? 1u << k : 0u;
  }
  return sel;
}

// the block histogram of rows [r0, r1) of a group of features, written as
// the block's f64 partial; kMasked: rows are selected by ``mask``, else
// every row of the range counts (the device-count entry's compacted rows)
template <bool kMasked>
__device__ __forceinline__ void hist_rows(const int32_t* __restrict__ bins,
                                          const float* __restrict__ grad,
                                          const float* __restrict__ hess,
                                          const uint8_t* __restrict__ mask,
                                          double* __restrict__ partial,
                                          int64_t stride, int64_t r0,
                                          int64_t r1, int num_f, int num_bins,
                                          int feat_per_block,
                                          unsigned char* smem) {
  const int f0 = blockIdx.y * feat_per_block;
  const int nf = min(feat_per_block, num_f - f0);
  const int cells = nf * num_bins;
  double* s_g = reinterpret_cast<double*>(smem);
  double* s_h = s_g + cells;
  unsigned* s_c = reinterpret_cast<unsigned*>(s_h + cells);
  // per warp: its lanes' grad/hess of one row, for the aggregating lane
  float2* s_x = reinterpret_cast<float2*>(
      smem + (((size_t)cells * 20 + 15) & ~(size_t)15));
  for (int i = threadIdx.x; i < cells; i += kThreads) {
    s_g[i] = 0.0;
    s_h[i] = 0.0;
    s_c[i] = 0u;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t chunks = r1 > r0 ? (r1 - r0 + kUnitRows - 1) / kUnitRows : 0;
  // units (chunk, feature), feature fastest: the warps at work at one time
  // share rows, so a row's mask, grad and hess come from L1 after its first
  // feature
  for (int64_t u = warp; u < chunks * nf; u += kWarps) {
    const int fl = (int)(u % nf);
    const int64_t r = r0 + (u / nf) * kUnitRows + 4 * lane;
    const int64_t rn = min(r1, r0 + (u / nf + 1) * kUnitRows);
    unsigned sel = 0u;
    if (kMasked) {
      sel = r < rn ? load_sel(mask, r, rn) : 0u;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) sel |= r + k < rn ? 1u << k : 0u;
    }
    const Quad q = load_bins(bins + (int64_t)(f0 + fl) * stride, r, rn);
    const float4 g4 = load_f4(grad, r, rn);
    const float4 h4 = load_f4(hess, r, rn);
    const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
    const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
    const int base = fl * num_bins;
    // aggregate the unit when its first rows already share bins widely
    // (a feature of a few levels); else each lane adds its own rows
    const bool ok0 = (sel & 1u) && (unsigned)q.b[0] < (unsigned)num_bins;
    const unsigned peers0 = __match_any_sync(0xffffffffu, ok0 ? q.b[0] : -1);
    const bool agg = __reduce_max_sync(0xffffffffu, ok0 ? __popc(peers0) : 0)
                     >= kAggMinGroup;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int b = q.b[k];
      const bool ok = ((sel >> k) & 1u) && (unsigned)b < (unsigned)num_bins;
      if (agg) {
        const unsigned peers =
            k == 0 ? peers0 : __match_any_sync(0xffffffffu, ok ? b : -1);
        s_x[warp * 32 + lane] = make_float2(gv[k], hv[k]);
        __syncwarp();
        if (ok && lane == __ffs(peers) - 1) {
          double sg = 0.0, sh = 0.0;
          for (unsigned m = peers; m; m &= m - 1) {
            const float2 x = s_x[warp * 32 + __ffs(m) - 1];
            sg += (double)x.x;
            sh += (double)x.y;
          }
          atomicAdd(s_g + base + b, sg);
          atomicAdd(s_h + base + b, sh);
          atomicAdd(s_c + base + b, (unsigned)__popc(peers));
        }
        __syncwarp();
      } else if (ok) {
        atomicAdd(s_g + base + b, (double)gv[k]);
        atomicAdd(s_h + base + b, (double)hv[k]);
        atomicAdd(s_c + base + b, 1u);
      }
    }
  }
  __syncthreads();

  double* dst = partial + ((int64_t)blockIdx.x * num_f + f0) * num_bins * 3;
  for (int i = threadIdx.x; i < cells; i += kThreads) {
    dst[3 * i] = s_g[i];
    dst[3 * i + 1] = s_h[i];
    dst[3 * i + 2] = (double)s_c[i];
  }
}

__global__ void __launch_bounds__(kThreads)
hist_block_kernel(const int32_t* __restrict__ bins,
                  const float* __restrict__ grad,
                  const float* __restrict__ hess,
                  const uint8_t* __restrict__ mask,
                  double* __restrict__ partial, int64_t n, int num_f,
                  int num_bins, int feat_per_block, int64_t rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  hist_rows<true>(bins, grad, hess, mask, partial, n, r0,
                  min(r0 + rows_per_block, n), num_f, num_bins,
                  feat_per_block, smem);
}

// (rows per block, blocks that hold rows) for the count at *count
__device__ __forceinline__ void count_geometry(const CountTiers& t,
                                               const int32_t* count,
                                               int64_t* cnt, int64_t* rpb,
                                               int* used) {
  const int64_t c = min((int64_t)max(*count, 0), t.width[0]);
  int k = 0;
  for (int i = 1; i < t.n; ++i) k = c <= t.width[i] ? i : k;
  *cnt = c;
  *rpb = t.rows_per_block[k];
  *used = (int)min((int64_t)t.row_blocks[k], (c + *rpb - 1) / *rpb);
}

__global__ void __launch_bounds__(kThreads)
hist_count_kernel(const int32_t* __restrict__ bins,
                  const float* __restrict__ grad,
                  const float* __restrict__ hess,
                  const int32_t* __restrict__ count,
                  double* __restrict__ partial, int64_t stride, int num_f,
                  int num_bins, int feat_per_block, CountTiers tiers) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t cnt, rpb;
  int used;
  count_geometry(tiers, count, &cnt, &rpb, &used);
  if ((int)blockIdx.x >= used) return;  // past the count: no rows, no partial
  const int64_t r0 = (int64_t)blockIdx.x * rpb;
  hist_rows<false>(bins, grad, hess, nullptr, partial, stride, r0,
                   min(r0 + rpb, cnt), num_f, num_bins, feat_per_block, smem);
}

// out[i] = sum over blocks of partial[blk, i], blocks in order, rounded to
// OutT once (float: the histogram; double: the f64 sums a sharded fit adds
// up across processes before it rounds)
template <typename OutT>
__global__ void hist_reduce_kernel(const double* __restrict__ partial,
                                   OutT* __restrict__ out, int64_t cells,
                                   int blocks) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cells) return;
  double s = 0.0;
  for (int k = 0; k < blocks; ++k) s += partial[(int64_t)k * cells + i];
  out[i] = (OutT)s;
}

// the count entry's reduction: the partials of the blocks that held rows
template <typename OutT>
__global__ void hist_count_reduce_kernel(const double* __restrict__ partial,
                                         OutT* __restrict__ out,
                                         int64_t cells,
                                         const int32_t* __restrict__ count,
                                         CountTiers tiers) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cells) return;
  int64_t cnt, rpb;
  int used;
  count_geometry(tiers, count, &cnt, &rpb, &used);
  double s = 0.0;
  for (int k = 0; k < used; ++k) s += partial[(int64_t)k * cells + i];
  out[i] = (OutT)s;
}

// global path: rows [0, n) selected by ``mask``, or with no mask rows
// [0, *count)
__global__ void hist_global_kernel(const int32_t* __restrict__ bins,
                                   const float* __restrict__ grad,
                                   const float* __restrict__ hess,
                                   const uint8_t* __restrict__ mask,
                                   const int32_t* __restrict__ count,
                                   double* __restrict__ acc, int64_t n,
                                   int num_f, int num_bins) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t rows = mask ? n : min((int64_t)max(*count, 0), n);
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < rows;
       r += stride) {
    if (mask && !mask[r]) continue;
    const double g = grad[r];
    const double h = hess[r];
    for (int f = 0; f < num_f; ++f) {
      const int b = bins[(int64_t)f * n + r];
      if ((unsigned)b >= (unsigned)num_bins) continue;
      double* cell = acc + ((int64_t)f * num_bins + b) * 3;
      atomicAdd(cell, g);
      atomicAdd(cell + 1, h);
      atomicAdd(cell + 2, 1.0);
    }
  }
}

int reduce(const double* partial, void* out, int out_f64, int64_t cells,
           int blocks, cudaStream_t s) {
  const int64_t grid = (cells + 255) / 256;
  if (out_f64) {
    hist_reduce_kernel<double><<<(unsigned)grid, 256, 0, s>>>(
        partial, static_cast<double*>(out), cells, blocks);
  } else {
    hist_reduce_kernel<float><<<(unsigned)grid, 256, 0, s>>>(
        partial, static_cast<float*>(out), cells, blocks);
  }
  return (int)cudaGetLastError();
}

// Opt a kernel into ``smem`` bytes of dynamic shared memory once per device
// (``done`` holds the most set so far on each device). Launches after the
// first make no runtime call but the launch, so a captured CUDA graph
// holds only kernels.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int smem, int* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (smem <= done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) done[dev] = smem;
  return err;
}

int g_block_smem[64];
int g_count_smem[64];

}  // namespace

// The grid comes from the host: row_blocks x groups blocks of kThreads,
// feat_per_block features and rows_per_block rows (a multiple of 4) each,
// smem_bytes of dynamic shared memory (20 * feat_per_block * num_bins, 16-
// aligned, plus 8 KB for the aggregating warps); feat_per_block = 0 selects the
// global path (scratch holds F * B * 3 doubles, row_blocks its grid).
// out_f64 = 0: ``out`` is f32 [F, B, 3]; 1: the same sums unrounded, f64.
extern "C" int mmlspark_hist(const void* bins, const void* grad,
                             const void* hess, const void* mask, void* out,
                             void* scratch, int64_t n, int num_f,
                             int num_bins, int feat_per_block, int row_blocks,
                             int64_t rows_per_block, int smem_bytes,
                             int out_f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t cells = (int64_t)num_f * num_bins * 3;
  if (n < 0 || num_f <= 0 || num_bins <= 0 || row_blocks <= 0 ||
      rows_per_block <= 0 || rows_per_block % 4) {
    return (int)cudaErrorInvalidValue;
  }
  double* acc = static_cast<double*>(scratch);
  if (feat_per_block <= 0) {
    cudaError_t err = cudaMemsetAsync(acc, 0, cells * sizeof(double), s);
    if (err != cudaSuccess) return (int)err;
    hist_global_kernel<<<(unsigned)row_blocks, 256, 0, s>>>(
        static_cast<const int32_t*>(bins), static_cast<const float*>(grad),
        static_cast<const float*>(hess), static_cast<const uint8_t*>(mask),
        nullptr, acc, n, num_f, num_bins);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return reduce(acc, out, out_f64, cells, 1, s);
  }
  const int groups = (num_f + feat_per_block - 1) / feat_per_block;
  cudaError_t err = opt_in(hist_block_kernel, smem_bytes, g_block_smem);
  if (err != cudaSuccess) return (int)err;
  hist_block_kernel<<<dim3((unsigned)row_blocks, (unsigned)groups), kThreads,
           (size_t)smem_bytes, s>>>(
      static_cast<const int32_t*>(bins), static_cast<const float*>(grad),
      static_cast<const float*>(hess), static_cast<const uint8_t*>(mask), acc,
      n, num_f, num_bins, feat_per_block, rows_per_block);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return reduce(acc, out, out_f64, cells, row_blocks, s);
}

// The device-count entry: rows [0, *count) of bins int32 [F, n] (row
// stride n) and grad/hess f32 [n] count, with no mask; *count is an int32
// in device memory, read by the kernels (no host read). ``tiers`` holds,
// widest first, the widths the rows may be grouped by and K1's geometry
// for each (width[0] = n; all with the same feat_per_block and
// smem_bytes). The grid is grid_blocks (the most row_blocks of any tier) x
// groups blocks, and those past the rows the count needs return at once.
// Scratch: f64 [grid_blocks, F, B, 3] (the global path: F * B * 3 doubles,
// grid_blocks blocks of 256 threads). Two launches, as the mask entry;
// the same output (out_f64 as there).
extern "C" int mmlspark_hist_count(const void* bins, const void* grad,
                                   const void* hess, const void* count,
                                   void* out, void* scratch, int64_t n,
                                   int num_f, int num_bins,
                                   int feat_per_block, int grid_blocks,
                                   int smem_bytes, CountTiers tiers,
                                   int out_f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t cells = (int64_t)num_f * num_bins * 3;
  if (n < 0 || num_f <= 0 || num_bins <= 0 || grid_blocks <= 0 ||
      tiers.n < 1 || tiers.n > kMaxTiers || tiers.width[0] != n) {
    return (int)cudaErrorInvalidValue;
  }
  for (int i = 0; i < tiers.n; ++i) {
    if (tiers.row_blocks[i] <= 0 || tiers.row_blocks[i] > grid_blocks ||
        tiers.rows_per_block[i] <= 0 || tiers.rows_per_block[i] % 4 ||
        (i && tiers.width[i] > tiers.width[i - 1])) {
      return (int)cudaErrorInvalidValue;
    }
  }
  const int32_t* cnt = static_cast<const int32_t*>(count);
  double* acc = static_cast<double*>(scratch);
  if (feat_per_block <= 0) {
    cudaError_t err = cudaMemsetAsync(acc, 0, cells * sizeof(double), s);
    if (err != cudaSuccess) return (int)err;
    hist_global_kernel<<<(unsigned)grid_blocks, 256, 0, s>>>(
        static_cast<const int32_t*>(bins), static_cast<const float*>(grad),
        static_cast<const float*>(hess), nullptr, cnt, acc, n, num_f,
        num_bins);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return reduce(acc, out, out_f64, cells, 1, s);
  }
  const int groups = (num_f + feat_per_block - 1) / feat_per_block;
  cudaError_t err = opt_in(hist_count_kernel, smem_bytes, g_count_smem);
  if (err != cudaSuccess) return (int)err;
  hist_count_kernel<<<dim3((unsigned)grid_blocks, (unsigned)groups),
                      kThreads, (size_t)smem_bytes, s>>>(
      static_cast<const int32_t*>(bins), static_cast<const float*>(grad),
      static_cast<const float*>(hess), cnt, acc, n, num_f, num_bins,
      feat_per_block, tiers);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t grid = (cells + 255) / 256;
  if (out_f64) {
    hist_count_reduce_kernel<double><<<(unsigned)grid, 256, 0, s>>>(
        acc, static_cast<double*>(out), cells, cnt, tiers);
  } else {
    hist_count_reduce_kernel<float><<<(unsigned)grid, 256, 0, s>>>(
        acc, static_cast<float*>(out), cells, cnt, tiers);
  }
  return (int)cudaGetLastError();
}
