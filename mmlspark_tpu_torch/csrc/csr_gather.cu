// K3: CSR gather of the columns a forest reads.
//
// Replaces the TPU kernel mmlspark_tpu/gbdt/pallas_sparse.py:_gather_kernel
// (driven by csr_gather_pallas / csr_gather). It turns one CSR-staged batch
// of sparse rows into the dense [N, U] matrix of only the U feature columns
// the forest's internal nodes read ("used"), so scoring a 2^18-wide hashed
// feature space never densifies it:
//
//   out[r, j] = values[k]  if some k in [indptr[r], indptr[r+1]) has
//                          indices[k] == min(used[j], width - 1)
//             = +0.0       otherwise
//
// The semantics are those of the reference's csr_gather_xla, bit for bit:
// used ids past the row width clamp to its last column (the dense
// traversal's clamped read), and "used" may come in any order, with
// duplicates; each row's indices are sorted and distinct and smaller than
// width (the executor's _csr_from_rows makes them so), so at most one entry
// matches a cell; entries at positions >= indptr[N] (the executor's
// power-of-two nnz padding; padded rows repeat the last offset) belong to no
// row and are never read; a stored value is copied as its 32 bits, so an
// explicit 0.0, a -0.0 and a NaN stay what they are. The TPU kernel instead
// contracts one-hot matrices on the MXU per nnz chunk, which adds zeros to
// each cell (turning -0.0 into 0.0 and spreading a NaN); that formulation
// exists because the TPU has no gather, and this card has one.
//
// Inputs: indptr int32 [N+1], indices int32 [nnz] (row-sorted), values as
// uint32 [nnz] (the f32 bits), used int32 [U]. Output: uint32 [N, U] (f32
// bits), every cell written exactly once.
//
// Bound on the H100. The function must read the offsets, the entries (index
// and value, 8 bytes each) and the used ids, and write 4*N*U bytes. At the
// fused executor's batch (256 rows, ~13,000 entries, ~55 used columns) that
// is ~0.16 MB, 0.05 us at 3.35 TB/s: far below what one launch costs, so the
// launch's latency bounds it, and within the launch the chain of dependent
// memory operations each warp waits through. Over a whole 65,536-row
// partition (~3.3M entries) it is ~41 MB, ~12 us: bytes.
//
// Design, query-driven out of shared memory:
// - blockIdx.y takes a chunk of up to kUsedChunk used ids (a forest of 1,000
//   trees reads ~30,000 columns), blockIdx.x a run of kWarps tiles, and each
//   warp one tile of rows_per_warp consecutive rows, whose entries are one
//   contiguous slice of the CSR arrays.
// - The block stages its chunk of used ids, clamped to width - 1, in shared
//   memory, loaded while each warp loads its tile's rows_per_warp + 1
//   offsets (one a lane): both round trips in flight together.
// - Each warp stages a window of up to kStage consecutive entries of its
//   tile (indices and values) in its own shared buffer with cp.async, all
//   of a lane's copies in flight at once (the first window while the block
//   stages the used ids), so a tile of short rows takes one round trip. A
//   row that runs past the window restarts it at the row's first entry; a
//   row longer than the window is met in pieces of kStage entries, and a
//   used id belongs to the piece whose last index is the first one >= it
//   (the row's last piece takes what is left), so each cell is decided in
//   exactly one piece.
// - Each lane takes NQ (1-4) of the chunk's used ids at a time, as few as
//   cover the chunk in one group of 32 * NQ where they can, and finds each
//   in the piece's sorted indices by a branchless binary search whose steps
//   depend only on the piece's length: the same for every lane, so the warp
//   never diverges, and a lane's NQ searches run in lockstep, their
//   shared-memory loads overlapping. A lane then writes each cell it
//   decides: the value's bits or +0.0. Consecutive lanes write consecutive
//   cells, so the stores coalesce; every output cell is written exactly
//   once, with no atomics, and the result does not depend on the order
//   anything runs in.
// So the match reads shared memory only, ~log2(row length) dependent loads
// a row, and a warp's chain of global round trips is its offsets
// (overlapped with the used ids), one window of entries, and its stores.
// The host sizes the grid (launch_geometry in gather_kernel.py): a small
// batch gets one row a warp, so each warp's chain is as short as it can be;
// a large one up to 4 rows a warp, so each round trip moves several rows'
// entries and fewer blocks are launched.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kWarps = 4;            // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kStage = 512;          // entries a warp's window holds
constexpr int kUsedChunk = 512;      // used ids a block stages
constexpr int kMaxRowsPerWarp = 31;  // each lane loads one of the offsets

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__host__ __device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a < b ? b : a;
}

// Start copying entries [pos, pos + cnt) into the warp's window with
// cp.async (4 bytes a lane and array: a row's slice has no alignment);
// wait_window() completes them.
__device__ __forceinline__ void stage_window(int32_t* s_idx, uint32_t* s_val,
                                             const int32_t* indices,
                                             const uint32_t* values,
                                             int64_t pos, int cnt, int lane) {
  for (int e = lane; e < cnt; e += 32) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     (uint32_t)__cvta_generic_to_shared(s_idx + e)),
                 "l"(indices + pos + e)
                 : "memory");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     (uint32_t)__cvta_generic_to_shared(s_val + e)),
                 "l"(values + pos + e)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The 4-byte word at a shared-memory address (volatile: never moved across
// wait_window's cp.async.wait_all).
__device__ __forceinline__ uint32_t lds(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void wait_window() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
}

// NQ: used ids a lane searches at once (a group is 32 * NQ of them), 1-4,
// the fewest that cover the chunk in one group where it can.
template <int NQ>
__global__ void __launch_bounds__(kThreads)
csr_gather_kernel(const int32_t* __restrict__ indptr,
                  const int32_t* __restrict__ indices,
                  const uint32_t* __restrict__ values,
                  const int32_t* __restrict__ used,
                  uint32_t* __restrict__ out, int n_rows, int n_used,
                  int64_t nnz, int32_t width, int rows_per_warp) {
  // the used ids [uc], the windows' indices [kWarps][kStage] and values
  // [kWarps][kStage]
  extern __shared__ int32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c0 = blockIdx.y * kUsedChunk;
  const int uc = (int)min64(kUsedChunk, n_used - c0);
  int32_t* __restrict__ s_used = smem;
  int32_t* __restrict__ s_idx = smem + uc + warp * kStage;
  uint32_t* __restrict__ s_val =
      reinterpret_cast<uint32_t*>(smem + uc + (kWarps + warp) * kStage);
  // the window's shared addresses, for the search's loads
  const uint32_t idx_base = (uint32_t)__cvta_generic_to_shared(s_idx);
  const uint32_t val_delta =
      (uint32_t)__cvta_generic_to_shared(s_val) - idx_base;

  const int64_t row0 =
      ((int64_t)blockIdx.x * kWarps + warp) * rows_per_warp;
  const int rows = (int)max64(0, min64(rows_per_warp, n_rows - row0));
  // the tile's offsets, clamped into the arrays, and the chunk's used ids:
  // both round trips in flight together
  int64_t off = 0;
  if (lane <= rows && rows > 0) {
    off = min64(max64(indptr[row0 + lane], 0), nnz);
  }
  int32_t ids[kUsedChunk / kThreads];
#pragma unroll
  for (int k = 0; k < kUsedChunk / kThreads; ++k) {
    const int j = threadIdx.x + k * kThreads;
    if (j < uc) ids[k] = min(used[c0 + j], width - 1);
  }
  // the tile's first window, copied while the block stages the used ids
  const int64_t tile_hi = __shfl_sync(~0u, off, rows);
  int64_t cur = __shfl_sync(~0u, off, 0);  // the next row's first entry
  int64_t win_lo = cur;                    // the window holds [win_lo, win_hi)
  int64_t win_hi = cur + max64(0, min64(kStage, tile_hi - cur));
  stage_window(s_idx, s_val, indices, values, win_lo, (int)(win_hi - win_lo),
               lane);
#pragma unroll
  for (int k = 0; k < kUsedChunk / kThreads; ++k) {
    const int j = threadIdx.x + k * kThreads;
    if (j < uc) s_used[j] = ids[k];
  }
  __syncthreads();
  wait_window();
  if (rows == 0) return;

  // this lane's used ids of a group: j = g + lane + 32 * i. A slot past the
  // chunk searches its last id and writes nothing. Loaded once when the
  // chunk is one group, per group and row when it is more.
  constexpr int kGroup = 32 * NQ;
  int32_t q[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) q[i] = s_used[min(lane + 32 * i, uc - 1)];
  for (int r = 0; r < rows; ++r) {
    // offsets out of order would make rows overlap; keep them in order
    // (memory safety only: no valid batch has them)
    const int64_t b = max64(__shfl_sync(~0u, off, r + 1), cur);
    uint32_t* __restrict__ out_row = out + (row0 + r) * (int64_t)n_used + c0;
    int64_t prev = INT64_MIN;  // the last index of the row's previous piece
    for (int64_t pos = cur;; pos = win_hi) {  // the row's pieces
      if (b > win_hi) {  // restart the window at the piece
        __syncwarp();    // every lane is done with the old window
        win_lo = pos;
        win_hi = pos + min64(kStage, max64(tile_hi, b) - pos);
        stage_window(s_idx, s_val, indices, values, win_lo,
                     (int)(win_hi - win_lo), lane);
        wait_window();
      }
      const bool last = b <= win_hi;
      const int lo = (int)(pos - win_lo);
      const int len = (int)(min64(b, win_hi) - pos);
      const int64_t top = last ? INT64_MAX : (int64_t)s_idx[lo + len - 1];
      for (int g = 0; g < uc; g += kGroup) {
        if (uc > kGroup) {
#pragma unroll
          for (int i = 0; i < NQ; ++i) {
            q[i] = s_used[min(g + lane + 32 * i, uc - 1)];
          }
        }
        // per id: the shared address of the last entry of the piece whose
        // index is <= it, or of the piece's first; the steps depend on the
        // piece's length only
        uint32_t at[NQ];
#pragma unroll
        for (int i = 0; i < NQ; ++i) at[i] = idx_base + 4u * lo;
        for (int n = len; n > 1;) {
          const uint32_t half = 4u * (n >> 1);
#pragma unroll
          for (int i = 0; i < NQ; ++i) {
            if ((int32_t)lds(at[i] + half) <= q[i]) at[i] += half;
          }
          n -= n >> 1;
        }
#pragma unroll
        for (int i = 0; i < NQ; ++i) {
          uint32_t v = 0u;  // an empty piece reads nothing of the window
          if (len > 0) {
            const int32_t index = (int32_t)lds(at[i]);
            const uint32_t value = lds(at[i] + val_delta);
            v = index == q[i] ? value : 0u;
          }
          const int j = g + lane + 32 * i;
          if (j < uc && q[i] > prev && q[i] <= top) out_row[j] = v;
        }
      }
      if (last) break;
      prev = top;
    }
    cur = b;
  }
}

// The launch's arguments as one block, packed by gather_kernel.py's _ARGS
// ("<6Qq6i"): ctypes converts each argument of a call anew, and a dozen of
// them cost the host more than the kernel takes on the card.
struct GatherArgs {
  const int32_t* indptr;
  const int32_t* indices;
  const uint32_t* values;
  const int32_t* used;
  uint32_t* out;
  cudaStream_t stream;
  int64_t nnz;
  int32_t n_rows, n_used, width, rows_per_warp, unused[2];
};
static_assert(sizeof(GatherArgs) == 80, "GatherArgs must match _ARGS");

}  // namespace

extern "C" int mmlspark_csr_gather(const void* packed) {
  GatherArgs a;
  memcpy(&a, packed, sizeof a);
  if (a.n_rows <= 0 || a.n_used <= 0) return (int)cudaGetLastError();
  const int64_t rows_per_block = (int64_t)kWarps * a.rows_per_warp;
  const int64_t grid_y = ((int64_t)a.n_used + kUsedChunk - 1) / kUsedChunk;
  if (a.rows_per_warp < 1 || a.rows_per_warp > kMaxRowsPerWarp ||
      grid_y > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)((a.n_rows + rows_per_block - 1) / rows_per_block),
                  (unsigned)grid_y);
  const int uc = (int)min64(a.n_used, kUsedChunk);
  const size_t smem = sizeof(int32_t) * (uc + 2 * kWarps * kStage);
  // ids a lane searches at once: the fewest that cover the chunk, up to 4
  auto* kernel = uc <= 32   ? csr_gather_kernel<1>
                 : uc <= 64 ? csr_gather_kernel<2>
                 : uc <= 96 ? csr_gather_kernel<3>
                            : csr_gather_kernel<4>;
  kernel<<<grid, kThreads, smem, a.stream>>>(
      a.indptr, a.indices, a.values, a.used, a.out, a.n_rows, a.n_used, a.nnz,
      a.width, a.rows_per_warp);
  return (int)cudaGetLastError();
}
