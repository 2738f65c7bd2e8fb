// K3: CSR gather of the columns a forest reads.
//
// Replaces the TPU kernel mmlspark_tpu/gbdt/pallas_sparse.py:_gather_kernel
// (driven by csr_gather_pallas / csr_gather). It turns one CSR-staged batch
// of sparse rows into the dense [N, U] matrix of only the U feature columns
// the forest's internal nodes read ("used", sorted ascending), so scoring a
// 2^18-wide hashed feature space never densifies it:
//
//   out[r, j] = values[k]  if some k in [indptr[r], indptr[r+1]) has
//                          indices[k] == min(used[j], width - 1)
//             = +0.0       otherwise
//
// The semantics are those of the reference's csr_gather_xla, bit for bit:
// used ids past the row width clamp to its last column (the dense
// traversal's clamped read); each row's indices are sorted and distinct and
// smaller than width (the executor's _csr_from_rows makes them so), so at
// most one entry matches a cell; entries at positions >= indptr[N] (the
// executor's power-of-two nnz padding; padded rows repeat the last offset)
// belong to no row and are never read; a stored value is copied as its 32
// bits, so an explicit 0.0, a -0.0 and a NaN stay what they are. The TPU
// kernel instead contracts one-hot matrices on the MXU per nnz chunk, which
// adds zeros to each cell (turning -0.0 into 0.0 and spreading a NaN); that
// formulation exists because the TPU has no gather, and this card has one.
//
// Inputs: indptr int32 [N+1], indices int32 [nnz] (row-sorted), values as
// uint32 [nnz] (the f32 bits), used int32 [U] (sorted ascending). Output:
// uint32 [N, U] (f32 bits), every cell written.
//
// Bound on the H100: bytes. The function must read the batch's entries
// (8 bytes each), its offsets and the used ids, and write 4*N*U bytes: for a
// 256-row batch of text rows (~50 entries a row) and ~300 used columns
// about 0.4 MB, 0.12 us against 3.35 TB/s, so each launch is bound by its
// latency, not by the card. The arithmetic is a few compares per cell.
//
// Design: one warp per row; its lanes stride over the U used columns, each
// clamps its column id and finds it by a lower-bound binary search in the
// row's sorted index slice (log2 of the row length steps, served by L1/L2
// once the first lanes have touched the slice). Consecutive lanes write
// consecutive cells of the row, so the stores coalesce. No shared memory,
// no atomics: every cell has one writer, and the result does not depend on
// the order anything runs in.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;

__global__ void __launch_bounds__(kThreads)
csr_gather_kernel(const int32_t* __restrict__ indptr,
                  const int32_t* __restrict__ indices,
                  const uint32_t* __restrict__ values,
                  const int32_t* __restrict__ used,
                  uint32_t* __restrict__ out, int n_rows, int n_used,
                  int64_t nnz, int32_t width) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  // the row's entries; an offset past the arrays is never dereferenced
  int64_t hi = indptr[row + 1];
  int64_t lo = indptr[row];
  if (hi > nnz) hi = nnz;
  if (lo > hi) lo = hi;
  uint32_t* __restrict__ out_row = out + row * (int64_t)n_used;
  for (int j = lane; j < n_used; j += 32) {
    const int32_t q = min(used[j], width - 1);
    int64_t a = lo;
    int64_t b = hi;
    while (a < b) {  // first position in [lo, hi) whose index is >= q
      const int64_t mid = a + ((b - a) >> 1);
      if (indices[mid] < q) {
        a = mid + 1;
      } else {
        b = mid;
      }
    }
    out_row[j] = (a < hi && indices[a] == q) ? values[a] : 0u;
  }
}

}  // namespace

extern "C" int mmlspark_csr_gather(const void* indptr, const void* indices,
                                   const void* values, const void* used,
                                   void* out, int n_rows, int n_used,
                                   int64_t nnz, int width, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_rows <= 0 || n_used <= 0) return (int)cudaGetLastError();
  const int blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  csr_gather_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const int32_t*>(indptr),
      static_cast<const int32_t*>(indices),
      static_cast<const uint32_t*>(values), static_cast<const int32_t*>(used),
      static_cast<uint32_t*>(out), n_rows, n_used, nnz, (int32_t)width);
  return (int)cudaGetLastError();
}
