// Hopper (sm_90a) building blocks shared by the flash-attention kernels:
// K5 (csrc/flash_attn.cu) and K6/K7 (csrc/flash_attn_bwd.cu).
//
//   - mbarriers (init, expect-tx, arrive, a parity wait that traps after
//     ~10 s instead of hanging the card);
//   - TMA: 4-D tiled loads and stores through CUtensorMaps
//     (cp.async.bulk.tensor.4d), and plain bulk copies of contiguous bytes
//     (cp.async.bulk) that complete on an mbarrier;
//   - wgmma fences, commits and waits, and register fences that keep the
//     compiler from touching the registers an in-flight wgmma owns;
//   - setmaxnreg, the 128-byte-swizzle shared-memory descriptor, exp2,
//     f32 -> bf16x2 packing and the accumulator -> A-fragment conversion;
//   - one 64-column box of a K-major product (ss_box, the D-chunk step of
//     the sliced kernels), the bf16 staging of a warpgroup's accumulator in
//     the TMA box layout and its TMA store (stage_rows, store_cols);
//   - the consumer warpgroups' turns at the tensor cores and their other
//     named barriers;
//   - on the host, the 4-D tensor map over a strided bf16 [B, T, H, D]
//     view, built with cuTensorMapEncodeTiled reached through
//     cudaGetDriverEntryPoint (so no library links -lcuda).
//
// Each source that includes this is its own shared library, so the
// definitions live in an anonymous namespace.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct Strides {  // in elements
  int64_t b, t, h;
};

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// ---------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait for the phase with the given parity to complete. A wait that lasts
// ~10 s traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  long long t0 = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > (1ll << 34)) {
      __trap();
    }
  }
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ``bytes`` contiguous bytes (a multiple of 16; both addresses 16-byte
// aligned) from global to shared memory, completing on ``bar``
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across this point
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) asm volatile("" : "+r"(r[i][c])::"memory");
  }
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile (rows of 128
// bytes, 8-row atoms of 1024 bytes): start address, leading and stride
// byte offsets (16-byte units), layout type 1 = 128B swizzle
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two f32 -> one bf16x2 register, ``lo`` in the low half
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// a warpgroup's f32 64 x kN accumulator rounded to bf16 as the A operand
// of a register-A wgmma, columns 16kk..16kk+15 in p[kk] (the accumulator
// layout of m64nN is the A-fragment layout of m64k16)
template <int kN>
__device__ __forceinline__ void pack_p(const float (&s)[kN / 2],
                                       uint32_t (&p)[kN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      p[kk][c] = pack_f32(s[8 * kk + 2 * c], s[8 * kk + 2 * c + 1]);
    }
  }
}

// d (+)= A B^T over one 64-column box, four k16 steps: A a warpgroup's 64
// rows and B N rows, both K-major in 128-byte swizzled boxes (rows of 128
// bytes); ``acc`` = 0 overwrites d at the first step, 1 accumulates
template <int N>
__device__ __forceinline__ void ss_box(float (&d)[N / 2], const uint8_t* sa,
                                       const uint8_t* sb, int acc) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_ss<N>(d, desc_sw128(sa + kk * 32, 16, 1024),
                desc_sw128(sb + kk * 32, 16, 1024), acc | (kk != 0));
  }
}

// one arrival of this warp on a ring stage's free barrier
__device__ __forceinline__ void release_stage(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// Products summed over D's 64-column chunks, streamed through a ring of
// kStages stages: chunk c of tile ``tile`` lies in stage g % kStages, g =
// tile * n_chunks + c (phase (g / kStages) & 1). ``issue(stage, acc)``
// issues the chunk's wgmmas (acc = 0 at the first chunk overwrites the
// accumulators). A stage is released once the wgmma that reads it has
// landed, the next chunk's being issued first; on return every wgmma has
// landed (the caller fences its accumulators).
template <int kStages, typename Issue>
__device__ __forceinline__ void sum_chunks(uint64_t* full, uint64_t* free,
                                           int tile, int n_chunks, int lane,
                                           Issue&& issue) {
  const int g0 = tile * n_chunks;
  mbar_wait(&full[g0 % kStages], (g0 / kStages) & 1);
  wgmma_fence();
  issue(g0 % kStages, 0);
  wgmma_commit();
  for (int c = 1; c < n_chunks; ++c) {
    const int g = g0 + c;
    mbar_wait(&full[g % kStages], (g / kStages) & 1);
    wgmma_fence();
    issue(g % kStages, 1);
    wgmma_commit();
    wgmma_wait<1>();  // chunk c - 1 has been read
    release_stage(&free[(g - 1) % kStages], lane);
  }
  wgmma_wait<0>();
  release_stage(&free[(g0 + n_chunks - 1) % kStages], lane);
}

// the chunk stages of a tile that is not computed: waited for, released
template <int kStages>
__device__ __forceinline__ void skip_chunks(uint64_t* full, uint64_t* free,
                                            int tile, int n_chunks,
                                            int lane) {
  for (int c = 0; c < n_chunks; ++c) {
    const int g = tile * n_chunks + c;
    mbar_wait(&full[g % kStages], (g / kStages) & 1);
    release_stage(&free[g % kStages], lane);
  }
}

// a warpgroup's 64 x DV accumulator rounded to bf16 into [DV/64][64][64]
// boxes in the TMA layout (row rr of a box at rr * 128 bytes, 16-byte unit
// u at (u ^ rr % 8) * 16)
template <int DV>
__device__ __forceinline__ void stage_rows(const float (&o)[DV / 2],
                                           uint8_t* dst, int warp, int lane) {
#pragma unroll
  for (int i = 0; i < DV / 8; ++i) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int rr = 16 * warp + lane / 4 + 8 * hf;
      *reinterpret_cast<uint32_t*>(dst + (i / 8) * 8192 + rr * 128 +
                                   (((i % 8) ^ (rr % 8)) * 16) +
                                   (lane & 3) * 4) =
          pack_f32(o[4 * i + 2 * hf], o[4 * i + 2 * hf + 1]);
    }
  }
}

// make a warpgroup's staged rows visible to TMA and wait for all of its
// threads (its first thread then stores them)
__device__ __forceinline__ void staged(int wg) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" ::"r"(8 + wg) : "memory");
}

// kBoxes staged 64 x 64 boxes to columns col0, col0 + 64, .. of 64 rows
template <int kBoxes>
__device__ __forceinline__ void store_cols(const CUtensorMap* map,
                                           const uint8_t* src, int col0,
                                           int row, int h, int b) {
#pragma unroll
  for (int c = 0; c < kBoxes; ++c) {
    tma_store(map, src + c * 8192, col0 + c * 64, row, h, b);
  }
}

__device__ __forceinline__ void store_done() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// named barriers over the two consumer warpgroups (256 threads)
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

// The consumer warpgroups take turns to issue their products, in order
// 0, 1, .., kWG - 1, 0, ..: warpgroup w waits at named barrier 1 + w for
// the previous one's pass. So one warpgroup's exponentials run under
// another's products instead of all of them contending for the tensor
// cores at once.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;" ::"r"(1 + wg) : "memory");
}

template <int kWG>
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;" ::"r"(1 + (wg + 1) % kWG) : "memory");
}

// ------------------------------------------------------------------ host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded (no -lcuda)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a 4-D map over one strided bf16 [B, T, H, D] tensor, in TMA's order
// (D, T, H, B), boxes of 64 columns x ``rows`` rows, 128-byte swizzled;
// reads past T come back as zeros and stores past T are dropped
bool make_map(CUtensorMap* map, const void* ptr, int batch, int t, int heads,
              int d, const Strides& st, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st.t * 2, (cuuint64_t)st.h * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
