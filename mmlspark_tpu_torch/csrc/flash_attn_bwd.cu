// K6 and K7: the flash-attention backward for Hopper (sm_90a), bf16 in and
// out, f32 accumulation.
//
// Replace the two Pallas kernels of the library's flash-attention backward
// (jax/experimental/pallas/ops/tpu/flash_attention.py), which the reference
// runs when it differentiates its flash route
// (mmlspark_tpu/models/attention.py:_flash_dispatch, under jax.value_and_grad
// in models/training.py:make_train_step):
//   K6 = _flash_attention_bwd_dkv (pallas_call :1121, kernel body :796),
//   K7 = _flash_attention_bwd_dq  (pallas_call :1456, kernel body :1146).
//
// The function, per (b, h), with s = sm_scale = 1/sqrt(D), q, k, v, dO bf16
// [B, T, H, D] read through their strides, lse and di f32 [B, H, Tq]:
//
//   P   = exp(s * Q K^T - lse)          (lse from K5's forward: natural log)
//   dV  = P^T dO                        (K6)
//   dP  = dO V^T
//   dS  = s * P o (dP - di)             (di = rowsum(dO o O), computed outside)
//   dK  = dS^T Q                        (K6)
//   dQ  = dS K                          (K7)
//
// non-causal (Tq != Tk allowed) or full-square causal (key j visible to
// query i when j <= i; masked entries of P are 0). Rounding as the library's
// kernels round: the scores, P, dP and dS are f32; P and dS are rounded to
// bf16 before the products that read them; every product sums in f32; dQ,
// dK and dV are rounded to bf16 once, at the end.
//
// Bound on the H100: operations. K6 does four products of 2*Tq*Tk*D flops
// per (b, h) (S^T, P^T dO, dP^T, dS^T Q), K7 three (S, dP, dS K), halved
// under causal masking, against 2 bytes per element of q, k, v, dO and the
// outputs: at T = 2048, D = 64 that is ~1,300-1,800 flops per byte, above
// the card's ~295 (989 TFLOP/s bf16 / 3.35 TB/s).
//
// Design (a first kernel that is right: mma.sync, not yet wgmma/TMA):
//   - K6: one CTA of 4 warps per (b, h x column split, 64-key tile); warp w
//     owns keys 16w..16w+15 of the tile and keeps their dK and dV rows in
//     registers. The CTA loads its K and V tiles once, then walks the query
//     tiles (kNQ rows: 64 at D = 64, 32 above; under causal masking only
//     the tiles at or below the diagonal), double-buffered with cp.async:
//     Q, dO, lse and di of the next tile load while this one computes;
//   - K7: one CTA of 4 warps per (b, h x column split, 64-query tile); warp
//     w owns query rows 16w..16w+15 and their dQ row in registers, loads
//     Q and dO once and walks the key tiles (K and V double-buffered;
//     causal: only tiles at or below the diagonal, the longest rows first);
//   - every product is mma.sync.m16n8k16 (bf16 in, f32 accumulate) with
//     operands from shared memory by ldmatrix (.trans where the tile is
//     [k][n]); tiles are stored with 16-byte chunks XOR-swizzled by row so
//     that ldmatrix reads no bank twice. The f32 S^T (K6) and dS (K7)
//     accumulators become the A operands of the next product in registers
//     (the accumulator layout of m16n8 is the A fragment layout of m16k16);
//   - at D = 256 a CTA computes half the output columns (kDV = 128): the
//     f32 accumulators of all 256 columns of dK and dV would take 256
//     registers a thread. The two CTAs of a tile each recompute P and dP
//     and accumulate their half of dK, dV (or dQ);
//   - 1-D grid over (batch, head x column split, tile), tiles fastest, as
//     K5's: past grid.z's 65,535 cap on B x H (flash_kernel.bwd_launch_grid
//     and grid_decode mirror it).
// No atomics: dQ has its own kernel (as in the library) instead of being
// added up across key tiles, so every output element has one writer and two
// calls give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct Strides {  // in elements
  int64_t b, t, h;
};

struct BwdArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;  // [B, H, Tq]
  const float* di;   // [B, H, Tq]
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  int heads, tq, tk;
  float scale, scale_log2;
};

template <int D>
struct BwdCfg {
  static constexpr int kDV = D <= 128 ? D : 128;  // output columns per CTA
  static constexpr int kSplit = D / kDV;
  static constexpr int kNQ = D == 64 ? 64 : 32;   // K6's query tile
  static constexpr int kRow = D * 2;              // bytes of a tile row
  static constexpr int kTile64 = 64 * kRow;
  static constexpr int kTileNQ = kNQ * kRow;
  // K6: K, V, then two stages of (Q, dO, lse, di)
  static constexpr int kStageDkv = 2 * kTileNQ + 2 * kNQ * 4;
  static constexpr int kSmemDkv = 2 * kTile64 + 2 * kStageDkv;
  // K7: Q, dO, then two stages of (K, V)
  static constexpr int kSmemDq = 2 * kTile64 + 2 * 2 * kTile64;
  static_assert(kSmemDq <= 232448 && kSmemDkv <= 232448, "shared memory");
};

// ---------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 f32
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// ------------------------------------------------------------ tiles and MMAs

// shared-memory address of row r, column c (a multiple of 8) of a tile of D
// bf16 columns: 16-byte chunk c/8 of the row stored at chunk (c/8) ^ (r % 8)
template <int D>
__device__ __forceinline__ uint32_t tile_addr(uint32_t base, int r, int c) {
  return base + r * (D * 2) + ((((c >> 3) ^ (r & 7))) << 4);
}

// ``rows`` rows of D bf16 from ``src`` (rows ``stride`` elements apart, each
// 16-byte aligned) into a swizzled tile, 16 bytes a cp.async
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          int64_t stride, int rows, int tid) {
  constexpr int kChunks = D / 8;
  for (int i = tid; i < rows * kChunks; i += 128) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    cp_async16(dst + r * (D * 2) + ((c ^ (r & 7)) << 4),
               src + r * stride + c * 8);
  }
}

template <int N>
__device__ __forceinline__ void load_f32(uint32_t dst, const float* src,
                                         int tid) {
  for (int i = tid; i < N / 4; i += 128) cp_async16(dst + 16 * i, src + 4 * i);
}

// acc[16 x N] += A[m0 : m0 + 16, :] B[0 : N, :]^T over the D columns of two
// swizzled tiles (A rows and B rows both K-major)
template <int N, int D>
__device__ __forceinline__ void gemm_abt(float (&acc)[N / 8][4], uint32_t sa,
                                         int m0, uint32_t sb, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, tile_addr<D>(sa, m0 + (lane & 15), 16 * kk + 8 * (lane >> 4)));
#pragma unroll
    for (int n = 0; n < N / 16; ++n) {
      uint32_t b[4];
      ldsm_x4(b, tile_addr<D>(sb, 16 * n + (lane & 7) + 8 * (lane >> 4),
                              16 * kk + 8 * ((lane >> 3) & 1)));
      mma16816(acc[2 * n], a, b[0], b[1]);
      mma16816(acc[2 * n + 1], a, b[2], b[3]);
    }
  }
}

// acc[16 x N] += A[16 x K] B[0 : K, c0 : c0 + N]: A as bf16 register
// fragments, B rows 0..K-1 of a swizzled tile of D columns ([k][n])
template <int N, int K, int D>
__device__ __forceinline__ void gemm_rb(float (&acc)[N / 8][4],
                                        const uint32_t (&a)[K / 16][4],
                                        uint32_t sb, int c0, int lane) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
#pragma unroll
    for (int n = 0; n < N / 16; ++n) {
      uint32_t b[4];
      ldsm_x4_t(b, tile_addr<D>(sb, 16 * kk + (lane & 15),
                                c0 + 16 * n + 8 * (lane >> 4)));
      mma16816(acc[2 * n], a[kk], b[0], b[1]);
      mma16816(acc[2 * n + 1], a[kk], b[2], b[3]);
    }
  }
}

// an f32 16 x N accumulator rounded to bf16 A fragments of K = N
template <int N>
__device__ __forceinline__ void to_a_frags(const float (&acc)[N / 8][4],
                                           uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_f32(acc[2 * kk][0], acc[2 * kk][1]);
    a[kk][1] = pack_f32(acc[2 * kk][2], acc[2 * kk][3]);
    a[kk][2] = pack_f32(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
    a[kk][3] = pack_f32(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  }
}

// a warp's 16 x N accumulator, rounded to bf16, into rows r0 and r0 + 8 of
// ``out`` (rows ``stride`` elements apart), columns c0 + 8j + 2(lane % 4)
template <int N>
__device__ __forceinline__ void store_rows(const float (&acc)[N / 8][4],
                                           __nv_bfloat16* out, int64_t stride,
                                           int r0, int c0, int lane) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      __nv_bfloat16* dst =
          out + (int64_t)(r0 + 8 * hf) * stride + c0 + 8 * j + 2 * (lane & 3);
      *reinterpret_cast<uint32_t*>(dst) =
          pack_f32(acc[j][2 * hf], acc[j][2 * hf + 1]);
    }
  }
}

__device__ __forceinline__ const __nv_bfloat16* at(const __nv_bfloat16* p,
                                                   const Strides& s, int b,
                                                   int t, int h) {
  return p + b * s.b + (int64_t)t * s.t + h * s.h;
}

// blockIdx.x -> (batch, head, first output column, tile), tiles fastest
template <int D>
__device__ __forceinline__ void decode(int tiles, int heads, int& b, int& h,
                                       int& col0, int& tile) {
  using C = BwdCfg<D>;
  const unsigned hc = (unsigned)heads * C::kSplit;
  tile = (int)(blockIdx.x % (unsigned)tiles);
  const int hs = (int)((blockIdx.x / (unsigned)tiles) % hc);
  b = (int)(blockIdx.x / ((unsigned)tiles * hc));
  h = hs / C::kSplit;
  col0 = (hs % C::kSplit) * C::kDV;
}

// ------------------------------------------------------------------ K6: dK dV

template <int D, bool kCausal>
__global__ void __launch_bounds__(128) flash_bwd_dkv(const BwdArgs a) {
  using C = BwdCfg<D>;
  constexpr int kNQ = C::kNQ;
  constexpr int kDV = C::kDV;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t s_k = smem_u32(smem);
  const uint32_t s_v = s_k + C::kTile64;
  const uint32_t s_stage = s_v + C::kTile64;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  int b, h, col0, kt;
  decode<D>(a.tk / 64, a.heads, b, h, col0, kt);
  const int k0 = 64 * kt;
  const int n_q = a.tq / kNQ;
  // causal: the query tiles whose last row sees the tile's first key
  const int qi0 = kCausal ? k0 / kNQ : 0;
  const int64_t row_bh = ((int64_t)b * a.heads + h) * a.tq;

  load_tile<D>(s_k, at(a.k, a.sk, b, k0, h), a.sk.t, 64, tid);
  load_tile<D>(s_v, at(a.v, a.sv, b, k0, h), a.sv.t, 64, tid);
  auto load_stage = [&](int qi, int st) {
    const uint32_t base = s_stage + st * C::kStageDkv;
    const int qs = qi * kNQ;
    load_tile<D>(base, at(a.q, a.sq, b, qs, h), a.sq.t, kNQ, tid);
    load_tile<D>(base + C::kTileNQ, at(a.dout, a.sdo, b, qs, h), a.sdo.t, kNQ,
                 tid);
    load_f32<kNQ>(base + 2 * C::kTileNQ, a.lse + row_bh + qs, tid);
    load_f32<kNQ>(base + 2 * C::kTileNQ + 4 * kNQ, a.di + row_bh + qs, tid);
  };
  load_stage(qi0, 0);
  cp_async_commit();

  float dk[kDV / 8][4];
  float dv[kDV / 8][4];
  zero(dk);
  zero(dv);
  const int key_lo = k0 + 16 * warp + lane / 4;  // this thread's keys: +0, +8

  for (int qi = qi0; qi < n_q; ++qi) {
    const int st = (qi - qi0) & 1;
    if (qi + 1 < n_q) {
      load_stage(qi + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t s_q = s_stage + st * C::kStageDkv;
    const uint32_t s_do = s_q + C::kTileNQ;
    const float* lse = reinterpret_cast<const float*>(
        smem + (s_q - s_k) + 2 * C::kTileNQ);
    const float* di = lse + kNQ;
    const int qs = qi * kNQ;
    const bool masked = kCausal && qs < k0 + 63;

    // P^T = exp(s K Q^T - lse): rows are keys, columns queries
    float p[kNQ / 8][4];
    zero(p);
    gemm_abt<kNQ, D>(p, s_k, 16 * warp, s_q, lane);
#pragma unroll
    for (int j = 0; j < kNQ / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qc = 8 * j + 2 * (lane & 3) + (i & 1);
        float e = ex2(fmaf(p[j][i], a.scale_log2, -lse[qc] * kLog2e));
        if (masked && key_lo + 8 * (i >> 1) > qs + qc) e = 0.f;
        p[j][i] = e;
      }
    }
    uint32_t frag[kNQ / 16][4];
    to_a_frags<kNQ>(p, frag);
    gemm_rb<kDV, kNQ, D>(dv, frag, s_do, col0, lane);  // dV += P^T dO

    // dP^T = V dO^T; dS^T = s P^T o (dP^T - di)
    float dp[kNQ / 8][4];
    zero(dp);
    gemm_abt<kNQ, D>(dp, s_v, 16 * warp, s_do, lane);
#pragma unroll
    for (int j = 0; j < kNQ / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qc = 8 * j + 2 * (lane & 3) + (i & 1);
        dp[j][i] = (dp[j][i] - di[qc]) * p[j][i] * a.scale;
      }
    }
    to_a_frags<kNQ>(dp, frag);
    gemm_rb<kDV, kNQ, D>(dk, frag, s_q, col0, lane);  // dK += dS^T Q
    __syncthreads();  // this stage is the next prefetch's target
  }

  const int r0 = 16 * warp + lane / 4;
  store_rows<kDV>(dk, const_cast<__nv_bfloat16*>(at(a.dk, a.sdk, b, k0, h)),
                  a.sdk.t, r0, col0, lane);
  store_rows<kDV>(dv, const_cast<__nv_bfloat16*>(at(a.dv, a.sdv, b, k0, h)),
                  a.sdv.t, r0, col0, lane);
}

// --------------------------------------------------------------------- K7: dQ

template <int D, bool kCausal>
__global__ void __launch_bounds__(128) flash_bwd_dq(const BwdArgs a) {
  using C = BwdCfg<D>;
  constexpr int kDV = C::kDV;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t s_q = smem_u32(smem);
  const uint32_t s_do = s_q + C::kTile64;
  const uint32_t s_stage = s_do + C::kTile64;  // [stage][K, V]
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  int b, h, col0, raw;
  const int m_tiles = a.tq / 64;
  decode<D>(m_tiles, a.heads, b, h, col0, raw);
  const int mt = kCausal ? m_tiles - 1 - raw : raw;  // causal: longest first
  const int q0 = 64 * mt;
  const int n_k = kCausal ? mt + 1 : a.tk / 64;

  load_tile<D>(s_q, at(a.q, a.sq, b, q0, h), a.sq.t, 64, tid);
  load_tile<D>(s_do, at(a.dout, a.sdo, b, q0, h), a.sdo.t, 64, tid);
  auto load_stage = [&](int j, int st) {
    const uint32_t base = s_stage + st * 2 * C::kTile64;
    load_tile<D>(base, at(a.k, a.sk, b, 64 * j, h), a.sk.t, 64, tid);
    load_tile<D>(base + C::kTile64, at(a.v, a.sv, b, 64 * j, h), a.sv.t, 64,
                 tid);
  };
  load_stage(0, 0);
  cp_async_commit();

  const int row_lo = q0 + 16 * warp + lane / 4;  // this thread's rows: +0, +8
  const int64_t row_bh = ((int64_t)b * a.heads + h) * a.tq;
  const float lse2[2] = {a.lse[row_bh + row_lo] * kLog2e,
                         a.lse[row_bh + row_lo + 8] * kLog2e};
  const float di[2] = {a.di[row_bh + row_lo], a.di[row_bh + row_lo + 8]};

  float dq[kDV / 8][4];
  zero(dq);
  for (int j = 0; j < n_k; ++j) {
    const int st = j & 1;
    if (j + 1 < n_k) {
      load_stage(j + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t s_k = s_stage + st * 2 * C::kTile64;
    const uint32_t s_v = s_k + C::kTile64;
    const int k0 = 64 * j;
    const bool masked = kCausal && j == mt;

    float p[8][4];
    zero(p);
    gemm_abt<64, D>(p, s_q, 16 * warp, s_k, lane);  // S = Q K^T
    float dp[8][4];
    zero(dp);
    gemm_abt<64, D>(dp, s_do, 16 * warp, s_v, lane);  // dP = dO V^T
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        float e = ex2(fmaf(p[jj][i], a.scale_log2, -lse2[r]));
        if (masked && k0 + 8 * jj + 2 * (lane & 3) + (i & 1) > row_lo + 8 * r) {
          e = 0.f;
        }
        dp[jj][i] = (dp[jj][i] - di[r]) * e * a.scale;  // dS
      }
    }
    uint32_t frag[4][4];
    to_a_frags<64>(dp, frag);
    gemm_rb<kDV, 64, D>(dq, frag, s_k, col0, lane);  // dQ += dS K
    __syncthreads();  // this stage is the next prefetch's target
  }

  store_rows<kDV>(dq, const_cast<__nv_bfloat16*>(at(a.dq, a.sdq, b, q0, h)),
                  a.sdq.t, 16 * warp + lane / 4, col0, lane);
}

// ------------------------------------------------------------------ host side

template <int D>
int launch(const BwdArgs& a, int batch, int causal, int which,
           cudaStream_t stream) {
  using C = BwdCfg<D>;
  const int tiles = which == 0 ? a.tk / 64 : a.tq / 64;
  const int64_t blocks = (int64_t)tiles * a.heads * C::kSplit * batch;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidConfiguration;
  void (*kernel)(const BwdArgs);
  int smem;
  if (which == 0) {
    kernel = causal ? flash_bwd_dkv<D, true> : flash_bwd_dkv<D, false>;
    smem = C::kSmemDkv;
  } else {
    kernel = causal ? flash_bwd_dq<D, true> : flash_bwd_dq<D, false>;
    smem = C::kSmemDq;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, 128, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch of K6 (which = 0: dK and dV) or K7 (which = 1: dQ).
// q, k, v, dout, dq, dk, dv: bf16 [B, T, H, D] with the given element
// strides (batch, time, head per tensor, in that order; the last dimension
// contiguous, the strides multiples of 8 and the bases 16-byte aligned);
// lse, di: contiguous f32 [B, H, Tq]. Tq and Tk are multiples of 64, causal
// needs Tq == Tk, and D is 64, 128 or 256. Returns a cudaError_t code.
extern "C" int mmlspark_flash_attn_bwd(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const float* lse, const float* di,
                                       void* dq, void* dk, void* dv, int batch,
                                       int heads, int tq, int tk, int head_dim,
                                       int causal, const int64_t* strides,
                                       float sm_scale, int which,
                                       void* stream) {
  if (batch <= 0 || heads <= 0 || tq <= 0) return (int)cudaGetLastError();
  if (tq % 64 || tk <= 0 || tk % 64 || (causal && tq != tk) ||
      (which != 0 && which != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  BwdArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.lse = lse;
  a.di = di;
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  Strides* st[7] = {&a.sq, &a.sk, &a.sv, &a.sdo, &a.sdq, &a.sdk, &a.sdv};
  for (int i = 0; i < 7; ++i) {
    *st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  }
  a.heads = heads;
  a.tq = tq;
  a.tk = tk;
  a.scale = sm_scale;
  a.scale_log2 = sm_scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch<64>(a, batch, causal, which, s);
    case 128:
      return launch<128>(a, batch, causal, which, s);
    case 256:
      return launch<256>(a, batch, causal, which, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
