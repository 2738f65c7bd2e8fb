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
// the card's ~295 (989 TFLOP/s bf16 / 3.35 TB/s). Beside the products each
// score takes an exponential and a few f32 operations, which at D = 64 take
// about as long as the products: they have to run under them.
//
// Design (K5's, csrc/flash_attn.cu, with its helpers from csrc/tma.cuh):
//   - a producer warpgroup, of which one thread issues every load, and two
//     consumer warpgroups of 64 rows each; setmaxnreg moves registers from
//     the producer (24 a thread) to the consumers (240);
//   - the tiles arrive by TMA (cp.async.bulk.tensor.4d through CUtensorMaps
//     over the strided [B, T, H, D] views, 64-column boxes, 128-byte
//     swizzled) into shared memory; the rows that stream go through a ring
//     of kStages stages, each with a full mbarrier (TMA completes it) and a
//     free one (each consumer warp arrives once its last product that reads
//     the stage has been waited on);
//   - every product is wgmma.mma_async (csrc/wgmma.cuh): the products whose
//     operands both lie in shared memory read them K-major (wgmma_ss); the
//     f32 accumulator of P or dS, rounded to bf16 in registers, is the A
//     operand of the next product (wgmma_rs), whose B operand is read
//     N-major ("transposed") from the same swizzled tile that an ss product
//     read K-major, as K5 reads V;
//   - within a warpgroup, tile i's first products are issued together with
//     tile i-1's register-A products, so tile i's exponentials run while
//     those are in flight; the two warpgroups take turns to issue (K5's
//     named-barrier turns), so one's exponentials also run under the
//     other's products;
//   - K6 (dK, dV): one CTA per (b, h, key tile). It loads its K and V once
//     and streams Q, dO and the tile's lse and di rows (the last two by a
//     bulk copy) through the ring, kBq queries a stage (64; 32 at D = 128,
//     for registers). At D = 64 and 128 a warpgroup owns 64 keys (128 a
//     CTA) and runs all four products per query tile: S^T = K Q^T and
//     dP^T = V dO^T (ss, N = kBq), then dV += P^T dO and dK += dS^T Q (rs,
//     N = D). At D = 256, dK and dV of 64
//     keys would take 256 registers a thread, so the two warpgroups share
//     one 64-key tile and split the work instead of the columns: warpgroup
//     0 computes S^T, P and dV, warpgroup 1 dP^T, dS and dK; P (f32) passes
//     from 0 to 1 through 16 KB of shared memory under two named barriers.
//     Every product is computed once: nothing is recomputed;
//   - K7 (dQ): one CTA per (b, h, 128-query tile), K5's skeleton with lse
//     known (no online softmax). It loads its Q and dO once and streams K
//     and V tiles of kBn keys (128 at D = 64, 64 at 128, 32 at 256, as many
//     as shared memory holds beside Q and dO): S = Q K^T and dP = dO V^T
//     (ss, N = kBn), then dQ += dS K (rs, N = D, K read N-major). No column
//     split: dQ of all 256 columns is 128 registers a thread;
//   - ragged lengths: TMA zero-fills rows past T; keys past Tk get P = 0,
//     and K7's rows past Tq read lse = di = 0, so their zero rows give
//     P = 1 and dS = 0. Every product over such rows adds exactly 0, and
//     nothing reads lse or di past Tq;
//   - causal masking: tiles wholly above the diagonal are neither loaded
//     (K6's first query tile is its first key's, K7's last key tile its last
//     query's) nor computed (K7's warpgroup of the earlier queries waits
//     for and releases the tiles past its diagonal); the tiles that cross
//     it are masked element by element; the CTAs with the most tiles start
//     first (K6's low key tiles, K7's high query tiles);
//   - the outputs are rounded to bf16 and staged in shared memory that only
//     the warpgroup itself reads (its K or V rows), in the TMA box layout,
//     then stored by TMA, which drops rows past T;
//   - a 1-D grid over (batch, head, tile), tiles fastest: past grid.z's
//     65,535 cap on B x H (flash_kernel.bwd_launch_grid and grid_decode
//     mirror it, and flash_kernel.bwd_smem_bytes each kernel's shared
//     memory).
//   - from D = 384 up, flash_bwd_dkv_sliced and flash_bwd_dq_sliced (below):
//     one instantiation per 128-column output slice, D a run-time count of
//     64-column chunks streamed through the ring, P and dS recomputed in
//     each slice.
// No atomics: dQ has its own kernel (as in the library) instead of being
// added up across key tiles, so every output element has one writer and two
// calls give the same bits.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kSmemMax = 232448;  // a block's shared memory on the H100
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;
// named barriers: 1, 2 the turns; 3, 4 K6's P hand-over at D = 256;
// 8 + w warpgroup w's output staging
constexpr int kBarPFull = 3;
constexpr int kBarPFree = 4;

// K6: dK and dV of kBk keys per CTA, query tiles of kBq rows
template <int D>
struct DkvCfg {
  static constexpr bool kSplit = D == 256;  // the warpgroups split the work
  static constexpr int kBk = kSplit ? 64 : 128;
  // 32 queries a tile at D = 128: with 64, dK and dV (128 registers a
  // thread), S^T, dP^T and their bf16 copies outgrow 240 registers, and
  // ptxas serialises the wgmma pipeline
  static constexpr int kBq = D == 128 ? 32 : 64;
  static constexpr int kChunks = D / 64;          // 64-column TMA boxes
  static constexpr int kThreads = 384;            // 2 consumers + producer
  static constexpr int kKVBytes = kBk * D * 2;    // the CTA's K (or V)
  static constexpr int kTileBytes = kBq * D * 2;  // one Q (or dO) tile
  static constexpr int kPBytes = kSplit ? 64 * kBq * 4 : 0;
  static constexpr int kRowBytes = 2 * kBq * 4;   // a tile's lse and di
  static constexpr int kStageBytes = 2 * kTileBytes + kRowBytes;
  // as many stages as fit (at most 3), with 1 KB of alignment slack and
  // room for the barriers
  static constexpr int kFit =
      (kSmemMax - 1024 - 256 - 2 * kKVBytes - kPBytes) / kStageBytes;
  static constexpr int kStages = kFit < 3 ? kFit : 3;
  static constexpr int kSmem =
      2 * kKVBytes + kPBytes + kStages * kStageBytes + 1024;
  static_assert(kStages >= 2, "a Q/dO ring needs two stages");
};

// K7: dQ of kBm queries per CTA, key tiles of kBn rows
template <int D>
struct DqCfg {
  static constexpr int kBm = 128;
  static constexpr int kBn = D == 64 ? 128 : D == 128 ? 64 : 32;
  static constexpr int kChunks = D / 64;
  static constexpr int kThreads = 384;
  static constexpr int kQBytes = 64 * D * 2;   // one warpgroup's Q (or dO)
  static constexpr int kKBytes = kBn * D * 2;  // one K (or V) tile
  static constexpr int kFit =
      (kSmemMax - 1024 - 256 - 4 * kQBytes) / (2 * kKBytes);
  static constexpr int kStages = kFit < 3 ? kFit : 3;
  static constexpr int kSmem = 4 * kQBytes + kStages * 2 * kKBytes + 1024;
  static_assert(kStages >= 2, "a K/V ring needs two stages");
};

// d (+)= A B^T over D = 64 * kChunks: A a warpgroup's 64 rows
// ([chunk][64][64] boxes), B kN rows ([chunk][kN][64]), both K-major
template <int kN, int kChunks>
__device__ __forceinline__ void ss_kmajor(float (&d)[kN / 2],
                                          const uint8_t* sa,
                                          const uint8_t* sb) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_ss<kN>(d, desc_sw128(sa + c * 8192 + kk * 32, 16, 1024),
                   desc_sw128(sb + c * kN * 128 + kk * 32, 16, 1024),
                   (c | kk) != 0);
    }
  }
}

// d += A B: A 64 x kK in registers (bf16 fragments), B kK rows x DV
// columns ([DV/64][kK][64] boxes) read N-major
template <int DV, int kK>
__device__ __forceinline__ void rs_nmajor(float (&d)[DV / 2],
                                          const uint32_t (&a)[kK / 16][4],
                                          const uint8_t* sb) {
#pragma unroll
  for (int kk = 0; kk < kK / 16; ++kk) {
    // 16 rows = two 8-row atoms; the DV columns are DV/64 boxes kK*128 apart
    wgmma_rs<DV>(d, a[kk], desc_sw128(sb + kk * 2048, kK * 128, 1024), 1);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

template <int kChunks>
__device__ __forceinline__ void store_tile(const CUtensorMap* map,
                                           const uint8_t* src, int row, int h,
                                           int b) {
  store_cols<kChunks>(map, src, 0, row, h, b);
}

// ------------------------------------------------------------------ K6: dK dV

// what a consumer warpgroup of K6 works on
struct DkvCtx {
  uint8_t* sk;         // the CTA's K: [kBk/64][chunk][64][64]
  uint8_t* sv;         // and V
  const uint8_t* sq;   // Q stages: [stage][chunk][kBq][64]
  const uint8_t* sdo;  // dO stages
  float* sp;           // P^T hand-over (D = 256): [kBq / 2][128 threads]
  const float* srows;  // [stage][lse kBq, di kBq]
  uint64_t* bar_kv;
  uint64_t* bar_full;  // [stage]
  uint64_t* bar_free;  // [stage]
  const CUtensorMap* tm_dk;
  const CUtensorMap* tm_dv;
  int k0, q_first, n_tiles, tk, h, b;
  float scale, scale_log2;
};

// what a warpgroup computes: everything for its own 64 keys (D <= 128), or,
// over the CTA's 64 keys, S^T, P and dV (kDvOnly) or dP^T, dS and dK
// (kDkOnly)
enum Role { kBoth, kDvOnly, kDkOnly };

template <int D, bool kCausal, int kRole>
__device__ __forceinline__ void dkv_consumer(const DkvCtx& x, int wg,
                                             int tid) {
  using C = DkvCfg<D>;
  constexpr int kS = C::kStages;
  constexpr int kBq = C::kBq;
  constexpr int kCh = C::kChunks;
  constexpr bool kP = kRole != kDkOnly;   // S^T, P, dV += P^T dO
  constexpr bool kDS = kRole != kDvOnly;  // dP^T, dS, dK += dS^T Q
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int key_first = x.k0 + (kRole == kBoth ? 64 * wg : 0);
  uint8_t* ska = x.sk + (kRole == kBoth ? wg * kCh * 8192 : 0);
  uint8_t* sva = x.sv + (kRole == kBoth ? wg * kCh * 8192 : 0);

  float dv[kP ? D / 2 : 1];
  float dk[kDS ? D / 2 : 1];
  float s[kP ? kBq / 2 : 1];
  float dp[kDS ? kBq / 2 : 1];
  uint32_t pf[kP ? kBq / 16 : 1][4];
  uint32_t df[kDS ? kBq / 16 : 1][4];
  zero(dv);
  zero(dk);
  zero(s);
  zero(dp);

  // this tile's first products (operands in shared memory), and the
  // previous tile's register-A products
  auto issue_ss = [&](int st) {
    wgmma_fence();
    if constexpr (kP) ss_kmajor<kBq, kCh>(s, ska, x.sq + st * C::kTileBytes);
    if constexpr (kDS) {
      ss_kmajor<kBq, kCh>(dp, sva, x.sdo + st * C::kTileBytes);
    }
    wgmma_commit();
  };
  auto issue_rs = [&](int st) {
    wgmma_fence();
    if constexpr (kP) rs_nmajor<D, kBq>(dv, pf, x.sdo + st * C::kTileBytes);
    if constexpr (kDS) rs_nmajor<D, kBq>(dk, df, x.sq + st * C::kTileBytes);
    wgmma_commit();
  };
  // P^T and dS^T of tile i from the landed S^T and dP^T: rows are keys,
  // columns queries (element idx of this thread: key key0 + 8 *
  // ((idx >> 1) & 1), query qs + col(idx))
  auto elementwise = [&](int i, int st) {
    const int qs = x.q_first + i * kBq;
    const float* lse = x.srows + st * 2 * kBq;
    const float* di = lse + kBq;
    if constexpr (kP) {
      const int key0 = key_first + 16 * warp + lane / 4;  // +0, +8
      const bool need_mask =
          (kCausal && qs < key_first + 63) || key_first + 64 > x.tk;
#pragma unroll
      for (int idx = 0; idx < kBq / 2; ++idx) {
        const int col = 8 * (idx >> 2) + 2 * (lane & 3) + (idx & 1);
        float p = ex2(fmaf(s[idx], x.scale_log2, -lse[col] * kLog2e));
        if (need_mask) {
          const int key = key0 + 8 * ((idx >> 1) & 1);
          if ((kCausal && key > qs + col) || key >= x.tk) p = 0.f;
        }
        s[idx] = p;
      }
      if constexpr (kRole == kDvOnly) {
        if (i > 0) named_sync(kBarPFree);  // warpgroup 1 has read P_{i-1}
#pragma unroll
        for (int idx = 0; idx < kBq / 2; ++idx) x.sp[idx * 128 + tid] = s[idx];
        named_arrive(kBarPFull);
      }
    }
    if constexpr (kDS) {
      if constexpr (kRole == kDkOnly) named_sync(kBarPFull);
#pragma unroll
      for (int idx = 0; idx < kBq / 2; ++idx) {
        const int col = 8 * (idx >> 2) + 2 * (lane & 3) + (idx & 1);
        float p;
        if constexpr (kRole == kBoth) {
          p = s[idx];
        } else {
          p = x.sp[idx * 128 + tid];
        }
        dp[idx] = (dp[idx] - di[col]) * p * x.scale;
      }
      if constexpr (kRole == kDkOnly) {
        if (i + 1 < x.n_tiles) named_arrive(kBarPFree);
      }
    }
  };
  auto fence_first = [&]() {
    if constexpr (kP) fence_regs(s);
    if constexpr (kDS) fence_regs(dp);
  };
  auto fence_second = [&]() {
    if constexpr (kP) {
      fence_regs(dv);
      fence_regs(pf);
    }
    if constexpr (kDS) {
      fence_regs(dk);
      fence_regs(df);
    }
  };
  auto pack = [&]() {
    if constexpr (kP) pack_p<kBq>(s, pf);
    if constexpr (kDS) pack_p<kBq>(dp, df);
  };
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&x.bar_free[st]);
  };

  if (wg == 1) turn_pass<2>(wg);  // warpgroup 0 goes first
  mbar_wait(x.bar_kv, 0);
  mbar_wait(&x.bar_full[0], 0);
  turn_wait(wg);
  issue_ss(0);
  turn_pass<2>(wg);
  wgmma_wait<0>();
  fence_first();
  elementwise(0, 0);
  pack();
  for (int i = 1; i < x.n_tiles; ++i) {
    const int st = i % kS;
    const int pst = (i - 1) % kS;
    mbar_wait(&x.bar_full[st], (i / kS) & 1);
    turn_wait(wg);
    issue_ss(st);
    issue_rs(pst);
    turn_pass<2>(wg);
    wgmma_wait<1>();  // this tile's S^T/dP^T have landed
    fence_first();
    elementwise(i, st);
    wgmma_wait<0>();  // the previous tile's register-A products are done
    fence_second();
    release(pst);
    pack();
  }
  {
    const int st = (x.n_tiles - 1) % kS;
    turn_wait(wg);
    issue_rs(st);
    turn_pass<2>(wg);
    wgmma_wait<0>();
    fence_second();
    release(st);
  }
  if (wg == 0) turn_wait(wg);  // the last warpgroup's last pass

  // stage into shared memory only this warpgroup reads (its own K/V rows;
  // at D = 256 warpgroup 0 alone reads K and warpgroup 1 alone V) and store
  if constexpr (kRole == kBoth) {
    stage_rows<D>(dk, ska, warp, lane);
    stage_rows<D>(dv, sva, warp, lane);
  } else if constexpr (kRole == kDvOnly) {
    stage_rows<D>(dv, ska, warp, lane);
  } else {
    stage_rows<D>(dk, sva, warp, lane);
  }
  staged(wg);
  if (tid == 0) {
    if constexpr (kRole == kBoth) {
      store_tile<kCh>(x.tm_dk, ska, key_first, x.h, x.b);
      store_tile<kCh>(x.tm_dv, sva, key_first, x.h, x.b);
    } else if constexpr (kRole == kDvOnly) {
      store_tile<kCh>(x.tm_dv, ska, key_first, x.h, x.b);
    } else {
      store_tile<kCh>(x.tm_dk, sva, key_first, x.h, x.b);
    }
    store_done();
  }
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(DkvCfg<D>::kThreads, 1)
    flash_bwd_dkv_sm90(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const __grid_constant__ CUtensorMap tm_dk,
                       const __grid_constant__ CUtensorMap tm_dv,
                       const float* __restrict__ lse,
                       const float* __restrict__ di, int tq, int tk, int heads,
                       float scale, float scale_log2) {
  using C = DkvCfg<D>;
  constexpr int kS = C::kStages;
  constexpr int kCh = C::kChunks;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_kv;
  __shared__ __align__(8) uint64_t bar_full[kS];
  __shared__ __align__(8) uint64_t bar_free[kS];
  // 128-byte swizzled tiles need 1024-byte alignment
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  DkvCtx x;
  x.sk = base;
  x.sv = x.sk + C::kKVBytes;
  uint8_t* sq = x.sv + C::kKVBytes;
  uint8_t* sdo = sq + kS * C::kTileBytes;
  x.sq = sq;
  x.sdo = sdo;
  x.sp = reinterpret_cast<float*>(sdo + kS * C::kTileBytes);
  float* srows = reinterpret_cast<float*>(sdo + kS * C::kTileBytes + C::kPBytes);
  x.srows = srows;
  x.bar_kv = &bar_kv;
  x.bar_full = bar_full;
  x.bar_free = bar_free;
  x.tm_dk = &tm_dk;
  x.tm_dv = &tm_dv;

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  // blockIdx.x -> (batch, head, key tile), key tiles fastest; under causal
  // masking the low key tiles see the most query tiles and start first
  const int k_tiles = ceil_div(tk, C::kBk);
  const int kt = (int)(blockIdx.x % (unsigned)k_tiles);
  x.h = (int)((blockIdx.x / (unsigned)k_tiles) % (unsigned)heads);
  x.b = (int)(blockIdx.x / ((unsigned)k_tiles * (unsigned)heads));
  x.k0 = kt * C::kBk;
  // causal: the query tiles whose last row sees the tile's first key
  const int qi0 = kCausal ? x.k0 / C::kBq : 0;
  x.q_first = qi0 * C::kBq;
  x.n_tiles = tq / C::kBq - qi0;
  x.tk = tk;
  x.scale = scale;
  x.scale_log2 = scale_log2;

  if (threadIdx.x == 0) {
    mbar_init(&bar_kv, 1);
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      mbar_init(&bar_full[s], 1);
      mbar_init(&bar_free[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 0) {
      const int64_t row_bh = ((int64_t)x.b * heads + x.h) * tq;
      mbar_expect_tx(&bar_kv, 2 * C::kKVBytes);
      for (int r = 0; r < C::kBk / 64; ++r) {
        for (int c = 0; c < kCh; ++c) {
          const int off = (r * kCh + c) * 8192;
          tma_load(x.sk + off, &tm_k, &bar_kv, c * 64, x.k0 + 64 * r, x.h, x.b);
          tma_load(x.sv + off, &tm_v, &bar_kv, c * 64, x.k0 + 64 * r, x.h, x.b);
        }
      }
      for (int i = 0; i < x.n_tiles; ++i) {
        const int st = i % kS;
        const int qs = x.q_first + i * C::kBq;
        mbar_wait(&bar_free[st], ((i / kS) & 1) ^ 1);
        mbar_expect_tx(&bar_full[st], C::kStageBytes);
        for (int c = 0; c < kCh; ++c) {
          const int off = st * C::kTileBytes + c * C::kBq * 128;
          tma_load(sq + off, &tm_q, &bar_full[st], c * 64, qs, x.h, x.b);
          tma_load(sdo + off, &tm_do, &bar_full[st], c * 64, qs, x.h, x.b);
        }
        float* rows = srows + st * 2 * C::kBq;
        bulk_load(rows, lse + row_bh + qs, C::kBq * 4, &bar_full[st]);
        bulk_load(rows + C::kBq, di + row_bh + qs, C::kBq * 4, &bar_full[st]);
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    setmaxnreg_inc<kConsumerRegs>();
    if constexpr (C::kSplit) {
      if (wg == 0) {
        dkv_consumer<D, kCausal, kDvOnly>(x, wg, tid);
      } else {
        dkv_consumer<D, kCausal, kDkOnly>(x, wg, tid);
      }
    } else {
      dkv_consumer<D, kCausal, kBoth>(x, wg, tid);
    }
  }
}

// --------------------------------------------------------------------- K7: dQ

template <int D, bool kCausal>
__global__ void __launch_bounds__(DqCfg<D>::kThreads, 1)
    flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_dq,
                      const float* __restrict__ lse,
                      const float* __restrict__ di, int tq, int tk, int heads,
                      float scale, float scale_log2) {
  using C = DqCfg<D>;
  constexpr int kS = C::kStages;
  constexpr int kBn = C::kBn;
  constexpr int kCh = C::kChunks;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q;
  __shared__ __align__(8) uint64_t bar_full[kS];
  __shared__ __align__(8) uint64_t bar_free[kS];
  uint8_t* sq = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sdo = sq + 2 * C::kQBytes;         // [warpgroup][chunk][64][64]
  uint8_t* sk = sdo + 2 * C::kQBytes;         // [stage][chunk][kBn][64]
  uint8_t* sv = sk + kS * C::kKBytes;

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  // blockIdx.x -> (batch, head, query tile), query tiles fastest; under
  // causal masking the high query tiles see the most keys and start first
  const int m_tiles = ceil_div(tq, C::kBm);
  const int raw = (int)(blockIdx.x % (unsigned)m_tiles);
  const int h = (int)((blockIdx.x / (unsigned)m_tiles) % (unsigned)heads);
  const int b = (int)(blockIdx.x / ((unsigned)m_tiles * (unsigned)heads));
  const int mt = kCausal ? m_tiles - 1 - raw : raw;
  const int q0 = mt * C::kBm;
  const int n_tiles = kCausal ? min(ceil_div(tk, kBn), ceil_div(q0 + C::kBm, kBn))
                              : ceil_div(tk, kBn);

  if (threadIdx.x == 0) {
    mbar_init(&bar_q, 1);
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      mbar_init(&bar_full[s], 1);
      mbar_init(&bar_free[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 0) {
      mbar_expect_tx(&bar_q, 4 * C::kQBytes);
      for (int w = 0; w < 2; ++w) {
        for (int c = 0; c < kCh; ++c) {
          const int off = w * C::kQBytes + c * 8192;
          tma_load(sq + off, &tm_q, &bar_q, c * 64, q0 + 64 * w, h, b);
          tma_load(sdo + off, &tm_do, &bar_q, c * 64, q0 + 64 * w, h, b);
        }
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kS;
        mbar_wait(&bar_free[st], ((j / kS) & 1) ^ 1);
        mbar_expect_tx(&bar_full[st], 2 * C::kKBytes);
        for (int c = 0; c < kCh; ++c) {
          const int off = st * C::kKBytes + c * kBn * 128;
          tma_load(sk + off, &tm_k, &bar_full[st], c * 64, j * kBn, h, b);
          tma_load(sv + off, &tm_v, &bar_full[st], c * 64, j * kBn, h, b);
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    setmaxnreg_inc<kConsumerRegs>();
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int row_first = q0 + 64 * wg;                 // this warpgroup's rows
    const int row0 = row_first + 16 * warp + lane / 4;  // this thread's: +0, +8
    // rows past Tq (zero-filled Q and dO) read lse = di = 0: P = 1, dS = 0
    const int64_t row_bh = ((int64_t)b * heads + h) * tq;
    float lse2[2], dir[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      lse2[r] = row < tq ? lse[row_bh + row] * kLog2e : 0.f;
      dir[r] = row < tq ? di[row_bh + row] : 0.f;
    }
    // under causal masking the later tiles lie wholly above this
    // warpgroup's diagonal: waited for and released, not computed
    const int n_comp =
        kCausal ? min(n_tiles, (row_first + 63) / kBn + 1) : n_tiles;
    uint8_t* sqw = sq + wg * C::kQBytes;
    const uint8_t* sdow = sdo + wg * C::kQBytes;

    float dq[D / 2];
    float s[kBn / 2];
    float dp[kBn / 2];
    uint32_t df[kBn / 16][4];
    zero(dq);
    zero(s);
    zero(dp);

    auto issue_ss = [&](int st) {
      wgmma_fence();
      ss_kmajor<kBn, kCh>(s, sqw, sk + st * C::kKBytes);
      ss_kmajor<kBn, kCh>(dp, sdow, sv + st * C::kKBytes);
      wgmma_commit();
    };
    auto issue_rs = [&](int st) {
      wgmma_fence();
      rs_nmajor<D, kBn>(dq, df, sk + st * C::kKBytes);
      wgmma_commit();
    };
    // dS of key tile j from the landed S and dP, into dp
    auto elementwise = [&](int j) {
      const int n0 = j * kBn;
      const bool need_mask =
          n0 + kBn > tk || (kCausal && n0 + kBn - 1 > row_first);
#pragma unroll
      for (int idx = 0; idx < kBn / 2; ++idx) {
        const int r = (idx >> 1) & 1;
        float p = ex2(fmaf(s[idx], scale_log2, -lse2[r]));
        if (need_mask) {
          const int key = n0 + 8 * (idx >> 2) + 2 * (lane & 3) + (idx & 1);
          if (key >= tk || (kCausal && key > row0 + 8 * r)) p = 0.f;
        }
        dp[idx] = (dp[idx] - dir[r]) * p * scale;
      }
    };
    auto release = [&](int st) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&bar_free[st]);
    };

    if (wg == 1) turn_pass<2>(wg);  // warpgroup 0 goes first
    mbar_wait(&bar_q, 0);
    mbar_wait(&bar_full[0], 0);
    turn_wait(wg);
    issue_ss(0);
    turn_pass<2>(wg);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    elementwise(0);
    pack_p<kBn>(dp, df);
    for (int j = 1; j < n_comp; ++j) {
      const int st = j % kS;
      const int pst = (j - 1) % kS;
      mbar_wait(&bar_full[st], (j / kS) & 1);
      turn_wait(wg);
      issue_ss(st);
      issue_rs(pst);
      turn_pass<2>(wg);
      wgmma_wait<1>();  // this tile's S and dP have landed
      fence_regs(s);
      fence_regs(dp);
      elementwise(j);
      wgmma_wait<0>();  // dQ += dS_{j-1} K_{j-1} is done
      fence_regs(dq);
      fence_regs(df);
      release(pst);
      pack_p<kBn>(dp, df);
    }
    {
      const int st = (n_comp - 1) % kS;
      turn_wait(wg);
      issue_rs(st);
      turn_pass<2>(wg);
      wgmma_wait<0>();
      fence_regs(dq);
      release(st);
    }
    for (int j = n_comp; j < n_tiles; ++j) {
      const int st = j % kS;
      mbar_wait(&bar_full[st], (j / kS) & 1);
      release(st);
      turn_wait(wg);  // every warpgroup takes as many turns
      turn_pass<2>(wg);
    }
    if (wg == 0) turn_wait(wg);  // the last warpgroup's last pass

    // stage dQ in this warpgroup's own (no longer needed) Q rows and store
    stage_rows<D>(dq, sqw, warp, lane);
    staged(wg);
    if (tid == 0) {
      store_tile<kCh>(&tm_dq, sqw, row_first, h, b);
      store_done();
    }
  }
}

// ----------------------------------- K6 and K7 at D >= 384: column slices
//
// At D = 384 K7's Q and dO of 128 queries (192 KB) leave no room for two
// K/V stages, one f32 dQ accumulator of all D columns takes D / 2
// registers a thread (256 at D = 512), and wgmma stops at N = 256. So at
// every multiple of 128 from 384 up, D is a run-time count of 64-column
// chunks and each CTA owns one slice of kDV output columns (one
// instantiation per slice width, not per head dim):
//   - the products reduced over all of D (K6: S^T = K Q^T and dP^T =
//     V dO^T; K7: S = Q K^T and dP = dO V^T) stream their operands in
//     64-column chunks through a ring: stage g = (tile * chunks + chunk)
//     holds the chunk's box of every operand, and each consumer warp
//     releases it once the wgmma that reads it has landed (the next
//     chunk's is issued first);
//   - P and dS are recomputed in each slice from those sums (the recompute
//     is the slices' repeated S and dP products: counted as useful flops,
//     it shows as the kernels' gap to their bound, not hidden); the
//     register-A products that write the slice (K6: dV += P^T dO_slice,
//     dK += dS^T Q_slice; K7: dQ += dS K_slice) read it from a second ring,
//     loaded before the tile's chunks and released after those products;
//   - every CTA writes only its own columns: no atomics, the same bits
//     from call to call;
//   - K6: a CTA per (b, h, slice, 128 keys), each consumer warpgroup 64
//     keys, query tiles of 32 (the D = 128 layout's registers: dK and dV
//     slices 128 a thread); K7: a CTA per (b, h, slice, 128 queries), key
//     tiles of 64; the tuned kernels' masking, causal walk and ragged
//     edges; the outputs staged in a ring stage once both warpgroups are
//     done (named barrier 5) and stored by TMA.
constexpr int kBarConsumers = 5;

template <int kDV>
struct DkvSlicedCfg {
  static constexpr int kBk = 128;                  // keys per CTA
  static constexpr int kBq = 32;                   // queries per tile
  static constexpr int kThreads = 384;
  static constexpr int kKBytes = kBk * 128;        // a box of K (or V)
  static constexpr int kQBytes = kBq * 128;        // a box of Q (or dO)
  static constexpr int kChunkBytes = 2 * kKBytes + 2 * kQBytes;
  static constexpr int kSliceQBytes = kBq * kDV * 2;  // Q (or dO) slice
  static constexpr int kRowBytes = 2 * kBq * 4;    // the tile's lse and di
  static constexpr int kSliceBytes = 2 * kSliceQBytes + kRowBytes;
  static constexpr int kChunkStages = 4;
  static constexpr int kSliceStages = 2;
  static constexpr int kSmem =
      kChunkStages * kChunkBytes + kSliceStages * kSliceBytes + 1024;
  static_assert(kSmem + 256 <= kSmemMax, "shared memory of a block");
  static_assert(kChunkBytes >= 2 * 64 * kDV * 2,
                "a warpgroup's dK and dV slices in a chunk stage");
};

template <int kDV>
struct DqSlicedCfg {
  static constexpr int kBm = 128;                  // queries per CTA
  static constexpr int kBn = 64;                   // keys per tile
  static constexpr int kThreads = 384;
  static constexpr int kQBytes = kBm * 128;        // a box of Q (or dO)
  static constexpr int kKBytes = kBn * 128;        // a box of K (or V)
  static constexpr int kChunkBytes = 2 * kQBytes + 2 * kKBytes;
  static constexpr int kSliceBytes = kBn * kDV * 2;  // the K slice
  static constexpr int kChunkStages = 3;
  static constexpr int kSliceStages = 2;
  static constexpr int kSmem =
      kChunkStages * kChunkBytes + kSliceStages * kSliceBytes + 1024;
  static_assert(kSmem + 256 <= kSmemMax, "shared memory of a block");
  static_assert(kSliceBytes >= 64 * kDV * 2, "a warpgroup's dQ slice");
};

template <int kDV, bool kCausal>
__global__ void __launch_bounds__(DkvSlicedCfg<kDV>::kThreads, 1)
    flash_bwd_dkv_sliced(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_dk,
                         const __grid_constant__ CUtensorMap tm_dv,
                         const float* __restrict__ lse,
                         const float* __restrict__ di, int tq, int tk,
                         int heads, int d, float scale, float scale_log2) {
  using C = DkvSlicedCfg<kDV>;
  constexpr int kBq = C::kBq;
  constexpr int kCS = C::kChunkStages;
  constexpr int kSS = C::kSliceStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_c[kCS];
  __shared__ __align__(8) uint64_t bar_ec[kCS];
  __shared__ __align__(8) uint64_t bar_s[kSS];
  __shared__ __align__(8) uint64_t bar_es[kSS];
  // [stage][K box kBk rows | V box | Q box kBq rows | dO box]
  uint8_t* sc = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // [stage][Q slice [kDV/64][kBq][64] | dO slice | lse kBq | di kBq]
  uint8_t* ss = sc + kCS * C::kChunkBytes;

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int n_chunks = d / 64;
  const int n_slices = d / kDV;
  // blockIdx.x -> (batch, head x slice, key tile), key tiles fastest
  const int k_tiles = ceil_div(tk, C::kBk);
  const int hc = heads * n_slices;
  const int kt = (int)(blockIdx.x % (unsigned)k_tiles);
  const int hy = (int)((blockIdx.x / (unsigned)k_tiles) % (unsigned)hc);
  const int b = (int)(blockIdx.x / ((unsigned)k_tiles * (unsigned)hc));
  const int h = hy / n_slices;
  const int col0 = (hy % n_slices) * kDV;
  const int k0 = kt * C::kBk;
  const int qi0 = kCausal ? k0 / kBq : 0;
  const int q_first = qi0 * kBq;
  const int n_tiles = tq / kBq - qi0;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kCS; ++s) {
      mbar_init(&bar_c[s], 1);
      mbar_init(&bar_ec[s], 8);  // one arrival per consumer warp
    }
#pragma unroll
    for (int s = 0; s < kSS; ++s) {
      mbar_init(&bar_s[s], 1);
      mbar_init(&bar_es[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 0) {
      const int64_t row_bh = ((int64_t)b * heads + h) * tq;
      for (int i = 0; i < n_tiles; ++i) {
        const int qs = q_first + i * kBq;
        const int sl = i % kSS;
        uint8_t* dst = ss + sl * C::kSliceBytes;
        mbar_wait(&bar_es[sl], ((i / kSS) & 1) ^ 1);
        mbar_expect_tx(&bar_s[sl], C::kSliceBytes);
        for (int c = 0; c < kDV / 64; ++c) {
          tma_load(dst + c * C::kQBytes, &tm_q, &bar_s[sl], col0 + c * 64, qs,
                   h, b);
          tma_load(dst + C::kSliceQBytes + c * C::kQBytes, &tm_do, &bar_s[sl],
                   col0 + c * 64, qs, h, b);
        }
        float* rows = reinterpret_cast<float*>(dst + 2 * C::kSliceQBytes);
        bulk_load(rows, lse + row_bh + qs, kBq * 4, &bar_s[sl]);
        bulk_load(rows + kBq, di + row_bh + qs, kBq * 4, &bar_s[sl]);
        for (int c = 0; c < n_chunks; ++c) {
          const int g = i * n_chunks + c;
          const int st = g % kCS;
          uint8_t* cd = sc + st * C::kChunkBytes;
          mbar_wait(&bar_ec[st], ((g / kCS) & 1) ^ 1);
          mbar_expect_tx(&bar_c[st], C::kChunkBytes);
          tma_load(cd, &tm_k, &bar_c[st], c * 64, k0, h, b);
          tma_load(cd + C::kKBytes, &tm_v, &bar_c[st], c * 64, k0, h, b);
          tma_load(cd + 2 * C::kKBytes, &tm_q, &bar_c[st], c * 64, qs, h, b);
          tma_load(cd + 2 * C::kKBytes + C::kQBytes, &tm_do, &bar_c[st],
                   c * 64, qs, h, b);
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    setmaxnreg_inc<kConsumerRegs>();
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int key_first = k0 + 64 * wg;
    const int key0 = key_first + 16 * warp + lane / 4;  // this thread's: +0, +8
    float dv[kDV / 2];
    float dk[kDV / 2];
    float s[kBq / 2];
    float dp[kBq / 2];
    uint32_t pf[kBq / 16][4];
    uint32_t df[kBq / 16][4];
    zero(dv);
    zero(dk);
    zero(s);
    zero(dp);

    for (int i = 0; i < n_tiles; ++i) {
      // S^T = K Q^T and dP^T = V dO^T of query tile i over the D chunks
      sum_chunks<kCS>(bar_c, bar_ec, i, n_chunks, lane, [&](int st, int acc) {
        const uint8_t* src = sc + st * C::kChunkBytes;
        ss_box<kBq>(s, src + wg * 8192, src + 2 * C::kKBytes, acc);
        ss_box<kBq>(dp, src + C::kKBytes + wg * 8192,
                    src + 2 * C::kKBytes + C::kQBytes, acc);
      });
      fence_regs(s);
      fence_regs(dp);

      // P^T and dS^T: rows are keys, columns queries (element idx of this
      // thread: key key0 + 8 * ((idx >> 1) & 1), query qs + col(idx))
      const int sl = i % kSS;
      const uint8_t* slice = ss + sl * C::kSliceBytes;
      mbar_wait(&bar_s[sl], (i / kSS) & 1);
      const float* rl = reinterpret_cast<const float*>(slice +
                                                       2 * C::kSliceQBytes);
      const float* rd = rl + kBq;
      const int qs = q_first + i * kBq;
      const bool need_mask =
          (kCausal && qs < key_first + 63) || key_first + 64 > tk;
#pragma unroll
      for (int idx = 0; idx < kBq / 2; ++idx) {
        const int col = 8 * (idx >> 2) + 2 * (lane & 3) + (idx & 1);
        float p = ex2(fmaf(s[idx], scale_log2, -rl[col] * kLog2e));
        if (need_mask) {
          const int key = key0 + 8 * ((idx >> 1) & 1);
          if ((kCausal && key > qs + col) || key >= tk) p = 0.f;
        }
        s[idx] = p;
        dp[idx] = (dp[idx] - rd[col]) * p * scale;
      }
      pack_p<kBq>(s, pf);
      pack_p<kBq>(dp, df);
      wgmma_fence();
      rs_nmajor<kDV, kBq>(dv, pf, slice + C::kSliceQBytes);  // dO slice
      rs_nmajor<kDV, kBq>(dk, df, slice);                    // Q slice
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pf);
      fence_regs(df);
      release_stage(&bar_es[sl], lane);
    }

    // every load has landed and every product read its stage: chunk stage
    // wg takes this warpgroup's dK and dV slices
    named_sync(kBarConsumers);
    uint8_t* out = sc + wg * C::kChunkBytes;
    stage_rows<kDV>(dk, out, warp, lane);
    stage_rows<kDV>(dv, out + 64 * kDV * 2, warp, lane);
    staged(wg);
    if (tid == 0) {
      store_cols<kDV / 64>(&tm_dk, out, col0, key_first, h, b);
      store_cols<kDV / 64>(&tm_dv, out + 64 * kDV * 2, col0, key_first, h, b);
      store_done();
    }
  }
}

template <int kDV, bool kCausal>
__global__ void __launch_bounds__(DqSlicedCfg<kDV>::kThreads, 1)
    flash_bwd_dq_sliced(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do,
                        const __grid_constant__ CUtensorMap tm_dq,
                        const float* __restrict__ lse,
                        const float* __restrict__ di, int tq, int tk,
                        int heads, int d, float scale, float scale_log2) {
  using C = DqSlicedCfg<kDV>;
  constexpr int kBn = C::kBn;
  constexpr int kCS = C::kChunkStages;
  constexpr int kSS = C::kSliceStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_c[kCS];
  __shared__ __align__(8) uint64_t bar_ec[kCS];
  __shared__ __align__(8) uint64_t bar_s[kSS];
  __shared__ __align__(8) uint64_t bar_es[kSS];
  // [stage][Q box 128 rows | dO box 128 rows | K box kBn rows | V box]
  uint8_t* sc = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // [stage][K slice [kDV/64][kBn][64]]
  uint8_t* ss = sc + kCS * C::kChunkBytes;

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int n_chunks = d / 64;
  const int n_slices = d / kDV;
  // blockIdx.x -> (batch, head x slice, query tile), query tiles fastest;
  // under causal masking the high query tiles start first
  const int m_tiles = ceil_div(tq, C::kBm);
  const int hc = heads * n_slices;
  const int raw = (int)(blockIdx.x % (unsigned)m_tiles);
  const int hy = (int)((blockIdx.x / (unsigned)m_tiles) % (unsigned)hc);
  const int b = (int)(blockIdx.x / ((unsigned)m_tiles * (unsigned)hc));
  const int h = hy / n_slices;
  const int col0 = (hy % n_slices) * kDV;
  const int mt = kCausal ? m_tiles - 1 - raw : raw;
  const int q0 = mt * C::kBm;
  const int n_tiles = kCausal ? min(ceil_div(tk, kBn), ceil_div(q0 + C::kBm, kBn))
                              : ceil_div(tk, kBn);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kCS; ++s) {
      mbar_init(&bar_c[s], 1);
      mbar_init(&bar_ec[s], 8);  // one arrival per consumer warp
    }
#pragma unroll
    for (int s = 0; s < kSS; ++s) {
      mbar_init(&bar_s[s], 1);
      mbar_init(&bar_es[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 0) {
      for (int j = 0; j < n_tiles; ++j) {
        const int sl = j % kSS;
        mbar_wait(&bar_es[sl], ((j / kSS) & 1) ^ 1);
        mbar_expect_tx(&bar_s[sl], C::kSliceBytes);
        for (int c = 0; c < kDV / 64; ++c) {
          tma_load(ss + sl * C::kSliceBytes + c * C::kKBytes, &tm_k, &bar_s[sl],
                   col0 + c * 64, j * kBn, h, b);
        }
        for (int c = 0; c < n_chunks; ++c) {
          const int g = j * n_chunks + c;
          const int st = g % kCS;
          uint8_t* cd = sc + st * C::kChunkBytes;
          mbar_wait(&bar_ec[st], ((g / kCS) & 1) ^ 1);
          mbar_expect_tx(&bar_c[st], C::kChunkBytes);
          for (int w = 0; w < 2; ++w) {
            tma_load(cd + w * 8192, &tm_q, &bar_c[st], c * 64, q0 + 64 * w, h,
                     b);
            tma_load(cd + C::kQBytes + w * 8192, &tm_do, &bar_c[st], c * 64,
                     q0 + 64 * w, h, b);
          }
          tma_load(cd + 2 * C::kQBytes, &tm_k, &bar_c[st], c * 64, j * kBn, h,
                   b);
          tma_load(cd + 2 * C::kQBytes + C::kKBytes, &tm_v, &bar_c[st], c * 64,
                   j * kBn, h, b);
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    setmaxnreg_inc<kConsumerRegs>();
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int row_first = q0 + 64 * wg;
    const int row0 = row_first + 16 * warp + lane / 4;  // this thread's: +0, +8
    // rows past Tq (zero-filled Q and dO) read lse = di = 0: P = 1, dS = 0
    const int64_t row_bh = ((int64_t)b * heads + h) * tq;
    float lse2[2], dir[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      lse2[r] = row < tq ? lse[row_bh + row] * kLog2e : 0.f;
      dir[r] = row < tq ? di[row_bh + row] : 0.f;
    }
    const int n_comp =
        kCausal ? min(n_tiles, (row_first + 63) / kBn + 1) : n_tiles;
    float dq[kDV / 2];
    float s[kBn / 2];
    float dp[kBn / 2];
    uint32_t df[kBn / 16][4];
    zero(dq);
    zero(s);
    zero(dp);

    for (int j = 0; j < n_comp; ++j) {
      // S = Q K^T and dP = dO V^T of key tile j over the D chunks
      sum_chunks<kCS>(bar_c, bar_ec, j, n_chunks, lane, [&](int st, int acc) {
        const uint8_t* src = sc + st * C::kChunkBytes;
        ss_box<kBn>(s, src + wg * 8192, src + 2 * C::kQBytes, acc);
        ss_box<kBn>(dp, src + C::kQBytes + wg * 8192,
                    src + 2 * C::kQBytes + C::kKBytes, acc);
      });
      fence_regs(s);
      fence_regs(dp);

      // dS of key tile j, into dp
      const int n0 = j * kBn;
      const bool need_mask =
          n0 + kBn > tk || (kCausal && n0 + kBn - 1 > row_first);
#pragma unroll
      for (int idx = 0; idx < kBn / 2; ++idx) {
        const int r = (idx >> 1) & 1;
        float p = ex2(fmaf(s[idx], scale_log2, -lse2[r]));
        if (need_mask) {
          const int key = n0 + 8 * (idx >> 2) + 2 * (lane & 3) + (idx & 1);
          if (key >= tk || (kCausal && key > row0 + 8 * r)) p = 0.f;
        }
        dp[idx] = (dp[idx] - dir[r]) * p * scale;
      }
      pack_p<kBn>(dp, df);
      const int sl = j % kSS;
      mbar_wait(&bar_s[sl], (j / kSS) & 1);
      wgmma_fence();
      rs_nmajor<kDV, kBn>(dq, df, ss + sl * C::kSliceBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(df);
      release_stage(&bar_es[sl], lane);
    }
    // under causal masking the later tiles lie wholly above this
    // warpgroup's diagonal: waited for and released, not computed
    for (int j = n_comp; j < n_tiles; ++j) {
      skip_chunks<kCS>(bar_c, bar_ec, j, n_chunks, lane);
      mbar_wait(&bar_s[j % kSS], (j / kSS) & 1);
      release_stage(&bar_es[j % kSS], lane);
    }

    // every load has landed and every product read its stage: slice stage
    // wg takes this warpgroup's dQ slice
    named_sync(kBarConsumers);
    uint8_t* out = ss + wg * C::kSliceBytes;
    stage_rows<kDV>(dq, out, warp, lane);
    staged(wg);
    if (tid == 0) {
      store_cols<kDV / 64>(&tm_dq, out, col0, row_first, h, b);
      store_done();
    }
  }
}

// ------------------------------------------------------------------ host side

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;  // [B, H, Tq]
  const float* di;   // [B, H, Tq]
  void* dq;
  void* dk;
  void* dv;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  int batch, heads, tq, tk;
  float scale;
};

template <typename Kernel>
int prepare(Kernel kernel, int smem, int64_t blocks) {
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidConfiguration;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int D>
int launch_dkv(const BwdArgs& a, int causal, cudaStream_t stream) {
  using C = DkvCfg<D>;
  CUtensorMap mq, mk, mv, mdo, mdk, mdv;
  if (!make_map(&mq, a.q, a.batch, a.tq, a.heads, D, a.sq, C::kBq) ||
      !make_map(&mk, a.k, a.batch, a.tk, a.heads, D, a.sk, 64) ||
      !make_map(&mv, a.v, a.batch, a.tk, a.heads, D, a.sv, 64) ||
      !make_map(&mdo, a.dout, a.batch, a.tq, a.heads, D, a.sdo, C::kBq) ||
      !make_map(&mdk, a.dk, a.batch, a.tk, a.heads, D, a.sdk, 64) ||
      !make_map(&mdv, a.dv, a.batch, a.tk, a.heads, D, a.sdv, 64)) {
    return (int)cudaErrorInvalidValue;
  }
  auto* kernel =
      causal ? flash_bwd_dkv_sm90<D, true> : flash_bwd_dkv_sm90<D, false>;
  const int64_t blocks = (int64_t)ceil_div(a.tk, C::kBk) * a.heads * a.batch;
  const int err = prepare(kernel, C::kSmem, blocks);
  if (err != 0) return err;
  kernel<<<(unsigned)blocks, C::kThreads, C::kSmem, stream>>>(
      mq, mk, mv, mdo, mdk, mdv, a.lse, a.di, a.tq, a.tk, a.heads, a.scale,
      a.scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const BwdArgs& a, int causal, cudaStream_t stream) {
  using C = DqCfg<D>;
  CUtensorMap mq, mk, mv, mdo, mdq;
  if (!make_map(&mq, a.q, a.batch, a.tq, a.heads, D, a.sq, 64) ||
      !make_map(&mk, a.k, a.batch, a.tk, a.heads, D, a.sk, C::kBn) ||
      !make_map(&mv, a.v, a.batch, a.tk, a.heads, D, a.sv, C::kBn) ||
      !make_map(&mdo, a.dout, a.batch, a.tq, a.heads, D, a.sdo, 64) ||
      !make_map(&mdq, a.dq, a.batch, a.tq, a.heads, D, a.sdq, 64)) {
    return (int)cudaErrorInvalidValue;
  }
  auto* kernel =
      causal ? flash_bwd_dq_sm90<D, true> : flash_bwd_dq_sm90<D, false>;
  const int64_t blocks = (int64_t)ceil_div(a.tq, C::kBm) * a.heads * a.batch;
  const int err = prepare(kernel, C::kSmem, blocks);
  if (err != 0) return err;
  kernel<<<(unsigned)blocks, C::kThreads, C::kSmem, stream>>>(
      mq, mk, mv, mdo, mdq, a.lse, a.di, a.tq, a.tk, a.heads, a.scale,
      a.scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const BwdArgs& a, int causal, int which, cudaStream_t stream) {
  return which == 0 ? launch_dkv<D>(a, causal, stream)
                    : launch_dq<D>(a, causal, stream);
}

// D >= 384: K6 or K7 in slices of kDV columns
template <int kDV>
int launch_sliced(const BwdArgs& a, int d, int causal, int which,
                  cudaStream_t stream) {
  if (d % kDV) return (int)cudaErrorInvalidValue;
  const int64_t slots = (int64_t)a.heads * (d / kDV) * a.batch;
  if (which == 0) {
    using C = DkvSlicedCfg<kDV>;
    CUtensorMap mq, mk, mv, mdo, mdk, mdv;
    if (!make_map(&mq, a.q, a.batch, a.tq, a.heads, d, a.sq, C::kBq) ||
        !make_map(&mk, a.k, a.batch, a.tk, a.heads, d, a.sk, C::kBk) ||
        !make_map(&mv, a.v, a.batch, a.tk, a.heads, d, a.sv, C::kBk) ||
        !make_map(&mdo, a.dout, a.batch, a.tq, a.heads, d, a.sdo, C::kBq) ||
        !make_map(&mdk, a.dk, a.batch, a.tk, a.heads, d, a.sdk, 64) ||
        !make_map(&mdv, a.dv, a.batch, a.tk, a.heads, d, a.sdv, 64)) {
      return (int)cudaErrorInvalidValue;
    }
    auto* kernel = causal ? flash_bwd_dkv_sliced<kDV, true>
                          : flash_bwd_dkv_sliced<kDV, false>;
    const int64_t blocks = (int64_t)ceil_div(a.tk, C::kBk) * slots;
    const int err = prepare(kernel, C::kSmem, blocks);
    if (err != 0) return err;
    kernel<<<(unsigned)blocks, C::kThreads, C::kSmem, stream>>>(
        mq, mk, mv, mdo, mdk, mdv, a.lse, a.di, a.tq, a.tk, a.heads, d,
        a.scale, a.scale * kLog2e);
    return (int)cudaGetLastError();
  }
  using C = DqSlicedCfg<kDV>;
  CUtensorMap mq, mk, mv, mdo, mdq;
  if (!make_map(&mq, a.q, a.batch, a.tq, a.heads, d, a.sq, 64) ||
      !make_map(&mk, a.k, a.batch, a.tk, a.heads, d, a.sk, C::kBn) ||
      !make_map(&mv, a.v, a.batch, a.tk, a.heads, d, a.sv, C::kBn) ||
      !make_map(&mdo, a.dout, a.batch, a.tq, a.heads, d, a.sdo, 64) ||
      !make_map(&mdq, a.dq, a.batch, a.tq, a.heads, d, a.sdq, 64)) {
    return (int)cudaErrorInvalidValue;
  }
  auto* kernel = causal ? flash_bwd_dq_sliced<kDV, true>
                        : flash_bwd_dq_sliced<kDV, false>;
  const int64_t blocks = (int64_t)ceil_div(a.tq, C::kBm) * slots;
  const int err = prepare(kernel, C::kSmem, blocks);
  if (err != 0) return err;
  kernel<<<(unsigned)blocks, C::kThreads, C::kSmem, stream>>>(
      mq, mk, mv, mdo, mdq, a.lse, a.di, a.tq, a.tk, a.heads, d, a.scale,
      a.scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch of K6 (which = 0: dK and dV) or K7 (which = 1: dQ).
// q, k, v, dout, dq, dk, dv: bf16 [B, T, H, D] with the given element
// strides (batch, time, head per tensor, in that order; the last dimension
// contiguous, the strides multiples of 8 and the bases 16-byte aligned);
// lse, di: contiguous f32 [B, H, Tq]. Tq and Tk are multiples of 64, causal
// needs Tq == Tk, and D is 64 or a multiple of 128 (64-256 through their
// tuned instantiations, from 384 up in 128-column slices). Returns a
// cudaError_t code.
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
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.di = di;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  Strides* st[7] = {&a.sq, &a.sk, &a.sv, &a.sdo, &a.sdq, &a.sdk, &a.sdv};
  for (int i = 0; i < 7; ++i) {
    *st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  }
  a.batch = batch;
  a.heads = heads;
  a.tq = tq;
  a.tk = tk;
  a.scale = sm_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch<64>(a, causal, which, s);
    case 128:
      return launch<128>(a, causal, which, s);
    case 256:
      return launch<256>(a, causal, which, s);
    default:
      if (head_dim < 384 || head_dim % 128) return (int)cudaErrorInvalidValue;
      return launch_sliced<128>(a, head_dim, causal, which, s);
  }
}
