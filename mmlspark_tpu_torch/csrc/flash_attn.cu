// K5: flash-attention forward for Hopper (sm_90a), bf16 in, f32 accumulate.
//
// Replaces the TPU route mmlspark_tpu/models/attention.py:_flash_dispatch,
// which calls the library kernel jax.experimental.pallas.ops.tpu.
// flash_attention (it reaches pl.pallas_call inside JAX). The function:
//
//   o[b, i, h, :] = sum_j softmax_j(q[b,i,h,:] . k[b,j,h,:] * sm_scale) v[b,j,h,:]
//
// over q, k, v in bf16 laid out [B, T, H, D] and read through their strides
// (the reference transposes to [B, H, T, D] for the library kernel; nothing
// here needs that), non-causal or full-square causal (Tq == Tk, key j
// visible to query i when j <= i), output bf16 [B, Tq, H, D].
// The numeric contract: the scores are f32, scaled by sm_scale * log2(e)
// (sm_scale = 1/sqrt(D) multiplies the f32 scores, as the library kernel
// does); the softmax is online, a running row max and sum in f32 with the
// accumulator rescaled per key tile; P is rounded to bf16 unnormalised
// before P V, and the output is divided by the row sum once at the end.
//
// Bound on the H100: operations. Per (b, h) the two products are
// 4 * Tq * Tk * D flops (halved under causal masking) against 2 bytes per
// element of q, k, v and o: at T = 2048, D = 64 that is ~2,000 flops per
// byte, far above the card's ~295 (989 TFLOP/s bf16 / 3.35 TB/s). At
// D = 64 the softmax's exponentials (one per score, 256 flops of product
// each) take as many SFU cycles as the products take tensor-core cycles,
// so they have to run beside the products, not between them.
//
// Design (flash_fwd_sm90, head dims 64-512; above 512 flash_fwd_sliced, the
// general path described before it below):
//   - one CTA per (64 * kWG query rows, head, batch): kWG consumer
//     warpgroups of 64 rows each (3 at D = 64, 2 above, where the output
//     accumulator is larger) and one producer warpgroup, of which one
//     thread works; setmaxnreg moves registers from the producer (24 a
//     thread) to the consumers (160 with three, 240 with two). Each K/V
//     tile read from L2 serves 192 or 128 queries;
//   - the producer loads the CTA's Q once, then K and V tiles of kN keys
//     (kN = 128 at D = 64 and 128, 64 at D = 256, 32 at D = 384 and 512)
//     into a ring of kStages shared-memory stages (as many as fit beside Q,
//     at most 3: 2 at D = 256 and 512), each with mbarriers: a full barrier
//     for K and one for V (TMA completes them), and a free barrier for
//     each, on which every consumer warp arrives once its products have
//     read the tile: K right after S = Q K^T, V after P V a softmax later,
//     so the next K loads while P V still reads V. The loads are TMA
//     (cp.async.bulk.tensor.4d) through CUtensorMaps over the strided
//     [B, T, H, D] views (D innermost, then T, H, B), passed as
//     __grid_constant__ kernel parameters and built on the host with
//     cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint so
//     the library needs no -lcuda. A box is 64 columns (128 bytes) wide,
//     128-byte swizzled, so a tile of D columns is D/64 boxes;
//   - S = Q K^T is wgmma.mma_async m64nNk16 (N = kN) with both operands
//     K-major in shared memory; O += P V is m64nDk16 (N = kDV, the output
//     columns of the CTA) with P, converted to
//     bf16 in registers, as A (the f32 accumulator layout of S is the A
//     fragment layout) and V read N-major ("transposed") from the same
//     swizzled tiles;
//   - within a warpgroup the products of one tile overlap the softmax of
//     another: S_j = Q K_j^T and O += P_{j-1} V_{j-1} are issued together,
//     the softmax of S_j runs while P_{j-1} V_{j-1} is in flight, and O is
//     rescaled once it lands; the consumer warpgroups take turns to issue
//     their products (named barriers), so one's softmax runs under the
//     other's products;
//   - ragged lengths: TMA zero-fills rows past Tq and Tk, keys past Tk get
//     a score of -inf, and the output goes back by TMA store, which drops
//     rows past Tq;
//   - causal masking: key tiles wholly above a warpgroup's diagonal are not
//     computed (their stages are still waited for and released), the tiles
//     that cross it are masked element by element, and the CTAs with the
//     most tiles start first;
//   - the output is divided by l, rounded to bf16 and written into the
//     warpgroup's own (no longer needed) Q tile in the TMA box layout, then
//     stored with one TMA store per 64 columns;
//   - with an ``lse`` buffer (training: K6 and K7 read it), one thread of
//     each row's quad writes the row's log-sum-exp of the scaled scores,
//     lse = ln(sum_j exp(sm_scale * q.k_j)) = (m * sm_scale * log2(e) +
//     log2(l)) * ln(2) in the kernel's base-2 terms, f32 [B, H, Tq]; at
//     D = 384 and 512 only the CTA of the first column half writes it. A
//     null ``lse`` (serving) skips the branch and nothing else changes;
//   - at D = 384 and 512 a CTA writes half the output columns (kDV = D/2):
//     an f32 accumulator of all D columns would take 192-256 registers a
//     thread. The two CTAs of a row tile each compute all of S = Q K^T and
//     half of P V, loading only their half of V; with 32-key tiles, Q
//     (96-128 KB) and two or three K/V stages fit in shared memory.
// No atomics: every output element has one writer, and the result does not
// depend on the order the CTAs run in.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr float kLn2 = 0.6931471805599453f;

// ----------------------------------------------------------------- the kernel

template <int D>
struct Sm90Cfg {
  static constexpr int kDV = D <= 256 ? D : D / 2;  // output columns per CTA
  static constexpr int kColSplit = D / kDV;
  static constexpr int kWG = D == 64 ? 3 : 2;       // consumer warpgroups
  static constexpr int kM = 64 * kWG;               // query rows per CTA
  static constexpr int kN = D <= 128 ? 128 : D == 256 ? 64 : 32;  // keys
  static constexpr int kChunks = D / 64;     // 64-column TMA boxes of Q, K
  static constexpr int kVChunks = kDV / 64;  // and of V and O
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr int kQBytes = 64 * D * 2;      // one warpgroup's Q rows
  static constexpr int kKBytes = kN * D * 2;      // one K tile
  static constexpr int kVBytes = kN * kDV * 2;    // one V tile
  // as many stages as fit (at most 3) beside Q in 227 KB, with 1 KB of
  // alignment slack and room for the barriers
  static constexpr int kFit =
      (232448 - 1024 - 256 - kWG * kQBytes) / (kKBytes + kVBytes);
  static constexpr int kStages = kFit < 3 ? kFit : 3;
  static constexpr int kSmem =
      kWG * kQBytes + kStages * (kKBytes + kVBytes) + 1024;
  static_assert(kStages >= 2, "a K/V ring needs two stages");
  // 65,536 registers: 24 a producer thread, the rest to the consumers
  static constexpr int kConsumerRegs = kWG == 2 ? 240 : 160;
  static constexpr int kProducerRegs = 24;
};

// scale, mask, online max and sum of one S tile; leaves exp2 of the scaled,
// shifted scores in ``s`` and the factor the accumulator must be rescaled
// by in ``corr``. m_run is kept in unscaled score units; l_run holds this
// thread's share of each row's sum (its quad is summed at the end).
template <int kN, bool kCausal>
__device__ __forceinline__ void online_softmax(float (&s)[kN / 2],
                                               float (&m_run)[2],
                                               float (&l_run)[2],
                                               float (&corr)[2], int n0,
                                               int row0, int row_first, int tk,
                                               float scale_log2, int lane) {
  const bool need_mask =
      n0 + kN > tk || (kCausal && n0 + kN - 1 > row_first);
  if (need_mask) {
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) {
      const int key = n0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      const int row = row0 + 8 * ((i >> 1) & 1);
      if (key >= tk || (kCausal && key > row)) s[i] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) {
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  }
  float msc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_run[r], mx[r]);
    // a row with no visible key yet keeps exp2 finite: exp2(-inf) = 0
    msc[r] = m_new == -INFINITY ? 0.f : m_new * scale_log2;
    corr[r] = ex2(m_run[r] * scale_log2 - msc[r]);
    m_run[r] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) {
    const float p = ex2(fmaf(s[i], scale_log2, -msc[(i >> 1) & 1]));
    s[i] = p;
    rs[(i >> 1) & 1] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + rs[r];
}

template <int kN, int kChunks>
__device__ __forceinline__ void issue_qk(float (&s)[kN / 2],
                                         const uint8_t* sq,
                                         const uint8_t* sk) {
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_ss<kN>(s, desc_sw128(sq + c * 8192 + kk * 32, 16, 1024),
                   desc_sw128(sk + c * kN * 128 + kk * 32, 16, 1024),
                   (c | kk) != 0);
    }
  }
  wgmma_commit();
}

template <int DV, int kN>
__device__ __forceinline__ void issue_pv(float (&o)[DV / 2],
                                         const uint32_t (&p)[kN / 16][4],
                                         const uint8_t* sv) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk) {
    // 16 keys = two 8-row atoms; the DV columns are DV/64 boxes kN*128 apart
    wgmma_rs<DV>(o, p[kk], desc_sw128(sv + kk * 2048, kN * 128, 1024), 1);
  }
  wgmma_commit();
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(Sm90Cfg<D>::kThreads, 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_o,
                   float* __restrict__ lse, int tq, int tk, int heads,
                   float scale_log2) {
  using C = Sm90Cfg<D>;
  constexpr int kN = C::kN;
  constexpr int kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q;
  __shared__ __align__(8) uint64_t bar_k[kStages];
  __shared__ __align__(8) uint64_t bar_v[kStages];
  __shared__ __align__(8) uint64_t bar_ek[kStages];  // K stage read
  __shared__ __align__(8) uint64_t bar_ev[kStages];  // V stage read
  // 128-byte swizzled tiles need 1024-byte alignment
  uint8_t* sq = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sk = sq + C::kWG * C::kQBytes;  // [stage][chunk][kN][64]
  uint8_t* sv = sk + kStages * C::kKBytes;

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  // a 1-D grid over (batch, head x column split, query block), query blocks
  // fastest: the launch order of a (query block, head, batch) grid without
  // grid.z's 65,535 cap on the batch; grid.x takes 2^31 - 1 blocks
  // (flash_kernel.launch_grid and grid_decode mirror this)
  const int m_blocks = ceil_div(tq, C::kM);
  const int hc = heads * C::kColSplit;
  const int m_raw = (int)(blockIdx.x % (unsigned)m_blocks);
  const int hy = (int)((blockIdx.x / (unsigned)m_blocks) % (unsigned)hc);
  const int b = (int)(blockIdx.x / ((unsigned)m_blocks * (unsigned)hc));
  // causal: the longest rows first
  const int m_block = kCausal ? m_blocks - 1 - m_raw : m_raw;
  const int h = hy / C::kColSplit;
  const int col0 = (hy % C::kColSplit) * C::kDV;  // first output col
  const int q0 = m_block * C::kM;
  const int n_tiles = kCausal ? min(ceil_div(tk, kN), ceil_div(q0 + C::kM, kN))
                              : ceil_div(tk, kN);

  if (threadIdx.x == 0) {
    mbar_init(&bar_q, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bar_k[s], 1);
      mbar_init(&bar_v[s], 1);
      mbar_init(&bar_ek[s], C::kWG * 4);  // one arrival per consumer warp
      mbar_init(&bar_ev[s], C::kWG * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == C::kWG) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<C::kProducerRegs>();
    if (tid == 0) {
      mbar_expect_tx(&bar_q, C::kWG * C::kQBytes);
      for (int w = 0; w < C::kWG; ++w) {
        for (int c = 0; c < C::kChunks; ++c) {
          tma_load(sq + w * C::kQBytes + c * 8192, &tm_q, &bar_q, c * 64,
                   q0 + 64 * w, h, b);
        }
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        const uint32_t free_parity = ((j / kStages) & 1) ^ 1;
        uint8_t* dk = sk + st * C::kKBytes;
        uint8_t* dv = sv + st * C::kVBytes;
        mbar_wait(&bar_ek[st], free_parity);
        mbar_expect_tx(&bar_k[st], C::kKBytes);
        for (int c = 0; c < C::kChunks; ++c) {
          tma_load(dk + c * kN * 128, &tm_k, &bar_k[st], c * 64, j * kN, h, b);
        }
        mbar_wait(&bar_ev[st], free_parity);
        mbar_expect_tx(&bar_v[st], C::kVBytes);
        for (int c = 0; c < C::kVChunks; ++c) {
          tma_load(dv + c * kN * 128, &tm_v, &bar_v[st], col0 + c * 64,
                   j * kN, h, b);
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    setmaxnreg_inc<C::kConsumerRegs>();
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int row_first = q0 + 64 * wg;               // this warpgroup's rows
    const int row0 = row_first + 16 * warp + lane / 4;  // this thread's: +0, +8
    // under causal masking the later tiles lie wholly above this
    // warpgroup's diagonal: waited for and released, not computed
    const int n_comp =
        kCausal ? min(n_tiles, (row_first + 63) / kN + 1) : n_tiles;
    uint8_t* sqw = sq + wg * C::kQBytes;

    constexpr int kDV = C::kDV;
    float o[kDV / 2];
#pragma unroll
    for (int i = 0; i < kDV / 2; ++i) o[i] = 0.f;
    float s[kN / 2];
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) s[i] = 0.f;
    uint32_t p[kN / 16][4];
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};
    float corr[2];

    if (wg == C::kWG - 1) turn_pass<C::kWG>(wg);  // warpgroup 0 goes first
    mbar_wait(&bar_q, 0);
    mbar_wait(&bar_k[0], 0);
    turn_wait(wg);
    issue_qk<kN, C::kChunks>(s, sqw, sk);
    turn_pass<C::kWG>(wg);
    wgmma_wait<0>();
    fence_regs(s);
    __syncwarp();
    if (lane == 0) mbar_arrive(&bar_ek[0]);
    online_softmax<kN, kCausal>(s, m_run, l_run, corr, 0, row0, row_first, tk,
                                scale_log2, lane);
    pack_p<kN>(s, p);

    for (int j = 1; j < n_comp; ++j) {
      const int st = j % kStages;
      const int pst = (j - 1) % kStages;
      mbar_wait(&bar_k[st], (j / kStages) & 1);
      turn_wait(wg);
      issue_qk<kN, C::kChunks>(s, sqw, sk + st * C::kKBytes);
      mbar_wait(&bar_v[pst], ((j - 1) / kStages) & 1);
      issue_pv<kDV, kN>(o, p, sv + pst * C::kVBytes);
      turn_pass<C::kWG>(wg);
      wgmma_wait<1>();  // S_j has landed; P_{j-1} V_{j-1} may still run
      fence_regs(s);
      __syncwarp();
      if (lane == 0) mbar_arrive(&bar_ek[st]);
      online_softmax<kN, kCausal>(s, m_run, l_run, corr, j * kN, row0,
                                  row_first, tk, scale_log2, lane);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
      __syncwarp();
      if (lane == 0) mbar_arrive(&bar_ev[pst]);
#pragma unroll
      for (int i = 0; i < kDV / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      pack_p<kN>(s, p);
    }
    {
      const int last = n_comp - 1;
      const int st = last % kStages;
      mbar_wait(&bar_v[st], (last / kStages) & 1);
      turn_wait(wg);
      issue_pv<kDV, kN>(o, p, sv + st * C::kVBytes);
      turn_pass<C::kWG>(wg);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
      __syncwarp();
      if (lane == 0) mbar_arrive(&bar_ev[st]);
    }
    for (int j = n_comp; j < n_tiles; ++j) {
      const int st = j % kStages;
      mbar_wait(&bar_k[st], (j / kStages) & 1);
      mbar_wait(&bar_v[st], (j / kStages) & 1);
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&bar_ek[st]);
        mbar_arrive(&bar_ev[st]);
      }
      turn_wait(wg);  // every warpgroup takes as many turns
      turn_pass<C::kWG>(wg);
    }
    if (wg == 0) turn_wait(wg);  // the last warpgroup's last pass

    // divide by l once, round to bf16 and stage the rows in this
    // warpgroup's Q tile, in the TMA box layout (row rr of a 64-column box
    // at rr * 128 bytes, 16-byte unit u at (u ^ rr % 8) * 16)
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[r] = l > 0.f ? 1.f / l : 0.f;
      const int row = row0 + 8 * r;
      if (lse != nullptr && col0 == 0 && (lane & 3) == 0 && row < tq) {
        lse[((int64_t)b * heads + h) * tq + row] =
            (m_run[r] * scale_log2 + log2f(l)) * kLn2;
      }
    }
#pragma unroll
    for (int i = 0; i < kDV / 8; ++i) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int rr = 16 * warp + lane / 4 + 8 * hf;
        uint8_t* dst = sqw + (i / 8) * 8192 + rr * 128 +
                       (((i % 8) ^ (rr % 8)) * 16) + (lane & 3) * 4;
        *reinterpret_cast<uint32_t*>(dst) =
            pack_f32(o[4 * i + 2 * hf] * inv[hf],
                     o[4 * i + 2 * hf + 1] * inv[hf]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(8 + wg) : "memory");
    if (tid == 0) {
      for (int c = 0; c < C::kVChunks; ++c) {
        tma_store(&tm_o, sqw + c * 8192, col0 + c * 64, row_first, h, b);
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
  }
}

// ------------------------------------------- the general path: D above 512
//
// Every multiple of 128 above 512 the gate admits, with D a run-time count
// of 64-column chunks: one instantiation per output slice width (kDV), not
// per head dim. Beside two warpgroups' Q (2 x 64 x D x 2 bytes: 160 KB at
// D = 640) no two K/V stages fit, and at D = 2048 even one warpgroup's Q
// does not, so nothing of D stays resident:
//   - a CTA owns 128 query rows (two consumer warpgroups of 64, one
//     producer warpgroup of which one thread works) and one slice of kDV
//     output columns; the slices of a row tile are D / kDV CTAs, each
//     computing all of S = Q K^T and its own P V_slice (the recompute is
//     (D / kDV) - 1 extra S products per key tile: counted as useful flops
//     it shows as the kernel's gap to its bound, not hidden);
//   - per key tile of kN keys, S accumulates over the D / 64 chunks: ring
//     stage g = (tile * chunks + chunk) holds the chunk's 64-column box of
//     the CTA's 128 queries and of the tile's kN keys (TMA, 128-byte
//     swizzled), released by each consumer warp once the wgmma that reads
//     it has landed (the next chunk's wgmma is issued first, so the tensor
//     cores never wait on a release);
//   - the V slice of the tile (kN x kDV) comes through a second ring, after
//     the tile's chunks: the producer's order is the consumers', so neither
//     ring can wait on the other;
//   - the softmax, masking, causal skipping, lse and ragged edges are the
//     tuned kernel's (online_softmax above); the output is divided by l,
//     staged in a V stage once both warpgroups are done (named barrier 5)
//     and stored by TMA, which drops rows past Tq.
template <int kDV>
struct SlicedCfg {
  static constexpr int kWG = 2;
  static constexpr int kM = 128;                     // query rows per CTA
  static constexpr int kN = 128;                     // keys per tile
  static constexpr int kThreads = 384;
  static constexpr int kQBytes = kM * 128;           // a box of 128 queries
  static constexpr int kKBytes = kN * 128;           // a box of kN keys
  static constexpr int kChunkBytes = kQBytes + kKBytes;
  static constexpr int kVBytes = kN * kDV * 2;       // a tile's V slice
  static constexpr int kChunkStages = 4;
  static constexpr int kVStages = 2;
  static constexpr int kSmem =
      kChunkStages * kChunkBytes + kVStages * kVBytes + 1024;
  static_assert(kSmem + 256 <= 232448, "shared memory of a block");
  static_assert(kVBytes >= 64 * kDV * 2, "a warpgroup's output in a V stage");
  static constexpr int kConsumerRegs = 240;
  static constexpr int kProducerRegs = 24;
};

constexpr int kBarConsumers = 5;  // both consumer warpgroups (named barrier)

template <int kDV, bool kCausal>
__global__ void __launch_bounds__(SlicedCfg<kDV>::kThreads, 1)
    flash_fwd_sliced(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_o,
                     float* __restrict__ lse, int tq, int tk, int heads,
                     int d, float scale_log2) {
  using C = SlicedCfg<kDV>;
  constexpr int kN = C::kN;
  constexpr int kCS = C::kChunkStages;
  constexpr int kVS = C::kVStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_c[kCS];   // chunk stage full
  __shared__ __align__(8) uint64_t bar_ec[kCS];  // chunk stage read
  __shared__ __align__(8) uint64_t bar_v[kVS];
  __shared__ __align__(8) uint64_t bar_ev[kVS];
  // 128-byte swizzled tiles need 1024-byte alignment
  uint8_t* sc = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sv = sc + kCS * C::kChunkBytes;  // [stage][kDV/64][kN][64]

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int n_chunks = d / 64;
  const int n_slices = d / kDV;
  // the tuned kernel's 1-D grid, with a head x slice slot (slices of a
  // head adjacent): flash_kernel.launch_grid and grid_decode mirror it
  const int m_blocks = ceil_div(tq, C::kM);
  const int hc = heads * n_slices;
  const int m_raw = (int)(blockIdx.x % (unsigned)m_blocks);
  const int hy = (int)((blockIdx.x / (unsigned)m_blocks) % (unsigned)hc);
  const int b = (int)(blockIdx.x / ((unsigned)m_blocks * (unsigned)hc));
  const int m_block = kCausal ? m_blocks - 1 - m_raw : m_raw;
  const int h = hy / n_slices;
  const int col0 = (hy % n_slices) * kDV;
  const int q0 = m_block * C::kM;
  const int n_tiles = kCausal ? min(ceil_div(tk, kN), ceil_div(q0 + C::kM, kN))
                              : ceil_div(tk, kN);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kCS; ++s) {
      mbar_init(&bar_c[s], 1);
      mbar_init(&bar_ec[s], C::kWG * 4);  // one arrival per consumer warp
    }
#pragma unroll
    for (int s = 0; s < kVS; ++s) {
      mbar_init(&bar_v[s], 1);
      mbar_init(&bar_ev[s], C::kWG * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == C::kWG) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<C::kProducerRegs>();
    if (tid == 0) {
      for (int j = 0; j < n_tiles; ++j) {
        for (int c = 0; c < n_chunks; ++c) {
          const int g = j * n_chunks + c;
          const int st = g % kCS;
          uint8_t* dst = sc + st * C::kChunkBytes;
          mbar_wait(&bar_ec[st], ((g / kCS) & 1) ^ 1);
          mbar_expect_tx(&bar_c[st], C::kChunkBytes);
          tma_load(dst, &tm_q, &bar_c[st], c * 64, q0, h, b);
          tma_load(dst + 8192, &tm_q, &bar_c[st], c * 64, q0 + 64, h, b);
          tma_load(dst + C::kQBytes, &tm_k, &bar_c[st], c * 64, j * kN, h, b);
        }
        const int vs = j % kVS;
        mbar_wait(&bar_ev[vs], ((j / kVS) & 1) ^ 1);
        mbar_expect_tx(&bar_v[vs], C::kVBytes);
        for (int c = 0; c < kDV / 64; ++c) {
          tma_load(sv + vs * C::kVBytes + c * kN * 128, &tm_v, &bar_v[vs],
                   col0 + c * 64, j * kN, h, b);
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    setmaxnreg_inc<C::kConsumerRegs>();
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int row_first = q0 + 64 * wg;
    const int row0 = row_first + 16 * warp + lane / 4;  // this thread's: +0, +8
    const int n_comp =
        kCausal ? min(n_tiles, (row_first + 63) / kN + 1) : n_tiles;

    float o[kDV / 2];
#pragma unroll
    for (int i = 0; i < kDV / 2; ++i) o[i] = 0.f;
    float s[kN / 2];
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) s[i] = 0.f;
    uint32_t p[kN / 16][4];
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};
    float corr[2];

    for (int j = 0; j < n_comp; ++j) {
      // S = Q K^T of key tile j over the D / 64 chunks
      sum_chunks<kCS>(bar_c, bar_ec, j, n_chunks, lane, [&](int st, int acc) {
        const uint8_t* src = sc + st * C::kChunkBytes;
        ss_box<kN>(s, src + wg * 8192, src + C::kQBytes, acc);
      });
      fence_regs(s);
      online_softmax<kN, kCausal>(s, m_run, l_run, corr, j * kN, row0,
                                  row_first, tk, scale_log2, lane);
#pragma unroll
      for (int i = 0; i < kDV / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      pack_p<kN>(s, p);
      const int vs = j % kVS;
      mbar_wait(&bar_v[vs], (j / kVS) & 1);
      issue_pv<kDV, kN>(o, p, sv + vs * C::kVBytes);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
      release_stage(&bar_ev[vs], lane);
    }
    // under causal masking the later tiles lie wholly above this
    // warpgroup's diagonal: waited for and released, not computed
    for (int j = n_comp; j < n_tiles; ++j) {
      skip_chunks<kCS>(bar_c, bar_ec, j, n_chunks, lane);
      mbar_wait(&bar_v[j % kVS], (j / kVS) & 1);
      release_stage(&bar_ev[j % kVS], lane);
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[r] = l > 0.f ? 1.f / l : 0.f;
      const int row = row0 + 8 * r;
      if (lse != nullptr && col0 == 0 && (lane & 3) == 0 && row < tq) {
        lse[((int64_t)b * heads + h) * tq + row] =
            (m_run[r] * scale_log2 + log2f(l)) * kLn2;
      }
    }
#pragma unroll
    for (int i = 0; i < kDV / 2; ++i) o[i] *= inv[(i >> 1) & 1];
    // every load has landed and every product read its stage: the V
    // stages take the two warpgroups' outputs
    named_sync(kBarConsumers);
    uint8_t* out = sv + wg * C::kVBytes;
    stage_rows<kDV>(o, out, warp, lane);
    staged(wg);
    if (tid == 0) {
      store_cols<kDV / 64>(&tm_o, out, col0, row_first, h, b);
      store_done();
    }
  }
}

// ------------------------------------------------------------------ host side

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int batch, int heads, int tq, int tk, int causal,
           const Strides (&st)[4], float sm_scale, cudaStream_t stream) {
  using C = Sm90Cfg<D>;
  CUtensorMap mq, mk, mv, mo;
  if (!make_map(&mq, q, batch, tq, heads, D, st[0], 64) ||
      !make_map(&mk, k, batch, tk, heads, D, st[1], C::kN) ||
      !make_map(&mv, v, batch, tk, heads, D, st[2], C::kN) ||
      !make_map(&mo, o, batch, tq, heads, D, st[3], 64)) {
    return (int)cudaErrorInvalidValue;
  }
  auto* kernel = causal ? flash_fwd_sm90<D, true> : flash_fwd_sm90<D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks =
      (int64_t)ceil_div(tq, C::kM) * heads * C::kColSplit * batch;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, C::kThreads, C::kSmem, stream>>>(
      mq, mk, mv, mo, lse, tq, tk, heads, sm_scale * kLog2e);
  return (int)cudaGetLastError();
}

// D above 512: the general path, slices of kDV output columns
template <int kDV>
int launch_sliced(const void* q, const void* k, const void* v, void* o,
                  float* lse, int batch, int heads, int tq, int tk, int d,
                  int causal, const Strides (&st)[4], float sm_scale,
                  cudaStream_t stream) {
  using C = SlicedCfg<kDV>;
  if (d % kDV) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mo;
  if (!make_map(&mq, q, batch, tq, heads, d, st[0], 64) ||
      !make_map(&mk, k, batch, tk, heads, d, st[1], C::kN) ||
      !make_map(&mv, v, batch, tk, heads, d, st[2], C::kN) ||
      !make_map(&mo, o, batch, tq, heads, d, st[3], 64)) {
    return (int)cudaErrorInvalidValue;
  }
  auto* kernel =
      causal ? flash_fwd_sliced<kDV, true> : flash_fwd_sliced<kDV, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks =
      (int64_t)ceil_div(tq, C::kM) * heads * (d / kDV) * batch;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, C::kThreads, C::kSmem, stream>>>(
      mq, mk, mv, mo, lse, tq, tk, heads, d, sm_scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: bf16 [B, T, H, D] with the given element strides (batch, time,
// head per tensor, in that order: q, k, v, o; the last dimension is
// contiguous, the strides multiples of 8 and the base 16-byte aligned). Tq
// and Tk are multiples of 64, causal needs Tq == Tk, and D is 64 or a
// multiple of 128 (64-512 through their tuned instantiations, above 512 the
// general path in 128-column slices). ``lse`` is null or an f32 [B, H, Tq] buffer for the rows'
// log-sum-exp (natural log of sum_j exp(sm_scale * q.k_j)). Returns a
// cudaError_t code.
extern "C" int mmlspark_flash_attn_fwd(const void* q, const void* k,
                                       const void* v, void* o, float* lse,
                                       int batch,
                                       int heads, int tq, int tk, int head_dim,
                                       int causal, const int64_t* strides,
                                       float sm_scale, void* stream) {
  if (batch <= 0 || heads <= 0 || tq <= 0) return (int)cudaGetLastError();
  if (tq % 64 || tk <= 0 || tk % 64 || (causal && tq != tk)) {
    return (int)cudaErrorInvalidValue;
  }
  Strides st[4];
  for (int i = 0; i < 4; ++i) {
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch<64>(q, k, v, o, lse, batch, heads, tq, tk, causal, st,
                       sm_scale, s);
    case 128:
      return launch<128>(q, k, v, o, lse, batch, heads, tq, tk, causal, st,
                        sm_scale, s);
    case 256:
      return launch<256>(q, k, v, o, lse, batch, heads, tq, tk, causal, st,
                        sm_scale, s);
    case 384:
      return launch<384>(q, k, v, o, lse, batch, heads, tq, tk, causal, st,
                        sm_scale, s);
    case 512:
      return launch<512>(q, k, v, o, lse, batch, heads, tq, tk, causal, st,
                        sm_scale, s);
    default:
      if (head_dim < 512 || head_dim % 128) return (int)cudaErrorInvalidValue;
      return launch_sliced<128>(q, k, v, o, lse, batch, heads, tq, tk,
                                head_dim, causal, st, sm_scale, s);
  }
}
