// K5: flash-attention forward for Hopper, bf16 in, f32 accumulate.
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
// sm_scale = 1/sqrt(D) multiplies the f32 scores, as the library kernel
// does (the reference's XLA path scales k in bf16 instead, which rounds at
// D = 128; both are within the reference's 0.05 bound).
//
// Bound on the H100: operations. Per (b, h) the two products are
// 4 * Tq * Tk * D flops (halved under causal masking) against 2 bytes per
// element of q, k, v and o: at T = 2048, D = 64 that is ~2,000 flops per
// byte, far above the card's ~295 (989 TFLOP/s bf16 / 3.35 TB/s). The
// softmax's exponentials (one per score) ride the SFU beside the tensor
// cores.
//
// Design (simple, right first; wgmma, TMA and warp specialisation are later
// work):
//   - one CTA of 4 warps per (64-query tile, head and chunk of output
//     columns, batch); each warp owns 16 query rows, and each thread two
//     rows (g and g + 8 of its warp's 16);
//   - a CTA writes DV of the D output columns: DV = D up to D = 256, and
//     D / 2 at D = 384 and 512, where the f32 accumulator of all D columns
//     would not fit in a thread's registers. Each of the two CTAs of such a
//     row tile computes the whole of S = Q K^T (the second time is the price
//     of the split) and its half of P V;
//   - the CTA's Q tile and, in turn, each 64-key tile of K and DV columns of
//     V sit in shared memory, rows padded by 16 bytes so the fragment loads
//     hit 32 distinct banks; at D = 256 the three tiles need 99 KB and at
//     D = 512 163 KB, which the launch opts into
//     (cudaFuncAttributeMaxDynamicSharedMemorySize);
//   - S = Q K^T and O += P V run on the tensor cores as
//     mma.sync.m16n8k16 with bf16 operands and f32 accumulators;
//   - the softmax is online: a running row max m and sum l in f32, the
//     accumulator rescaled by exp(m_old - m_new) per tile; P is rounded to
//     bf16 before P V, as the reference's XLA path rounds its probabilities
//     (attention.py:120), and the output is divided by l once at the end;
//   - under causal masking the K/V tiles wholly above the diagonal are
//     skipped and the diagonal tile is masked element by element.
// No atomics: every output element has one writer, and the result does not
// depend on the order the CTAs run in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;  // query rows per CTA, 16 per warp
constexpr int kBlockN = 64;  // keys per K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;  // bf16 elements of padding per shared-memory row
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {  // in elements
  int64_t b, t, h;
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one bf16x2 register, ``lo`` in the low half
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two adjacent bf16 in shared memory as one register
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 from separate addresses as one register, ``lo`` in the low half
__device__ __forceinline__ uint32_t ld_two(const __nv_bfloat16* lo,
                                           const __nv_bfloat16* hi) {
  const uint32_t a = *reinterpret_cast<const uint16_t*>(lo);
  const uint32_t b = *reinterpret_cast<const uint16_t*>(hi);
  return a | (b << 16);
}

// 64 rows of one head (D bf16 each, ``row_stride`` apart in global memory)
// into shared memory [64][D + kPad], 16 bytes per thread per step
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int64_t row_stride, int tid) {
  constexpr int kChunks = D / 8;
#pragma unroll 4
  for (int c = tid; c < kBlockN * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + col) =
        *reinterpret_cast<const uint4*>(src + r * row_stride + col);
  }
}

// the output columns one CTA writes (see the design note above)
__host__ __device__ constexpr int chunk_cols(int d) {
  return d <= 256 ? d : d / 2;
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, int tk, Strides qs, Strides ks,
                 Strides vs, Strides os, float scale_log2) {
  constexpr int DV = chunk_cols(D);
  constexpr int kColChunks = D / DV;
  constexpr int kRow = D + kPad;
  constexpr int kRowV = DV + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBlockM * kRow;
  __nv_bfloat16* sV = sK + kBlockN * kRow;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // row within the mma tile
  const int t = lane & 3;   // column pair within the mma tile
  const int qt = blockIdx.x;
  const int h = blockIdx.y / kColChunks;
  const int col0 = (blockIdx.y % kColChunks) * DV;  // first output column
  const int b = blockIdx.z;
  const int64_t q0 = (int64_t)qt * kBlockM;

  const __nv_bfloat16* qb = q + b * qs.b + q0 * qs.t + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h + col0;
  load_tile<D>(sQ, qb, qs.t, tid);

  float acc[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }
  float m_run[2] = {-INFINITY, -INFINITY};  // running max, log2 units
  float l_run[2] = {0.f, 0.f};              // running sum of exp
  const int row_a = warp * 16 + g;          // this thread's rows: row_a, +8
  // causal: Tq == Tk, so query tile qt sees key tiles 0..qt
  const int n_tiles = kCausal ? qt + 1 : tk / kBlockN;

  for (int j = 0; j < n_tiles; ++j) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(sK, kb + (int64_t)j * kBlockN * ks.t, ks.t, tid);
    load_tile<DV>(sV, vb + (int64_t)j * kBlockN * vs.t, vs.t, tid);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[kBlockN / 8][4];
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const __nv_bfloat16* qa = sQ + row_a * kRow + kk * 16 + 2 * t;
      const uint32_t a[4] = {ld_pair(qa), ld_pair(qa + 8 * kRow),
                             ld_pair(qa + 8), ld_pair(qa + 8 * kRow + 8)};
#pragma unroll
      for (int n = 0; n < kBlockN / 8; ++n) {
        const __nv_bfloat16* kp = sK + (n * 8 + g) * kRow + kk * 16 + 2 * t;
        mma_bf16(s[n], a, ld_pair(kp), ld_pair(kp + 8));
      }
    }

    // scale (log2 units), mask the diagonal tile, row max over the tile
    const bool diag = kCausal && j == qt;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[n][c] * scale_log2;
        if (diag) {
          const int key = n * 8 + 2 * t + (c & 1);
          const int row = row_a + ((c >> 1) << 3);
          if (key > row) x = -INFINITY;
        }
        s[n][c] = x;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
      }
    }
    // a row's 64 scores sit in the 4 threads of its group
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    float m_use[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], mx[r]);
      // a row with no visible key yet keeps exp() finite: exp(-inf) = 0
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      corr[r] = exp2f(m_run[r] - m_use[r]);
      m_run[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = exp2f(s[n][c] - m_use[c >> 1]);
        s[n][c] = p;
        rs[c >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l_run[r] = l_run[r] * corr[r] + rs[r];
    }
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // O += P V: the S accumulators of key columns 16kk..16kk+15 are the A
    // operand's layout, rounded to bf16
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint32_t a[4] = {pack_f32(s[2 * kk][0], s[2 * kk][1]),
                             pack_f32(s[2 * kk][2], s[2 * kk][3]),
                             pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vrow = sV + (kk * 16 + 2 * t) * kRowV + g;
#pragma unroll
      for (int n = 0; n < DV / 8; ++n) {
        const __nv_bfloat16* vp = vrow + n * 8;
        mma_bf16(acc[n], a, ld_two(vp, vp + kRowV),
                 ld_two(vp + 8 * kRowV, vp + 9 * kRowV));
      }
    }
  }

  // divide by l once, round to bf16, store this thread's two rows
  const float inv0 = l_run[0] > 0.f ? 1.f / l_run[0] : 0.f;
  const float inv1 = l_run[1] > 0.f ? 1.f / l_run[1] : 0.f;
  __nv_bfloat16* o0 = o + b * os.b + (q0 + row_a) * os.t + h * os.h + col0;
  __nv_bfloat16* o1 = o0 + 8 * os.t;
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) {
    const int col = n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(o0 + col) =
        pack_f32(acc[n][0] * inv0, acc[n][1] * inv0);
    *reinterpret_cast<uint32_t*>(o1 + col) =
        pack_f32(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

template <int D, bool kCausal>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int heads, int tq, int tk, const Strides (&st)[4], float sm_scale,
           cudaStream_t stream) {
  constexpr int DV = chunk_cols(D);
  const int smem = (2 * (D + kPad) + DV + kPad) * kBlockM *
                   (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, kCausal>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(tq / kBlockM, heads * (D / DV), batch);
  flash_fwd_kernel<D, kCausal><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      tk, st[0], st[1], st[2], st[3], sm_scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int batch,
             int heads, int tq, int tk, int causal, const Strides (&st)[4],
             float sm_scale, cudaStream_t stream) {
  return causal ? launch<D, true>(q, k, v, o, batch, heads, tq, tk, st,
                                  sm_scale, stream)
                : launch<D, false>(q, k, v, o, batch, heads, tq, tk, st,
                                   sm_scale, stream);
}

}  // namespace

// q, k, v, o: bf16 [B, T, H, D] with the given element strides (batch, time,
// head per tensor, in that order: q, k, v, o; the last dimension is
// contiguous). Tq and Tk are multiples of 64, causal needs Tq == Tk, and D
// is 64, 128, 256, 384 or 512. Returns a cudaError_t code.
extern "C" int mmlspark_flash_attn_fwd(const void* q, const void* k,
                                       const void* v, void* o, int batch,
                                       int heads, int tq, int tk, int head_dim,
                                       int causal, const int64_t* strides,
                                       float sm_scale, void* stream) {
  if (batch <= 0 || heads <= 0 || tq <= 0) return (int)cudaGetLastError();
  if (tq % kBlockM || tk <= 0 || tk % kBlockN || (causal && tq != tk)) {
    return (int)cudaErrorInvalidValue;
  }
  Strides st[4];
  for (int i = 0; i < 4; ++i) {
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch_d<64>(q, k, v, o, batch, heads, tq, tk, causal, st,
                          sm_scale, s);
    case 128:
      return launch_d<128>(q, k, v, o, batch, heads, tq, tk, causal, st,
                           sm_scale, s);
    case 256:
      return launch_d<256>(q, k, v, o, batch, heads, tq, tk, causal, st,
                           sm_scale, s);
    case 384:
      return launch_d<384>(q, k, v, o, batch, heads, tq, tk, causal, st,
                           sm_scale, s);
    case 512:
      return launch_d<512>(q, k, v, o, batch, heads, tq, tk, causal, st,
                           sm_scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
