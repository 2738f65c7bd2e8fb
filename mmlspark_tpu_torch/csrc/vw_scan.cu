// The VW online learner's pass on the card: one launch walks every example
// in order (the device form of mmlspark_tpu/vw/learner.py make_scan_pass,
// the lax.scan step at :106-158; not a Pallas kernel).
//
// One CTA of one warp. The optimizer state stays in global memory (w, g2
// and the learning-rate clock t for adaptive or plain SGD; z and n for
// FTRL): at 2^18 slots an array is 1 MB and lives in L2. Reads of the state
// go through L2 only (__ldcg), so a weight this warp just wrote is never
// read stale from L1.
//
// Per example (K padded slots, lane j handles slots j, j + 32, ...):
//   1. the slots' indices and values into shared memory, and a flag per
//      slot: is it the first occurrence of its index in the example;
//   2. the prediction: each lane sums its slots in ascending order, then a
//      fixed shuffle tree across the warp, so bits repeat from call to call;
//   3. the loss gradient (squared / logistic / hinge / quantile) times the
//      example weight, and gi per slot (plus the l2 decay on active slots
//      for SGD; t advances only on an example weight > 0);
//   4. the update with the reference's duplicate-index semantics (a
//      scatter-add: duplicates accumulate one after the other in slot
//      order). Adaptive is two-phase: every g2[idx] += gi^2 first, then the
//      weights' steps read the fully accumulated g2. The first occurrence
//      of an index adds its duplicates' terms in slot order, so the sums
//      are the sequential ones of native_src's mml_vw_train_pass.
// Two paths. The fast one takes an example of at most 64 slots whose
// active slots (value != 0; a slot of value 0 changes nothing in any mode)
// hold distinct in-range indices, the common case: each active slot's state
// is read once into registers and its update written from them, while the
// next example's slots load. Every other example takes the general path
// through shared memory (duplicates, out-of-range indices, wide examples).
// Both round every step as the C pass does (no FMA contraction).
// FTRL's step (z += gi - sigma * wi, n += gi^2 from the n read before the
// example) is the reference's at learner.py:106-125.
//
// Index semantics are XLA's for a hand-built dataset: a negative index
// wraps once, a gather clamps into [0, dim), a scatter outside it drops.
// The pass's summed example loss (weighted) is written to loss_out in f64.

#include <cuda_runtime.h>
#include <stdint.h>

// The kernel's arguments as one block (``scan_kernel._Args`` packs it).
struct ScanArgs {
    const int32_t* idx;
    const float* val;
    const float* labels;
    const float* wgts;
    float* s0;          // w (sgd / adaptive) or z (ftrl)
    float* s1;          // g2 (adaptive; unused by plain sgd) or n (ftrl)
    float* t_io;        // the learning-rate clock (sgd / adaptive)
    double* loss_out;
    int64_t n;
    int32_t k;
    int32_t dim;
    int32_t loss;       // 0 squared 1 logistic 2 hinge 3 quantile
    int32_t mode;       // 0 sgd 1 adaptive 2 ftrl
    float tau, lr, power_t, initial_t, l1, l2, alpha, beta;
};

namespace {

constexpr int WARP = 32;

__device__ __forceinline__ int32_t norm_index(int32_t i, int32_t dim) {
    return i < 0 ? i + dim : i;
}

__device__ __forceinline__ int32_t gather_index(int32_t i, int32_t dim) {
    return min(max(i, 0), dim - 1);
}

__device__ __forceinline__ float loss_grad(int loss, float pred, float label,
                                           float tau) {
    switch (loss) {
        case 1: return -label / (1.0f + expf(label * pred));
        case 2: return (label * pred < 1.0f) ? -label : 0.0f;
        case 3: return (pred > label) ? (1.0f - tau) : -tau;
        default: return pred - label;
    }
}

__device__ __forceinline__ float example_loss(int loss, float pred,
                                              float label, float tau) {
    switch (loss) {
        case 1: {
            const float m = -label * pred;
            return fmaxf(m, 0.0f) + log1pf(expf(-fabsf(m)));
        }
        case 2: return fmaxf(0.0f, 1.0f - label * pred);
        case 3: {
            const float d = pred - label;
            return d > 0.0f ? (1.0f - tau) * d : -tau * d;
        }
        default: return 0.5f * (pred - label) * (pred - label);
    }
}

__device__ __forceinline__ float rate_pow(float x, float p) {
    return p == 0.5f ? sqrtf(x) : powf(x, p);
}

// The update's arithmetic, rounded step by step (no contraction into FMAs),
// shared by both paths of the kernel (native_src's C pass rounds the same
// way, -ffp-contract=off).
__device__ __forceinline__ float sgd_gi(float g, float v, float w, float l2) {
    return __fadd_rn(__fmul_rn(g, v), v != 0.0f ? __fmul_rn(l2, w) : 0.0f);
}

__device__ __forceinline__ float adaptive_step(float lr, float gi, float g2,
                                               float power_t) {
    const float scale = __fadd_rn(rate_pow(__fadd_rn(g2, 1e-16f), power_t),
                                  1e-8f);
    return __fdiv_rn(__fmul_rn(-lr, gi), scale);
}

__device__ __forceinline__ float ftrl_weight(const ScanArgs& a, float z,
                                             float n) {
    if (fabsf(z) <= a.l1) return 0.0f;
    const float sign = (z > 0.0f) - (z < 0.0f);
    const float den = __fadd_rn(__fdiv_rn(__fadd_rn(a.beta, sqrtf(n)), a.alpha),
                                a.l2);
    return __fdiv_rn(-__fsub_rn(z, __fmul_rn(sign, a.l1)), den);
}

// FTRL's two scatter terms of a slot: gi - sigma * wi and gi^2
__device__ __forceinline__ void ftrl_terms(const ScanArgs& a, float g, float v,
                                           float wi, float n, float* t1,
                                           float* t2) {
    const float gi = __fmul_rn(g, v);
    const float gg = __fmul_rn(gi, gi);
    const float sigma = __fdiv_rn(__fsub_rn(sqrtf(__fadd_rn(n, gg)), sqrtf(n)),
                                  a.alpha);
    *t1 = __fsub_rn(gi, __fmul_rn(sigma, wi));
    *t2 = gg;
}

// Add the terms of every slot holding index ``ix`` (slot ``j`` is its first
// occurrence) to ``base`` one after the other, in slot order.
__device__ __forceinline__ float add_in_order(float base, int j, int k,
                                              const int32_t* s_idx,
                                              const float* terms) {
    const int32_t ix = s_idx[j];
    float acc = base;
    for (int jj = j; jj < k; jj++)
        if (s_idx[jj] == ix) acc = __fadd_rn(acc, terms[jj]);
    return acc;
}

// register slots a lane keeps (the fast path takes examples of <= 64 slots)
constexpr int SLOTS = 2;

__global__ void __launch_bounds__(WARP, 1) vw_scan_kernel(ScanArgs a) {
    extern __shared__ unsigned char smem[];
    const int k = a.k;
    int32_t* s_idx = reinterpret_cast<int32_t*>(smem);      // normalised
    float* s_val = reinterpret_cast<float*>(s_idx + k);
    float* s_w = s_val + k;        // the slot's weight (before the update)
    float* s_aux = s_w + k;        // n (ftrl)
    float* s_t1 = s_aux + k;       // first scatter's terms
    float* s_t2 = s_t1 + k;        // second scatter's terms
    uint8_t* s_first = reinterpret_cast<uint8_t*>(s_t2 + k);
    const int lane = threadIdx.x;
    const int dim = a.dim;
    const bool small = k <= WARP * SLOTS;
    float t = (a.mode == 2) ? 0.0f : *a.t_io;
    double loss_sum = 0.0;

    // the next example's slots, loaded while this one is processed
    int32_t nix[SLOTS];
    float nv[SLOTS];
#pragma unroll
    for (int s = 0; s < SLOTS; s++) {
        const int j = lane + s * WARP;
        const bool in = small && a.n > 0 && j < k;
        nix[s] = in ? a.idx[j] : 0;
        nv[s] = in ? a.val[j] : 0.0f;
    }

    for (int64_t i = 0; i < a.n; i++) {
        int32_t ix[SLOTS];
        float v[SLOTS];
        if (small) {
#pragma unroll
            for (int s = 0; s < SLOTS; s++) {
                const int j = lane + s * WARP;
                ix[s] = norm_index(nix[s], dim);
                v[s] = nv[s];
                if (j < k) {
                    s_idx[j] = ix[s];
                    s_val[j] = v[s];
                }
            }
            if (i + 1 < a.n) {
                const int32_t* nrow = a.idx + (i + 1) * (int64_t)k;
                const float* vrow = a.val + (i + 1) * (int64_t)k;
#pragma unroll
                for (int s = 0; s < SLOTS; s++) {
                    const int j = lane + s * WARP;
                    if (j < k) {
                        nix[s] = nrow[j];
                        nv[s] = vrow[j];
                    }
                }
            }
        } else {
            const int32_t* ix_row = a.idx + i * (int64_t)k;
            const float* v_row = a.val + i * (int64_t)k;
            for (int j = lane; j < k; j += WARP) {
                s_idx[j] = norm_index(ix_row[j], dim);
                s_val[j] = v_row[j];
            }
        }
        __syncwarp();
        // first occurrences; an example whose active slots (value != 0)
        // repeat an index or leave [0, dim) takes the general path. A slot
        // of value 0 changes nothing in any mode (its gi and its terms are
        // 0), so the fast path skips it
        bool special = false;
        for (int j = lane; j < k; j += WARP) {
            bool first = true;
            for (int jj = 0; jj < j; jj++)
                if (s_idx[jj] == s_idx[j]) { first = false; break; }
            s_first[j] = first;
            special |= s_val[j] != 0.0f
                && (!first || s_idx[j] < 0 || s_idx[j] >= dim);
        }
        const bool slow = !small || __any_sync(0xffffffffu, special);
        const float label = a.labels[i];
        const float wgt = a.wgts[i];

        if (!slow) {
            // fast path: the state of each active slot read once, the
            // update written from registers
            float a0[SLOTS], a1[SLOTS], wi[SLOTS];
#pragma unroll
            for (int s = 0; s < SLOTS; s++) {
                a0[s] = a1[s] = wi[s] = 0.0f;
                if (v[s] != 0.0f && lane + s * WARP < k) {
                    a0[s] = __ldcg(a.s0 + ix[s]);
                    if (a.mode != 0) a1[s] = __ldcg(a.s1 + ix[s]);
                }
            }
            float part = 0.0f;
#pragma unroll
            for (int s = 0; s < SLOTS; s++) {
                if (v[s] == 0.0f || lane + s * WARP >= k) continue;
                wi[s] = a.mode == 2 ? ftrl_weight(a, a0[s], a1[s]) : a0[s];
                part = __fadd_rn(part, __fmul_rn(wi[s], v[s]));
            }
            for (int off = WARP / 2; off > 0; off >>= 1)
                part = __fadd_rn(part, __shfl_down_sync(0xffffffffu, part, off));
            const float pred = __shfl_sync(0xffffffffu, part, 0);
            const float g = __fmul_rn(loss_grad(a.loss, pred, label, a.tau), wgt);
            if (lane == 0)
                loss_sum += (double)(example_loss(a.loss, pred, label, a.tau) * wgt);
            if (a.mode != 2) t += (wgt > 0.0f) ? 1.0f : 0.0f;
            const float eta = a.mode == 0
                ? __fdiv_rn(a.lr, rate_pow(__fadd_rn(t, a.initial_t), a.power_t))
                : 0.0f;
#pragma unroll
            for (int s = 0; s < SLOTS; s++) {
                if (v[s] == 0.0f || lane + s * WARP >= k) continue;
                if (a.mode == 2) {
                    float t1, t2;
                    ftrl_terms(a, g, v[s], wi[s], a1[s], &t1, &t2);
                    a.s0[ix[s]] = __fadd_rn(a0[s], t1);
                    a.s1[ix[s]] = __fadd_rn(a1[s], t2);
                } else {
                    const float gi = sgd_gi(g, v[s], wi[s], a.l2);
                    if (a.mode == 1) {
                        const float g2 = __fadd_rn(a1[s], __fmul_rn(gi, gi));
                        a.s1[ix[s]] = g2;
                        a.s0[ix[s]] = __fadd_rn(
                            a0[s], adaptive_step(a.lr, gi, g2, a.power_t));
                    } else {
                        a.s0[ix[s]] = __fadd_rn(a0[s], __fmul_rn(-eta, gi));
                    }
                }
            }
            __syncwarp();
            continue;
        }

        // the general path: every slot, through shared memory
        float part = 0.0f;
        for (int j = lane; j < k; j += WARP) {
            const int32_t g = gather_index(s_idx[j], dim);
            float wi;
            if (a.mode == 2) {
                const float ni = __ldcg(a.s1 + g);
                wi = ftrl_weight(a, __ldcg(a.s0 + g), ni);
                s_aux[j] = ni;
            } else {
                wi = __ldcg(a.s0 + g);
            }
            s_w[j] = wi;
            part = __fadd_rn(part, __fmul_rn(wi, s_val[j]));
        }
        for (int off = WARP / 2; off > 0; off >>= 1)
            part = __fadd_rn(part, __shfl_down_sync(0xffffffffu, part, off));
        const float pred = __shfl_sync(0xffffffffu, part, 0);
        const float g = __fmul_rn(loss_grad(a.loss, pred, label, a.tau), wgt);
        if (lane == 0)
            loss_sum += (double)(example_loss(a.loss, pred, label, a.tau) * wgt);

        if (a.mode == 2) {
            // z += gi - sigma * wi and n += gi^2, both from the n read above
            for (int j = lane; j < k; j += WARP)
                ftrl_terms(a, g, s_val[j], s_w[j], s_aux[j], &s_t1[j], &s_t2[j]);
            __syncwarp();
            for (int j = lane; j < k; j += WARP) {
                const int32_t ix = s_idx[j];
                if (!s_first[j] || ix < 0 || ix >= dim) continue;
                a.s0[ix] = add_in_order(__ldcg(a.s0 + ix), j, k, s_idx, s_t1);
                a.s1[ix] = add_in_order(__ldcg(a.s1 + ix), j, k, s_idx, s_t2);
            }
            __syncwarp();
            continue;
        }

        // gi with the l2 decay gated on active slots
        for (int j = lane; j < k; j += WARP)
            s_t1[j] = sgd_gi(g, s_val[j], s_w[j], a.l2);
        t += (wgt > 0.0f) ? 1.0f : 0.0f;
        __syncwarp();
        if (a.mode == 1) {
            // phase 1: every g2[idx] += gi^2
            for (int j = lane; j < k; j += WARP)
                s_t2[j] = __fmul_rn(s_t1[j], s_t1[j]);
            __syncwarp();
            for (int j = lane; j < k; j += WARP) {
                const int32_t ix = s_idx[j];
                if (!s_first[j] || ix < 0 || ix >= dim) continue;
                a.s1[ix] = add_in_order(__ldcg(a.s1 + ix), j, k, s_idx, s_t2);
            }
            __syncwarp();
            // phase 2: the steps read the accumulated g2
            for (int j = lane; j < k; j += WARP) {
                const float g2 = __ldcg(a.s1 + gather_index(s_idx[j], dim));
                s_t2[j] = adaptive_step(a.lr, s_t1[j], g2, a.power_t);
            }
        } else {
            const float eta = __fdiv_rn(
                a.lr, rate_pow(__fadd_rn(t, a.initial_t), a.power_t));
            for (int j = lane; j < k; j += WARP)
                s_t2[j] = __fmul_rn(-eta, s_t1[j]);
        }
        __syncwarp();
        for (int j = lane; j < k; j += WARP) {
            const int32_t ix = s_idx[j];
            if (!s_first[j] || ix < 0 || ix >= dim) continue;
            a.s0[ix] = add_in_order(__ldcg(a.s0 + ix), j, k, s_idx, s_t2);
        }
        __syncwarp();
    }
    if (lane == 0) {
        if (a.mode != 2) *a.t_io = t;
        *a.loss_out = loss_sum;
    }
}

}  // namespace

extern "C" size_t mmlspark_vw_scan_smem(int32_t k) {
    return (size_t)k * (6 * sizeof(float) + 1);
}

extern "C" int mmlspark_vw_scan(const ScanArgs* args, cudaStream_t stream) {
    const size_t smem = mmlspark_vw_scan_smem(args->k);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            vw_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    vw_scan_kernel<<<1, WARP, smem, stream>>>(*args);
    return (int)cudaGetLastError();
}
