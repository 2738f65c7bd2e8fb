// mmlspark_tpu native runtime: host-side hot paths in C++.
//
// The reference ships its hot host code as native libraries (OpenCV imgproc for
// image preprocessing, LightGBM's C++ histogram core, VW's murmur hashing)
// loaded through NativeLoader (core/env/NativeLoader.java:28-140). The TPU
// rebuild keeps device compute in XLA/Pallas; THIS library covers the host
// side: image decode-adjacent preprocessing (resize/blur/unroll feeding the
// chip), batched feature hashing, and the binned-histogram CPU reference used
// for verification and non-accelerator fallback.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in the image).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <limits>
#include <queue>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// MurmurHash3 x86_32 (VW-compatible; validated against standard vectors)
// ---------------------------------------------------------------------------

static inline uint32_t rotl32(uint32_t x, int8_t r) {
    return (x << r) | (x >> (32 - r));
}

uint32_t mml_murmur3_32(const uint8_t* data, int32_t len, uint32_t seed) {
    const uint32_t c1 = 0xcc9e2d51u, c2 = 0x1b873593u;
    uint32_t h = seed;
    const int32_t nblocks = len / 4;
    for (int32_t i = 0; i < nblocks; i++) {
        uint32_t k;
        std::memcpy(&k, data + i * 4, 4);
        k *= c1; k = rotl32(k, 15); k *= c2;
        h ^= k; h = rotl32(h, 13); h = h * 5u + 0xe6546b64u;
    }
    const uint8_t* tail = data + nblocks * 4;
    uint32_t k1 = 0;
    switch (len & 3) {
        case 3: k1 ^= (uint32_t)tail[2] << 16; [[fallthrough]];
        case 2: k1 ^= (uint32_t)tail[1] << 8;  [[fallthrough]];
        case 1: k1 ^= tail[0];
                k1 *= c1; k1 = rotl32(k1, 15); k1 *= c2; h ^= k1;
    }
    h ^= (uint32_t)len;
    h ^= h >> 16; h *= 0x85ebca6bu; h ^= h >> 13; h *= 0xc2b2ae35u; h ^= h >> 16;
    return h;
}

// Batch hashing: concatenated utf-8 buffer + offsets -> hashes.
void mml_murmur3_batch(const uint8_t* buf, const int64_t* offsets, int64_t n,
                       uint32_t seed, uint32_t* out) {
    for (int64_t i = 0; i < n; i++) {
        const int64_t start = offsets[i], end = offsets[i + 1];
        out[i] = mml_murmur3_32(buf + start, (int32_t)(end - start), seed);
    }
}

// ---------------------------------------------------------------------------
// Image preprocessing (OpenCV-imgproc replacement for the host pipeline)
// ---------------------------------------------------------------------------

// Half-pixel-center bilinear resize, HWC float32 (matches ops/image._bilinear).
void mml_resize_bilinear_f32(const float* src, int32_t h, int32_t w, int32_t c,
                             float* dst, int32_t oh, int32_t ow) {
    for (int32_t oy = 0; oy < oh; oy++) {
        const double fy = ((double)oy + 0.5) * h / oh - 0.5;
        int32_t y0 = (int32_t)std::floor(fy);
        double wy = fy - y0;
        if (y0 < 0) { y0 = 0; wy = 0.0; }
        if (y0 > h - 1) { y0 = h - 1; wy = 0.0; }
        const int32_t y1 = std::min(y0 + 1, h - 1);
        if (wy < 0) wy = 0; if (wy > 1) wy = 1;
        for (int32_t ox = 0; ox < ow; ox++) {
            const double fx = ((double)ox + 0.5) * w / ow - 0.5;
            int32_t x0 = (int32_t)std::floor(fx);
            double wx = fx - x0;
            if (x0 < 0) { x0 = 0; wx = 0.0; }
            if (x0 > w - 1) { x0 = w - 1; wx = 0.0; }
            const int32_t x1 = std::min(x0 + 1, w - 1);
            if (wx < 0) wx = 0; if (wx > 1) wx = 1;
            for (int32_t ch = 0; ch < c; ch++) {
                const double tl = src[(y0 * w + x0) * c + ch];
                const double tr = src[(y0 * w + x1) * c + ch];
                const double bl = src[(y1 * w + x0) * c + ch];
                const double br = src[(y1 * w + x1) * c + ch];
                const double top = tl * (1 - wx) + tr * wx;
                const double bot = bl * (1 - wx) + br * wx;
                dst[(oy * ow + ox) * c + ch] = (float)(top * (1 - wy) + bot * wy);
            }
        }
    }
}

void mml_resize_bilinear_u8(const uint8_t* src, int32_t h, int32_t w, int32_t c,
                            uint8_t* dst, int32_t oh, int32_t ow) {
    // u8 path: compute in float, round-clamp (matches numpy path)
    for (int32_t oy = 0; oy < oh; oy++) {
        const double fy = ((double)oy + 0.5) * h / oh - 0.5;
        int32_t y0 = (int32_t)std::floor(fy);
        double wy = fy - y0;
        if (y0 < 0) { y0 = 0; wy = 0.0; }
        if (y0 > h - 1) { y0 = h - 1; wy = 0.0; }
        const int32_t y1 = std::min(y0 + 1, h - 1);
        if (wy < 0) wy = 0; if (wy > 1) wy = 1;
        for (int32_t ox = 0; ox < ow; ox++) {
            const double fx = ((double)ox + 0.5) * w / ow - 0.5;
            int32_t x0 = (int32_t)std::floor(fx);
            double wx = fx - x0;
            if (x0 < 0) { x0 = 0; wx = 0.0; }
            if (x0 > w - 1) { x0 = w - 1; wx = 0.0; }
            const int32_t x1 = std::min(x0 + 1, w - 1);
            if (wx < 0) wx = 0; if (wx > 1) wx = 1;
            for (int32_t ch = 0; ch < c; ch++) {
                const double tl = src[(y0 * w + x0) * c + ch];
                const double tr = src[(y0 * w + x1) * c + ch];
                const double bl = src[(y1 * w + x0) * c + ch];
                const double br = src[(y1 * w + x1) * c + ch];
                const double top = tl * (1 - wx) + tr * wx;
                const double bot = bl * (1 - wx) + br * wx;
                double v = std::nearbyint(top * (1 - wy) + bot * wy);
                if (v < 0) v = 0; if (v > 255) v = 255;
                dst[(oy * ow + ox) * c + ch] = (uint8_t)v;
            }
        }
    }
}

// HWC uint8 -> flat CHW float64 (UnrollImage hot path).
void mml_unroll_chw_f64(const uint8_t* src, int32_t h, int32_t w, int32_t c,
                        double* out, int32_t normalize) {
    const double scale = normalize ? (1.0 / 255.0) : 1.0;
    for (int32_t ch = 0; ch < c; ch++)
        for (int32_t y = 0; y < h; y++)
            for (int32_t x = 0; x < w; x++)
                out[(ch * h + y) * w + x] = src[(y * w + x) * c + ch] * scale;
}

// ---------------------------------------------------------------------------
// Binned histogram accumulation (LightGBM core CPU reference)
// ---------------------------------------------------------------------------

// bins [n,f] int32, grad/hess [n] f32, mask [n] u8 -> hist [f, num_bins, 3]
void mml_histogram(const int32_t* bins, const float* grad, const float* hess,
                   const uint8_t* mask, int64_t n, int32_t f, int32_t num_bins,
                   float* hist) {
    std::memset(hist, 0, sizeof(float) * (size_t)f * num_bins * 3);
    for (int64_t i = 0; i < n; i++) {
        if (!mask[i]) continue;
        const float g = grad[i], hs = hess[i];
        const int32_t* row = bins + i * f;
        for (int32_t j = 0; j < f; j++) {
            float* cell = hist + ((size_t)j * num_bins + row[j]) * 3;
            cell[0] += g;
            cell[1] += hs;
            cell[2] += 1.0f;
        }
    }
}

// ---------------------------------------------------------------------------
// Tree-ensemble prediction (LGBM_BoosterPredictForMat CPU reference)
// ---------------------------------------------------------------------------

// SoA forest: feature/left/right [t,m] i32, threshold [t,m] f32,
// default_left [t,m] u8, value [t,m] f32 (pre-scaled by shrinkage).
void mml_forest_predict(const float* X, int64_t n, int32_t num_feat,
                        const int32_t* feature, const float* threshold,
                        const uint8_t* default_left, const int32_t* left,
                        const int32_t* right, const float* value,
                        int32_t t, int32_t m, const int32_t* class_of_tree,
                        int32_t num_class, double* out) {
    for (int64_t i = 0; i < n; i++) {
        const float* x = X + i * num_feat;
        for (int32_t ti = 0; ti < t; ti++) {
            const int32_t base = ti * m;
            int32_t node = 0;
            while (feature[base + node] >= 0) {
                const float v = x[feature[base + node]];
                bool go_left = std::isnan(v) ? (bool)default_left[base + node]
                                             : (v <= threshold[base + node]);
                node = go_left ? left[base + node] : right[base + node];
            }
            out[i * num_class + class_of_tree[ti]] += value[base + node];
        }
    }
}

// f64 variant: bit-equal to the Python host traversal (f64 features and
// thresholds; the f32 version above mirrors the device ensemble's layout).
// value is pre-scaled by shrinkage, like the f32 SoA.
void mml_forest_predict_f64(const double* X, int64_t n, int32_t num_feat,
                            const int32_t* feature, const double* threshold,
                            const uint8_t* default_left, const int32_t* left,
                            const int32_t* right, const double* value,
                            int32_t t, int32_t m,
                            const int32_t* class_of_tree,
                            int32_t num_class, double* out) {
    for (int64_t i = 0; i < n; i++) {
        const double* x = X + i * num_feat;
        for (int32_t ti = 0; ti < t; ti++) {
            const int32_t base = ti * m;
            int32_t node = 0;
            while (feature[base + node] >= 0) {
                const double v = x[feature[base + node]];
                bool go_left = std::isnan(v) ? (bool)default_left[base + node]
                                             : (v <= threshold[base + node]);
                node = go_left ? left[base + node] : right[base + node];
            }
            out[i * num_class + class_of_tree[ti]] += value[base + node];
        }
    }
}

// ---------------------------------------------------------------------------
// CSR forest predict (PredictForCSRSingle parity,
// LightGBMBooster.scala:21-148): per-row tree traversal over sparse rows.
// The row's CSR slice is feature-sorted, so each node's feature value is a
// lower_bound over at most max_row_nnz entries; absent features carry 0.0
// and compare against the threshold (the sparse engine's zero-bin
// semantics — numeric features only; categorical forests take the host
// path). Mirrors gbdt/sparse.predict_csr exactly; parity is a test gate.
// ---------------------------------------------------------------------------

void mml_csr_forest_predict(
        const int64_t* indptr, const int64_t* indices, const double* values,
        int64_t n_rows,
        const int32_t* feature, const double* threshold,
        const int32_t* left, const int32_t* right, const double* value,
        const int64_t* tree_offset, const double* shrinkage,
        const int32_t* class_of_tree, int32_t n_trees, int32_t num_class,
        double* out) {
    for (int64_t r = 0; r < n_rows; ++r) {
        const int64_t lo0 = indptr[r], hi0 = indptr[r + 1];
        double* orow = out + r * num_class;
        for (int32_t t = 0; t < n_trees; ++t) {
            const int64_t base = tree_offset[t];
            const int32_t* feat_t = feature + base;
            const double* thr_t = threshold + base;
            const int32_t* l_t = left + base;
            const int32_t* r_t = right + base;
            int32_t node = 0;
            while (feat_t[node] != -1) {
                const int64_t f = feat_t[node];
                int64_t lo = lo0, hi = hi0;
                while (lo < hi) {
                    const int64_t mid = (lo + hi) >> 1;
                    if (indices[mid] < f) lo = mid + 1; else hi = mid;
                }
                const double x =
                    (lo < hi0 && indices[lo] == f) ? values[lo] : 0.0;
                node = (x <= thr_t[node]) ? l_t[node] : r_t[node];
            }
            orow[class_of_tree[t]] += value[base + node] * shrinkage[t];
        }
    }
}

// Quantile-edge binning (BinMapper.transform hot path): bin =
// lower_bound(edges, v) + 1, NaN -> 0 (missing). Branchless lower_bound
// (cmov, no mispredicts — edges are < max_bin and L1-resident). Folds the
// isnan/searchsorted/where/cast numpy passes into one sweep; ctypes
// releases the GIL during the call, so the device engine's overlapped
// bin+ship worker keeps streaming while this runs.
static inline int32_t bin_one(double v, const double* edges,
                              int32_t n_edges) {
    if (std::isnan(v)) return 0;
    const double* p = edges;
    int32_t len = n_edges;
    while (len > 1) {
        const int32_t half = len >> 1;
        p += (p[half - 1] < v) ? half : 0;
        len -= half;
    }
    return (int32_t)(p - edges) + (p[0] < v) + 1;
}

void mml_bin_column_f64(const double* vals, int64_t n, const double* edges,
                        int32_t n_edges, int32_t* out) {
    for (int64_t i = 0; i < n; i++) out[i] = bin_one(vals[i], edges, n_edges);
}

// ---------------------------------------------------------------------------
// Sequential online linear learning (VW core equivalent, the reference's
// per-row JNI learn() loop — vw/VowpalWabbitBase.scala:218-305). One pass of
// adaptive (AdaGrad) or decayed SGD over padded sparse examples, mirroring
// vw/learner.make_scan_pass's f32 semantics exactly: same gather/two-phase-
// scatter order (duplicate hashed indices accumulate like the XLA scatter),
// same l2 gating on active slots, same epsilon terms. FTRL stays on the
// scan path. loss: 0=squared 1=logistic 2=hinge 3=quantile.
// ---------------------------------------------------------------------------

void mml_vw_train_pass(
        const int32_t* idx, const float* val,
        const float* labels, const float* wgts,
        int64_t n, int32_t k, int32_t loss, float tau,
        float lr, float power_t, float initial_t, float l2,
        int32_t adaptive,
        float* w, float* g2, float* t_io, double* loss_sum_out) {
    float t = *t_io;
    double loss_sum = 0.0;
    // power_t = 0.5 (the VW default) hits hardware sqrt instead of powf —
    // the pow was ~half the per-example cost at 32 nnz
    const bool half_power = (power_t == 0.5f);
    std::vector<float> gi((size_t)k);
    for (int64_t i = 0; i < n; i++) {
        const int32_t* ix = idx + (size_t)i * k;
        const float* vv = val + (size_t)i * k;
        const float label = labels[i], wgt = wgts[i];
        float pred = 0.0f;
        for (int32_t j = 0; j < k; j++) pred += w[ix[j]] * vv[j];
        float g;
        float ex_loss;
        switch (loss) {
            case 1: {  // logistic, labels in {-1, +1}
                g = -label / (1.0f + std::exp(label * pred));
                const float m = -label * pred;
                ex_loss = std::max(m, 0.0f) +
                          std::log1p(std::exp(-std::fabs(m)));
                break;
            }
            case 2: {  // hinge
                g = (label * pred < 1.0f) ? -label : 0.0f;
                ex_loss = std::max(0.0f, 1.0f - label * pred);
                break;
            }
            case 3: {  // quantile
                g = (pred > label) ? (1.0f - tau) : -tau;
                const float d = pred - label;
                ex_loss = d > 0.0f ? (1.0f - tau) * d : -tau * d;
                break;
            }
            default: {  // squared
                g = pred - label;
                ex_loss = 0.5f * (pred - label) * (pred - label);
            }
        }
        g *= wgt;
        // l2 decay gated on active slots (padded entries are value 0)
        for (int32_t j = 0; j < k; j++)
            gi[j] = g * vv[j] + (vv[j] != 0.0f ? l2 * w[ix[j]] : 0.0f);
        t += (wgt > 0.0f) ? 1.0f : 0.0f;
        if (adaptive) {
            // two phases so duplicate indices within one example see the
            // fully-accumulated g2, like the XLA gather-after-scatter
            for (int32_t j = 0; j < k; j++) g2[ix[j]] += gi[j] * gi[j];
            if (half_power) {
                for (int32_t j = 0; j < k; j++)
                    w[ix[j]] += -lr * gi[j] /
                        (std::sqrt(g2[ix[j]] + 1e-16f) + 1e-8f);
            } else {
                for (int32_t j = 0; j < k; j++)
                    w[ix[j]] += -lr * gi[j] /
                        (std::pow(g2[ix[j]] + 1e-16f, power_t) + 1e-8f);
            }
        } else {
            const float eta = lr / (half_power
                                    ? std::sqrt(t + initial_t)
                                    : std::pow(t + initial_t, power_t));
            for (int32_t j = 0; j < k; j++) w[ix[j]] += -eta * gi[j];
        }
        loss_sum += (double)(ex_loss * wgt);
    }
    *t_io = t;
    *loss_sum_out = loss_sum;
}

}  // extern "C" (host kernels above; C++ helpers below)

// Whole-matrix binning: row-major X [N, F] -> feature-major bins [F, N],
// blocked over rows so X is streamed ONCE (a per-column python loop re-reads
// the full strided matrix F times — the measured bottleneck at 200k x 28).
// Ragged per-feature edges arrive concatenated with offsets [F+1]; features
// with zero edges emit bin 1 for non-missing values, like the numpy path.
template <typename OutT>
static void bin_matrix(const double* X, int64_t n, int32_t num_f,
                       const double* edges, const int64_t* offsets,
                       OutT* out) {
    // row-outer: X streams sequentially once, and the per-row feature
    // searches are independent dependency chains the out-of-order core
    // overlaps (feature-outer re-reads the strided matrix per feature)
    std::vector<const double*> ef(num_f);
    std::vector<int32_t> ne(num_f);
    for (int32_t f = 0; f < num_f; f++) {
        ef[f] = edges + offsets[f];
        ne[f] = (int32_t)(offsets[f + 1] - offsets[f]);
    }
    for (int64_t i = 0; i < n; i++) {
        const double* row = X + (size_t)i * num_f;
        for (int32_t f = 0; f < num_f; f++) {
            const int32_t nf = ne[f];
            out[(size_t)f * n + i] = (OutT)(
                nf == 0 ? (std::isnan(row[f]) ? 0 : 1)
                        : bin_one(row[f], ef[f], nf));
        }
    }
}

extern "C" void mml_bin_matrix_f64_u8(
        const double* X, int64_t n, int32_t num_f, const double* edges,
        const int64_t* offsets, uint8_t* out) {
    bin_matrix(X, n, num_f, edges, offsets, out);
}

extern "C" void mml_bin_matrix_f64_i32(
        const double* X, int64_t n, int32_t num_f, const double* edges,
        const int64_t* offsets, int32_t* out) {
    bin_matrix(X, n, num_f, edges, offsets, out);
}

// ---------------------------------------------------------------------------
// Leaf-wise GBDT tree growth (LightGBM serial-tree-learner equivalent).
//
// The reference's training engine is LightGBM's C++ core driven through
// LGBM_BoosterUpdateOneIter (lightgbm/TrainUtils.scala:170-233). The TPU
// engine covers the large-N regime with the whole-run lax.scan on device;
// THIS grower is the small-N host path, where per-dispatch overhead beats
// any accelerator win. It mirrors gbdt/tree.grow_tree + histogram.
// find_best_split numerics (f32 histogram/gain math, f64 leaf values,
// first-max argmax in [F, B-1] flat order, heap tie-break by insertion
// order) so trees agree with the XLA host grower on non-degenerate splits.
// Numeric splits only — categorical forests stay on the XLA paths.
// ---------------------------------------------------------------------------

namespace {

struct BestSplit {
    float gain = -std::numeric_limits<float>::infinity();
    int32_t feature = 0;
    int32_t bin = 1;          // rows with bin <= this go left
    bool default_left = false;
    float lg = 0, lh = 0;     // left sums (chosen missing direction)
    int64_t lc = 0;
    float tg = 0, th = 0;     // node totals
    int64_t tc = 0;
};

struct HeapEntry {
    float gain;
    int64_t order;      // insertion tie-break: earlier pops first
    int32_t node;       // node id
    int32_t hist_slot;  // index into the histogram pool
    int32_t depth;
    BestSplit split;    // evaluated once at push; reused at pop
};

struct HeapCmp {
    bool operator()(const HeapEntry& a, const HeapEntry& b) const {
        if (a.gain != b.gain) return a.gain < b.gain;  // max-heap on gain
        return a.order > b.order;                      // then FIFO
    }
};

// Pair-packed histogram slab: (grad, hess) float pairs + separate int32
// counts (denser hot cells than an [B,3] float layout; counts are exact
// ints — the f32 counts of the XLA histogram are integer-exact below 2^24
// per bin, so comparisons agree).
struct HistSlab {
    std::vector<float> gh;     // [F * B * 2]
    std::vector<int32_t> cnt;  // [F * B]
};

inline float leaf_obj(float G, float H, float l1, float l2) {
    // -0.5 * T(G)^2 / (H + l2), T = soft-threshold (histogram._leaf_objective)
    float t = std::copysign(std::max(std::fabs(G) - l1, 0.0f), G);
    if (G == 0.0f) t = 0.0f;  // sign(0) = 0 in jnp
    return -0.5f * t * t / (H + l2);
}

// Mirror of histogram.find_best_split over a pair-packed histogram.
BestSplit find_best(const HistSlab& hist, int32_t num_f, int32_t b,
                    const uint8_t* fmask, float l1, float l2,
                    float min_hess, float min_data) {
    BestSplit best;
    const float* gh = hist.gh.data();
    const int32_t* cnt = hist.cnt.data();
    // node totals from feature 0 (find_best_split uses total[0])
    float G = 0, H = 0;
    int64_t C = 0;
    for (int32_t t = 0; t < b; t++) {
        G += gh[(size_t)t * 2 + 0];
        H += gh[(size_t)t * 2 + 1];
        C += cnt[t];
    }
    best.tg = G; best.th = H; best.tc = C;
    const float parent = leaf_obj(G, H, l1, l2);
    for (int32_t f = 0; f < num_f; f++) {
        if (fmask && !fmask[f]) continue;
        const float* ghf = gh + (size_t)f * b * 2;
        const int32_t* cntf = cnt + (size_t)f * b;
        const float mg = ghf[0], mh = ghf[1];  // missing bin sums
        const int64_t mc = cntf[0];
        const bool has_missing = (mc != 0) | (mg != 0.0f) | (mh != 0.0f);
        float cg = 0, ch = 0;                  // cum over value bins
        int64_t cc = 0;
        for (int32_t t = 1; t < b; t++) {
            cg += ghf[(size_t)t * 2 + 0];
            ch += ghf[(size_t)t * 2 + 1];
            cc += cntf[t];
            // missing -> left (when this feature HAS no missing entries,
            // both directions evaluate identically and jnp's gain_l >=
            // gain_r tie picks left — so only this one is computed)
            float gain_l = -std::numeric_limits<float>::infinity();
            {
                const float GL = cg + mg, HL = ch + mh;
                const float CL = (float)(cc + mc);
                const float GR = G - GL, HR = H - HL;
                const float CR = (float)(C - cc - mc);
                if (CL >= min_data && CR >= min_data && HL >= min_hess &&
                    HR >= min_hess)
                    gain_l = -(leaf_obj(GL, HL, l1, l2) +
                               leaf_obj(GR, HR, l1, l2) - parent);
            }
            bool dir_left = true;
            float gain = gain_l;
            if (has_missing) {
                // missing -> right
                float gain_r = -std::numeric_limits<float>::infinity();
                const float GL = cg, HL = ch;
                const float CL = (float)cc;
                const float GR = G - GL, HR = H - HL;
                const float CR = (float)(C - cc);
                if (CL >= min_data && CR >= min_data && HL >= min_hess &&
                    HR >= min_hess)
                    gain_r = -(leaf_obj(GL, HL, l1, l2) +
                               leaf_obj(GR, HR, l1, l2) - parent);
                dir_left = gain_l >= gain_r;
                gain = dir_left ? gain_l : gain_r;
            }
            if (gain > best.gain) {  // strict: first max in flat (f, t) order
                best.gain = gain;
                best.feature = f;
                best.bin = t;
                best.default_left = dir_left;
                best.lg = dir_left ? cg + mg : cg;
                best.lh = dir_left ? ch + mh : ch;
                best.lc = dir_left ? cc + mc : cc;
            }
        }
    }
    return best;
}

}  // namespace

// Grow ONE leaf-wise tree. bins_fm: [F, N] feature-major uint8 (bin 0 =
// missing). Outputs are caller-allocated with capacity 2*num_leaves-1;
// o_leaf_of_row [N] receives the final node id of EVERY row (masked or not
// — the booster updates all rows' scores). Returns the node count.
extern "C" int32_t mml_gbdt_grow_tree(
        const uint8_t* bins_fm, int64_t n, int32_t num_f, int32_t num_bins,
        const float* grad, const float* hess, const uint8_t* row_mask,
        const uint8_t* feature_mask,
        int32_t num_leaves, int32_t max_depth, double min_data_in_leaf,
        double min_sum_hessian, double min_gain_to_split,
        double lambda_l1, double lambda_l2, double max_delta_step,
        int32_t* o_feature, int32_t* o_threshold_bin, uint8_t* o_default_left,
        int32_t* o_left, int32_t* o_right, double* o_value, float* o_gain,
        int32_t* o_count, double* o_weight, int32_t* o_leaf_of_row) {
    const int32_t max_nodes = 2 * num_leaves - 1;
    const float l1 = (float)lambda_l1, l2 = (float)lambda_l2;
    const float min_hess = (float)min_sum_hessian;
    const float min_data = (float)min_data_in_leaf;
    const size_t gh_sz = (size_t)num_f * num_bins * 2;
    const size_t cnt_sz = (size_t)num_f * num_bins;

    // init all nodes as leaves
    for (int32_t i = 0; i < max_nodes; i++) {
        o_feature[i] = -1; o_threshold_bin[i] = 0; o_default_left[i] = 1;
        o_left[i] = -1; o_right[i] = -1; o_value[i] = 0.0; o_gain[i] = 0.0f;
        o_count[i] = 0; o_weight[i] = 0.0;
    }

    // row index partition: idx grouped per node, [start, len) ranges.
    std::vector<int64_t> idx(n);
    for (int64_t i = 0; i < n; i++) idx[i] = i;
    std::vector<int64_t> node_start(max_nodes, 0), node_len(max_nodes, 0);
    node_len[0] = n;

    // histogram pool: one slab per live heap entry + 2 scratch
    std::vector<HistSlab> pool;
    std::vector<int32_t> free_slots;
    auto alloc_slot = [&]() -> int32_t {
        if (!free_slots.empty()) {
            int32_t s = free_slots.back(); free_slots.pop_back();
            return s;
        }
        pool.push_back({std::vector<float>(gh_sz),
                        std::vector<int32_t>(cnt_sz)});
        return (int32_t)pool.size() - 1;
    };

    // root histogram over masked rows, feature-major (sequential column
    // reads; per-feature accumulation order is row order, like the
    // scatter). A sparse mask (bagging/GOSS) is compacted to an index
    // list ONCE — the per-row mask branch mispredicts ~randomly across
    // n x F iterations and costs more than the gathers it avoids.
    std::vector<int64_t> mrows;
    std::vector<float> mgh;
    if (row_mask) {
        mrows.reserve(n);
        for (int64_t i = 0; i < n; i++)
            if (row_mask[i]) mrows.push_back(i);
        mgh.resize(mrows.size() * 2);
        for (size_t i = 0; i < mrows.size(); i++) {
            mgh[i * 2 + 0] = grad[mrows[i]];
            mgh[i * 2 + 1] = hess[mrows[i]];
        }
    }
    const int32_t root_slot = alloc_slot();
    {
        HistSlab& root = pool[root_slot];
        std::memset(root.gh.data(), 0, gh_sz * sizeof(float));
        std::memset(root.cnt.data(), 0, cnt_sz * sizeof(int32_t));
        for (int32_t f = 0; f < num_f; f++) {
            const uint8_t* col = bins_fm + (size_t)f * n;
            float* ghf = root.gh.data() + (size_t)f * num_bins * 2;
            int32_t* cntf = root.cnt.data() + (size_t)f * num_bins;
            if (row_mask) {
                const int64_t nm = (int64_t)mrows.size();
                for (int64_t i = 0; i < nm; i++) {
                    const uint32_t bv = col[mrows[i]];
                    ghf[bv * 2 + 0] += mgh[i * 2 + 0];
                    ghf[bv * 2 + 1] += mgh[i * 2 + 1];
                    cntf[bv] += 1;
                }
            } else {
                for (int64_t i = 0; i < n; i++) {
                    const uint32_t bv = col[i];
                    ghf[bv * 2 + 0] += grad[i];
                    ghf[bv * 2 + 1] += hess[i];
                    cntf[bv] += 1;
                }
            }
        }
        // root-only buffers: release before the split loop (child
        // histograms use the scratch/gh_gather pattern below)
        std::vector<int64_t>().swap(mrows);
        std::vector<float>().swap(mgh);
    }

    std::priority_queue<HeapEntry, std::vector<HeapEntry>, HeapCmp> heap;
    int64_t order = 0;
    {
        const HistSlab& root = pool[root_slot];
        float G = 0, H = 0;
        int64_t C = 0;
        for (int32_t t = 0; t < num_bins; t++) {
            G += root.gh[(size_t)t * 2 + 0];
            H += root.gh[(size_t)t * 2 + 1];
            C += root.cnt[t];
        }
        o_count[0] = (int32_t)C;
        o_weight[0] = (double)H;
        BestSplit s = find_best(root, num_f, num_bins, feature_mask, l1, l2,
                                min_hess, min_data);
        if (std::isfinite(s.gain) && s.gain > (float)min_gain_to_split &&
            (max_depth <= 0 || 0 < max_depth)) {
            heap.push({s.gain, order++, 0, root_slot, 0, s});
        } else {
            free_slots.push_back(root_slot);
        }
        // an unsplit root keeps value 0.0 (grow_tree parity: the booster's
        // init_score carries the base prediction)
    }

    std::vector<int64_t> scratch(n);
    std::vector<float> gh_gather;  // packed (grad, hess) of gathered rows
    int32_t n_nodes = 1, n_leaves_cur = 1;

    while (!heap.empty() && n_leaves_cur < num_leaves) {
        HeapEntry e = heap.top(); heap.pop();
        const BestSplit& s = e.split;  // evaluated at push time
        const int32_t nid = e.node, f = s.feature, tb = s.bin;
        const int32_t lid = n_nodes, rid = n_nodes + 1;
        n_nodes += 2;

        o_feature[nid] = f;
        o_threshold_bin[nid] = tb;
        o_default_left[nid] = s.default_left ? 1 : 0;
        o_left[nid] = lid; o_right[nid] = rid;
        o_gain[nid] = s.gain;
        o_value[nid] = 0.0;

        // stable partition of the node's rows (ALL rows, masked or not —
        // row order stays ascending so child histograms accumulate in the
        // same order the masked scatter would)
        const uint8_t* bf = bins_fm + (size_t)f * n;
        const int64_t start = node_start[nid], len = node_len[nid];
        int64_t nl = 0, nr = 0;
        for (int64_t i = 0; i < len; i++) {
            const int64_t r = idx[start + i];
            const uint8_t bv = bf[r];
            const bool go_left = (bv == 0) ? s.default_left : (bv <= tb);
            if (go_left) idx[start + nl++] = r;
            else scratch[nr++] = r;
        }
        std::memcpy(idx.data() + start + nl, scratch.data(),
                    (size_t)nr * sizeof(int64_t));
        node_start[lid] = start;        node_len[lid] = nl;
        node_start[rid] = start + nl;   node_len[rid] = nr;

        // child sums from the split (f32 sums like SplitInfo, f64 leaf math)
        const double lsum[3] = {(double)s.lg, (double)s.lh, (double)s.lc};
        const double rsum[3] = {(double)(s.tg - s.lg), (double)(s.th - s.lh),
                                (double)(s.tc - s.lc)};  // counts exact ints
        for (int32_t ci = 0; ci < 2; ci++) {
            const double* sums = ci == 0 ? lsum : rsum;
            const int32_t cid = ci == 0 ? lid : rid;
            double gt = std::copysign(
                std::max(std::fabs(sums[0]) - lambda_l1, 0.0), sums[0]);
            if (sums[0] == 0.0) gt = 0.0;
            double v = -gt / (sums[1] + lambda_l2);
            if (max_delta_step > 0)
                v = std::max(-max_delta_step, std::min(max_delta_step, v));
            o_value[cid] = v;
            o_count[cid] = (int32_t)sums[2];
            o_weight[cid] = sums[1];
        }
        n_leaves_cur += 1;

        // smaller child by MASKED count (lsum[2] <= rsum[2] -> left)
        const bool left_small = lsum[2] <= rsum[2];
        const int32_t small_id = left_small ? lid : rid;
        const int32_t big_id = left_small ? rid : lid;

        // small child's histogram from its rows (feature-major: gathers stay
        // within one column at a time); sibling by subtraction. Masked rows
        // are compacted once so the per-feature pass touches only them, and
        // the gathered grad/hess are packed into a contiguous pair buffer so
        // every feature pass reads them sequentially.
        const int32_t small_slot = alloc_slot();
        HistSlab& h_small = pool[small_slot];
        std::memset(h_small.gh.data(), 0, gh_sz * sizeof(float));
        std::memset(h_small.cnt.data(), 0, cnt_sz * sizeof(int32_t));
        {
            const int64_t ss = node_start[small_id], sl = node_len[small_id];
            int64_t nm = 0;  // masked rows of the small child -> scratch
            for (int64_t i = 0; i < sl; i++) {
                const int64_t r = idx[ss + i];
                if (!row_mask || row_mask[r]) scratch[nm++] = r;
            }
            gh_gather.resize((size_t)nm * 2);
            for (int64_t i = 0; i < nm; i++) {
                gh_gather[(size_t)i * 2 + 0] = grad[scratch[i]];
                gh_gather[(size_t)i * 2 + 1] = hess[scratch[i]];
            }
            for (int32_t ff = 0; ff < num_f; ff++) {
                const uint8_t* col = bins_fm + (size_t)ff * n;
                float* ghf = h_small.gh.data() + (size_t)ff * num_bins * 2;
                int32_t* cntf = h_small.cnt.data() + (size_t)ff * num_bins;
                for (int64_t i = 0; i < nm; i++) {
                    const uint32_t bv = col[scratch[i]];
                    ghf[bv * 2 + 0] += gh_gather[(size_t)i * 2 + 0];
                    ghf[bv * 2 + 1] += gh_gather[(size_t)i * 2 + 1];
                    cntf[bv] += 1;
                }
            }
        }
        // parent slab becomes the big child's histogram in place
        // (subtract_histogram semantics: clamp hess/count at >= 0)
        const int32_t big_slot = e.hist_slot;
        {
            HistSlab& h_big = pool[big_slot];
            float* bg = h_big.gh.data();
            const float* sg = h_small.gh.data();
            for (size_t i = 0; i < gh_sz; i += 2) {
                bg[i + 0] -= sg[i + 0];
                bg[i + 1] = std::max(bg[i + 1] - sg[i + 1], 0.0f);
            }
            int32_t* bc = h_big.cnt.data();
            const int32_t* sc = h_small.cnt.data();
            for (size_t i = 0; i < cnt_sz; i++)
                bc[i] = std::max(bc[i] - sc[i], 0);
        }

        // push children: csums[2] >= 2*min_data_in_leaf, gain/depth gates
        const int32_t child_depth = e.depth + 1;
        for (int32_t ci = 0; ci < 2; ci++) {
            const int32_t cid = ci == 0 ? small_id : big_id;
            const int32_t slot = ci == 0 ? small_slot : big_slot;
            const double* sums = cid == lid ? lsum : rsum;
            bool pushed = false;
            if (sums[2] >= 2.0 * min_data_in_leaf) {
                BestSplit cs = find_best(pool[slot], num_f, num_bins,
                                         feature_mask, l1, l2, min_hess,
                                         min_data);
                if (std::isfinite(cs.gain) &&
                    cs.gain > (float)min_gain_to_split &&
                    (max_depth <= 0 || child_depth < max_depth)) {
                    heap.push({cs.gain, order++, cid, slot, child_depth, cs});
                    pushed = true;
                }
            }
            if (!pushed) free_slots.push_back(slot);
        }
    }

    // final row -> node routing
    for (int32_t nid = 0; nid < n_nodes; nid++) {
        if (o_feature[nid] >= 0) continue;  // internal
        const int64_t start = node_start[nid], len = node_len[nid];
        for (int64_t i = 0; i < len; i++) o_leaf_of_row[idx[start + i]] = nid;
    }
    return n_nodes;
}

extern "C" int32_t mml_version() { return 5; }
