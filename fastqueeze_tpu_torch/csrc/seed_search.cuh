// Per-read seed search and gapless verify shared by K8 (align_batch.cu)
// and K9 (indel_batch.cu).
//
// One thread runs one read's strand, decision for decision as
// native/alignhost.cpp one_strand does, which mirrors
// fastqueeze_tpu/align/hash.py _one_strand (B11): the bucketed binary
// search of every sampled k-mer, n_seeds first-occurrence argmin picks
// with the +-excl_bp mask, min(occ, n_cand) candidates a pick in CSR
// order, the two-probe-word prefilter with lax.top_k's stable order, the
// funnel-shift XOR/popcount verify and its first-occurrence argmin.
// Candidate lists (6,144 a read in the rescue tier) live in a per-read
// global scratch slab; the prefilter's (probe count, index) order is a
// counting sort over the probe counts 0..32.  Bound by dependent random
// loads (binary-search steps, CSR positions, packed reference words), so
// the design keeps only what a read needs and takes no shared memory.
#pragma once

#include <cstdint>

namespace fqa {

constexpr int32_t kBig = 1 << 28;
constexpr int kMaxProbe = 33;   // two 16-base probe words: counts 0..32

struct Index {
    const void* keys;   // int32 keys (k <= 15) or int64 (wide, k <= 31)
    int32_t wide;
    int64_t nk;
    const int32_t* offsets;
    const int32_t* positions;
    int64_t npos;
    const uint32_t* packed;   // no padding: fetches clamp to nw - 1
    int64_t nw;
    const int32_t* l1;
    int32_t l1_shift, search_steps, ref_len;
};

struct Cfg {
    int32_t k, stride, n_cand, max_mis, n_seeds, excl_bp, probe_k, lp;
};

__host__ __device__ inline int64_t align16(int64_t x) {
    return (x + 15) & ~int64_t(15);
}

__host__ __device__ inline int32_t n_samples(const Cfg& c) {
    return (c.lp - c.k + 1 + c.stride - 1) / c.stride;
}

// Per-read scratch of one strand search: occ/ii per sample, candidate
// values and the verify order, read/mask words, probe counts (255 = not a
// survivor), then the reverse-complement row and its degenerate flags.
struct Scratch {
    int32_t* occ;
    int32_t* ii;
    uint32_t* cand;
    int32_t* order;
    uint32_t* rw;
    uint32_t* mw;
    uint8_t* pm;
    uint8_t* rc;
    uint8_t* rdege;
};

__host__ __device__ inline int64_t seed_scratch_bytes(const Cfg& c) {
    const int64_t S = n_samples(c);
    const int64_t tot = (int64_t)c.n_cand * c.n_seeds;
    return align16(8 * S) + align16(8 * tot) + align16(8 * (c.lp / 16))
           + align16(tot) + align16(2 * (int64_t)c.lp);
}

__device__ inline Scratch seed_scratch(const Cfg& c, uint8_t* base) {
    const int64_t S = n_samples(c);
    const int64_t tot = (int64_t)c.n_cand * c.n_seeds;
    Scratch s;
    s.occ = reinterpret_cast<int32_t*>(base);
    s.ii = s.occ + S;
    base += align16(8 * S);
    s.cand = reinterpret_cast<uint32_t*>(base);
    s.order = reinterpret_cast<int32_t*>(s.cand + tot);
    base += align16(8 * tot);
    s.rw = reinterpret_cast<uint32_t*>(base);
    s.mw = s.rw + c.lp / 16;
    base += align16(8 * (c.lp / 16));
    s.pm = base;
    base += align16(tot);
    s.rc = base;
    s.rdege = base + c.lp;
    return s;
}

__device__ __forceinline__ uint64_t key_at(const Index& ix, int64_t i) {
    return ix.wide ? (uint64_t)__ldg(static_cast<const long long*>(ix.keys)
                                     + i)
                   : (uint64_t)(uint32_t)__ldg(
                         static_cast<const int32_t*>(ix.keys) + i);
}

__device__ __forceinline__ uint32_t ref_word(const Index& ix, int64_t w) {
    w = w < 0 ? 0 : (w > ix.nw - 1 ? ix.nw - 1 : w);
    return __ldg(ix.packed + w);
}

__device__ __forceinline__ uint8_t ref_base(const Index& ix, int64_t idx) {
    return (uint8_t)((ref_word(ix, idx >> 4) >> (2u * (15 - (idx & 15))))
                     & 3u);
}

__device__ __forceinline__ int mis2bit(uint32_t x) {
    return __popc((x | (x >> 1)) & 0x55555555u);
}

// Word j of the read funnel-shifted into the candidate's ref frame,
// sh = 2 * (cand & 15) (hash._read_in_ref_frame).
__device__ __forceinline__ uint32_t frame_word(const uint32_t* arr, int W,
                                               int j, uint32_t sh) {
    const uint32_t a = (j >= 1 && j <= W) ? arr[j - 1] : 0u;
    const uint32_t b = (j < W) ? arr[j] : 0u;
    const uint32_t shl = 32u - (sh > 1u ? sh : 1u);
    const uint32_t hi = (j >= 1 && sh > 0) ? (a << shl) : 0u;
    return hi | (b >> sh);
}

// Fills rc/rdege with the reverse complement of row/drow, zero past len.
__device__ inline void reverse_complement(const uint8_t* row,
                                          const uint8_t* drow, int32_t len,
                                          int lp, uint8_t* rc,
                                          uint8_t* rdege) {
    for (int i = 0; i < lp; i++) {
        rc[i] = i < len ? (uint8_t)(3 - row[len - 1 - i]) : 0;
        rdege[i] = i < len ? drow[len - 1 - i] : 0;
    }
}

// One strand of one read: row/drow hold lp bytes (zero past len).  Writes
// the best mismatch count (kBig when nothing verified) and the window
// start of the first-occurrence argmin, including the fallbacks an
// unmapped read's indel anchor observes: candidate 0 when no candidate
// is valid, and the first valid candidate of least probe rank when the
// prefilter prunes them all (rank = first-word count + 8 once that alone
// is over max_mis, as the native mirror ranks it).
__device__ inline void one_strand(const Index& ix, const Cfg& cfg,
                                  const Scratch& ws, const uint8_t* row,
                                  const uint8_t* drow, int32_t len,
                                  int32_t* mis_out, int32_t* pos_out) {
    const int lp = cfg.lp, k = cfg.k, W = lp / 16;
    const int S = n_samples(cfg);
    const uint64_t kmask = (k >= 32) ? ~0ull : ((1ull << (2 * k)) - 1);

    // rolling k-mers; each sampled one is looked up at once
    uint64_t v = 0;
    int32_t last_dege = -1;
    for (int i = 0; i < lp; i++) {
        v = ((v << 2) | row[i]) & kmask;
        if (drow[i]) last_dege = i;
        const int q = i - k + 1;
        if (q < 0 || q % cfg.stride) continue;
        const int s = q / cfg.stride;
        const bool ok = q <= len - k && last_dege < q;
        const int64_t bq = (int64_t)(v >> ix.l1_shift);
        int64_t lo = __ldg(ix.l1 + bq), hi = __ldg(ix.l1 + bq + 1);
        const int64_t hi0 = hi;
        for (int t = 0; t < ix.search_steps; t++) {
            const bool active = lo < hi;
            const int64_t mid = (lo + hi) >> 1;
            const int64_t m = mid < ix.nk - 1 ? mid : ix.nk - 1;
            const bool less = key_at(ix, m) < v;
            if (active && less) lo = mid + 1;
            if (active && !less) hi = mid;
        }
        const int64_t i2 = lo < ix.nk - 1 ? lo : ix.nk - 1;
        ws.ii[s] = (int32_t)i2;
        const bool found = key_at(ix, i2) == v && lo < hi0 && ok;
        ws.occ[s] = found ? __ldg(ix.offsets + i2 + 1) - __ldg(ix.offsets + i2)
                          : kBig;
    }

    for (int w = 0; w < W; w++) {
        uint32_t r = 0, m = 0;
        for (int t = 0; t < 16; t++) {
            const int i = 16 * w + t;
            const uint32_t shv = 2u * (15 - t);
            if (i < len) {
                r |= (uint32_t)row[i] << shv;
                m |= 3u << shv;
            }
        }
        ws.rw[w] = r;
        ws.mw[w] = m;
    }

    const int C = cfg.n_cand, NS = cfg.n_seeds, total = C * NS;
    const int K = cfg.probe_k;
    const bool pre = K > 0 && total > 2 * K && W > 3;
    const int j1 = 1, j2 = W / 2;
    int32_t cnt[kMaxProbe];
    for (int b = 0; b < kMaxProbe; b++) cnt[b] = 0;
    int32_t pm_min = kBig;
    int pm_arg = -1, n_surv = 0;
    bool any_valid = false;
    uint32_t cand0 = 0;
    for (int it = 0; it < NS; it++) {
        int jb = 0;
        for (int s = 1; s < S; s++)
            if (ws.occ[s] < ws.occ[jb]) jb = s;
        const int32_t occ_best = ws.occ[jb];
        const int32_t pb = jb * cfg.stride;
        if (cfg.excl_bp > 0) {
            for (int s = 0; s < S; s++) {
                const int d = s * cfg.stride - pb;
                if ((d < 0 ? -d : d) <= cfg.excl_bp) ws.occ[s] = kBig;
            }
        } else {
            ws.occ[jb] = kBig;
        }
        int64_t base = __ldg(ix.offsets + ws.ii[jb]);
        if (base < 0) base = 0;
        int32_t lim = occ_best < C ? occ_best : C;
        if (lim < 0) lim = 0;
        for (int cj = 0; cj < C; cj++) {
            const int c = it * C + cj;
            ws.pm[c] = 255;
            if (cj >= lim) continue;
            int64_t ptr = base + cj;
            if (ptr > ix.npos - 1) ptr = ix.npos - 1;
            const int32_t cp_i = __ldg(ix.positions + ptr) - pb;
            if (c == 0) cand0 = (uint32_t)cp_i;
            if (cp_i < 0 || (int64_t)cp_i + len > ix.ref_len) continue;
            ws.cand[c] = (uint32_t)cp_i;
            any_valid = true;
            if (!pre) {
                ws.pm[c] = 0;
                continue;
            }
            const uint32_t cp = (uint32_t)cp_i;
            const int64_t w0 = cp >> 4;
            const uint32_t sh = 2u * (cp & 15u);
            int32_t pm = mis2bit((frame_word(ws.rw, W, j1, sh)
                                  ^ ref_word(ix, w0 + j1))
                                 & frame_word(ws.mw, W, j1, sh));
            if (pm <= cfg.max_mis) {
                pm += mis2bit((frame_word(ws.rw, W, j2, sh)
                               ^ ref_word(ix, w0 + j2))
                              & frame_word(ws.mw, W, j2, sh));
                if (pm <= cfg.max_mis) {
                    ws.pm[c] = (uint8_t)pm;
                    cnt[pm]++;
                    n_surv++;
                }
            } else {
                pm += 8;
            }
            if (pm < pm_min) {
                pm_min = pm;
                pm_arg = c;
            }
        }
    }
    if (!any_valid) {
        *mis_out = kBig;
        *pos_out = (C > 0 && NS > 0) ? (int32_t)cand0 : 0;
        return;
    }
    if (pre && n_surv == 0) {
        *mis_out = kBig;
        *pos_out = (int32_t)ws.cand[pm_arg];
        return;
    }

    // verify order: (probe count, index) for the prefiltered list (a
    // counting sort), index order otherwise
    int n_list = 0;
    if (pre) {
        int32_t start[kMaxProbe];
        int32_t acc = 0;
        for (int b = 0; b < kMaxProbe; b++) {
            start[b] = acc;
            acc += cnt[b];
        }
        for (int c = 0; c < total; c++) {
            const uint8_t p = ws.pm[c];
            if (p != 255) ws.order[start[p]++] = c;
        }
        n_list = n_surv;
    } else {
        for (int c = 0; c < total; c++)
            if (ws.pm[c] == 0) ws.order[n_list++] = c;
    }

    int32_t best_mis = kBig;
    uint32_t best_pos = 0;
    bool have = false;
    int taken = 0;
    for (int t = 0; t < n_list; t++) {
        const int c = ws.order[t];
        if (pre) {
            // a probe count is a lower bound of the full count, so nothing
            // from here on can strictly beat the running best
            if (have && ws.pm[c] >= best_mis) break;
            if (taken++ >= K) break;
        }
        const uint32_t cp = ws.cand[c];
        const int64_t w0 = cp >> 4;
        const uint32_t sh = 2u * (cp & 15u);
        const int32_t bound = have ? best_mis : kBig;
        int32_t m = 0;
        for (int j = 0; j <= W && m < bound; j++)
            m += mis2bit((frame_word(ws.rw, W, j, sh) ^ ref_word(ix, w0 + j))
                         & frame_word(ws.mw, W, j, sh));
        if (!have || m < best_mis) {
            best_mis = m;
            best_pos = cp;
            have = true;
            if (best_mis == 0) break;
        }
    }
    *mis_out = best_mis;
    *pos_out = (int32_t)best_pos;
}

}  // namespace fqa
