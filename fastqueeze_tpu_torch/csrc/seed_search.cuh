// Per-read seed search and gapless verify shared by K8 (align_batch.cu),
// K9 (indel_batch.cu) and K14 (rescue_indel_fused.cu): one warp a read.
//
// one_strand reproduces native/alignhost.cpp one_strand decision for
// decision, which mirrors fastqueeze_tpu/align/hash.py _one_strand (B11):
// the bucketed binary search of every sampled k-mer, n_seeds
// first-occurrence argmin picks with the +-excl_bp mask, min(occ, n_cand)
// candidates a pick in CSR order, the two-probe-word prefilter with
// lax.top_k's stable order, the funnel-shift XOR/popcount verify and its
// first-occurrence argmin.  Bound by chains of dependent random loads
// (binary-search steps into a ~1 GB index, CSR positions, packed
// reference words); the design puts 32 independent chains in flight a
// read where a thread a read had one:
//   1. lookups: lane l takes samples l, l+32, ..., builds each k-mer from
//      the row (no rolling), runs the l1-bounded searches of up to kIlp
//      samples side by side, and stores occ / ii per sample;
//   2. picks: a warp argmin on (occ, sample), so the first occurrence
//      wins; the lanes mask their own samples;
//   3. candidates: lanes stride over a pick's list 32 at a time (the CSR
//      loads coalesce), each computes its probe words and pm (+8 when the
//      first word alone is over max_mis); cand0, any_valid and the
//      (pm_min, pm_arg) first occurrence are warp reductions and the
//      probe-count histogram shared-memory counts;
//   4. order: a stable counting sort by (probe count, index): each chunk
//      of 32 candidates in index order places its survivors at the
//      bucket's running offset plus their rank among the chunk's lanes of
//      the same bucket (__match_any_sync); without the prefilter a
//      ballot compacts the valid candidates in index order;
//   5. verify: rounds of 32 consecutive order entries, each lane counting
//      one entry's mismatches over W+1 words with the round-start best as
//      its early exit, then the serial rules applied in lane order (break
//      when have && pm >= best, the taken++ >= K cut, strict m < best,
//      break at best == 0).  This equals the serial loop: a lane's count
//      is exact whenever it is below the round-start best, and the best
//      only falls within a round, so a count cut short is >= the current
//      best and can never be taken; the first entry (no best yet) runs
//      with no bound.  A lane whose probe count is already >= the
//      round-start best skips its count: the serial loop breaks at or
//      before it.
// A warp's small arrays (occ / ii, the read and mask words, the staged
// rows, the counts, the candidate lists of tier 1) live in its slice of
// shared memory; whatever does not fit in kWarpSmem (the rescue tier's
// 6,144-entry lists, the chunk tier's rows) goes to its global slab.
#pragma once

#include <cstdint>

namespace fqa {

constexpr int32_t kBig = 1 << 28;
constexpr int32_t kNone = 0x7fffffff;   // argmin key of a lane with nothing
constexpr int kMaxProbe = 33;   // two 16-base probe words: counts 0..32
constexpr unsigned kFull = 0xffffffffu;
constexpr int kIlp = 4;         // binary searches a lane runs side by side
constexpr int kWarps = 4;       // warps (reads) a block
constexpr int64_t kWarpSmem = 12 * 1024;   // a warp's shared-memory budget

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

// A warp's arrays, in order of placement: each goes to shared memory while
// the warp's shared total stays within kWarpSmem, else to its global slab.
enum Region {
    kCnt,      // int32 [33] probe-count histogram, then bucket offsets
    kLim,      // int32 [n_seeds] candidates listed a pick
    kRw,       // uint32 [W] read words, then [W] mask words
    kRows,     // uint8 [lp] x 4: row, degenerate flags, RC row, RC flags
    kOcc,      // int32 [S] occurrences, then [S] key indices
    kCand,     // uint32 [tot] candidates, int32 [tot] order, uint8 [tot] pm
    kIndel,    // int32 [2G+2] x [lp+1] a strand, two strands (K9, K14)
    kRegions
};

struct Layout {
    int64_t off[kRegions];
    bool shared[kRegions];
    int64_t smem, gmem;   // a warp's shared and global bytes
};

// (2G+1) compare-row prefix counts and the filler row F of one strand.
__host__ __device__ inline int64_t rows_bytes(int lp, int G) {
    return align16(4 * (int64_t)(2 * G + 2) * (lp + 1));
}

// G = 0: K8's search alone; G > 0: K9's rows on top.
__host__ __device__ inline Layout make_layout(const Cfg& c, int G) {
    const int64_t S = n_samples(c), W = c.lp / 16;
    const int64_t tot = (int64_t)c.n_cand * c.n_seeds;
    const int64_t size[kRegions] = {
        align16(4 * 2 * kMaxProbe), align16(4 * (int64_t)c.n_seeds),
        align16(8 * W), align16(4 * (int64_t)c.lp), align16(8 * S),
        align16(8 * tot) + align16(tot), G > 0 ? 2 * rows_bytes(c.lp, G) : 0};
    Layout L;
    L.smem = L.gmem = 0;
    for (int r = 0; r < kRegions; r++) {
        L.shared[r] = L.smem + size[r] <= kWarpSmem;
        int64_t& at = L.shared[r] ? L.smem : L.gmem;
        L.off[r] = at;
        at += size[r];
    }
    return L;
}

// A warp's pointers into its shared slice and its global slab.
struct Ws {
    int32_t* cnt;     // [33] histogram; start[33] follows
    int32_t* start;
    int32_t* lim;
    uint32_t* rw;
    uint32_t* mw;
    uint8_t* row;     // staged forward row and flags
    uint8_t* drow;
    uint8_t* rc;      // reverse complement and its flags
    uint8_t* rdege;
    int32_t* occ;
    int32_t* ii;
    uint32_t* cand;
    int32_t* order;
    uint8_t* pm;
    int32_t* rows;    // K9: strand 0's rows, strand 1's at + rows_stride
    int64_t rows_stride;
};

__device__ inline Ws warp_ws(const Cfg& c, int G, uint8_t* smem,
                             uint8_t* gmem) {
    const Layout L = make_layout(c, G);
    auto at = [&](int r) { return (L.shared[r] ? smem : gmem) + L.off[r]; };
    const int64_t S = n_samples(c), W = c.lp / 16;
    const int64_t tot = (int64_t)c.n_cand * c.n_seeds;
    Ws w;
    w.cnt = reinterpret_cast<int32_t*>(at(kCnt));
    w.start = w.cnt + kMaxProbe;
    w.lim = reinterpret_cast<int32_t*>(at(kLim));
    w.rw = reinterpret_cast<uint32_t*>(at(kRw));
    w.mw = w.rw + W;
    w.row = at(kRows);
    w.drow = w.row + c.lp;
    w.rc = w.drow + c.lp;
    w.rdege = w.rc + c.lp;
    w.occ = reinterpret_cast<int32_t*>(at(kOcc));
    w.ii = w.occ + S;
    w.cand = reinterpret_cast<uint32_t*>(at(kCand));
    w.order = reinterpret_cast<int32_t*>(w.cand + tot);
    w.pm = at(kCand) + align16(8 * tot);
    w.rows = reinterpret_cast<int32_t*>(at(kIndel));
    w.rows_stride = rows_bytes(c.lp, G) / 4;
    return w;
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// Lexicographic (v, i) minimum over the warp, with a payload; every lane
// gets the result.  Ties in v go to the smaller i: the first occurrence.
__device__ __forceinline__ void warp_argmin(int32_t& v, int32_t& i,
                                            uint32_t& pay) {
#pragma unroll
    for (int o = 16; o; o >>= 1) {
        const int32_t v2 = __shfl_xor_sync(kFull, v, o);
        const int32_t i2 = __shfl_xor_sync(kFull, i, o);
        const uint32_t p2 = __shfl_xor_sync(kFull, pay, o);
        if (v2 < v || (v2 == v && i2 < i)) {
            v = v2;
            i = i2;
            pay = p2;
        }
    }
}

__device__ __forceinline__ void warp_argmin(int32_t& v, int32_t& i) {
    uint32_t p = 0;
    warp_argmin(v, i, p);
}

// Inclusive prefix sum over the lanes.
__device__ __forceinline__ int32_t warp_scan(int32_t x) {
    const int lane = lane_id();
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int32_t y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x += y;
    }
    return x;
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

__device__ __forceinline__ int word_mis(const Index& ix, const Ws& ws,
                                        int W, int j, uint32_t sh,
                                        uint32_t refw) {
    return mis2bit((frame_word(ws.rw, W, j, sh) ^ refw)
                   & frame_word(ws.mw, W, j, sh));
}

// Stages lp bytes of a global row and its flags in the warp's buffers.
__device__ inline void stage_row(const uint8_t* row, const uint8_t* drow,
                                 int lp, const Ws& ws) {
    __syncwarp();
    for (int i = lane_id(); i < lp; i += 32) {
        ws.row[i] = row[i];
        ws.drow[i] = drow[i];
    }
    __syncwarp();
}

// Clamps a read's length to [0, lp]; has_dege: a degenerate base in it.
__device__ inline int32_t read_len(int32_t len, int lp, const uint8_t* drow,
                                   bool* has_dege) {
    if (len > lp) len = lp;
    if (len < 0) len = 0;
    bool hd = false;
    for (int i = lane_id(); i < len; i += 32) hd |= drow[i] != 0;
    *has_dege = __any_sync(kFull, hd);
    return len;
}

// The reverse complement of the staged row into ws.rc / ws.rdege, zero
// past len.
__device__ inline void reverse_complement(const Ws& ws, int32_t len,
                                          int lp) {
    __syncwarp();
    for (int i = lane_id(); i < lp; i += 32) {
        ws.rc[i] = i < len ? (uint8_t)(3 - ws.row[len - 1 - i]) : 0;
        ws.rdege[i] = i < len ? ws.drow[len - 1 - i] : 0;
    }
    __syncwarp();
}

// Step 1: every sample's occ and key index.
__device__ inline void lookups(const Index& ix, const Cfg& cfg, const Ws& ws,
                               const uint8_t* row, const uint8_t* drow,
                               int32_t len, int S) {
    const int lane = lane_id(), k = cfg.k;
    __syncwarp();   // the previous strand's readers are done
    for (int s0 = 0; s0 < S; s0 += 32 * kIlp) {
        uint64_t v[kIlp];
        int32_t lo[kIlp], hi[kIlp], hi0[kIlp];   // l1 is int32: so are they
        bool ok[kIlp];
#pragma unroll
        for (int u = 0; u < kIlp; u++) {
            const int s = s0 + lane + 32 * u;
            v[u] = 0;
            ok[u] = false;
            lo[u] = hi[u] = hi0[u] = 0;
            if (s >= S) continue;
            const int q = s * cfg.stride;
            bool dg = false;
            for (int j = 0; j < k; j++) {
                v[u] = (v[u] << 2) | row[q + j];
                dg |= drow[q + j] != 0;
            }
            ok[u] = q <= len - k && !dg;
            const int64_t bq = (int64_t)(v[u] >> ix.l1_shift);
            lo[u] = __ldg(ix.l1 + bq);
            hi[u] = hi0[u] = __ldg(ix.l1 + bq + 1);
        }
        for (int t = 0; t < ix.search_steps; t++) {
            uint64_t km[kIlp];
            int32_t mid[kIlp];
            bool live = false;
#pragma unroll
            for (int u = 0; u < kIlp; u++) {
                mid[u] = (int32_t)(((uint32_t)lo[u] + (uint32_t)hi[u]) >> 1);
                if (lo[u] < hi[u]) {
                    km[u] = key_at(ix, mid[u] < ix.nk - 1 ? mid[u]
                                                          : ix.nk - 1);
                    live = true;
                }
            }
            if (!live) break;   // the remaining steps change nothing
#pragma unroll
            for (int u = 0; u < kIlp; u++) {
                if (lo[u] < hi[u]) {
                    if (km[u] < v[u]) lo[u] = mid[u] + 1;
                    else hi[u] = mid[u];
                }
            }
        }
#pragma unroll
        for (int u = 0; u < kIlp; u++) {
            const int s = s0 + lane + 32 * u;
            if (s >= S) continue;
            const int64_t i2 = lo[u] < ix.nk - 1 ? (int64_t)lo[u] : ix.nk - 1;
            ws.ii[s] = (int32_t)i2;
            const bool found = ok[u] && lo[u] < hi0[u] && key_at(ix, i2) == v[u];
            ws.occ[s] = found ? __ldg(ix.offsets + i2 + 1)
                                    - __ldg(ix.offsets + i2)
                              : kBig;
        }
    }
    // read and mask words of the row: 16 bases a word, MSB first
    const int W = cfg.lp / 16;
    for (int w = lane; w < W; w += 32) {
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
    for (int b = lane; b < kMaxProbe; b += 32) ws.cnt[b] = 0;
    __syncwarp();
}

// One strand of one read, on the whole warp: row/drow hold lp bytes (zero
// past len).  Every lane gets the best mismatch count (kBig when nothing
// verified) and the window start of the first-occurrence argmin,
// including the fallbacks an unmapped read's indel anchor observes:
// candidate 0 when no candidate is valid, and the first valid candidate of
// least probe rank when the prefilter prunes them all (rank = first-word
// count + 8 once that alone is over max_mis, as the native mirror ranks
// it).
__device__ inline void one_strand(const Index& ix, const Cfg& cfg,
                                  const Ws& ws, const uint8_t* row,
                                  const uint8_t* drow, int32_t len,
                                  int32_t* mis_out, int32_t* pos_out) {
    const int lane = lane_id();
    const int W = cfg.lp / 16, S = n_samples(cfg);
    lookups(ix, cfg, ws, row, drow, len, S);

    const int C = cfg.n_cand, NS = cfg.n_seeds;
    const int K = cfg.probe_k;
    const bool pre = K > 0 && (int64_t)C * NS > 2 * K && W > 3;
    const int j1 = 1, j2 = W / 2;
    int32_t pm_min = kNone, pm_arg = kNone;   // lane-local, then the warp's
    uint32_t pm_cand = 0;
    bool any_valid = false;
    uint32_t cand0 = 0;
    int32_t n_surv = 0;
    for (int it = 0; it < NS; it++) {
        // step 2: the pick, first occurrence of the least occ
        int32_t ob = kNone, jb = kNone;
        for (int s = lane; s < S; s += 32)
            if (ws.occ[s] < ob) {
                ob = ws.occ[s];
                jb = s;
            }
        warp_argmin(ob, jb);
        if (jb == kNone) jb = 0;   // no sample: as the serial scan's jb = 0
        const int32_t occ_best = S > 0 ? ob : kBig;
        const int32_t pb = jb * cfg.stride;
        for (int s = lane; s < S; s += 32) {
            const int d = s * cfg.stride - pb;
            if (cfg.excl_bp > 0 ? (d < 0 ? -d : d) <= cfg.excl_bp : s == jb)
                ws.occ[s] = kBig;
        }
        int64_t base = __ldg(ix.offsets + ws.ii[jb]);
        if (base < 0) base = 0;
        int32_t lim = occ_best < C ? occ_best : C;
        if (lim < 0) lim = 0;
        if (lane == 0) ws.lim[it] = lim;
        // step 3: the pick's candidates, 32 at a time
        for (int cj = lane; cj - lane < lim; cj += 32) {
            if (cj >= lim) continue;
            const int c = it * C + cj;
            int64_t ptr = base + cj;
            if (ptr > ix.npos - 1) ptr = ix.npos - 1;
            const int32_t cp_i = __ldg(ix.positions + ptr) - pb;
            if (c == 0) cand0 = (uint32_t)cp_i;
            uint8_t keep = 255;
            if (cp_i >= 0 && (int64_t)cp_i + len <= ix.ref_len) {
                const uint32_t cp = (uint32_t)cp_i;
                ws.cand[c] = cp;
                any_valid = true;
                if (!pre) {
                    keep = 0;
                } else {
                    const int64_t w0 = cp >> 4;
                    const uint32_t sh = 2u * (cp & 15u);
                    int32_t pm = word_mis(ix, ws, W, j1, sh,
                                          ref_word(ix, w0 + j1));
                    if (pm <= cfg.max_mis) {
                        pm += word_mis(ix, ws, W, j2, sh,
                                       ref_word(ix, w0 + j2));
                        if (pm <= cfg.max_mis) {
                            keep = (uint8_t)pm;
                            atomicAdd(ws.cnt + pm, 1);
                            n_surv++;
                        }
                    } else {
                        pm += 8;
                    }
                    if (pm < pm_min) {   // c ascends within a lane
                        pm_min = pm;
                        pm_arg = c;
                        pm_cand = cp;
                    }
                }
            }
            ws.pm[c] = keep;
        }
        __syncwarp();
    }
    const bool any = __any_sync(kFull, any_valid);
    cand0 = __shfl_sync(kFull, cand0, 0);
    if (!any) {
        *mis_out = kBig;
        *pos_out = (C > 0 && NS > 0) ? (int32_t)cand0 : 0;
        return;
    }
    for (int o = 16; o; o >>= 1) n_surv += __shfl_xor_sync(kFull, n_surv, o);
    if (pre && n_surv == 0) {
        warp_argmin(pm_min, pm_arg, pm_cand);
        *mis_out = kBig;
        *pos_out = (int32_t)pm_cand;
        return;
    }

    // step 4: the verify order
    int n_list = 0;
    const unsigned lt = (1u << lane) - 1u;
    if (pre) {
        // exclusive bucket offsets: lane b holds bucket b, bucket 32 after
        const int32_t cb = ws.cnt[lane];
        const int32_t incl = warp_scan(cb);
        ws.start[lane] = incl - cb;
        if (lane == 31) ws.start[32] = incl;
        __syncwarp();
        for (int it = 0; it < NS; it++) {
            const int lim = ws.lim[it];
            for (int cj = lane; cj - lane < lim; cj += 32) {
                const int c = it * C + cj;
                const uint32_t p = cj < lim ? ws.pm[c] : 255u;
                const unsigned peers = __match_any_sync(kFull, p);
                int32_t slot = 0;
                if (p != 255u) slot = ws.start[p] + __popc(peers & lt);
                __syncwarp();
                if (p != 255u) {
                    ws.order[slot] = c;
                    if (lane == 31 - __clz(peers))   // the group's last lane
                        ws.start[p] += __popc(peers);
                }
                __syncwarp();
            }
        }
        n_list = n_surv;
    } else {
        for (int it = 0; it < NS; it++) {
            const int lim = ws.lim[it];
            for (int cj = lane; cj - lane < lim; cj += 32) {
                const int c = it * C + cj;
                const bool ok = cj < lim && ws.pm[c] == 0;
                const unsigned bal = __ballot_sync(kFull, ok);
                if (ok) ws.order[n_list + __popc(bal & lt)] = c;
                n_list += __popc(bal);
            }
        }
    }
    __syncwarp();

    // step 5: verify rounds of 32 order entries, applied in lane order
    const int n_eff = pre && K < n_list ? K : n_list;
    int32_t best_mis = kBig;
    uint32_t best_pos = 0;
    bool have = false;
    int taken = 0;
    bool stop = false;
    for (int t0 = 0; t0 < n_eff && !stop; t0 += 32) {
        const int t = t0 + lane;
        const bool in = t < n_eff;
        const int c = in ? ws.order[t] : 0;
        const int32_t p = in && pre ? ws.pm[c] : 0;
        const uint32_t cp = in ? ws.cand[c] : 0u;
        const int32_t bound = have ? best_mis : kBig;
        int32_t m = kBig;
        if (in && !(pre && have && p >= bound)) {
            const int64_t w0 = cp >> 4;
            const uint32_t sh = 2u * (cp & 15u);
            m = 0;
            for (int j = 0; j <= W && m < bound; j += 4) {
                uint32_t rf[4];
#pragma unroll
                for (int u = 0; u < 4; u++)
                    rf[u] = j + u <= W ? ref_word(ix, w0 + j + u) : 0u;
#pragma unroll
                for (int u = 0; u < 4; u++)
                    if (j + u <= W) m += word_mis(ix, ws, W, j + u, sh, rf[u]);
            }
        }
        const int n_here = n_eff - t0 < 32 ? n_eff - t0 : 32;
        for (int l = 0; l < n_here; l++) {
            const int32_t pl = __shfl_sync(kFull, p, l);
            const int32_t ml = __shfl_sync(kFull, m, l);
            const uint32_t cl = __shfl_sync(kFull, cp, l);
            if (pre) {
                // a probe count is a lower bound of the full count, so
                // nothing from here on can strictly beat the running best
                if (have && pl >= best_mis) {
                    stop = true;
                    break;
                }
                if (taken++ >= K) {
                    stop = true;
                    break;
                }
            }
            if (!have || ml < best_mis) {
                best_mis = ml;
                best_pos = cl;
                have = true;
                if (best_mis == 0) {
                    stop = true;
                    break;
                }
            }
        }
    }
    *mis_out = best_mis;
    *pos_out = (int32_t)best_pos;
}

}  // namespace fqa
