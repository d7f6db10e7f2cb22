// Per-read bodies of the aligner's tiers, one warp a read, shared by K8
// (align_batch.cu), K9 (indel_batch.cu) and K14 (rescue_indel_fused.cu).
//
// gapless_read is one read of fastqueeze_tpu/align/hash.py _align_batch
// (B11): the seed search of seed_search.cuh on the forward grid, the
// reverse-complement grid or both, the strand rule, and the mismatch mask
// of a mapped read, the lanes over its positions.  indel_read is one read
// of _indel_batch (B12): per strand the seed search for the anchor -- the
// best gapless candidate, fallbacks included, since the reads here are
// the ones the gapless tiers failed -- then the 2G+1 compare rows of the
// read against the reference at shifts -G..+G as exclusive prefix counts
// (lanes over 32 columns at a time, a warp scan with a carry a chunk),
// every split x gap over both anchorings (variants gap ascending, A
// before B, strict-< chaining; each a warp argmin on (tot, split), first
// occurrence), the greedy TAIL and HEAD second op where one op cannot
// reach max_mis (head wins only if strictly better), and the
// spliced-window mask, built by the lanes from the rows' differences.
// The decisions follow native/alignhost.cpp step for step.  A strand's
// rows (2G+2 rows of lp+1 int32: 4,128 bytes at G = 3, Lp = 128) sit in
// the warp's shared slice when both strands' fit with the search's
// arrays in seed_search.cuh's kWarpSmem (Lp 128, G <= 3), else in its
// global slab (the chunk tier's Lp 1024).
#pragma once

#include <cstdint>

#include "seed_search.cuh"

namespace fqa {

// One read of K8 on the warp: strand_mode 0 forward, 1 reverse complement
// (the fallback pass over reads forward failed), 2 both (RC as fallback
// unless both_strands).  row/drow hold lp bytes in global memory, zero
// past len; mm gets lp mask bytes.
__device__ inline void gapless_read(const Index& ix, const Cfg& cfg,
                                    const Ws& ws, const uint8_t* row,
                                    const uint8_t* drow, int32_t len_in,
                                    int32_t strand_mode, int32_t both_strands,
                                    uint8_t* mapped, int32_t* pos_out,
                                    uint8_t* rev_out, uint8_t* mm) {
    const int lp = cfg.lp, lane = lane_id();
    stage_row(row, drow, lp, ws);
    bool has_dege;
    const int32_t len = read_len(len_in, lp, ws.drow, &has_dege);
    int32_t mis_f = kBig, pos_f = 0, mis_r = kBig, pos_r = 0;
    if (strand_mode != 1)
        one_strand(ix, cfg, ws, ws.row, ws.drow, len, &mis_f, &pos_f);
    // RC as fallback: when forward mapped, its RC result is unused
    const bool need_rc = strand_mode != 0 &&
        !(strand_mode == 2 && !both_strands && mis_f <= cfg.max_mis);
    if (need_rc) {
        reverse_complement(ws, len, lp);
        one_strand(ix, cfg, ws, ws.rc, ws.rdege, len, &mis_r, &pos_r);
    }
    bool use_rev;
    int32_t mis, pos;
    if (strand_mode == 0) {
        use_rev = false;
        mis = mis_f;
        pos = pos_f;
    } else if (strand_mode == 1) {
        use_rev = mis_r <= cfg.max_mis;
        mis = mis_r;
        pos = pos_r;
    } else {
        use_rev = both_strands ? mis_r < mis_f : mis_f > cfg.max_mis;
        mis = use_rev ? mis_r : mis_f;
        pos = use_rev ? pos_r : pos_f;
    }
    const bool is_mapped = mis <= cfg.max_mis && !has_dege && len >= cfg.k;
    if (lane == 0) {
        *mapped = is_mapped;
        *pos_out = pos;
        *rev_out = use_rev && is_mapped;
    }
    const uint8_t* eff =
        (strand_mode == 1 || (strand_mode == 2 && use_rev)) ? ws.rc : ws.row;
    for (int i = lane; i < lp; i += 32)
        mm[i] = is_mapped && i < len &&
                eff[i] != ref_base(ix, (int64_t)(uint32_t)pos + i);
}

// strand_eval's outputs, as the decode splice reads them: shift gA past
// sA, then gB more past sB (sB = gB = 0 with one op); jb is segment 0's
// compare row, pg/sg the one-op rows the second pass starts from.
struct SRes {
    int32_t tot, sA, gA, sB, gB, po, jb, pg, sg;
};

// First-occurrence argmin of f(s) over s in [lo, hi] on the warp:
// (kNone, kNone) when the range is empty.
template <class Fn>
__device__ __forceinline__ void range_argmin(int32_t lo, int32_t hi, Fn f,
                                             int32_t* tb, int32_t* sb) {
    int32_t v = kNone, at = kNone;
    for (int32_t s = lo + lane_id(); s <= hi; s += 32) {
        const int32_t t = f(s);
        if (t < v) {
            v = t;
            at = s;
        }
    }
    warp_argmin(v, at);
    *tb = v;
    *sb = at;
}

// One strand of indel_read: rows E (row j at E + j * (lp+1), j in
// [0, 2G]) and F (at E + (2G+1) * (lp+1)) of the read c / d.
__device__ inline SRes strand_eval(const Index& ix, const Cfg& cfg,
                                   const Ws& ws, int32_t* E,
                                   const uint8_t* c, const uint8_t* d,
                                   int32_t len, int G, int ops) {
    const int lp = cfg.lp, NG = 2 * G + 1, lane = lane_id();
    const int64_t R = lp + 1;
    int32_t mis_g, posi;
    one_strand(ix, cfg, ws, c, d, len, &mis_g, &posi);
    const bool ok_b = posi >= 2 * G &&
                      (int64_t)posi + len + 2 * G <= ix.ref_len;
    // exclusive prefix counts of the compare rows and the filler row F,
    // 32 columns at a time; constant past len (only columns <= len are
    // read)
    int32_t* F = E + NG * R;
    __syncwarp();
    for (int j = 0; j <= NG; j++) {
        int32_t* Ej = E + j * R;
        int32_t carry = 0;
        if (lane == 0) Ej[0] = 0;
        for (int i0 = 0; i0 < lp; i0 += 32) {
            const int i = i0 + lane;
            int32_t x = 0;
            if (i < len) {
                if (j < NG) {
                    int64_t idx = (int64_t)posi + (j - G) + i;
                    if (idx < 0) idx = 0;
                    if (idx > ix.ref_len - 1) idx = ix.ref_len - 1;
                    x = c[i] != ref_base(ix, idx);
                } else {
                    x = c[i] != 0;
                }
            }
            const int32_t incl = warp_scan(x);
            if (i < lp) Ej[i + 1] = carry + incl;
            carry += __shfl_sync(kFull, incl, 31);
        }
    }
    __syncwarp();
    const int32_t* E0 = E + G * R;
    SRes b{kBig, 0, 0, 0, 0, posi, 0, 0, 0};

    // tot[s] = pref[s] + (F[s+h] - F[s]) + (suf[len] - suf[s+h]) over
    // s in [0, len - h], first-occurrence argmin, strict-< chaining
    auto consider = [&](const int32_t* pref, const int32_t* suf, int h,
                        int32_t g_out, int32_t d_pos, int32_t pg,
                        int32_t sg) {
        int32_t tb, sb;
        const int32_t sl = suf[len];
        range_argmin(0, len - h, [&](int32_t s) {
            return pref[s] + (F[s + h] - F[s]) + (sl - suf[s + h]);
        }, &tb, &sb);
        if (tb < b.tot) {
            b.tot = tb;
            b.sA = sb;
            b.gA = g_out;
            b.po = posi + d_pos;
            b.pg = pg + G;
            b.sg = sg + G;
            b.jb = pg + G;
        }
    };
    for (int g = -G; g <= G; g++) {
        if (g == 0) continue;
        const int32_t* Eg = E + (g + G) * R;
        const int h = g > 0 ? g : -g;
        if (g > 0) {
            consider(E0, Eg, 0, g, 0, 0, g);    // A: the read deletes g
            consider(Eg, E0, h, -g, g, g, 0);   // B: insertion of g
        } else {
            consider(E0, Eg, h, g, 0, 0, g);    // A: the read inserts h
            consider(Eg, E0, 0, -g, g, g, 0);   // B: deletion of h
        }
    }
    if (!ok_b) b.tot = kBig;

    if (ops >= 2 && b.tot > cfg.max_mis && b.tot < kBig) {
        const int h1 = b.gA < 0 ? -b.gA : 0;
        const int32_t s1 = b.sA;
        const int32_t* Epg = E + b.pg * R;
        const int32_t* Esg = E + b.sg * R;
        const int32_t op1_lit = F[s1 + h1] - F[s1];
        // TAIL: a second op at s2 >= s1 + h1 moves the rest to row sg+g2
        const int32_t base_c = Epg[s1] + op1_lit - Esg[s1 + h1];
        int32_t tt = kBig, st = 0, gt = 0;
        for (int g2 = -G; g2 <= G; g2++) {
            if (g2 == 0) continue;
            const int j2 = b.sg + g2;
            if (j2 < 0 || j2 > 2 * G) continue;
            const int32_t* E2 = E + j2 * R;
            const int h2 = g2 < 0 ? -g2 : 0;
            const int32_t e2l = E2[len];
            int32_t tb, sb;
            range_argmin(s1 + h1, len - h2, [&](int32_t s2) {
                return base_c + Esg[s2] + (F[s2 + h2] - F[s2])
                       + (e2l - E2[s2 + h2]);
            }, &tb, &sb);
            if (tb < tt) {
                tt = tb;
                st = sb;
                gt = g2;
            }
        }
        // HEAD: a new first op at s0 <= s1 - hh re-bases the prefix
        const int32_t tail_c = op1_lit + Esg[len] - Esg[s1 + h1] + Epg[s1];
        int32_t th = kBig, sh = 0, gh_sel = 0;
        for (int gh = -G; gh <= G; gh++) {
            if (gh == 0) continue;
            const int j0 = b.pg + gh;
            if (j0 < 0 || j0 > 2 * G) continue;
            const int32_t* Ej0 = E + j0 * R;
            const int hh = gh > 0 ? gh : 0;
            int32_t tb, sb;
            range_argmin(0, s1 - hh, [&](int32_t s0) {
                return tail_c + Ej0[s0] + (F[s0 + hh] - F[s0])
                       - Epg[s0 + hh];
            }, &tb, &sb);
            if (tb < th) {
                th = tb;
                sh = sb;
                gh_sel = gh;
            }
        }
        const bool use_head = th < tt;
        const int32_t tbest = use_head ? th : tt;
        if (tbest < b.tot) {
            b.tot = tbest;
            if (use_head) {
                b.sB = b.sA;
                b.gB = b.gA;
                b.sA = sh;
                b.gA = -gh_sel;
                b.jb = b.pg + gh_sel;
                b.po += gh_sel;
            } else {
                b.sB = st;
                b.gB = gt;
            }
        }
    }
    return b;
}

// One read of K9 on the warp (ws from warp_ws(cfg, G, ...)): found, pos,
// the two ops (s1, g1, s2, g2), strand, and lp mask bytes in
// spliced-window coordinates.  row/drow in global memory.
__device__ inline void indel_read(const Index& ix, const Cfg& cfg,
                                  const Ws& ws, const uint8_t* row,
                                  const uint8_t* drow, int32_t len_in, int G,
                                  int ops, uint8_t* found_out,
                                  int32_t* pos_out, int32_t* split_out,
                                  int32_t* gap_out, int32_t* split2_out,
                                  int32_t* gap2_out, uint8_t* rev_out,
                                  uint8_t* mm) {
    const int lp = cfg.lp, lane = lane_id();
    stage_row(row, drow, lp, ws);
    bool has_dege;
    const int32_t len = read_len(len_in, lp, ws.drow, &has_dege);
    int32_t* rows_f = ws.rows;
    int32_t* rows_r = ws.rows + ws.rows_stride;

    const SRes f = strand_eval(ix, cfg, ws, rows_f, ws.row, ws.drow, len, G,
                               ops);
    SRes rv{kBig, 0, 0, 0, 0, 0, 0, 0, 0};
    if (f.tot > 0) {       // tot_r < tot_f needs tot_f > 0
        reverse_complement(ws, len, lp);
        rv = strand_eval(ix, cfg, ws, rows_r, ws.rc, ws.rdege, len, G, ops);
    }
    const bool use_rev = rv.tot < f.tot;
    const SRes& r = use_rev ? rv : f;
    const int32_t* E = use_rev ? rows_r : rows_f;
    const bool found = r.tot <= cfg.max_mis && !has_dege && len >= cfg.k;
    if (lane == 0) {
        *found_out = found;
        *pos_out = r.po;
        *split_out = r.sA;
        *gap_out = r.gA;
        *split2_out = r.sB;
        *gap2_out = r.gB;
        *rev_out = use_rev && found;
    }
    // spliced-window mask: rows jb, jb+gA, jb+gA+gB (compare bits as the
    // prefix counts' steps), literal filler over the insertion ranges
    const int64_t R = lp + 1;
    const int32_t hA = r.gA < 0 ? -r.gA : 0;
    const int32_t hB = r.gB < 0 ? -r.gB : 0;
    auto row_at = [&](int j) {
        j = j < 0 ? 0 : (j > 2 * G ? 2 * G : j);
        return E + j * R;
    };
    const int32_t* r0 = row_at(r.jb);
    const int32_t* r1 = row_at(r.jb + r.gA);
    const int32_t* r2 = row_at(r.jb + r.gA + r.gB);
    const int32_t* F = E + (2 * G + 1) * R;
    for (int i = lane; i < lp; i += 32) {
        int32_t v = 0;
        if (found && i < len) {
            const int32_t* rr;
            if (i < r.sA) rr = r0;
            else if (i < r.sA + hA) rr = hA > 0 ? F : r1;
            else if (i < r.sB) rr = r1;
            else if (i < r.sB + hB) rr = hB > 0 ? F : r2;
            else rr = r2;
            v = rr[i + 1] - rr[i];
        }
        mm[i] = (uint8_t)v;
    }
}

}  // namespace fqa
