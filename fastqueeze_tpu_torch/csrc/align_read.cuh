// Per-read bodies of the aligner's tiers, shared by K8 (align_batch.cu),
// K9 (indel_batch.cu) and K14 (rescue_indel_fused.cu).
//
// gapless_read is one read of fastqueeze_tpu/align/hash.py _align_batch
// (B11): the seed search of seed_search.cuh on the forward grid, the
// reverse-complement grid or both, the strand rule, and the mismatch mask
// of a mapped read.  indel_read is one read of _indel_batch (B12): per
// strand K8's seed search for the anchor -- the best gapless candidate,
// fallbacks included, since the reads here are the ones the gapless
// tiers failed -- then the 2G+1 compare rows of the read against the
// reference at shifts -G..+G with their exclusive prefix counts, every
// split x gap over both anchorings (variants gap ascending, A before B,
// strict-< chaining), the greedy TAIL and HEAD second op where one op
// cannot reach max_mis (head wins only if strictly better), and the
// spliced-window mask.  The decisions follow native/alignhost.cpp step
// for step.  A thread owns one read; its rows live in a per-read global
// scratch slab (7 x 129 int32 at G = 3, Lp = 128, one slab a strand).
#pragma once

#include <cstdint>

#include "seed_search.cuh"

namespace fqa {

// Clamps a read's length to [0, lp] and says whether it has a degenerate
// base.
__device__ inline int32_t read_len(int32_t len, int lp, const uint8_t* drow,
                                   bool* has_dege) {
    if (len > lp) len = lp;
    if (len < 0) len = 0;
    bool hd = false;
    for (int i = 0; i < len; i++) hd |= drow[i] != 0;
    *has_dege = hd;
    return len;
}

// One read of K8: strand_mode 0 forward, 1 reverse complement (the
// fallback pass over reads forward failed), 2 both (RC as fallback unless
// both_strands).  row/drow hold lp bytes, zero past len; mm gets lp mask
// bytes.
__device__ inline void gapless_read(const Index& ix, const Cfg& cfg,
                                    const Scratch& ws, const uint8_t* row,
                                    const uint8_t* drow, int32_t len_in,
                                    int32_t strand_mode, int32_t both_strands,
                                    uint8_t* mapped, int32_t* pos_out,
                                    uint8_t* rev_out, uint8_t* mm) {
    const int lp = cfg.lp;
    bool has_dege;
    const int32_t len = read_len(len_in, lp, drow, &has_dege);
    int32_t mis_f = kBig, pos_f = 0, mis_r = kBig, pos_r = 0;
    if (strand_mode != 1)
        one_strand(ix, cfg, ws, row, drow, len, &mis_f, &pos_f);
    // RC as fallback: when forward mapped, its RC result is unused
    const bool need_rc = strand_mode != 0 &&
        !(strand_mode == 2 && !both_strands && mis_f <= cfg.max_mis);
    if (need_rc) {
        reverse_complement(row, drow, len, lp, ws.rc, ws.rdege);
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
    *mapped = is_mapped;
    *pos_out = pos;
    *rev_out = use_rev && is_mapped;
    const uint8_t* eff =
        (strand_mode == 1 || (strand_mode == 2 && use_rev)) ? ws.rc : row;
    for (int i = 0; i < lp; i++)
        mm[i] = is_mapped && i < len &&
                eff[i] != ref_base(ix, (int64_t)(uint32_t)pos + i);
}

struct StrandRows {   // one strand's compare rows and prefix counts
    int32_t* E;       // (2G+1) x (lp+1)
    int32_t* F;       // lp+1: literal-vs-filler prefix counts
    uint8_t* cmp;     // (2G+1) x lp
    uint8_t* lit;     // lp
};

__host__ __device__ inline int64_t rows_bytes(int lp, int G) {
    const int64_t NG = 2 * G + 1;
    return align16(4 * NG * (lp + 1)) + align16(4 * (lp + 1))
           + align16(NG * lp) + align16(lp);
}

// Scratch of one indel_read: the seed search's, then a row slab a strand.
__host__ __device__ inline int64_t indel_scratch_bytes(const Cfg& cfg,
                                                       int G) {
    return seed_scratch_bytes(cfg) + 2 * rows_bytes(cfg.lp, G);
}

__device__ inline StrandRows strand_rows(uint8_t* base, int lp, int G) {
    const int64_t NG = 2 * G + 1;
    StrandRows r;
    r.E = reinterpret_cast<int32_t*>(base);
    base += align16(4 * NG * (lp + 1));
    r.F = reinterpret_cast<int32_t*>(base);
    base += align16(4 * (lp + 1));
    r.cmp = base;
    base += align16(NG * lp);
    r.lit = base;
    return r;
}

// strand_eval's outputs, as the decode splice reads them: shift gA past
// sA, then gB more past sB (sB = gB = 0 with one op); jb is segment 0's
// compare row, pg/sg the one-op rows the second pass starts from.
struct SRes {
    int32_t tot, sA, gA, sB, gB, po, jb, pg, sg;
};

__device__ inline SRes strand_eval(const Index& ix, const Cfg& cfg,
                                   const Scratch& ws, const StrandRows& rw,
                                   const uint8_t* c, const uint8_t* d,
                                   int32_t len, int G, int ops) {
    const int lp = cfg.lp, NG = 2 * G + 1;
    int32_t mis_g, posi;
    one_strand(ix, cfg, ws, c, d, len, &mis_g, &posi);
    const bool ok_b = posi >= 2 * G &&
                      (int64_t)posi + len + 2 * G <= ix.ref_len;
    for (int j = 0; j < NG; j++) {
        const int g = j - G;
        int32_t* Ej = rw.E + j * (lp + 1);
        uint8_t* cj = rw.cmp + j * lp;
        Ej[0] = 0;
        for (int i = 0; i < len; i++) {
            int64_t idx = (int64_t)posi + g + i;
            if (idx < 0) idx = 0;
            if (idx > ix.ref_len - 1) idx = ix.ref_len - 1;
            cj[i] = c[i] != ref_base(ix, idx);
            Ej[i + 1] = Ej[i] + cj[i];
        }
    }
    const int32_t* F = rw.F;
    rw.F[0] = 0;
    for (int i = 0; i < len; i++) {
        rw.lit[i] = c[i] != 0;
        rw.F[i + 1] = rw.F[i] + rw.lit[i];
    }
    const int32_t* E0 = rw.E + G * (lp + 1);
    SRes b{kBig, 0, 0, 0, 0, posi, 0, 0, 0};

    // tot[s] = pref[s] + (F[s+h] - F[s]) + (suf[len] - suf[s+h]) over
    // s in [0, len - h], first-occurrence argmin, strict-< chaining
    auto consider = [&](const int32_t* pref, const int32_t* suf, int h,
                        int32_t g_out, int32_t d_pos, int32_t pg,
                        int32_t sg) {
        int32_t tb = kBig, sb = 0;
        for (int32_t s = 0; s <= len - h; s++) {
            const int32_t tot = pref[s] + (F[s + h] - F[s])
                                + (suf[len] - suf[s + h]);
            if (tot < tb) {
                tb = tot;
                sb = s;
            }
        }
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
        const int32_t* Eg = rw.E + (g + G) * (lp + 1);
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
        const int32_t* Epg = rw.E + b.pg * (lp + 1);
        const int32_t* Esg = rw.E + b.sg * (lp + 1);
        const int32_t op1_lit = F[s1 + h1] - F[s1];
        // TAIL: a second op at s2 >= s1 + h1 moves the rest to row sg+g2
        const int32_t base_c = Epg[s1] + op1_lit - Esg[s1 + h1];
        int32_t tt = kBig, st = 0, gt = 0;
        for (int g2 = -G; g2 <= G; g2++) {
            if (g2 == 0) continue;
            const int j2 = b.sg + g2;
            if (j2 < 0 || j2 > 2 * G) continue;
            const int32_t* E2 = rw.E + j2 * (lp + 1);
            const int h2 = g2 < 0 ? -g2 : 0;
            for (int32_t s2 = s1 + h1; s2 <= len - h2; s2++) {
                const int32_t tot = base_c + Esg[s2] + (F[s2 + h2] - F[s2])
                                    + (E2[len] - E2[s2 + h2]);
                if (tot < tt) {
                    tt = tot;
                    st = s2;
                    gt = g2;
                }
            }
        }
        // HEAD: a new first op at s0 <= s1 - hh re-bases the prefix
        const int32_t tail_c = op1_lit + Esg[len] - Esg[s1 + h1] + Epg[s1];
        int32_t th = kBig, sh = 0, gh_sel = 0;
        for (int gh = -G; gh <= G; gh++) {
            if (gh == 0) continue;
            const int j0 = b.pg + gh;
            if (j0 < 0 || j0 > 2 * G) continue;
            const int32_t* Ej0 = rw.E + j0 * (lp + 1);
            const int hh = gh > 0 ? gh : 0;
            for (int32_t s0 = 0; s0 <= s1 - hh; s0++) {
                const int32_t tot = tail_c + Ej0[s0] + (F[s0 + hh] - F[s0])
                                    - Epg[s0 + hh];
                if (tot < th) {
                    th = tot;
                    sh = s0;
                    gh_sel = gh;
                }
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

// One read of K9 over ``scratch`` (indel_scratch_bytes(cfg, G) bytes):
// found, pos, the two ops (s1, g1, s2, g2), strand, and lp mask bytes in
// spliced-window coordinates.
__device__ inline void indel_read(const Index& ix, const Cfg& cfg,
                                  uint8_t* scratch, const uint8_t* row,
                                  const uint8_t* drow, int32_t len_in, int G,
                                  int ops, uint8_t* found_out,
                                  int32_t* pos_out, int32_t* split_out,
                                  int32_t* gap_out, int32_t* split2_out,
                                  int32_t* gap2_out, uint8_t* rev_out,
                                  uint8_t* mm) {
    const int lp = cfg.lp;
    bool has_dege;
    const int32_t len = read_len(len_in, lp, drow, &has_dege);
    const Scratch ws = seed_scratch(cfg, scratch);
    uint8_t* base = scratch + seed_scratch_bytes(cfg);
    const StrandRows rows_f = strand_rows(base, lp, G);
    const StrandRows rows_r = strand_rows(base + rows_bytes(lp, G), lp, G);

    const SRes f = strand_eval(ix, cfg, ws, rows_f, row, drow, len, G, ops);
    SRes rv{kBig, 0, 0, 0, 0, 0, 0, 0, 0};
    if (f.tot > 0) {       // tot_r < tot_f needs tot_f > 0
        reverse_complement(row, drow, len, lp, ws.rc, ws.rdege);
        rv = strand_eval(ix, cfg, ws, rows_r, ws.rc, ws.rdege, len, G, ops);
    }
    const bool use_rev = rv.tot < f.tot;
    const SRes& r = use_rev ? rv : f;
    const StrandRows& rr = use_rev ? rows_r : rows_f;
    const bool found = r.tot <= cfg.max_mis && !has_dege && len >= cfg.k;
    *found_out = found;
    *pos_out = r.po;
    *split_out = r.sA;
    *gap_out = r.gA;
    *split2_out = r.sB;
    *gap2_out = r.gB;
    *rev_out = use_rev && found;
    // spliced-window mask: rows jb, jb+gA, jb+gA+gB, literal filler over
    // the insertion ranges
    const int32_t hA = r.gA < 0 ? -r.gA : 0;
    const int32_t hB = r.gB < 0 ? -r.gB : 0;
    const uint8_t* r0 = rr.cmp + r.jb * lp;
    const uint8_t* r1 = rr.cmp + (r.jb + r.gA) * lp;
    const uint8_t* r2 = rr.cmp + (r.jb + r.gA + r.gB) * lp;
    for (int i = 0; i < lp; i++) {
        uint8_t v = 0;
        if (found && i < len) {
            if (i < r.sA) v = r0[i];
            else if (i < r.sA + hA) v = hA > 0 ? rr.lit[i] : r1[i];
            else if (i < r.sB) v = r1[i];
            else if (i < r.sB + hB) v = hB > 0 ? rr.lit[i] : r2[i];
            else v = r2[i];
        }
        mm[i] = v;
    }
}

}  // namespace fqa
