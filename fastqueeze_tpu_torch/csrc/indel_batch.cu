// K9 indel_batch: the indel tier (<= 2 gap operations a read), one thread
// per read.
//
// Replaces fastqueeze_tpu/align/hash.py _indel_batch (B12).  Per strand
// it runs K8's seed search (seed_search.cuh) for the anchor -- the best
// gapless candidate, fallbacks included, since the reads here are the
// ones the gapless tiers failed -- then builds the 2G+1 compare rows of
// the read against the reference at shifts -G..+G with their exclusive
// prefix counts, scores every split x gap over both anchorings
// (variants gap ascending, A before B, strict-< chaining), runs the
// greedy TAIL and HEAD second op where one op cannot reach max_mis (head
// wins only if strictly better), and writes the spliced-window mask.
// The decisions follow native/alignhost.cpp fq_indel_batch step for step.
// The TPU version scores all (B, Lp+1) splits as dense vector ops; here
// each thread scans its read's splits in order, with the rows in a
// per-read global scratch slab (7 x 129 int32 at G = 3, Lp = 128, one
// slab a strand).  Bound by the anchor's seed search (random loads);
// the scoring is ~10^4 integer adds a read, from L1/L2.

#include <cstdint>

#include <cuda_runtime.h>

#include "seed_search.cuh"

namespace {

struct StrandRows {   // one strand's compare rows and prefix counts
    int32_t* E;       // (2G+1) x (lp+1)
    int32_t* F;       // lp+1: literal-vs-filler prefix counts
    uint8_t* cmp;     // (2G+1) x lp
    uint8_t* lit;     // lp
};

__host__ __device__ inline int64_t rows_bytes(int lp, int G) {
    const int64_t NG = 2 * G + 1;
    return fqa::align16(4 * NG * (lp + 1)) + fqa::align16(4 * (lp + 1))
           + fqa::align16(NG * lp) + fqa::align16(lp);
}

__device__ inline StrandRows strand_rows(uint8_t* base, int lp, int G) {
    const int64_t NG = 2 * G + 1;
    StrandRows r;
    r.E = reinterpret_cast<int32_t*>(base);
    base += fqa::align16(4 * NG * (lp + 1));
    r.F = reinterpret_cast<int32_t*>(base);
    base += fqa::align16(4 * (lp + 1));
    r.cmp = base;
    base += fqa::align16(NG * lp);
    r.lit = base;
    return r;
}

// strand_eval's outputs, as the decode splice reads them: shift gA past
// sA, then gB more past sB (sB = gB = 0 with one op); jb is segment 0's
// compare row, pg/sg the one-op rows the second pass starts from.
struct SRes {
    int32_t tot, sA, gA, sB, gB, po, jb, pg, sg;
};

__device__ SRes strand_eval(const fqa::Index& ix, const fqa::Cfg& cfg,
                            const fqa::Scratch& ws, const StrandRows& rw,
                            const uint8_t* c, const uint8_t* d, int32_t len,
                            int G, int ops) {
    const int lp = cfg.lp, NG = 2 * G + 1;
    int32_t mis_g, posi;
    fqa::one_strand(ix, cfg, ws, c, d, len, &mis_g, &posi);
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
            cj[i] = c[i] != fqa::ref_base(ix, idx);
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
    SRes b{fqa::kBig, 0, 0, 0, 0, posi, 0, 0, 0};

    // tot[s] = pref[s] + (F[s+h] - F[s]) + (suf[len] - suf[s+h]) over
    // s in [0, len - h], first-occurrence argmin, strict-< chaining
    auto consider = [&](const int32_t* pref, const int32_t* suf, int h,
                        int32_t g_out, int32_t d_pos, int32_t pg,
                        int32_t sg) {
        int32_t tb = fqa::kBig, sb = 0;
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
    if (!ok_b) b.tot = fqa::kBig;

    if (ops >= 2 && b.tot > cfg.max_mis && b.tot < fqa::kBig) {
        const int h1 = b.gA < 0 ? -b.gA : 0;
        const int32_t s1 = b.sA;
        const int32_t* Epg = rw.E + b.pg * (lp + 1);
        const int32_t* Esg = rw.E + b.sg * (lp + 1);
        const int32_t op1_lit = F[s1 + h1] - F[s1];
        // TAIL: a second op at s2 >= s1 + h1 moves the rest to row sg+g2
        const int32_t base_c = Epg[s1] + op1_lit - Esg[s1 + h1];
        int32_t tt = fqa::kBig, st = 0, gt = 0;
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
        int32_t th = fqa::kBig, sh = 0, gh_sel = 0;
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

__global__ void indel_batch(fqa::Index ix, fqa::Cfg cfg,
                            const uint8_t* __restrict__ codes,
                            const uint8_t* __restrict__ dege,
                            const int32_t* __restrict__ lengths, int32_t B,
                            int32_t G, int32_t ops, uint8_t* scratch,
                            int64_t per, uint8_t* __restrict__ found_out,
                            int32_t* __restrict__ pos_out,
                            int32_t* __restrict__ split_out,
                            int32_t* __restrict__ gap_out,
                            int32_t* __restrict__ split2_out,
                            int32_t* __restrict__ gap2_out,
                            uint8_t* __restrict__ rev_out,
                            uint8_t* __restrict__ mis_mask) {
    const int32_t b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const int lp = cfg.lp;
    const uint8_t* row = codes + (int64_t)b * lp;
    const uint8_t* drow = dege + (int64_t)b * lp;
    int32_t len = lengths[b];
    if (len > lp) len = lp;
    if (len < 0) len = 0;
    bool has_dege = false;
    for (int i = 0; i < len; i++) has_dege |= drow[i] != 0;
    uint8_t* base = scratch + b * per;
    const fqa::Scratch ws = fqa::seed_scratch(cfg, base);
    base += fqa::seed_scratch_bytes(cfg);
    const StrandRows rows_f = strand_rows(base, lp, G);
    const StrandRows rows_r = strand_rows(base + rows_bytes(lp, G), lp, G);

    const SRes f = strand_eval(ix, cfg, ws, rows_f, row, drow, len, G, ops);
    SRes rv{fqa::kBig, 0, 0, 0, 0, 0, 0, 0, 0};
    if (f.tot > 0) {       // tot_r < tot_f needs tot_f > 0
        fqa::reverse_complement(row, drow, len, lp, ws.rc, ws.rdege);
        rv = strand_eval(ix, cfg, ws, rows_r, ws.rc, ws.rdege, len, G, ops);
    }
    const bool use_rev = rv.tot < f.tot;
    const SRes& r = use_rev ? rv : f;
    const StrandRows& rr = use_rev ? rows_r : rows_f;
    const bool found = r.tot <= cfg.max_mis && !has_dege && len >= cfg.k;
    found_out[b] = found;
    pos_out[b] = r.po;
    split_out[b] = r.sA;
    gap_out[b] = r.gA;
    split2_out[b] = r.sB;
    gap2_out[b] = r.gB;
    rev_out[b] = use_rev && found;
    // spliced-window mask: rows jb, jb+gA, jb+gA+gB, literal filler over
    // the insertion ranges
    uint8_t* mm = mis_mask + (int64_t)b * lp;
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

}  // namespace

extern "C" int64_t fq_indel_scratch_bytes(int32_t k, int32_t stride,
                                          int32_t n_cand, int32_t max_mis,
                                          int32_t n_seeds, int32_t excl_bp,
                                          int32_t probe_k, int32_t lp,
                                          int32_t G) {
    const fqa::Cfg cfg{k, stride, n_cand, max_mis, n_seeds, excl_bp, probe_k,
                       lp};
    return fqa::seed_scratch_bytes(cfg) + 2 * rows_bytes(lp, G);
}

extern "C" int fq_indel_batch_cuda(
    const void* keys, int32_t wide, int64_t nk, const int32_t* offsets,
    const int32_t* positions, int64_t npos, const uint32_t* packed,
    int64_t nw, const int32_t* l1, int32_t l1_shift, int32_t search_steps,
    int32_t ref_len, int32_t k, int32_t stride, int32_t n_cand,
    int32_t max_mis, int32_t n_seeds, int32_t excl_bp, int32_t probe_k,
    int32_t lp, const uint8_t* codes, const uint8_t* dege,
    const int32_t* lengths, int32_t B, int32_t G, int32_t ops,
    uint8_t* scratch, int64_t per, uint8_t* found, int32_t* pos,
    int32_t* split, int32_t* gap, int32_t* split2, int32_t* gap2,
    uint8_t* rev, uint8_t* mis_mask, void* stream) {
    const fqa::Index ix{keys, wide, nk, offsets, positions, npos, packed, nw,
                        l1, l1_shift, search_steps, ref_len};
    const fqa::Cfg cfg{k, stride, n_cand, max_mis, n_seeds, excl_bp, probe_k,
                       lp};
    const int threads = 32;
    const int blocks = (B + threads - 1) / threads;
    indel_batch<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        ix, cfg, codes, dege, lengths, B, G, ops, scratch, per, found, pos,
        split, gap, split2, gap2, rev, mis_mask);
    return static_cast<int>(cudaGetLastError());
}
