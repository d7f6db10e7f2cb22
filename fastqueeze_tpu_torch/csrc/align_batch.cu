// K8 align_batch: the gapless seed aligner, one thread per read.
//
// Replaces fastqueeze_tpu/align/hash.py _align_batch (B11), which runs
// _one_strand (seed_search.cuh) on the forward grid, the
// reverse-complement grid or both, picks the strand by the fallback or
// both-strand rule, and builds the mismatch mask of the mapped reads from
// the packed reference.  The TPU version evaluates every candidate of
// every read as one dense (B, C) gather; here a thread walks its read's
// list and stops where the argmin can no longer change (the native
// mirror's rules), so the deep rescue tier's 6,144 candidates cost only
// what a read needs.  Bound by dependent random loads into the index
// (~1 GB at 100 Mbp): 32-thread blocks spread the reads over every SM.

#include <cstdint>

#include <cuda_runtime.h>

#include "seed_search.cuh"

namespace {

__global__ void align_batch(fqa::Index ix, fqa::Cfg cfg,
                            const uint8_t* __restrict__ codes,
                            const uint8_t* __restrict__ dege,
                            const int32_t* __restrict__ lengths, int32_t B,
                            int32_t strand_mode, int32_t both_strands,
                            uint8_t* scratch, int64_t per,
                            uint8_t* __restrict__ mapped,
                            int32_t* __restrict__ pos_out,
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
    const fqa::Scratch ws = fqa::seed_scratch(cfg, scratch + b * per);

    int32_t mis_f = fqa::kBig, pos_f = 0, mis_r = fqa::kBig, pos_r = 0;
    if (strand_mode != 1)
        fqa::one_strand(ix, cfg, ws, row, drow, len, &mis_f, &pos_f);
    // RC as fallback: when forward mapped, its RC result is unused
    const bool need_rc = strand_mode != 0 &&
        !(strand_mode == 2 && !both_strands && mis_f <= cfg.max_mis);
    if (need_rc) {
        fqa::reverse_complement(row, drow, len, lp, ws.rc, ws.rdege);
        fqa::one_strand(ix, cfg, ws, ws.rc, ws.rdege, len, &mis_r, &pos_r);
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
    mapped[b] = is_mapped;
    pos_out[b] = pos;
    rev_out[b] = use_rev && is_mapped;
    uint8_t* mm = mis_mask + (int64_t)b * lp;
    const uint8_t* eff =
        (strand_mode == 1 || (strand_mode == 2 && use_rev)) ? ws.rc : row;
    for (int i = 0; i < lp; i++)
        mm[i] = is_mapped && i < len &&
                eff[i] != fqa::ref_base(ix, (int64_t)(uint32_t)pos + i);
}

}  // namespace

extern "C" int64_t fq_align_scratch_bytes(int32_t k, int32_t stride,
                                          int32_t n_cand, int32_t max_mis,
                                          int32_t n_seeds, int32_t excl_bp,
                                          int32_t probe_k, int32_t lp) {
    const fqa::Cfg cfg{k, stride, n_cand, max_mis, n_seeds, excl_bp, probe_k,
                       lp};
    return fqa::seed_scratch_bytes(cfg);
}

extern "C" int fq_align_batch_cuda(
    const void* keys, int32_t wide, int64_t nk, const int32_t* offsets,
    const int32_t* positions, int64_t npos, const uint32_t* packed,
    int64_t nw, const int32_t* l1, int32_t l1_shift, int32_t search_steps,
    int32_t ref_len, int32_t k, int32_t stride, int32_t n_cand,
    int32_t max_mis, int32_t n_seeds, int32_t excl_bp, int32_t probe_k,
    int32_t lp, const uint8_t* codes, const uint8_t* dege,
    const int32_t* lengths, int32_t B, int32_t strand_mode,
    int32_t both_strands, uint8_t* scratch, int64_t per, uint8_t* mapped,
    int32_t* pos, uint8_t* rev, uint8_t* mis_mask, void* stream) {
    const fqa::Index ix{keys, wide, nk, offsets, positions, npos, packed, nw,
                        l1, l1_shift, search_steps, ref_len};
    const fqa::Cfg cfg{k, stride, n_cand, max_mis, n_seeds, excl_bp, probe_k,
                       lp};
    const int threads = 32;
    const int blocks = (B + threads - 1) / threads;
    align_batch<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        ix, cfg, codes, dege, lengths, B, strand_mode, both_strands, scratch,
        per, mapped, pos, rev, mis_mask);
    return static_cast<int>(cudaGetLastError());
}
