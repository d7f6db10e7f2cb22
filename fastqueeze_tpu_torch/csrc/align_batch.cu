// K8 align_batch: the gapless seed aligner, one warp a read.
//
// Replaces fastqueeze_tpu/align/hash.py _align_batch (B11), which runs
// _one_strand (seed_search.cuh) on the forward grid, the
// reverse-complement grid or both, picks the strand by the fallback or
// both-strand rule, and builds the mismatch mask of the mapped reads from
// the packed reference (the per-read body is align_read.cuh's
// gapless_read, which K14 shares).  The TPU version evaluates every
// candidate of every read as one dense (B, C) gather; here a warp walks
// its read's seeds and candidates 32 at a time and stops verifying where
// the argmin can no longer change (the native mirror's rules), so the deep
// rescue tier's 6,144 candidates cost only what a read needs.  Bound by
// dependent random loads into the index (~1 GB at 100 Mbp): the warp keeps
// 32 lookups, candidate loads or verifies in flight where one thread a
// read kept one; blocks of kWarps warps, each with its own shared slice.

#include <cstdint>

#include <cuda_runtime.h>

#include "align_read.cuh"

namespace {

__global__ void align_batch(fqa::Index ix, fqa::Cfg cfg,
                            const uint8_t* __restrict__ codes,
                            const uint8_t* __restrict__ dege,
                            const int32_t* __restrict__ lengths, int32_t B,
                            int32_t strand_mode, int32_t both_strands,
                            uint8_t* scratch, int64_t per, int64_t smem_warp,
                            uint8_t* __restrict__ mapped,
                            int32_t* __restrict__ pos_out,
                            uint8_t* __restrict__ rev_out,
                            uint8_t* __restrict__ mis_mask) {
    extern __shared__ __align__(16) uint8_t smem[];
    const int w = threadIdx.x >> 5;
    const int64_t b = (int64_t)blockIdx.x * fqa::kWarps + w;
    if (b >= B) return;
    const int64_t off = b * cfg.lp;
    const fqa::Ws ws = fqa::warp_ws(cfg, 0, smem + w * smem_warp,
                                    scratch + b * per);
    fqa::gapless_read(ix, cfg, ws, codes + off, dege + off, lengths[b],
                      strand_mode, both_strands, mapped + b, pos_out + b,
                      rev_out + b, mis_mask + off);
}

}  // namespace

// A warp's global slab (bytes) for K8's cfg.
extern "C" int64_t fq_align_scratch_bytes(int32_t k, int32_t stride,
                                          int32_t n_cand, int32_t max_mis,
                                          int32_t n_seeds, int32_t excl_bp,
                                          int32_t probe_k, int32_t lp) {
    const fqa::Cfg cfg{k, stride, n_cand, max_mis, n_seeds, excl_bp, probe_k,
                       lp};
    return fqa::make_layout(cfg, 0).gmem;
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
    const int64_t sw = fqa::make_layout(cfg, 0).smem;
    const int blocks = (B + fqa::kWarps - 1) / fqa::kWarps;
    align_batch<<<blocks, 32 * fqa::kWarps, fqa::kWarps * sw,
                  static_cast<cudaStream_t>(stream)>>>(
        ix, cfg, codes, dege, lengths, B, strand_mode, both_strands, scratch,
        per, sw, mapped, pos, rev, mis_mask);
    return static_cast<int>(cudaGetLastError());
}
