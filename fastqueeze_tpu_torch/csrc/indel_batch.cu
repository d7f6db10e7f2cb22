// K9 indel_batch: the indel tier (<= 2 gap operations a read), one warp a
// read.
//
// Replaces fastqueeze_tpu/align/hash.py _indel_batch (B12).  The per-read
// body is align_read.cuh's indel_read (which K14 shares): per strand K8's
// seed search for the anchor, the 2G+1 compare rows and their prefix
// counts, the split x gap scan over both anchorings, the greedy second op
// and the spliced-window mask, as native/alignhost.cpp fq_indel_batch
// decides.  The TPU version scores all (B, Lp+1) splits as dense vector
// ops; here the warp's lanes fill the rows 32 columns at a time and each
// split scan is a warp argmin, with the rows in the warp's shared slice
// at Lp 128 and in its global slab at the chunk tier's Lp 1024.  Bound by
// the anchor's seed search (random loads); the scoring is ~10^4 integer
// adds a read.

#include <cstdint>

#include <cuda_runtime.h>

#include "align_read.cuh"

namespace {

__global__ void indel_batch(fqa::Index ix, fqa::Cfg cfg,
                            const uint8_t* __restrict__ codes,
                            const uint8_t* __restrict__ dege,
                            const int32_t* __restrict__ lengths, int32_t B,
                            int32_t G, int32_t ops, uint8_t* scratch,
                            int64_t per, int64_t smem_warp,
                            uint8_t* __restrict__ found_out,
                            int32_t* __restrict__ pos_out,
                            int32_t* __restrict__ split_out,
                            int32_t* __restrict__ gap_out,
                            int32_t* __restrict__ split2_out,
                            int32_t* __restrict__ gap2_out,
                            uint8_t* __restrict__ rev_out,
                            uint8_t* __restrict__ mis_mask) {
    extern __shared__ __align__(16) uint8_t smem[];
    const int w = threadIdx.x >> 5;
    const int64_t b = (int64_t)blockIdx.x * fqa::kWarps + w;
    if (b >= B) return;
    const int64_t off = b * cfg.lp;
    const fqa::Ws ws = fqa::warp_ws(cfg, G, smem + w * smem_warp,
                                    scratch + b * per);
    fqa::indel_read(ix, cfg, ws, codes + off, dege + off, lengths[b], G, ops,
                    found_out + b, pos_out + b, split_out + b, gap_out + b,
                    split2_out + b, gap2_out + b, rev_out + b,
                    mis_mask + off);
}

}  // namespace

// A warp's global slab (bytes) for K9's cfg and G.
extern "C" int64_t fq_indel_scratch_bytes(int32_t k, int32_t stride,
                                          int32_t n_cand, int32_t max_mis,
                                          int32_t n_seeds, int32_t excl_bp,
                                          int32_t probe_k, int32_t lp,
                                          int32_t G) {
    const fqa::Cfg cfg{k, stride, n_cand, max_mis, n_seeds, excl_bp, probe_k,
                       lp};
    return fqa::make_layout(cfg, G).gmem;
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
    const int64_t sw = fqa::make_layout(cfg, G).smem;
    const int blocks = (B + fqa::kWarps - 1) / fqa::kWarps;
    indel_batch<<<blocks, 32 * fqa::kWarps, fqa::kWarps * sw,
                  static_cast<cudaStream_t>(stream)>>>(
        ix, cfg, codes, dege, lengths, B, G, ops, scratch, per, sw, found,
        pos, split, gap, split2, gap2, rev, mis_mask);
    return static_cast<int>(cudaGetLastError());
}
