// K14 rescue_indel_fused: the rescue tier and the indel tier in one
// launch, one warp a todo slot.
//
// Replaces fastqueeze_tpu/align/hash.py _rescue_indel_fused (B14).  The
// slots index a compacted todo list (idx, do) into one tier-1 batch's
// grids, which stay on the card; a slot whose do is false has length 0.
// The warp runs the multi-seed rescue (K8's gapless_read with cfg2,
// both strands with RC as the fallback unless both_strands) and, on the
// slots it did not map, the indel tier (K9's indel_read with cfg3, G and
// ops) on the same row, with no return to the host in between.  The two
// halves reuse one shared slice and one global slab a slot, each laid out
// for its own cfg.  A disabled half writes zeros, as the JAX function
// returns them; m2 is masked to do and f to do & ~m2.  Bound, like K8 and
// K9, by dependent random loads into the index, 32 in flight a slot; the
// fusion saves the host round trip and the second upload of the todo rows
// between the tiers, not device work.

#include <cstdint>

#include <cuda_runtime.h>

#include "align_read.cuh"

namespace {

__global__ void rescue_indel_fused(
    fqa::Index ix, fqa::Cfg cfg2, int32_t rescue, fqa::Cfg cfg3, int32_t G,
    int32_t ops, const uint8_t* __restrict__ codes,
    const uint8_t* __restrict__ dege, const int32_t* __restrict__ lengths,
    int32_t B, const int32_t* __restrict__ idx,
    const uint8_t* __restrict__ do_, int32_t cap, int32_t both_strands,
    uint8_t* scratch, int64_t per, int64_t smem_warp,
    uint8_t* __restrict__ m2, int32_t* __restrict__ p2,
    uint8_t* __restrict__ r2, uint8_t* __restrict__ mm2,
    uint8_t* __restrict__ f, int32_t* __restrict__ pi,
    int32_t* __restrict__ s1, int32_t* __restrict__ g1,
    int32_t* __restrict__ s2, int32_t* __restrict__ g2,
    uint8_t* __restrict__ ri, uint8_t* __restrict__ mmi) {
    extern __shared__ __align__(16) uint8_t smem[];
    const int w = threadIdx.x >> 5, lane = fqa::lane_id();
    const int64_t i = (int64_t)blockIdx.x * fqa::kWarps + w;
    if (i >= cap) return;
    const int lp = cfg3.lp;
    int32_t r = idx[i];                 // a gather clamps, as jnp's does
    r = r < 0 ? 0 : (r > B - 1 ? B - 1 : r);
    const bool on = do_[i] != 0;
    const uint8_t* row = codes + (int64_t)r * lp;
    const uint8_t* drow = dege + (int64_t)r * lp;
    const int32_t len = lengths[r];
    uint8_t* sl = smem + w * smem_warp;
    uint8_t* slab = scratch + i * per;
    uint8_t* mm2_i = mm2 + i * lp;
    uint8_t* mmi_i = mmi + i * lp;

    uint8_t hit = 0;
    if (rescue && on) {
        fqa::gapless_read(ix, cfg2, fqa::warp_ws(cfg2, 0, sl, slab), row,
                          drow, len, 2, both_strands, m2 + i, p2 + i, r2 + i,
                          mm2_i);
        __syncwarp();
        hit = m2[i];
    } else {
        if (lane == 0) {
            m2[i] = 0;
            p2[i] = 0;
            r2[i] = 0;
        }
        for (int j = lane; j < lp; j += 32) mm2_i[j] = 0;
    }
    if (ops > 0 && on && !hit) {
        fqa::indel_read(ix, cfg3, fqa::warp_ws(cfg3, G, sl, slab), row, drow,
                        len, G, ops, f + i, pi + i, s1 + i, g1 + i, s2 + i,
                        g2 + i, ri + i, mmi_i);
    } else {
        if (lane == 0) {
            f[i] = 0;
            pi[i] = s1[i] = g1[i] = s2[i] = g2[i] = 0;
            ri[i] = 0;
        }
        for (int j = lane; j < lp; j += 32) mmi_i[j] = 0;
    }
}

}  // namespace

extern "C" int fq_rescue_indel_fused_cuda(
    const void* keys, int32_t wide, int64_t nk, const int32_t* offsets,
    const int32_t* positions, int64_t npos, const uint32_t* packed,
    int64_t nw, const int32_t* l1, int32_t l1_shift, int32_t search_steps,
    int32_t ref_len, int32_t k2, int32_t stride2, int32_t n_cand2,
    int32_t max_mis2, int32_t n_seeds2, int32_t excl_bp2, int32_t probe_k2,
    int32_t lp2, int32_t rescue, int32_t k3, int32_t stride3,
    int32_t n_cand3, int32_t max_mis3, int32_t n_seeds3, int32_t excl_bp3,
    int32_t probe_k3, int32_t lp3, int32_t G, int32_t ops,
    const uint8_t* codes, const uint8_t* dege, const int32_t* lengths,
    int32_t B, const int32_t* idx, const uint8_t* do_, int32_t cap,
    int32_t both_strands, uint8_t* scratch, int64_t per, uint8_t* m2,
    int32_t* p2, uint8_t* r2, uint8_t* mm2, uint8_t* f, int32_t* pi,
    int32_t* s1, int32_t* g1, int32_t* s2, int32_t* g2, uint8_t* ri,
    uint8_t* mmi, void* stream) {
    const fqa::Index ix{keys, wide, nk, offsets, positions, npos, packed, nw,
                        l1, l1_shift, search_steps, ref_len};
    const fqa::Cfg cfg2{k2, stride2, n_cand2, max_mis2, n_seeds2, excl_bp2,
                        probe_k2, lp2};
    const fqa::Cfg cfg3{k3, stride3, n_cand3, max_mis3, n_seeds3, excl_bp3,
                        probe_k3, lp3};
    const int64_t sw2 = rescue ? fqa::make_layout(cfg2, 0).smem : 0;
    const int64_t sw3 = ops > 0 ? fqa::make_layout(cfg3, G).smem : 0;
    const int64_t sw = sw2 > sw3 ? sw2 : sw3;
    const int blocks = (cap + fqa::kWarps - 1) / fqa::kWarps;
    rescue_indel_fused<<<blocks, 32 * fqa::kWarps, fqa::kWarps * sw,
                         static_cast<cudaStream_t>(stream)>>>(
        ix, cfg2, rescue, cfg3, G, ops, codes, dege, lengths, B, idx, do_,
        cap, both_strands, scratch, per, sw, m2, p2, r2, mm2, f, pi, s1, g1,
        s2, g2, ri, mmi);
    return static_cast<int>(cudaGetLastError());
}
