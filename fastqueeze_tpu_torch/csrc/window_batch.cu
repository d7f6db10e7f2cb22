// K10 window_batch: the PE mate-rescue window, one warp per read.
//
// Replaces fastqueeze_tpu/align/hash.py _window_batch (B13, hash.py:797):
// a read whose interleaved mate mapped is verified at every reference
// offset in [center - C/2, center + C/2) on both strands; per strand the
// first-occurrence argmin of the mismatch count wins, the reverse strand
// only when strictly better; mapped = mis <= max_mis and no degenerate
// base; the mismatch mask is taken at the winning window.  The TPU
// version materialises the dense (B, C) count grid.  Here a warp stages
// its read (forward words, reverse-complement words, their common
// validity mask) and the window's reference words, (C + lp)/16 + 2 u32,
// in shared memory with coalesced loads; lane t verifies candidates t,
// t + 32, ... by funnel-shifting the read into each candidate's frame
// (XOR, AND with the mask, fold each 2-bit slot, popcount over the W + 1
// frame words), keeps the lexicographic minimum of (mis, candidate), and
// a __shfl_xor_sync reduction gives the warp's first-occurrence argmin.
//
// Bound: integer operations, 2 strands x C x (W + 1) frame words x ~12
// ops a read, against (C + lp)/4 bytes of reference it reads.  A lane
// stops a candidate once its partial count reaches the lane's best so far
// (the strict-< rule cannot pick it), the reverse scan starts bounded by
// the forward best and is skipped when that is 0: the native mirror's
// early exits (native/alignhost.cpp fq_window_batch), which change no
// decision.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;              // reads per block
constexpr int32_t kBig = 1 << 28;      // hash._BIG: no valid candidate

__device__ __forceinline__ int32_t mis2(uint32_t x) {
    return __popc((x | (x >> 1)) & 0x55555555u);
}

// Word j of a read (words w[0..W)) funnel-shifted right by sh bits into a
// candidate's reference frame (hash._read_in_ref_frame).
__device__ __forceinline__ uint32_t frame(const uint32_t* w, int j, int W,
                                          int sh) {
    uint32_t out = j < W ? w[j] >> sh : 0u;
    if (sh > 0 && j >= 1 && j <= W) out |= w[j - 1] << (32 - sh);
    return out;
}

__device__ __forceinline__ int64_t floor16(int64_t v) {
    return v >= 0 ? v / 16 : -((-v + 15) / 16);
}

// One strand's scan: returns (mis << 32) | candidate index of the warp's
// first-occurrence minimum, counting only candidates under bound0.
__device__ uint64_t scan(const uint32_t* rd, const uint32_t* mw,
                         const uint32_t* win, int64_t c0, int64_t base,
                         int32_t len, int32_t ref_len, int32_t C, int W,
                         int32_t bound0, int lane) {
    int32_t best = kBig;
    uint32_t bj = 0xffffffffu;
    for (int32_t cj = lane; cj < C; cj += 32) {
        const int64_t cp = c0 + cj;
        if (cp < 0 || cp + len > ref_len) continue;
        const int32_t bound = best < bound0 ? best : bound0;
        const int sh = 2 * static_cast<int>(cp & 15);
        const uint32_t* rf = win + ((cp >> 4) - base);
        int32_t m = 0;
        for (int j = 0; j <= W && m < bound; j++)
            m += mis2((frame(rd, j, W, sh) ^ rf[j]) & frame(mw, j, W, sh));
        if (m < bound) {
            best = m;
            bj = static_cast<uint32_t>(cj);
        }
    }
    uint64_t key = (static_cast<uint64_t>(static_cast<uint32_t>(best)) << 32)
                   | bj;
    for (int o = 16; o; o >>= 1) {
        const uint64_t other = __shfl_xor_sync(0xffffffffu, key, o);
        key = other < key ? other : key;
    }
    return key;
}

__global__ void window_batch(const uint32_t* __restrict__ packed, int64_t nw,
                             int32_t ref_len,
                             const uint8_t* __restrict__ codes,
                             const uint8_t* __restrict__ dege,
                             const int32_t* __restrict__ lengths,
                             const int32_t* __restrict__ centers, int32_t B,
                             int32_t lp, int32_t C, int32_t max_mis,
                             int32_t nwin, uint8_t* __restrict__ mapped,
                             int32_t* __restrict__ pos_out,
                             uint8_t* __restrict__ rev_out,
                             uint8_t* __restrict__ mis_mask) {
    extern __shared__ uint32_t smem[];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int32_t b = blockIdx.x * kWarps + warp;
    if (b >= B) return;                        // the whole warp leaves
    const int W = lp >> 4;
    uint32_t* rw = smem + warp * (3 * W + nwin);
    uint32_t* rr = rw + W;
    uint32_t* mw = rr + W;
    uint32_t* win = mw + W;
    const uint8_t* row = codes + static_cast<int64_t>(b) * lp;
    const uint8_t* drow = dege + static_cast<int64_t>(b) * lp;
    int32_t len = lengths[b];
    len = len < 0 ? 0 : (len > lp ? lp : len);
    bool dg = false;
    for (int i = lane; i < len; i += 32) dg |= drow[i] != 0;
    const bool has_dege = __any_sync(0xffffffffu, dg);

    for (int w = lane; w < W; w += 32) {
        uint32_t f = 0, r = 0, m = 0;
        for (int t = 0; t < 16; t++) {
            const int i = w * 16 + t;
            if (i < len) {
                const uint32_t sh = 2u * (15 - t);
                f |= static_cast<uint32_t>(row[i] & 3) << sh;
                r |= static_cast<uint32_t>(3 - (row[len - 1 - i] & 3)) << sh;
                m |= 3u << sh;
            }
        }
        rw[w] = f;
        rr[w] = r;
        mw[w] = m;
    }
    const int64_t c0 = static_cast<int64_t>(centers[b]) - C / 2;
    const int64_t base = floor16(c0);
    for (int i = lane; i < nwin; i += 32) {
        const int64_t gi = base + i;
        win[i] = (gi >= 0 && gi < nw) ? packed[gi] : 0u;
    }
    __syncwarp();

    const uint64_t kf = scan(rw, mw, win, c0, base, len, ref_len, C, W, kBig,
                             lane);
    const int32_t mis_f = static_cast<int32_t>(kf >> 32);
    uint64_t kr = static_cast<uint64_t>(kBig) << 32;
    if (mis_f > 0)       // RC is observable only when strictly better
        kr = scan(rr, mw, win, c0, base, len, ref_len, C, W, mis_f, lane);
    const int32_t mis_r = static_cast<int32_t>(kr >> 32);
    const bool use_rev = mis_r < mis_f;
    const int32_t mis = use_rev ? mis_r : mis_f;
    const uint32_t jb = static_cast<uint32_t>(use_rev ? kr : kf);
    const int64_t pos = mis >= kBig ? c0 : c0 + jb;
    const bool is_mapped = mis <= max_mis && !has_dege;

    uint8_t* mm = mis_mask + static_cast<int64_t>(b) * lp;
    for (int i = lane; i < lp; i += 32) {
        uint8_t v = 0;
        if (is_mapped && i < len) {
            const uint32_t e = use_rev ? 3u - (row[len - 1 - i] & 3)
                                       : static_cast<uint32_t>(row[i] & 3);
            const int64_t idx = pos + i;
            int64_t wi = idx >> 4;
            if (wi > nw - 1) wi = nw - 1;
            const uint32_t rb = (packed[wi] >> (2 * (15 - (idx & 15)))) & 3u;
            v = e != rb;
        }
        mm[i] = v;
    }
    if (lane == 0) {
        mapped[b] = is_mapped;
        pos_out[b] = static_cast<int32_t>(pos);
        rev_out[b] = use_rev && is_mapped;
    }
}

}  // namespace

extern "C" int fq_window_batch_cuda(
    const uint32_t* packed, int64_t nw, int32_t ref_len, const uint8_t* codes,
    const uint8_t* dege, const int32_t* lengths, const int32_t* centers,
    int32_t B, int32_t lp, int32_t C, int32_t max_mis, uint8_t* mapped,
    int32_t* pos, uint8_t* rev, uint8_t* mis_mask, void* stream) {
    const int W = lp / 16;
    const int32_t nwin = (C + 15) / 16 + W + 2;
    const size_t smem = static_cast<size_t>(kWarps) * (3 * W + nwin)
                        * sizeof(uint32_t);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            window_batch, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int blocks = (B + kWarps - 1) / kWarps;
    window_batch<<<blocks, kWarps * 32, smem,
                   static_cast<cudaStream_t>(stream)>>>(
        packed, nw, ref_len, codes, dege, lengths, centers, B, lp, C, max_mis,
        nwin, mapped, pos, rev, mis_mask);
    return static_cast<int>(cudaGetLastError());
}
