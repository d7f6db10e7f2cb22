// K10 window_batch: the PE mate-rescue window, one warp per read, each
// lane on one residue class of the candidates.
//
// Replaces fastqueeze_tpu/align/hash.py _window_batch (B13, hash.py:797):
// a read whose interleaved mate mapped is verified at every reference
// offset in [center - C/2, center + C/2) on both strands; per strand the
// first-occurrence argmin of the mismatch count wins, the reverse strand
// only when strictly better; mapped = mis <= max_mis and no degenerate
// base; the mismatch mask is taken at the winning window.  The TPU
// version materialises the dense (B, C) count grid.
//
// A candidate cp meets the read in the reference's 16-base words at the
// shift 2 (cp & 15) (hash._read_in_ref_frame), so the read's frame words
// depend only on cp's residue mod 16.  Lane l takes the candidates with
// cp = l (mod 32), ascending: residue l & 15, the two lanes of a residue
// on alternate candidates.  Once a strand, a lane builds its W + 1 frame
// words of the read and of the validity mask (folded ahead to the low bit
// of each 2-bit slot) in registers (W <= 16; above, the 16 residues'
// words in shared memory); a candidate then costs, a frame word, one
// shared load of the staged reference word, XOR, the fold
// ((x | x >> 1) & m), popcount and add.
//
// Prologue: the row's codes and degenerate flags as 4-byte words, a
// lane's four codes packed into a byte, the 16-base words assembled by
// __shfl_xor_sync; the reverse-complement words from the forward ones
// (2-bit pairs reversed by __brev and a pair swap, funnel-shifted by
// Lp - len bases, complemented under the mask), with no second pass over
// the bytes; the window's reference words, (C + 15)/16 + W + 2 u32, in
// shared memory with coalesced loads.  A read with a degenerate base can
// never map, so its warp skips both scans.
//
// Exits (none changes a decision): the lanes step through the candidates
// in rounds of 32 consecutive positions, and after each round the warp's
// best count (__reduce_min_sync) bounds every later candidate, all of
// which lie further right, so a candidate stops once its partial count
// reaches that bound (frame word 1, 16 whole bases, read first, the test
// after 1, 3, 5, ... words) and the warp stops at a best of 0; the
// reverse scan starts bounded by the forward best and is skipped when
// that is 0 (the native mirror's exits, native/alignhost.cpp
// fq_window_batch).  Each lane works out once a strand which of its
// rounds hold a valid candidate.  A lane keeps the first candidate of its
// best count, and two __reduce_min_sync (the count, then the candidate
// among the lanes holding it) give the first-occurrence argmin.  The mask
// pass reads the winning window's bases from the staged window.
//
// Bound: integer operations, per frame word an XOR, a shift, a LOP3 and
// an add on the ALU and a popcount at a quarter of its rate, against
// (C + Lp)/4 bytes of reference a read; on an H100 at B = 4096, C =
// 1128, Lp = 128 it takes 0.036 ms, ~2x the full scan's operations and
// ~7x those of the words its inputs need (a round of 32 candidates waits
// for its slowest lane and carries ~20 instructions of control and the
// warp's reduction).  The first K10 (lane t on candidates t, t + 32, ...,
// each frame word built by two funnel shifts of the read and two of the
// mask from shared memory with a test a word; the read staged by 8 lanes
// with byte loads; the mask pass reading the reference from device
// memory) took 0.119-0.121 ms on the same shape.

#include <cstdint>

#include <cuda_runtime.h>

#include "check.cuh"

namespace {

constexpr int kWarps = 4;              // reads per block, at most
constexpr int32_t kBig = 1 << 28;      // hash._BIG: no valid candidate
constexpr uint32_t kFull = 0xffffffffu;
constexpr uint32_t kLow = 0x55555555u; // the low bit of every 2-bit slot

__device__ __forceinline__ int64_t floor16(int64_t v) {
    return v >= 0 ? v / 16 : -((-v + 15) / 16);
}

// The 2-bit pairs of x in reverse order.
__device__ __forceinline__ uint32_t reverse_pairs(uint32_t x) {
    const uint32_t y = __brev(x);
    return ((y >> 1) & kLow) | ((y & kLow) << 1);
}

// Four bytes at p (a 4-byte word where ``vec``, else four byte loads).
__device__ __forceinline__ uint32_t load4(const uint8_t* p, bool vec) {
    if (vec) return *reinterpret_cast<const uint32_t*>(p);
    return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16
           | uint32_t(p[3]) << 24;
}

// Word j (0 <= j <= W) of a read's MSB-first words w[0..W) shifted right
// by sh bits into a candidate's reference frame.
__device__ __forceinline__ uint32_t frame_word(const uint32_t* w, int j,
                                               int W, int sh) {
    const uint32_t lo = j < W ? w[j] : 0u;
    const uint32_t hi = j >= 1 && j <= W ? w[j - 1] : 0u;
    return __funnelshift_r(lo, hi, sh);
}

// One strand's scan over the candidates below bound0.  kW > 0: the frame
// words in registers (W <= kW, the words past W zero); kW == 0: in
// shared memory, word j of residue r at sf[16 j + r] (read) and
// sm[16 j + r] (mask, folded).  Returns the warp's first-occurrence
// minimum (mis, candidate index); mis = kBig where no candidate is
// below bound0.
template <int kW>
__device__ __forceinline__ void scan(const uint32_t* words,
                                     const uint32_t* mw, uint32_t* sf,
                                     uint32_t* sm, const uint32_t* win,
                                     int32_t nwin, int W, int64_t c0,
                                     int64_t base, int32_t len,
                                     int32_t ref_len, int32_t C,
                                     int32_t bound0, int lane,
                                     int32_t* mis, uint32_t* cand) {
    const int r = lane & 15;
    const int sh = 2 * r;
    constexpr int kR = kW > 0 ? kW + 1 : 1;
    uint32_t F[kR], M[kR];
    if constexpr (kW > 0) {
#pragma unroll
        for (int j = 0; j < kR; ++j) {
            F[j] = frame_word(words, j, W, sh);
            M[j] = frame_word(mw, j, W, sh) & kLow;
        }
    } else {
        // lanes 0-15 the read's words of residue r, lanes 16-31 the mask's
        __syncwarp();
        const uint32_t* src = lane < 16 ? words : mw;
        uint32_t* dst = lane < 16 ? sf : sm;
        const uint32_t keep = lane < 16 ? kFull : kLow;
        for (int j = 0; j <= W; ++j)
            dst[16 * j + r] = frame_word(src, j, W, sh) & keep;
        __syncwarp();
    }
    [[maybe_unused]] const int nj = kW > 0 ? kW : W;
    int32_t bound = bound0, best = kBig;
    uint32_t bj = 0xffffffffu;
    // this lane's candidates: cp = cp0 + 32 i, cp = lane (mod 32); the
    // rounds [ia, ib) hold those with cj < C, cp >= 0, cp + len <= ref_len
    const int32_t first = static_cast<int32_t>((lane - c0) & 31);
    const int64_t cp0 = c0 + first;
    const int64_t room = int64_t(ref_len) - len - cp0;
    const int32_t ia = cp0 >= 0 ? 0 : static_cast<int32_t>((31 - cp0) / 32);
    const int32_t ib = static_cast<int32_t>(min(
        int64_t(first < C ? (C - 1 - first) / 32 + 1 : 0),
        room >= 0 ? room / 32 + 1 : int64_t(0)));
    const uint32_t* rf = win + (floor16(cp0) - base);
    const int32_t rounds = (C + 31) >> 5;
    for (int32_t i = 0; i < rounds && bound > 0; ++i, rf += 2) {
        if (i >= ia && i < ib) {
            FQK_BOUND("window_batch", "win", rf - win, nwin);
            FQK_BOUND("window_batch", "win", rf - win + nj, nwin);
            // frame word 1 first (16 whole bases of a read of 32 or more),
            // then 0, 2, 3, ...; the exit tested after 1, 3, 5, ... words
            int32_t m = 0;
            if constexpr (kW > 0) {
#pragma unroll
                for (int p = 0; p < kR; ++p) {
                    const int j = p < 2 ? 1 - p : p;
                    const uint32_t x = F[j] ^ rf[j];
                    m += __popc((x | (x >> 1)) & M[j]);
                    if (!(p & 1) && m >= bound) break;
                }
            } else {
                for (int p = 0; p <= W; ++p) {
                    const int j = p < 2 ? 1 - p : p;
                    const uint32_t x = sf[16 * j + r] ^ rf[j];
                    m += __popc((x | (x >> 1)) & sm[16 * j + r]);
                    if (!(p & 1) && m >= bound) break;
                }
            }
            if (m < bound) {                 // below this lane's best too
                best = m;
                bj = static_cast<uint32_t>(first + 32 * i);
            }
        }
        bound = min(bound, static_cast<int32_t>(__reduce_min_sync(
                               kFull, static_cast<unsigned>(best))));
    }
    const int32_t wbest = static_cast<int32_t>(
        __reduce_min_sync(kFull, static_cast<unsigned>(best)));
    *mis = wbest;
    *cand = __reduce_min_sync(kFull, best == wbest ? bj : 0xffffffffu);
}

template <int kW>
__global__ void __launch_bounds__(kWarps * 32)
window_batch(const uint32_t* __restrict__ packed, int64_t nw,
             int32_t ref_len, const uint8_t* __restrict__ codes,
             const uint8_t* __restrict__ dege,
             const int32_t* __restrict__ lengths,
             const int32_t* __restrict__ centers, int32_t B, int32_t lp,
             int32_t C, int32_t max_mis, int32_t nwin, int32_t per_warp,
             bool vec, uint8_t* __restrict__ mapped,
             int32_t* __restrict__ pos_out, uint8_t* __restrict__ rev_out,
             uint8_t* __restrict__ mis_mask) {
    extern __shared__ uint32_t smem[];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int64_t b = int64_t(blockIdx.x) * (blockDim.x >> 5) + warp;
    if (b >= B) return;                        // the whole warp leaves
    const int W = lp >> 4;
    uint32_t* rw = smem + int64_t(warp) * per_warp;
    uint32_t* rr = rw + W;
    uint32_t* mw = rr + W;
    uint32_t* win = mw + W;
    uint32_t* sf = win + nwin;                 // kW == 0 only
    uint32_t* sm = sf + 16 * (W + 1);
    const uint8_t* row = codes + b * lp;
    const uint8_t* drow = dege + b * lp;
    int32_t len = lengths[b];
    len = len < 0 ? 0 : (len > lp ? lp : len);

    // the forward words and the mask: lane q of a round on bases
    // 4q..4q+3, four lanes a 16-base word
    const int nq = lp >> 2;
    bool dg = false;
    for (int q0 = 0; q0 < nq; q0 += 32) {
        const int q = q0 + lane;
        uint32_t v = 0, mv = 0;
        if (q < nq) {
            const int nv = min(max(len - 4 * q, 0), 4);
            const uint32_t keep = nv == 4 ? kFull : (1u << (8 * nv)) - 1u;
            const uint32_t x = load4(row + 4 * q, vec) & keep;
            dg |= (load4(drow + 4 * q, vec) & keep) != 0;
            const uint32_t p = ((x & 3u) << 6) | ((x >> 4) & 0x30u)
                               | ((x >> 14) & 0xCu) | ((x >> 24) & 3u);
            const int at = 8 * (3 - (lane & 3));
            v = p << at;
            mv = ((0xFF00u >> (2 * nv)) & 0xFFu) << at;
        }
        v |= __shfl_xor_sync(kFull, v, 1);
        v |= __shfl_xor_sync(kFull, v, 2);
        mv |= __shfl_xor_sync(kFull, mv, 1);
        mv |= __shfl_xor_sync(kFull, mv, 2);
        if ((lane & 3) == 0 && q < nq) {
            rw[q >> 2] = v;
            mw[q >> 2] = mv;
        }
    }
    const bool has_dege = __any_sync(kFull, dg);
    const int64_t c0 = static_cast<int64_t>(centers[b]) - C / 2;
    const int64_t base = floor16(c0);
    for (int i = lane; i < nwin; i += 32) {
        const int64_t gi = base + i;
        win[i] = (gi >= 0 && gi < nw) ? packed[gi] : 0u;
    }
    __syncwarp();
    // reverse complement: the pair-reversed words read from the end are
    // the read reversed at lp; it starts lp - len bases in
    const int D = lp - len, dq = D >> 4, dsh = 2 * (D & 15);
    for (int k = lane; k < W; k += 32) {
        const int a = k + dq;
        const uint32_t hi = a < W ? reverse_pairs(rw[W - 1 - a]) : 0u;
        const uint32_t lo = a + 1 < W ? reverse_pairs(rw[W - 2 - a]) : 0u;
        rr[k] = __funnelshift_l(lo, hi, dsh) ^ mw[k];
    }
    __syncwarp();

    int32_t mis_f = kBig, mis_r = kBig;
    uint32_t jf = 0xffffffffu, jr = 0xffffffffu;
    if (!has_dege) {
        scan<kW>(rw, mw, sf, sm, win, nwin, W, c0, base, len, ref_len, C,
                 kBig, lane, &mis_f, &jf);
        if (mis_f > 0)       // RC is observable only when strictly better
            scan<kW>(rr, mw, sf, sm, win, nwin, W, c0, base, len, ref_len,
                     C, mis_f, lane, &mis_r, &jr);
    }
    const bool use_rev = mis_r < mis_f;
    const int32_t mis = use_rev ? mis_r : mis_f;
    const uint32_t jb = use_rev ? jr : jf;
    const int64_t pos = mis >= kBig ? c0 : c0 + jb;
    const bool is_mapped = mis <= max_mis && !has_dege;

    // the mask, four bases a lane; the window's bases from the stage
    const uint32_t* ew = use_rev ? rr : rw;
    uint8_t* mm = mis_mask + b * lp;
    for (int q = lane; q < nq; q += 32) {
        uint32_t out = 0;
        if (is_mapped) {
#pragma unroll
            for (int t = 0; t < 4; ++t) {
                const int i = 4 * q + t;
                if (i < len) {
                    const uint32_t e =
                        (ew[i >> 4] >> (2 * (15 - (i & 15)))) & 3u;
                    const int64_t idx = pos + i;
                    FQK_BOUND("window_batch", "mask win", (idx >> 4) - base,
                              nwin);
                    const uint32_t rb = (win[(idx >> 4) - base]
                                         >> (2 * (15 - (idx & 15)))) & 3u;
                    out |= uint32_t(e != rb) << (8 * t);
                }
            }
        }
        if (vec) {
            *reinterpret_cast<uint32_t*>(mm + 4 * q) = out;
        } else {
#pragma unroll
            for (int t = 0; t < 4; ++t)
                mm[4 * q + t] = static_cast<uint8_t>(out >> (8 * t));
        }
    }
    if (lane == 0) {
        mapped[b] = is_mapped;
        pos_out[b] = static_cast<int32_t>(pos);
        rev_out[b] = use_rev && is_mapped;
    }
}

// The frame words' register bucket for W words: the smallest of
// lp_bucket's W <= 16 (align/hash.py) at or above W, else 0 (shared).
int frame_bucket(int W) {
    static constexpr int kBuckets[] = {2, 3, 4, 6, 8, 12, 16};
    for (int k : kBuckets)
        if (W <= k) return k;
    return 0;
}

template <int kW>
int launch(int warps, size_t smem, const uint32_t* packed, int64_t nw,
           int32_t ref_len, const uint8_t* codes, const uint8_t* dege,
           const int32_t* lengths, const int32_t* centers, int32_t B,
           int32_t lp, int32_t C, int32_t max_mis, int32_t nwin,
           int32_t per_warp, bool vec, uint8_t* mapped, int32_t* pos,
           uint8_t* rev, uint8_t* mis_mask, cudaStream_t st) {
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            window_batch<kW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const unsigned blocks = static_cast<unsigned>((B + warps - 1) / warps);
    window_batch<kW><<<blocks, warps * 32, smem, st>>>(
        packed, nw, ref_len, codes, dege, lengths, centers, B, lp, C,
        max_mis, nwin, per_warp, vec, mapped, pos, rev, mis_mask);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K10: B reads of (B, lp) u8 codes and bool degenerate flags, lp % 16 ==
// 0, lengths <= lp, window size C > 0, a non-empty reference.  Writes
// every output byte of every row.  One launch.
extern "C" int fq_window_batch_cuda(
    const uint32_t* packed, int64_t nw, int32_t ref_len, const uint8_t* codes,
    const uint8_t* dege, const int32_t* lengths, const int32_t* centers,
    int32_t B, int32_t lp, int32_t C, int32_t max_mis, uint8_t* mapped,
    int32_t* pos, uint8_t* rev, uint8_t* mis_mask, void* stream) {
    if (B < 0 || lp <= 0 || lp % 16 || C <= 0 || nw <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (B == 0) return 0;
    const int W = lp / 16;
    const int kW = frame_bucket(W);
    const int32_t nwin = (C + 15) / 16 + (kW ? kW : W) + 2;
    const int32_t per_warp = 3 * W + nwin + (kW ? 0 : 32 * (W + 1));
    int warps = kWarps;
    while (warps > 1 && size_t(warps) * per_warp * 4 > 227 * 1024) warps /= 2;
    const size_t smem = size_t(warps) * per_warp * sizeof(uint32_t);
    const bool vec = ((reinterpret_cast<uintptr_t>(codes)
                       | reinterpret_cast<uintptr_t>(dege)
                       | reinterpret_cast<uintptr_t>(mis_mask)) & 3) == 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FQ_WINDOW_LAUNCH(K)                                                  \
    return launch<K>(warps, smem, packed, nw, ref_len, codes, dege, lengths, \
                     centers, B, lp, C, max_mis, nwin, per_warp, vec,        \
                     mapped, pos, rev, mis_mask, st)
    switch (kW) {
        case 2: FQ_WINDOW_LAUNCH(2);
        case 3: FQ_WINDOW_LAUNCH(3);
        case 4: FQ_WINDOW_LAUNCH(4);
        case 6: FQ_WINDOW_LAUNCH(6);
        case 8: FQ_WINDOW_LAUNCH(8);
        case 12: FQ_WINDOW_LAUNCH(12);
        case 16: FQ_WINDOW_LAUNCH(16);
        default: FQ_WINDOW_LAUNCH(0);
    }
#undef FQ_WINDOW_LAUNCH
}
