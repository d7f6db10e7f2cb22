// K19 sharded_align: gapless multi-seed alignment against a k-mer index
// sharded by key range, u32 reference coordinates, one warp a read.
//
// Replaces fastqueeze_tpu/parallel/mesh.py align_blocks_index_sharded
// (B17), i.e. fastqueeze_tpu/align/hash.py _align_batch with
// _one_strand's shard_axis branch.  Shard d holds keys [d*nk/D,
// (d+1)*nk/D) of the counted CSR (parallel/mesh.shard_ref_index: u32
// (hi, lo) keys padded with 0xFFFFFFFF to a common kp, offsets, u32
// positions) and the whole 2-bit packed reference.  One entry point per
// phase; the collectives between them (pmin, pmax over the shards) are
// parallel/mesh.py's, since across cards they cross devices.  A launch
// runs its phase for every shard on the card (blockIdx.y a shard, the
// shards' equal-shaped arrays stacked), so a call makes 7 launches
// whatever the shard count; each phase runs one warp a (shard, read), 4
// reads a block:
//   (a) fq_sharded_lookup: the warp packs the read's effective strand
//       into 16-base words and its degenerate flags into 32-base bit
//       words once (a byte a lane, two __reduce_or_sync and a ballot per
//       32 bases), then lane l takes seeds l, l + 32, ... two at a time
//       side by side: each k-mer (narrow u32 or wide (hi, lo30)) is cut
//       from the words with one 64-bit funnel, its window's degenerate
//       bits tested with one mask, and a valid seed runs the binary
//       search of search_steps = ceil(log2(kp + 1)) dependent steps over
//       the shard's keys; occ (kBig where the shard has no hit or the
//       window is invalid), found, and the key index ii where found (0
//       elsewhere: only a found seed's ii is read).  Then pmin(occ).
//   (b) fq_sharded_candidates: the read's S global counts in the warp's
//       shared memory; each of n_seeds rounds takes the first-index
//       argmin as two __reduce_min_sync (the count, then the seed among
//       the lanes holding it), masks the +-excl_bp window (or the one
//       seed) lane by lane, and the owner shard's lanes write the C
//       positions positions[offsets[ii] + j] - seed_off (u32) coalesced,
//       j = lane, lane + 32, ...; 0 elsewhere; the in-range flags and the
//       round's owner bit.  Then pmax(cand), pmax(owner).
//   (c) fq_sharded_verify: the shard's slice [d*Cs, (d+1)*Cs) of the
//       candidate list padded to D*Cs, a lane a candidate, rounds of 32.
//       The read's frame words depend only on the candidate's residue
//       mod 16 (hash._read_in_ref_frame), so they are built once a read:
//       up to Lp 256 lane l keeps residue l & 15's W + 1 read and folded
//       mask words in registers and a lane takes its candidate's words
//       from lane (cand & 15) by __shfl_sync; above that the 16 residues'
//       words sit in shared memory.  cand_ok (in range, an owner, inside
//       the reference), the W + 1 word mismatch count (no probe
//       prefilter in this branch) with the reference words loaded side
//       by side, and the first-index argmin as two warp reductions.  Then
//       pmin(mis) and pmin(pos where mis is the global minimum, else
//       0xFFFFFFFF).
//   (d) fq_sharded_tail: _align_batch's strand choice, mapped, is_rev,
//       the degenerate test by __any_sync and the (B, Lp) mismatch mask
//       from u32 window positions, four bases a lane, stored 4 bytes at a
//       time.
// The reverse strand is read in place (base i <- 3 - codes[len - 1 - i])
// under each phase's rc flag.  Bound: chains of dependent random loads
// (search steps, CSR positions, reference words), 32 reads' worth of
// them in flight a warp.  The first K19 ran a thread a read in (b)-(d)
// (a serial argmin over S counts, the candidates stored at a stride of
// n_seeds * C words, the read's words in local-memory arrays, the mask a
// byte at a time at a stride of Lp) and built each k-mer in (a) with k
// byte loads, and a launch a phase and shard (25 launches a call at 4
// shards on one card).

#include <cstdint>

#include <cuda_runtime.h>

#include "check.cuh"

namespace {

constexpr int32_t kBig = 1 << 28;
constexpr int kWarps = 4;              // reads a block
constexpr int kMaxW = 64;              // Lp <= 1024
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr uint32_t kLow = 0x55555555u; // the low bit of every 2-bit slot

constexpr int kChunks = 4;             // 32-base chunks loaded at once
constexpr int kIlp = 4;                // binary searches a lane runs at once

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

__device__ __forceinline__ uint32_t ref_word(const uint32_t* packed,
                                             int64_t nw, int64_t w) {
    w = w < 0 ? 0 : (w > nw - 1 ? nw - 1 : w);
    return __ldg(packed + w);
}

// Base i of the read's effective strand (the reverse complement is zero
// past the length, as kernels._rc_grid clamps its index), and its
// degenerate flag.
__device__ __forceinline__ uint32_t eff_code(const uint8_t* row, int32_t Lp,
                                             int32_t len, int i, int rc) {
    if (!rc) return row[i];
    const int j = min(max(len - 1 - i, 0), Lp - 1);
    return i < len ? 3u - row[j] : 0u;
}

__device__ __forceinline__ bool eff_dege(const uint8_t* drow, int32_t Lp,
                                         int32_t len, int i, int rc) {
    if (!rc) return drow[i] != 0;
    const int j = min(max(len - 1 - i, 0), Lp - 1);
    return i < len && drow[j] != 0;
}

// The warp's words of the read's effective strand: cw[w] holds bases
// 16w .. 16w + 15 MSB-first (2 bits each, every base of the row), dw[w]
// the degenerate flags of bases 32w .. 32w + 31 (bit i & 31; dw may be
// null); cw and dw get two zero words past the row.
__device__ __forceinline__ void read_words(const uint8_t* row,
                                           const uint8_t* drow, int32_t Lp,
                                           int32_t len, int rc,
                                           uint32_t* cw, uint32_t* dw) {
    const int lane = lane_id();
    const int W = Lp >> 4;
    for (int i1 = 0; i1 < Lp; i1 += 32 * kChunks) {
        // the bytes of kChunks chunks loaded side by side, then packed
        uint32_t c[kChunks];
        bool g[kChunks];
#pragma unroll
        for (int u = 0; u < kChunks; ++u) {
            const int i = i1 + 32 * u + lane;
            c[u] = i < Lp ? eff_code(row, Lp, len, i, rc) : 0u;
            g[u] = dw != nullptr && i < Lp
                   && eff_dege(drow, Lp, len, i, rc);
        }
#pragma unroll
        for (int u = 0; u < kChunks; ++u) {
            const int i0 = i1 + 32 * u;
            if (i0 >= Lp) break;
            const uint32_t a = __reduce_or_sync(
                kFull, lane < 16 ? c[u] << (2 * (15 - lane)) : 0u);
            const uint32_t b = __reduce_or_sync(
                kFull, lane >= 16 ? c[u] << (2 * (31 - lane)) : 0u);
            const uint32_t d = __ballot_sync(kFull, g[u]);
            if (lane == 0) {
                cw[i0 >> 4] = a;
                cw[(i0 >> 4) + 1] = b;
                if (dw != nullptr) dw[i0 >> 5] = d;
            }
        }
    }
    __syncwarp();
    if (lane < 2) {
        cw[W + lane] = 0u;
        if (dw != nullptr) dw[((Lp + 31) >> 5) + lane] = 0u;
    }
    __syncwarp();
}

// --- (a) lookup --------------------------------------------------------------

constexpr int kCw = kMaxW + 3;         // a warp's code words
constexpr int kDw = kMaxW / 2 + 2;     // a warp's degenerate bit words

__global__ void __launch_bounds__(kWarps * 32)
lookup(const uint8_t* __restrict__ codes, const uint8_t* __restrict__ dege,
       const int32_t* __restrict__ lengths, int32_t B, int32_t Lp, int32_t k,
       int32_t stride, int32_t S, int32_t rc, int32_t wide,
       const uint32_t* __restrict__ keys_hi,
       const uint32_t* __restrict__ keys_lo,
       const int32_t* __restrict__ offsets, int64_t nk, int32_t steps,
       int32_t* __restrict__ occ, uint8_t* __restrict__ found,
       int32_t* __restrict__ ii) {
    __shared__ uint32_t s_cw[kWarps][kCw];
    __shared__ uint32_t s_dw[kWarps][kDw];
    const int warp = threadIdx.x >> 5;
    const int lane = lane_id();
    const int64_t r = int64_t(blockIdx.x) * kWarps + warp;
    if (r >= B) return;                    // the whole warp leaves
    // shard blockIdx.y of the launch's shards: its keys and outputs
    const int64_t d = blockIdx.y;
    keys_hi += d * nk;
    keys_lo += d * nk;
    offsets += d * (nk + 1);
    occ += d * B * S;
    found += d * B * S;
    ii += d * B * S;
    const int32_t len = lengths[r];
    uint32_t* cw = s_cw[warp];
    uint32_t* dw = s_dw[warp];
    read_words(codes + r * Lp, dege + r * Lp, Lp, len, rc, cw, dw);
    const uint64_t kmask = (uint64_t(1) << k) - 1;
    for (int32_t s0 = lane; s0 < S; s0 += 32 * kIlp) {
        // kIlp seeds side by side: s0, s0 + 32, ...
        int64_t lo[kIlp], hi[kIlp];
        uint32_t qh[kIlp], ql[kIlp];
        bool ok[kIlp];
#pragma unroll
        for (int u = 0; u < kIlp; ++u) {
            const int32_t s = s0 + 32 * u;
            const int32_t q = s * stride;
            ok[u] = s < S && q <= len - k;
            uint64_t v = 0;
            if (s < S) {
                const int wi = q >> 4, o = q & 15;
                const uint64_t w2 = (uint64_t(cw[wi]) << 32) | cw[wi + 1];
                const uint64_t x = o ? (w2 << (2 * o))
                                           | (cw[wi + 2] >> (32 - 2 * o))
                                     : w2;
                v = x >> (64 - 2 * k);
                const int di = q >> 5, db = q & 31;
                const uint64_t dg = ((uint64_t(dw[di + 1]) << 32) | dw[di])
                                    >> db;
                ok[u] = ok[u] && (dg & kmask) == 0;
            }
            qh[u] = wide ? static_cast<uint32_t>(v >> 30)
                         : static_cast<uint32_t>(v);
            ql[u] = static_cast<uint32_t>(v & 0x3FFFFFFFu);
            lo[u] = 0;
            hi[u] = ok[u] ? nk : 0;        // an invalid seed searches nothing
        }
        for (int t = 0; t < steps; ++t) {
            // every search's keys loaded first (a settled or empty search
            // rereads a cached key), then the steps
            uint32_t kh[kIlp], kl[kIlp];
#pragma unroll
            for (int u = 0; u < kIlp; ++u) {
                const int64_t mid = (lo[u] + hi[u]) >> 1;
                const int64_t m = mid < nk - 1 ? mid : nk - 1;
                kh[u] = __ldg(keys_hi + m);
                kl[u] = wide ? __ldg(keys_lo + m) : 0u;
            }
#pragma unroll
            for (int u = 0; u < kIlp; ++u) {
                const bool active = lo[u] < hi[u];
                const int64_t mid = (lo[u] + hi[u]) >> 1;
                const bool less =
                    kh[u] < qh[u] || (wide && kh[u] == qh[u] && kl[u] < ql[u]);
                if (active && less) lo[u] = mid + 1;
                if (active && !less) hi[u] = mid;
            }
        }
#pragma unroll
        for (int u = 0; u < kIlp; ++u) {
            const int32_t s = s0 + 32 * u;
            if (s >= S) continue;
            bool f = false;
            int64_t i2 = 0;
            if (ok[u]) {
                i2 = lo[u] < nk - 1 ? lo[u] : nk - 1;
                bool eq = __ldg(keys_hi + i2) == qh[u];
                if (wide) eq = eq && __ldg(keys_lo + i2) == ql[u];
                f = eq && lo[u] < nk;
            }
            const int64_t g = r * S + s;
            occ[g] = f ? __ldg(offsets + i2 + 1) - __ldg(offsets + i2) : kBig;
            found[g] = f;
            ii[g] = f ? static_cast<int32_t>(i2) : 0;
        }
    }
}

// --- (b) candidates ----------------------------------------------------------

__global__ void __launch_bounds__(kWarps * 32)
candidates(const int32_t* __restrict__ occ, int32_t B, int32_t S,
           int32_t stride, const uint8_t* __restrict__ found,
           const int32_t* __restrict__ ii,
           const int32_t* __restrict__ offsets, int64_t nk,
           const uint32_t* __restrict__ positions, int64_t npos,
           int32_t n_seeds, int32_t C, int32_t excl_bp,
           uint32_t* __restrict__ cand, uint8_t* __restrict__ in_range,
           uint8_t* __restrict__ owner) {
    extern __shared__ uint32_t s_occ[];
    const int warp = threadIdx.x >> 5;
    const int lane = lane_id();
    const int64_t r = int64_t(blockIdx.x) * kWarps + warp;
    if (r >= B) return;
    const int64_t tot = int64_t(n_seeds) * C;
    // shard blockIdx.y of the launch's shards: its found / ii, its CSR
    // and its outputs; the counts are the global ones
    const int64_t d = blockIdx.y;
    found += d * B * S;
    ii += d * B * S;
    offsets += d * (nk + 1);
    positions += d * npos;
    cand += d * B * tot;
    in_range += d * B * tot;
    owner += d * B * n_seeds;
    // the read's counts and, a seed the shard found, its key index (-1
    // where not found), staged once
    uint32_t* o = s_occ + int64_t(warp) * 2 * S;
    int32_t* fi = reinterpret_cast<int32_t*>(o + S);
    for (int32_t s = lane; s < S; s += 32) {
        o[s] = static_cast<uint32_t>(occ[r * S + s]);
        fi[s] = found[r * S + s] ? ii[r * S + s] : -1;
    }
    __syncwarp();
    for (int32_t round = 0; round < n_seeds; ++round) {
        uint32_t best = kFull, bs = kFull;
        for (int32_t s = lane; s < S; s += 32) {
            const uint32_t v = o[s];
            if (v < best) {
                best = v;
                bs = static_cast<uint32_t>(s);
            }
        }
        const uint32_t gmin = __reduce_min_sync(kFull, best);
        const int32_t jb = static_cast<int32_t>(
            __reduce_min_sync(kFull, best == gmin ? bs : kFull));
        const int32_t pb = jb * stride;
        const int32_t key = fi[jb];
        __syncwarp();
        if (excl_bp > 0) {
            for (int32_t s = lane; s < S; s += 32) {
                const int32_t dpos = s * stride - pb;
                if ((dpos < 0 ? -dpos : dpos) <= excl_bp) o[s] = kBig;
            }
        } else if (lane == (jb & 31)) {
            o[jb] = kBig;
        }
        __syncwarp();
        const bool own = key >= 0;
        const int64_t base = own ? __ldg(offsets + key) : 0;
        const int32_t lim = min(static_cast<int32_t>(gmin), C);
        const int64_t row = r * tot + int64_t(round) * C;
        for (int32_t j = lane; j < C; j += 32) {
            uint32_t cv = 0;
            if (own) {
                int64_t p = base + j;
                p = p < 0 ? 0 : (p > npos - 1 ? npos - 1 : p);
                cv = __ldg(positions + p) - static_cast<uint32_t>(pb);
            }
            cand[row + j] = cv;
            in_range[row + j] = j < lim;
        }
        if (lane == 0) owner[r * n_seeds + round] = own;
    }
}

// --- (c) verify --------------------------------------------------------------

// Word j (0 <= j <= W) of a read's MSB-first words w[0..W) shifted right
// by sh bits into a candidate's reference frame.
__device__ __forceinline__ uint32_t frame_word(const uint32_t* w, int j,
                                               int W, int sh) {
    const uint32_t lo = j < W ? w[j] : 0u;
    const uint32_t hi = j >= 1 && j <= W ? w[j - 1] : 0u;
    return __funnelshift_r(lo, hi, sh);
}

__device__ __forceinline__ int mis_word(uint32_t f, uint32_t m,
                                        uint32_t refw) {
    const uint32_t x = f ^ refw;
    return __popc((x | (x >> 1)) & m);
}

// kW > 0: the frame words in registers (W <= kW), lane l holding residue
// l & 15's; kW == 0: the 16 residues' words in shared memory, word j of
// residue r at sf[16 j + r] (read) and sm[16 j + r] (mask, folded).
template <int kW>
__global__ void __launch_bounds__(kWarps * 32)
verify(const uint8_t* __restrict__ codes,
       const int32_t* __restrict__ lengths, int32_t B, int32_t Lp,
       int32_t rc, const uint32_t* __restrict__ cand,
       const uint8_t* __restrict__ in_range,
       const uint8_t* __restrict__ owner, int32_t n_seeds, int32_t C,
       uint32_t ref_len, int64_t c0, int32_t Cs,
       const uint32_t* __restrict__ packed, int64_t nw,
       int32_t* __restrict__ mis_out, uint32_t* __restrict__ pos_out) {
    extern __shared__ uint32_t smem[];
    const int warp = threadIdx.x >> 5;
    const int lane = lane_id();
    const int64_t r = int64_t(blockIdx.x) * kWarps + warp;
    if (r >= B) return;
    // shard blockIdx.y of the launch's shards: its slice of the list
    c0 += int64_t(blockIdx.y) * Cs;
    mis_out += int64_t(blockIdx.y) * B;
    pos_out += int64_t(blockIdx.y) * B;
    const int W = Lp >> 4;
    const int per_warp = 2 * (W + 3) + (kW > 0 ? 0 : 32 * (W + 1));
    uint32_t* rw = smem + int64_t(warp) * per_warp;
    uint32_t* mw = rw + W + 3;
    const int32_t len = lengths[r];
    read_words(codes + r * Lp, nullptr, Lp, len, rc, rw, nullptr);
    for (int w = lane; w < W; w += 32) {
        const int nv = min(max(len - 16 * w, 0), 16);
        const uint32_t m = nv == 16 ? kFull
                                    : (nv == 0 ? 0u : ~(kFull >> (2 * nv)));
        mw[w] = m;
        rw[w] &= m;
    }
    __syncwarp();
    const int res = lane & 15;
    constexpr int kR = kW > 0 ? kW + 1 : 1;
    uint32_t F[kR], M[kR];
    uint32_t* sf = mw + W + 3;
    uint32_t* sm = sf + 16 * (W + 1);
    if constexpr (kW > 0) {
#pragma unroll
        for (int j = 0; j < kR; ++j) {
            F[j] = j <= W ? frame_word(rw, j, W, 2 * res) : 0u;
            M[j] = j <= W ? frame_word(mw, j, W, 2 * res) & kLow : 0u;
        }
    } else {
        // lanes 0-15 the read's words of residue r, lanes 16-31 the mask's
        const uint32_t* src = lane < 16 ? rw : mw;
        uint32_t* dst = lane < 16 ? sf : sm;
        const uint32_t keep = lane < 16 ? kFull : kLow;
        for (int j = 0; j <= W; ++j)
            dst[16 * j + res] = frame_word(src, j, W, 2 * res) & keep;
        __syncwarp();
    }
    // cand_ok: in range, a shard owns the round's seed, the read fits and
    // the window ends inside the reference (u32: an underflowed start
    // wraps past ref_len - len); columns past the list are padding
    const int64_t stot = int64_t(n_seeds) * C;
    const uint32_t ulen = static_cast<uint32_t>(len);
    const bool fits = ulen <= ref_len;
    const uint32_t max_start = ref_len - ulen;
    uint32_t best = kFull, bc = kFull, bpos = 0;
    for (int32_t c1 = 0; c1 < Cs; c1 += 32) {
        const int32_t c = c1 + lane;
        const int64_t col = c0 + c;
        uint32_t cv = 0;
        bool ok = false;
        if (c < Cs && col < stot) {
            const int64_t idx = r * stot + col;
            cv = cand[idx];
            ok = in_range[idx] && owner[r * n_seeds + col / C] && fits
                 && cv <= max_start;
        }
        const int64_t w0 = static_cast<int64_t>(cv >> 4);
        const int cr = static_cast<int>(cv & 15u);
        int32_t mis = 0;
        if constexpr (kW > 0) {
            uint32_t refw[kR];
#pragma unroll
            for (int j = 0; j < kR; ++j)
                refw[j] = ok && j <= W ? ref_word(packed, nw, w0 + j) : 0u;
#pragma unroll
            for (int j = 0; j < kR; ++j) {
                // every lane shuffles (a full-warp exchange), then counts
                const uint32_t f = __shfl_sync(kFull, F[j], cr);
                const uint32_t m = __shfl_sync(kFull, M[j], cr);
                mis += mis_word(f, m, refw[j]);
            }
        } else if (ok) {
            constexpr int kU = 8;
            for (int j0 = 0; j0 <= W; j0 += kU) {
                uint32_t refw[kU];
#pragma unroll
                for (int u = 0; u < kU; ++u)
                    refw[u] = j0 + u <= W ? ref_word(packed, nw, w0 + j0 + u)
                                          : 0u;
#pragma unroll
                for (int u = 0; u < kU; ++u) {
                    const int j = j0 + u;
                    if (j <= W)
                        mis += mis_word(sf[16 * j + cr], sm[16 * j + cr],
                                        refw[u]);
                }
            }
        }
        const uint32_t mv = ok ? static_cast<uint32_t>(mis)
                               : static_cast<uint32_t>(kBig);
        if (c < Cs && mv < best) {
            best = mv;
            bc = static_cast<uint32_t>(c);
            bpos = cv;
        }
    }
    const uint32_t gmin = __reduce_min_sync(kFull, best);
    const uint32_t cb = __reduce_min_sync(kFull, best == gmin ? bc : kFull);
    const uint32_t pos = __shfl_sync(kFull, bpos, cb & 31);
    if (lane == 0) {
        mis_out[r] = static_cast<int32_t>(gmin);
        pos_out[r] = pos;
    }
}

// --- (d) tail ------------------------------------------------------------------

__global__ void __launch_bounds__(kWarps * 32)
tail(const uint8_t* __restrict__ codes, const uint8_t* __restrict__ dege,
     const int32_t* __restrict__ lengths, int32_t B, int32_t Lp,
     int32_t mode, int32_t both_strands, int32_t max_mis, int32_t k,
     const int32_t* __restrict__ mis_f, const uint32_t* __restrict__ pos_f,
     const int32_t* __restrict__ mis_r, const uint32_t* __restrict__ pos_r,
     const uint32_t* __restrict__ packed, int64_t nw, bool vec,
     uint8_t* __restrict__ mapped, uint32_t* __restrict__ pos,
     uint8_t* __restrict__ rev, uint8_t* __restrict__ mask) {
    const int warp = threadIdx.x >> 5;
    const int lane = lane_id();
    const int64_t r = int64_t(blockIdx.x) * kWarps + warp;
    if (r >= B) return;
    const uint8_t* row = codes + r * Lp;
    const uint8_t* drow = dege + r * Lp;
    const int32_t len = lengths[r];
    bool dg = false;
    for (int i = lane; i < Lp && i < len; i += 32) dg |= drow[i] != 0;
    const bool has_dege = __any_sync(kFull, dg);
    bool use_rev;
    int32_t mis;
    uint32_t p;
    if (mode == 0) {
        use_rev = false;
        mis = mis_f[r];
        p = pos_f[r];
    } else if (mode == 1) {
        use_rev = mis_r[r] <= max_mis;
        mis = mis_r[r];
        p = pos_r[r];
    } else {
        use_rev = both_strands ? mis_r[r] < mis_f[r] : mis_f[r] > max_mis;
        mis = use_rev ? mis_r[r] : mis_f[r];
        p = use_rev ? pos_r[r] : pos_f[r];
    }
    const bool mp = mis <= max_mis && !has_dege && len >= k;
    const int rcs = mode == 1 || (mode == 2 && use_rev);
    uint8_t* mm = mask + r * Lp;
    for (int q = lane; q < (Lp >> 2); q += 32) {
        uint32_t out = 0;
        if (mp) {
#pragma unroll
            for (int t = 0; t < 4; ++t) {
                const int i = 4 * q + t;
                if (i < len) {
                    const uint32_t idx = p + static_cast<uint32_t>(i);
                    const uint32_t w = ref_word(packed, nw, idx >> 4);
                    const uint32_t refc = (w >> (2u * (15 - (idx & 15u))))
                                          & 3u;
                    out |= uint32_t(eff_code(row, Lp, len, i, rcs) != refc)
                           << (8 * t);
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
        mapped[r] = mp;
        pos[r] = p;
        rev[r] = use_rev && mp;
    }
}

inline unsigned blocks_of(int64_t B) {
    return static_cast<unsigned>((B + kWarps - 1) / kWarps);
}

template <int kW>
int launch_verify(size_t smem, int32_t nshards, cudaStream_t st,
                  const uint8_t* codes,
                  const int32_t* lengths, int32_t B, int32_t Lp, int32_t rc,
                  const uint32_t* cand, const uint8_t* in_range,
                  const uint8_t* owner, int32_t n_seeds, int32_t C,
                  uint32_t ref_len, int64_t c0, int32_t Cs,
                  const uint32_t* packed, int64_t nw, int32_t* mis,
                  uint32_t* pos) {
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            verify<kW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    verify<kW><<<dim3(blocks_of(B), nshards), kWarps * 32, smem, st>>>(
        codes, lengths, B, Lp, rc, cand, in_range, owner, n_seeds, C,
        ref_len, c0, Cs, packed, nw, mis, pos);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry point runs the phase for nshards shards at once, shard d
// on blockIdx.y = d: the shards' index arrays stacked with the strides
// of equal shards (keys kp, offsets kp + 1, positions npos) and their
// outputs stacked (d, B, ...); one shard is nshards = 1.

// (a) codes, dege: (B, Lp) u8, lengths (B,) i32 -> occ (nshards, B, S)
// i32, found (nshards, B, S) u8, ii (nshards, B, S) i32 (0 where not
// found) over each shard's keys (kp entries).
extern "C" int fq_sharded_lookup(
        const uint8_t* codes, const uint8_t* dege, const int32_t* lengths,
        int32_t B, int32_t Lp, int32_t k, int32_t stride, int32_t S,
        int32_t rc, int32_t wide, const uint32_t* keys_hi,
        const uint32_t* keys_lo, const int32_t* offsets, int64_t kp,
        int32_t steps, int32_t nshards, int32_t* occ, uint8_t* found,
        int32_t* ii, void* stream) {
    if (B <= 0 || S <= 0) return 0;
    if (Lp % 16 || Lp > 16 * kMaxW || k < 1 || k > 31 || kp < 1
        || stride < 1 || (S - 1) * stride + k > Lp || nshards < 1
        || nshards > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    lookup<<<dim3(blocks_of(B), nshards), kWarps * 32, 0,
             static_cast<cudaStream_t>(stream)>>>(
        codes, dege, lengths, B, Lp, k, stride, S, rc, wide, keys_hi,
        keys_lo, offsets, kp, steps, occ, found, ii);
    return static_cast<int>(cudaGetLastError());
}

// (b) occ: (B, S) i32 global counts, found / ii (nshards, B, S) ->
// cand (nshards, B, n_seeds * C) u32, in_range (nshards, B, n_seeds * C)
// u8, owner (nshards, B, n_seeds) u8.
extern "C" int fq_sharded_candidates(
        const int32_t* occ, int32_t B, int32_t S, int32_t stride,
        const uint8_t* found, const int32_t* ii, const int32_t* offsets,
        int64_t kp, const uint32_t* positions, int64_t npos,
        int32_t n_seeds, int32_t C, int32_t excl_bp, int32_t nshards,
        uint32_t* cand, uint8_t* in_range, uint8_t* owner, void* stream) {
    if (B <= 0) return 0;
    const size_t smem = size_t(kWarps) * 2 * S * sizeof(uint32_t);
    if (S < 1 || npos < 1 || n_seeds < 1 || C < 1 || kp < 1
        || smem > 227 * 1024 || nshards < 1 || nshards > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            candidates, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    candidates<<<dim3(blocks_of(B), nshards), kWarps * 32, smem,
                 static_cast<cudaStream_t>(stream)>>>(
        occ, B, S, stride, found, ii, offsets, kp, positions, npos,
        n_seeds, C, excl_bp, cand, in_range, owner);
    return static_cast<int>(cudaGetLastError());
}

// (c) cand, in_range: (B, n_seeds * C) global candidates (after pmax)
// and their in-range flags, owner (B, n_seeds) (after pmax); shard d
// verifies columns [c0 + d Cs, c0 + (d + 1) Cs) of the list padded with
// zeros -> mis (nshards, B) i32, pos (nshards, B) u32.
extern "C" int fq_sharded_verify(
        const uint8_t* codes, const int32_t* lengths, int32_t B, int32_t Lp,
        int32_t rc, const uint32_t* cand, const uint8_t* in_range,
        const uint8_t* owner, int32_t n_seeds, int32_t C, uint32_t ref_len,
        int64_t c0, int32_t Cs, const uint32_t* packed, int64_t nw,
        int32_t nshards, int32_t* mis, uint32_t* pos, void* stream) {
    if (B <= 0) return 0;
    if (Lp % 16 || Lp / 16 > kMaxW || nw < 1 || c0 < 0 || Cs < 1
        || n_seeds < 1 || C < 1 || nshards < 1 || nshards > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    const int W = Lp / 16;
    const int kW = W <= 4 ? 4 : W <= 8 ? 8 : W <= 16 ? 16 : 0;
    const size_t smem = size_t(kWarps) * sizeof(uint32_t)
                        * (2 * (W + 3) + (kW ? 0 : 32 * (W + 1)));
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FQ_VERIFY_LAUNCH(K)                                                 \
    return launch_verify<K>(smem, nshards, st, codes, lengths, B, Lp, rc,   \
                            cand, in_range, owner, n_seeds, C, ref_len, c0, \
                            Cs, packed, nw, mis, pos)
    switch (kW) {
        case 4: FQ_VERIFY_LAUNCH(4);
        case 8: FQ_VERIFY_LAUNCH(8);
        case 16: FQ_VERIFY_LAUNCH(16);
        default: FQ_VERIFY_LAUNCH(0);
    }
#undef FQ_VERIFY_LAUNCH
}

// (d) mode 0 fwd, 1 rc, 2 both (mis_f/pos_f, mis_r/pos_r as the mode
// needs them) -> mapped, pos (u32), rev: (B,); mask (B, Lp) u8.
extern "C" int fq_sharded_tail(
        const uint8_t* codes, const uint8_t* dege, const int32_t* lengths,
        int32_t B, int32_t Lp, int32_t mode, int32_t both_strands,
        int32_t max_mis, int32_t k, const int32_t* mis_f,
        const uint32_t* pos_f, const int32_t* mis_r, const uint32_t* pos_r,
        const uint32_t* packed, int64_t nw, uint8_t* mapped, uint32_t* pos,
        uint8_t* rev, uint8_t* mask, void* stream) {
    if (B <= 0) return 0;
    if (mode < 0 || mode > 2 || nw < 1 || Lp % 16)
        return static_cast<int>(cudaErrorInvalidValue);
    const bool vec = (reinterpret_cast<uintptr_t>(mask) & 3) == 0;
    tail<<<blocks_of(B), kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        codes, dege, lengths, B, Lp, mode, both_strands, max_mis, k, mis_f,
        pos_f, mis_r, pos_r, packed, nw, vec, mapped, pos, rev, mask);
    return static_cast<int>(cudaGetLastError());
}
