// K19 sharded_align: gapless multi-seed alignment against a k-mer index
// sharded by key range, u32 reference coordinates.
//
// Replaces fastqueeze_tpu/parallel/mesh.py align_blocks_index_sharded
// (B17), i.e. fastqueeze_tpu/align/hash.py _align_batch with
// _one_strand's shard_axis branch.  Shard d holds keys [d*nk/D,
// (d+1)*nk/D) of the counted CSR (parallel/mesh.shard_ref_index: u32
// (hi, lo) keys padded with 0xFFFFFFFF to a common kp, offsets, u32
// positions) and the whole 2-bit packed reference.  One entry point per
// phase; the collectives between them (pmin, pmax over the shards) are
// parallel/mesh.py's:
//   (a) fq_sharded_lookup, one thread per (read, sampled seed): the seed's
//       key (narrow u32 or wide (hi, lo30)), a binary search of
//       search_steps = ceil(log2(kp + 1)) steps over the shard's keys;
//       occ (kBig where the shard has no hit or the window is invalid),
//       found and the key index ii.  Then pmin(occ).
//   (b) fq_sharded_candidates, one thread per read: n_seeds rounds of the
//       first-index argmin of the global occ, the +-excl_bp (or the one
//       index) exclusion, and for j < n_cand the owner shard's
//       positions[offsets[ii] + j] - seed_off, wrapping in u32, 0
//       elsewhere; the in-range flags and the owner bit of every round.
//       Then pmax(cand), pmax(owner).
//   (c) fq_sharded_verify, one thread per read: the shard's slice
//       [d*Cs, (d+1)*Cs) of the candidate list padded to D*Cs, cand_ok
//       (in range, an owner, inside the reference), the full W + 1 frame
//       word mismatch count (no probe prefilter in this branch) against the
//       packed reference, the first-index argmin.  Then pmin(mis) and
//       pmin(pos where mis is the global minimum, else 0xFFFFFFFF).
//   (d) fq_sharded_tail, one thread per read: _align_batch's strand
//       choice, mapped, is_rev and the (B, Lp) mismatch mask from u32
//       window positions.
// The reverse strand is read in place (base i <- 3 - codes[len - 1 - i])
// by (a) and (c) under their rc flag.  Bound: dependent random loads
// (search steps, CSR positions, reference words) a thread per read, as
// K8; the data moved is the grids, the index entries touched and the
// outputs.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int32_t kBig = 1 << 28;
constexpr int kThreads = 128;
constexpr int kMaxW = 64;            // Lp <= 1024

// Base i of the read's effective strand, and its degenerate flag.
__device__ __forceinline__ uint32_t eff_code(const uint8_t* row,
                                             int32_t len, int i, int rc) {
    if (!rc) return row[i];
    return i < len ? 3u - row[len - 1 - i] : 0u;
}

__device__ __forceinline__ bool eff_dege(const uint8_t* drow, int32_t len,
                                         int i, int rc) {
    if (!rc) return drow[i] != 0;
    return i < len && drow[len - 1 - i] != 0;
}

__device__ __forceinline__ int mis2bit(uint32_t x) {
    return __popc((x | (x >> 1)) & 0x55555555u);
}

__device__ __forceinline__ uint32_t ref_word(const uint32_t* packed,
                                             int64_t nw, int64_t w) {
    w = w < 0 ? 0 : (w > nw - 1 ? nw - 1 : w);
    return __ldg(packed + w);
}

// Word j of the read funnel-shifted into the candidate's ref frame,
// sh = 2 * (cand & 15) (hash._read_in_ref_frame).
__device__ __forceinline__ uint32_t frame_word(const uint32_t* arr, int W,
                                               int j, uint32_t sh) {
    const uint32_t a = (j >= 1 && j <= W) ? arr[j - 1] : 0u;
    const uint32_t b = (j < W) ? arr[j] : 0u;
    const uint32_t shl = 32u - (sh > 1u ? sh : 1u);
    const uint32_t hi = (j >= 1 && sh > 0) ? (a << shl) : 0u;
    return hi | (b >> sh);
}

__global__ void lookup(const uint8_t* __restrict__ codes,
                       const uint8_t* __restrict__ dege,
                       const int32_t* __restrict__ lengths, int32_t B,
                       int32_t Lp, int32_t k, int32_t stride, int32_t S,
                       int32_t rc, int32_t wide,
                       const uint32_t* __restrict__ keys_hi,
                       const uint32_t* __restrict__ keys_lo,
                       const int32_t* __restrict__ offsets, int64_t nk,
                       int32_t steps, int32_t* __restrict__ occ,
                       uint8_t* __restrict__ found,
                       int32_t* __restrict__ ii) {
    const int64_t g = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
    if (g >= int64_t(B) * S) return;
    const int64_t r = g / S;
    const int32_t s = static_cast<int32_t>(g % S);
    const uint8_t* row = codes + r * Lp;
    const uint8_t* drow = dege + r * Lp;
    const int32_t len = lengths[r];
    const int q = s * stride;
    uint64_t v = 0;
    bool dg = false;
    for (int j = 0; j < k; ++j) {
        v = (v << 2) | eff_code(row, len, q + j, rc);
        dg |= eff_dege(drow, len, q + j, rc);
    }
    const bool ok = q <= len - k && !dg;
    const uint32_t qh = wide ? static_cast<uint32_t>(v >> 30)
                             : static_cast<uint32_t>(v);
    const uint32_t ql = static_cast<uint32_t>(v & 0x3FFFFFFFu);
    int64_t lo = 0, hi = nk;
    for (int t = 0; t < steps; ++t) {
        const bool active = lo < hi;
        const int64_t mid = (lo + hi) >> 1;
        const int64_t m = mid < nk - 1 ? mid : nk - 1;
        const uint32_t kh = __ldg(keys_hi + m);
        const bool less = wide ? (kh < qh || (kh == qh
                                              && __ldg(keys_lo + m) < ql))
                               : kh < qh;
        if (active && less) lo = mid + 1;
        if (active && !less) hi = mid;
    }
    const int64_t i2 = lo < nk - 1 ? lo : nk - 1;
    bool eq = __ldg(keys_hi + i2) == qh;
    if (wide) eq = eq && __ldg(keys_lo + i2) == ql;
    const bool f = eq && lo < nk && ok;
    occ[g] = f ? __ldg(offsets + i2 + 1) - __ldg(offsets + i2) : kBig;
    found[g] = f;
    ii[g] = static_cast<int32_t>(i2);
}

__global__ void candidates(int32_t* __restrict__ occ, int32_t B, int32_t S,
                           int32_t stride, const uint8_t* __restrict__ found,
                           const int32_t* __restrict__ ii,
                           const int32_t* __restrict__ offsets,
                           const uint32_t* __restrict__ positions,
                           int64_t npos, int32_t n_seeds, int32_t C,
                           int32_t excl_bp, uint32_t* __restrict__ cand,
                           uint8_t* __restrict__ in_range,
                           uint8_t* __restrict__ owner) {
    const int64_t r = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
    if (r >= B) return;
    int32_t* o = occ + r * S;
    const int64_t tot = int64_t(n_seeds) * C;
    for (int32_t round = 0; round < n_seeds; ++round) {
        int32_t jb = 0;
        int32_t best = o[0];
        for (int32_t s = 1; s < S; ++s)
            if (o[s] < best) {
                best = o[s];
                jb = s;
            }
        const int32_t pb = jb * stride;
        if (excl_bp > 0) {
            for (int32_t s = 0; s < S; ++s) {
                const int32_t dpos = s * stride - pb;
                if ((dpos < 0 ? -dpos : dpos) <= excl_bp) o[s] = kBig;
            }
        } else {
            o[jb] = kBig;
        }
        const bool own = found[r * S + jb] != 0;
        const int64_t base = __ldg(offsets + ii[r * S + jb]);
        const int32_t lim = best < C ? best : C;
        for (int32_t j = 0; j < C; ++j) {
            const int64_t idx = r * tot + int64_t(round) * C + j;
            int64_t p = base + j;
            p = p < 0 ? 0 : (p > npos - 1 ? npos - 1 : p);
            cand[idx] = own ? __ldg(positions + p) - static_cast<uint32_t>(pb)
                            : 0u;
            in_range[idx] = j < lim;
        }
        owner[r * n_seeds + round] = own;
    }
}

__global__ void verify(const uint8_t* __restrict__ codes,
                       const int32_t* __restrict__ lengths, int32_t B,
                       int32_t Lp, int32_t rc,
                       const uint32_t* __restrict__ cand,
                       const uint8_t* __restrict__ in_range,
                       const uint8_t* __restrict__ owner, int32_t n_seeds,
                       int32_t C, uint32_t ref_len, int64_t c0, int32_t Cs,
                       const uint32_t* __restrict__ packed, int64_t nw,
                       int32_t* __restrict__ mis_out,
                       uint32_t* __restrict__ pos_out) {
    const int64_t r = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
    if (r >= B) return;
    const uint8_t* row = codes + r * Lp;
    const int32_t len = lengths[r];
    const int W = Lp / 16;
    uint32_t rw[kMaxW], mw[kMaxW];
    for (int w = 0; w < W; ++w) {
        uint32_t a = 0, m = 0;
        for (int t = 0; t < 16; ++t) {
            const int i = 16 * w + t;
            if (i < len) {
                a |= eff_code(row, len, i, rc) << (2u * (15 - t));
                m |= 3u << (2u * (15 - t));
            }
        }
        rw[w] = a;
        mw[w] = m;
    }
    // cand_ok: in range, a shard owns the round's seed, the read fits and
    // the window ends inside the reference (u32: an underflowed start
    // wraps past ref_len - len); columns past the list are padding
    const int64_t stot = int64_t(n_seeds) * C;
    const uint32_t ulen = static_cast<uint32_t>(len);
    const bool fits = ulen <= ref_len;
    const uint32_t max_start = ref_len - ulen;
    int32_t best = 0;
    uint32_t best_pos = 0;
    for (int32_t c = 0; c < Cs; ++c) {
        const int64_t col = c0 + c;
        uint32_t cv = 0;
        bool ok = false;
        if (col < stot) {
            const int64_t idx = r * stot + col;
            cv = cand[idx];
            ok = in_range[idx] && owner[r * n_seeds + col / C] && fits
                 && cv <= max_start;
        }
        int32_t mis = kBig;
        if (ok) {
            const int64_t w0 = static_cast<int64_t>(cv >> 4);
            const uint32_t sh = 2u * (cv & 15u);
            mis = 0;
            for (int j = 0; j <= W; ++j) {
                const uint32_t refw = ref_word(packed, nw, w0 + j);
                mis += mis2bit((frame_word(rw, W, j, sh) ^ refw)
                               & frame_word(mw, W, j, sh));
            }
        }
        if (c == 0 || mis < best) {
            best = mis;
            best_pos = cv;
        }
    }
    mis_out[r] = best;
    pos_out[r] = best_pos;
}

__global__ void tail(const uint8_t* __restrict__ codes,
                     const uint8_t* __restrict__ dege,
                     const int32_t* __restrict__ lengths, int32_t B,
                     int32_t Lp, int32_t mode, int32_t both_strands,
                     int32_t max_mis, int32_t k,
                     const int32_t* __restrict__ mis_f,
                     const uint32_t* __restrict__ pos_f,
                     const int32_t* __restrict__ mis_r,
                     const uint32_t* __restrict__ pos_r,
                     const uint32_t* __restrict__ packed, int64_t nw,
                     uint8_t* __restrict__ mapped, uint32_t* __restrict__ pos,
                     uint8_t* __restrict__ rev, uint8_t* __restrict__ mask) {
    const int64_t r = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
    if (r >= B) return;
    const uint8_t* row = codes + r * Lp;
    const uint8_t* drow = dege + r * Lp;
    const int32_t len = lengths[r];
    bool has_dege = false;
    for (int i = 0; i < Lp && i < len; ++i) has_dege |= drow[i] != 0;
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
    for (int i = 0; i < Lp; ++i) {
        const uint32_t idx = p + static_cast<uint32_t>(i);
        const uint32_t w = ref_word(packed, nw, idx >> 4);
        const uint32_t refc = (w >> (2u * (15 - (idx & 15u)))) & 3u;
        mask[r * Lp + i] = mp && i < len && eff_code(row, len, i, rcs) != refc;
    }
    mapped[r] = mp;
    pos[r] = p;
    rev[r] = use_rev && mp;
}

inline int blocks_of(int64_t n) {
    return static_cast<int>((n + kThreads - 1) / kThreads);
}

}  // namespace

// (a) codes, dege: (B, Lp) u8, lengths (B,) i32 -> occ (B, S) i32, found
// (B, S) u8, ii (B, S) i32 over the shard's keys (kp entries).
extern "C" int fq_sharded_lookup(
        const uint8_t* codes, const uint8_t* dege, const int32_t* lengths,
        int32_t B, int32_t Lp, int32_t k, int32_t stride, int32_t S,
        int32_t rc, int32_t wide, const uint32_t* keys_hi,
        const uint32_t* keys_lo, const int32_t* offsets, int64_t kp,
        int32_t steps, int32_t* occ, uint8_t* found, int32_t* ii,
        void* stream) {
    if (B <= 0 || S <= 0) return 0;
    if (Lp % 16 || k < 1 || k > 31 || kp < 1 || (S - 1) * stride + k > Lp)
        return static_cast<int>(cudaErrorInvalidValue);
    lookup<<<blocks_of(int64_t(B) * S), kThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(
        codes, dege, lengths, B, Lp, k, stride, S, rc, wide, keys_hi,
        keys_lo, offsets, kp, steps, occ, found, ii);
    return static_cast<int>(cudaGetLastError());
}

// (b) occ: (B, S) i32 global counts, overwritten (the exclusions) ->
// cand (B, n_seeds * C) u32, in_range (B, n_seeds * C) u8, owner
// (B, n_seeds) u8.
extern "C" int fq_sharded_candidates(
        int32_t* occ, int32_t B, int32_t S, int32_t stride,
        const uint8_t* found, const int32_t* ii, const int32_t* offsets,
        const uint32_t* positions, int64_t npos, int32_t n_seeds, int32_t C,
        int32_t excl_bp, uint32_t* cand, uint8_t* in_range, uint8_t* owner,
        void* stream) {
    if (B <= 0) return 0;
    if (S < 1 || npos < 1 || n_seeds < 1 || C < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    candidates<<<blocks_of(B), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
        occ, B, S, stride, found, ii, offsets, positions, npos, n_seeds, C,
        excl_bp, cand, in_range, owner);
    return static_cast<int>(cudaGetLastError());
}

// (c) cand, in_range: (B, n_seeds * C) global candidates (after pmax)
// and their in-range flags, owner (B, n_seeds) (after pmax); this shard
// verifies columns [c0, c0 + Cs) of the list padded with zeros -> mis
// (B,) i32, pos (B,) u32.
extern "C" int fq_sharded_verify(
        const uint8_t* codes, const int32_t* lengths, int32_t B, int32_t Lp,
        int32_t rc, const uint32_t* cand, const uint8_t* in_range,
        const uint8_t* owner, int32_t n_seeds, int32_t C, uint32_t ref_len,
        int64_t c0, int32_t Cs, const uint32_t* packed, int64_t nw,
        int32_t* mis, uint32_t* pos, void* stream) {
    if (B <= 0) return 0;
    if (Lp % 16 || Lp / 16 > kMaxW || nw < 1 || c0 < 0 || Cs < 1
        || n_seeds < 1 || C < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    verify<<<blocks_of(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        codes, lengths, B, Lp, rc, cand, in_range, owner, n_seeds, C,
        ref_len, c0, Cs, packed, nw, mis, pos);
    return static_cast<int>(cudaGetLastError());
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
    if (mode < 0 || mode > 2 || nw < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    tail<<<blocks_of(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        codes, dege, lengths, B, Lp, mode, both_strands, max_mis, k, mis_f,
        pos_f, mis_r, pos_r, packed, nw, mapped, pos, rev, mask);
    return static_cast<int>(cudaGetLastError());
}
