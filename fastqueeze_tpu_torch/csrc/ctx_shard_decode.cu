// K18 ctx_shard_decode: frozen-table rANS decode of one stream with the
// quantized table sharded by context rows.
//
// Replaces fastqueeze_tpu/parallel/mesh.py decode_blocks_frozen_sharded /
// _build_frozen_sharded (B18), with _device_aux (B1) and context_grids
// (B2) inline.  Shard s holds rows [s * n_local, (s + 1) * n_local) of the
// u16 cumulative table; per wave the shard that owns a lane's context
// searches its row and every other shard contributes (0, 0, 0), the
// partials (sym, start, freq) are summed over the shards (the reference's
// psum), and the rANS step and the model update run on the sum.
//
// Two routes, both on K4's thread-block cluster (frozen_wave.cuh,
// cluster_xchg.cuh: up to 8 CTAs, one lane a thread up to 4096 lanes,
// several lanes a thread above, the rank by the push-and-poll exchange):
//   (a) every shard on one card (fq_ctx_shard_run): exactly one shard
//       owns each context, so the sum is that shard's partial and no
//       partial is formed at all.  The stream is K4's body in one launch,
//       the row read through the card's array of row-block pointers
//       (ShardRows: shard = ctx / n_local, a shift);
//   (b) shards on several cards (fq_ctx_shard_step, one launch a wave,
//       since the sum crosses cards): the card's launch t finishes wave
//       t - 1 on the summed partials the caller passes (rANS step, rank,
//       word reads, model update, once a card) and searches wave t's rows
//       of the contexts this card's shards own, writing the card's one
//       (3, L) partial.  The lane state lives between launches as a
//       structure of arrays in global scratch (coalesced, L2-resident),
//       the word offset in a pair of slots by wave parity.
// Bound: every wave is a dependent chain (the context needs the previous
// symbol, the word offset the rank), so the stream is latency-bound as
// K4 is; route (b) adds a launch a wave and the state's round trip
// through L2.  The first K18 (one CTA of 1,024 threads a shard, each
// thread walking its lanes one after another, every shard repeating the
// whole lane walk, a binary search over the row, a launch a wave on both
// routes) took ~77 us a wave at --qlevel 3 on an H100, 14x K4.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "frozen_wave.cuh"

namespace {

// The lane state of route (b): field f of lane l at st[f * L + l].
enum Field { kX, kN, kJ, kRem, kPos, kH, kDrops, kQ, kFields = kQ + 8 };

template <int KIND>
__device__ __forceinline__ void load_state(const int32_t* st, int32_t L,
                                           int32_t l, ModelState& s,
                                           ReadCursor& c) {
    c.j = st[kJ * L + l];
    c.rem = st[kRem * L + l];
    c.pos = st[kPos * L + l];
    if (KIND == 0) {
        s.h = static_cast<uint32_t>(st[kH * L + l]);
    } else {
        s.drops = st[kDrops * L + l];
#pragma unroll
        for (int j = 0; j < 8; ++j) s.q[j] = st[(kQ + j) * L + l];
    }
}

template <int KIND>
__device__ __forceinline__ void store_state(int32_t* st, int32_t L,
                                            int32_t l, const ModelState& s,
                                            const ReadCursor& c) {
    st[kJ * L + l] = c.j;
    st[kRem * L + l] = c.rem;
    st[kPos * L + l] = c.pos;
    if (KIND == 0) {
        st[kH * L + l] = static_cast<int32_t>(s.h);
    } else {
        st[kDrops * L + l] = s.drops;
#pragma unroll
        for (int j = 0; j < 8; ++j) st[(kQ + j) * L + l] = s.q[j];
    }
}

struct StepArgs {
    const uint32_t* states0;
    const uint16_t* words;
    int64_t W;
    const int32_t* cgrid;
    int32_t J, T, L;
    ShardRows rows;          // this card's shards
    int64_t ctx0;            // their first row
    const int32_t* xin;      // (nparts, 3, L) partials of wave t - 1
    int32_t nparts;
    int32_t* xout;           // (3, L) this card's partial of wave t
    int32_t* st;             // (kFields, L) lane state
    int64_t* off;            // (2,) word offset by wave parity
    uint8_t* out;            // (T, L) symbols, or null (not the writer)
    uint32_t* x_final;       // (L,) final states, or null
    int32_t per;             // lanes a thread
};

// The wave t - 1 state before renormalization from the summed partials.
__device__ __forceinline__ uint32_t step_xn(const StepArgs& a, int32_t l,
                                            uint32_t x, int32_t* sym) {
    const int32_t L = a.L;
    uint32_t sm = 0, start = 0, f = 0;
    for (int32_t p = 0; p < a.nparts; ++p) {
        const int32_t* part = a.xin + int64_t(p) * 3 * L;
        sm += static_cast<uint32_t>(part[l]);
        start += static_cast<uint32_t>(part[L + l]);
        f += static_cast<uint32_t>(part[2 * L + l]);
    }
    *sym = static_cast<int32_t>(sm);
    return f * (x >> fqk::kProbBits) + (x & fqk::kMaskM) - start;
}

// THREADS: the shape's CTA size (kOneThreads for one lane a thread, so
// the lane's state fits in registers; kMultiThreads above)
template <int KIND, int NSEG, int THREADS>
__global__ void __launch_bounds__(THREADS)
shard_step(StepArgs a, ModelSpec m, int32_t t) {
    cg::cluster_group cl = cg::this_cluster();
    __shared__ RankSmem sm;
    const int32_t L = a.L;
    const int32_t A = a.rows.A;
    const int32_t g = static_cast<int32_t>(cl.block_rank()) * blockDim.x
                      + threadIdx.x;
    const int32_t l0 = min(g * a.per, L);
    const int32_t l1 = min(l0 + a.per, L);
    const int32_t tp = t - 1;
    int64_t w = 0;
    if (t > 0) {
        fqk::rank_init(cl, sm);
        const int64_t off = a.off[t & 1];
        int32_t need = 0;
        for (int32_t l = l0; l < l1; ++l) {
            if (tp >= a.st[kN * L + l]) continue;
            int32_t sym;
            need += step_xn(a, l, static_cast<uint32_t>(a.st[kX * L + l]),
                            &sym) < fqk::kRansL;
        }
        int32_t grand;
        w = off + fqk::cluster_rank(cl, sm, 0, need, &grand);
        if (cl.block_rank() == 0 && threadIdx.x == 0)
            a.off[(t + 1) & 1] = off + grand;
    } else if (cl.block_rank() == 0 && threadIdx.x == 0) {
        a.off[1] = 0;
    }
    const int64_t nrows = int64_t(a.rows.nshards) * a.rows.n_local;
    for (int32_t l = l0; l < l1; ++l) {
        ModelState s;
        ReadCursor cur;
        uint32_t x;
        int32_t n;
        if (t == 0) {
            fqk::model_reset<KIND>(m, s);
            cur = ReadCursor{-1, 0, 0};
            x = a.states0[l];
            n = fqk::lane_length(a.cgrid, a.J, L, l);
            a.st[kN * L + l] = n;
        } else {
            load_state<KIND>(a.st, L, l, s, cur);
            x = static_cast<uint32_t>(a.st[kX * L + l]);
            n = a.st[kN * L + l];
            const int64_t idx = int64_t(tp) * L + l;
            if (tp < n) {
                int32_t sym;
                uint32_t xn = step_xn(a, l, x, &sym);
                if (xn < fqk::kRansL)
                    xn = (xn << 16) | fqk::word_at(a.words, a.W, w++);
                x = xn;
                if (a.out != nullptr) a.out[idx] = static_cast<uint8_t>(sym);
                fqk::model_update<KIND>(m, s, sym);
                --cur.rem;
                ++cur.pos;
            } else if (a.out != nullptr) {
                a.out[idx] = 0;
            }
        }
        if (t == a.T) {
            if (a.x_final != nullptr) a.x_final[l] = x;
            continue;
        }
        int32_t sym = 0;
        uint32_t start = 0, f = 0;
        if (t < n) {
            if (fqk::cursor_next(cur, a.cgrid, a.J, L, l))
                fqk::model_reset<KIND>(m, s);
            const int64_t ctx = fqk::model_ctx<KIND>(m, s, cur.pos) - a.ctx0;
            if (ctx >= 0 && ctx < nrows) {
                Row<NSEG> row;
                row_fetch(row, a.rows.row(ctx), A);
                row_search(row, A, x & fqk::kMaskM, sym, start, f);
            }
        }
        a.xout[l] = sym;
        a.xout[L + l] = static_cast<int32_t>(start);
        a.xout[2 * L + l] = static_cast<int32_t>(f);
        a.st[kX * L + l] = static_cast<int32_t>(x);
        store_state<KIND>(a.st, L, l, s, cur);
    }
}

using StepKernel = void (*)(StepArgs, ModelSpec, int32_t);

StepKernel step_kernel(int32_t kind, bool one) {
    constexpr int kO = fqk::kOneThreads, kM = fqk::kMultiThreads;
    if (kind == 0) return one ? &shard_step<0, kSeg<0>, kO>
                              : &shard_step<0, kSeg<0>, kM>;
    if (kind == 1) return one ? &shard_step<1, kSeg<1>, kO>
                              : &shard_step<1, kSeg<1>, kM>;
    return nullptr;
}

ShardRows shard_rows(const uint16_t* const* ptrs, int64_t n_local,
                     int32_t nshards, int32_t A) {
    int32_t lg = -1;
    if (n_local > 0 && (n_local & (n_local - 1)) == 0) {
        lg = 0;
        while ((int64_t(1) << lg) < n_local) ++lg;
    }
    return ShardRows{ptrs, n_local, lg, nshards, A};
}

}  // namespace

// Lane state of route (b): int32 words a lane (a (words, L) scratch).
extern "C" int64_t fq_ctx_shard_state_words() { return kFields; }

// Route (a): the whole stream in one launch, every shard on this card.
// cums: device array of nshards pointers to (n_local, A + 1) u16 row
// blocks, shard order; lanes: K4's scratch (fq_decode_lane_bytes() a
// lane, used above 4096 lanes).  Writes the (T, L) symbols and the (L,)
// final states (T > 0).
extern "C" int fq_ctx_shard_run(
        const uint32_t* states0, const uint16_t* words, int64_t W,
        const int32_t* cgrid, int32_t J, int32_t T, int32_t L,
        const uint16_t* const* cums, int64_t n_local, int32_t A,
        int32_t kind, int64_t a, int64_t b, int64_t c, int64_t d, int64_t e,
        int64_t f, int64_t g, int32_t nshards, void* lanes, uint8_t* out,
        uint32_t* x_final, void* stream) {
    const ModelSpec m{kind, a, b, c, d, e, f, g};
    if (nshards < 1 || A < 2 || n_local < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const WaveArgs<ShardRows> args{states0, words, W, cgrid, J, T, L,
                                   shard_rows(cums, n_local, nshards, A),
                                   static_cast<WaveLane*>(lanes), 1, out,
                                   x_final};
    return wave_decode(args, m, static_cast<cudaStream_t>(stream));
}

// Route (b): wave step t (0 .. T) of this card's nshards shards, global
// shard indices shard0 .. shard0 + nshards - 1 (cums: their row blocks):
// t > 0 finishes wave t - 1 on the nparts partials in xin (summed over
// the cards), t < T writes this card's (3, L) partial of wave t to xout,
// t == T writes x_final.  st: (fq_ctx_shard_state_words(), L) int32
// scratch, off: (2,) int64, both kept by the caller between the steps;
// out and x_final null on every card but the writer.
extern "C" int fq_ctx_shard_step(
        const uint32_t* states0, const uint16_t* words, int64_t W,
        const int32_t* cgrid, int32_t J, int32_t T, int32_t L,
        const uint16_t* const* cums, int64_t n_local, int32_t A,
        int32_t kind, int64_t a, int64_t b, int64_t c, int64_t d, int64_t e,
        int64_t f, int64_t g, int32_t shard0, int32_t nshards,
        const int32_t* xin, int32_t nparts, int32_t* xout, int32_t* st,
        int64_t* off, uint8_t* out, uint32_t* x_final, int32_t t,
        void* stream) {
    const ModelSpec m{kind, a, b, c, d, e, f, g};
    if (nshards < 1 || A < 2 || n_local < 1 || t < 0 || t > T
        || (t > 0 && (xin == nullptr || nparts < 1)))
        return static_cast<int>(cudaErrorInvalidValue);
    if (L <= 0) return 0;
    const fqk::Shape sh = fqk::shape_for(L);
    const StepKernel k = step_kernel(kind, sh.one);
    if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const StepArgs args{states0, words, W, cgrid, J, T, L,
                        shard_rows(cums, n_local, nshards, A),
                        int64_t(shard0) * n_local, xin, nparts, xout, st,
                        off, out, x_final, sh.per};
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = fqk::cluster_config(
        sh, static_cast<cudaStream_t>(stream), attr);
    const cudaError_t rc = cudaLaunchKernelEx(&cfg, k, args, m, t);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    return static_cast<int>(cudaGetLastError());
}
