// K18 ctx_shard_decode: frozen-table rANS decode of one stream with the
// quantized table sharded by context rows.
//
// Replaces fastqueeze_tpu/parallel/mesh.py decode_blocks_frozen_sharded /
// _build_frozen_sharded (B18), with _device_aux (B1) and context_grids
// (B2) inline.  Shard s holds rows [s * n_local, (s + 1) * n_local) of
// the u16 cumulative table and its own copy of what the reference keeps
// replicated: every lane's model state, read cursor and rANS state, and
// the word offset.  One CTA a shard owns the whole stream (each thread
// ceil(L / blockDim) consecutive lanes, as in K4), and one launch does
// one wave step t in 0..T:
//   1. (t > 0) sum the partials (sym, start, freq) of wave t - 1 over the
//      shards, run the rANS step, the block-wide exclusive scan of the
//      lanes that renormalize and their word reads, update the valid
//      lanes' model state; the writer shard stores the symbols;
//   2. (t < T) step each valid lane's cursor, compute its context and,
//      when the shard owns that row, binary-search it; the lane's partial
//      is (sym, start, freq) there and (0, 0, 0) elsewhere, written to
//      this shard's slot of the exchange buffer for wave t.
//   t == T writes the lanes' final states.
// The exchange buffer is double-buffered by wave parity, (2, D, 3, L):
// step t reads parity (t - 1) & 1 and writes parity t & 1, so shards that
// share a card run as D CTAs of one launch a wave and read each other's
// slots directly; stream order between the launches is the barrier.  With
// shards on several cards the caller launches one wave at a time on each
// card and sums the slots between launches (parallel/mesh.psum), passing
// the sum as the single slot to read.
// Bound: every wave is a dependent chain (the context needs the previous
// symbol, the word offset the scan), so the stream is latency-bound as
// K4 is, plus one launch a wave (T + 1 launches a stream, queued here in
// one host loop).

#include <cstdint>

#include <cuda_runtime.h>

#include "lane_walk.cuh"

namespace {

using fqk::ModelSpec;
using fqk::ModelState;
using fqk::ReadCursor;

constexpr int kThreads = 1024;

struct Lane {
    ModelState s;
    ReadCursor cur;
    uint32_t x;       // rANS state
    uint32_t xn;      // this wave's state before renormalization
    int32_t n;        // symbols in the lane
    int32_t sym;      // the wave's summed symbol
};

struct Args {
    const uint32_t* states0;
    const uint16_t* words;
    int64_t W;
    const int32_t* cgrid;
    int32_t J, T, L, A;
    const uint16_t* const* cums;   // per local shard: its n_local rows
    int64_t n_local;
    int32_t shard0;                // global index of local shard 0
    const int32_t* xin;            // (nparts, 3, L) partials of wave t - 1
    int32_t nparts;
    int32_t* xout;                 // (local shards, 3, L) partials of wave t
    Lane* lanes;                   // (local shards, L)
    int64_t* off;                  // (local shards,) word offsets
    uint8_t* out;                  // (T, L) symbols: local shard 0 writes
    uint32_t* x_final;             // (L,)
    int32_t writer;                // local shard 0 writes out and x_final
};

template <int KIND>
__global__ void __launch_bounds__(kThreads)
ctx_shard_wave(Args a, ModelSpec m, int32_t t) {
    const int32_t b = blockIdx.x;
    const int32_t L = a.L;
    const int32_t per = (L + kThreads - 1) / kThreads;
    const int32_t l0 = threadIdx.x * per;
    const int32_t l1 = min(l0 + per, L);
    Lane* lanes = a.lanes + int64_t(b) * L;
    const bool write = a.writer && b == 0;
    if (t == 0) {
        for (int32_t l = l0; l < l1; ++l) {
            Lane& ln = lanes[l];
            fqk::model_reset<KIND>(m, ln.s);
            ln.cur = ReadCursor{-1, 0, 0};
            ln.x = a.states0[l];
            ln.n = fqk::lane_length(a.cgrid, a.J, L, l);
        }
        if (threadIdx.x == 0) a.off[b] = 0;
    } else {
        const int32_t tp = t - 1;
        int32_t need = 0;
        for (int32_t l = l0; l < l1; ++l) {
            Lane& ln = lanes[l];
            if (tp >= ln.n) continue;
            uint32_t sym = 0, start = 0, f = 0;
            for (int32_t p = 0; p < a.nparts; ++p) {
                const int32_t* part = a.xin + int64_t(p) * 3 * L;
                sym += static_cast<uint32_t>(part[l]);
                start += static_cast<uint32_t>(part[L + l]);
                f += static_cast<uint32_t>(part[2 * L + l]);
            }
            ln.xn = f * (ln.x >> fqk::kProbBits) + (ln.x & fqk::kMaskM)
                    - start;
            ln.sym = static_cast<int32_t>(sym);
            need += ln.xn < fqk::kRansL;
        }
        int32_t total;
        const int64_t off = a.off[b];
        int64_t w = off + fqk::block_exclusive_scan<kThreads>(need, &total);
        for (int32_t l = l0; l < l1; ++l) {
            Lane& ln = lanes[l];
            const int64_t idx = int64_t(tp) * L + l;
            if (tp >= ln.n) {
                if (write) a.out[idx] = 0;
                continue;
            }
            uint32_t xn = ln.xn;
            if (xn < fqk::kRansL) {
                xn = (xn << 16) | a.words[w < a.W ? w : a.W - 1];
                ++w;
            }
            ln.x = xn;
            if (write) a.out[idx] = static_cast<uint8_t>(ln.sym);
            fqk::model_update<KIND>(m, ln.s, ln.sym);
            --ln.cur.rem;
            ++ln.cur.pos;
        }
        // every thread has read off[b] before the scan's barriers
        if (threadIdx.x == 0) a.off[b] = off + total;
    }
    if (t == a.T) {
        if (write)
            for (int32_t l = l0; l < l1; ++l) a.x_final[l] = lanes[l].x;
        return;
    }
    const int64_t ctx0 = int64_t(a.shard0 + b) * a.n_local;
    const uint16_t* cum = a.cums[b];
    int32_t* part = a.xout + int64_t(b) * 3 * L;
    for (int32_t l = l0; l < l1; ++l) {
        Lane& ln = lanes[l];
        int32_t sym = 0, start = 0, f = 0;
        if (t < ln.n) {
            if (fqk::cursor_next(ln.cur, a.cgrid, a.J, L, l))
                fqk::model_reset<KIND>(m, ln.s);
            const int64_t ctx = fqk::model_ctx<KIND>(m, ln.s, ln.cur.pos);
            if (ctx >= ctx0 && ctx < ctx0 + a.n_local) {
                FQK_BOUND("ctx_shard_wave", "cum row", ctx - ctx0,
                          a.n_local);
                const uint16_t* row = cum + (ctx - ctx0) * (a.A + 1);
                const uint32_t low = ln.x & fqk::kMaskM;
                int32_t lo = 0, hi = a.A - 1;
                while (lo < hi) {
                    const int32_t mid = (lo + hi + 1) >> 1;
                    if (row[mid] <= low) lo = mid;
                    else hi = mid - 1;
                }
                sym = lo;
                start = row[lo];
                f = row[lo + 1] - row[lo];
            }
        }
        part[l] = sym;
        part[L + l] = start;
        part[2 * L + l] = f;
    }
}

template <int KIND>
int launch_waves(const Args& base, const ModelSpec& m, int32_t nshards,
                 int32_t t0, int32_t t1, int32_t* xbuf, cudaStream_t st) {
    for (int32_t t = t0; t < t1; ++t) {
        Args a = base;
        if (xbuf != nullptr) {       // shards on one card: parity buffers
            const int64_t slot = int64_t(nshards) * 3 * base.L;
            a.xin = xbuf + ((t + 1) & 1) * slot;
            a.xout = xbuf + (t & 1) * slot;
            a.nparts = nshards;
        }
        ctx_shard_wave<KIND><<<nshards, kThreads, 0, st>>>(a, m, t);
        const int rc = static_cast<int>(cudaGetLastError());
        if (rc) return rc;
    }
    return 0;
}

}  // namespace

// lanes: scratch of nshards * L * sizeof(Lane) bytes
// (fq_ctx_shard_lane_bytes()).
extern "C" int64_t fq_ctx_shard_lane_bytes() { return sizeof(Lane); }

// Wave steps t0 .. t1 - 1 (of 0 .. T) of the nshards shards on this card,
// global shard indices shard0 .. shard0 + nshards - 1.  cums: device
// array of nshards pointers to (n_local, A + 1) u16 row blocks.  xbuf
// non-null: the (2, nshards, 3, L) parity buffers of shards that are all
// on this card (xin, xout, nparts ignored); null: read nparts partials
// from xin and write this card's to xout (one wave at a time, the caller
// summing between launches).
extern "C" int fq_ctx_shard_decode(
        const uint32_t* states0, const uint16_t* words, int64_t W,
        const int32_t* cgrid, int32_t J, int32_t T, int32_t L,
        const uint16_t* const* cums, int64_t n_local, int32_t A,
        int32_t kind, int64_t a, int64_t b, int64_t c, int64_t d, int64_t e,
        int64_t f, int64_t g, int32_t shard0, int32_t nshards,
        int32_t* xbuf, const int32_t* xin, int32_t nparts, int32_t* xout,
        void* lanes, int64_t* off, uint8_t* out, uint32_t* x_final,
        int32_t writer, int32_t t0, int32_t t1, void* stream) {
    const ModelSpec m{kind, a, b, c, d, e, f, g};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (nshards < 1 || t0 < 0 || t1 > T + 1 || A < 2)
        return static_cast<int>(cudaErrorInvalidValue);
    Args base{states0, words, W, cgrid, J, T, L, A, cums, n_local, shard0,
              xin, nparts, xout, static_cast<Lane*>(lanes), off, out,
              x_final, writer};
    if (kind == 0)
        return launch_waves<0>(base, m, nshards, t0, t1, xbuf, st);
    if (kind == 1)
        return launch_waves<1>(base, m, nshards, t0, t1, xbuf, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
