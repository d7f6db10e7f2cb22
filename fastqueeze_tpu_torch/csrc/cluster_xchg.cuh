// The thread-block cluster that decodes one stream (K4 frozen_decode, K6
// adapt_decode, K12 semi_decode): its shape for L lanes, the exchanges
// between its CTAs inside the wave loop, and the reads a wave makes (a
// table row in aligned 16-byte segments, the renormalization words).
//
// Lanes are split over the cluster's threads in lane order: up to 8 x 512
// lanes one lane a thread, above that up to 8 x 1024 threads owning
// ceil(L / 8192) consecutive lanes each.  An exchange is a
// cluster-wide step every thread of every CTA takes: each CTA reduces
// its threads' values (one __syncthreads), warp 0 pushes the CTA's
// result, tagged with the exchange's sequence number, into a slot of
// every CTA's shared memory (one 64-bit remote store each through
// distributed shared memory), and each warp polls its own CTA's slots
// until all carry the tag.  The slots are double-buffered by the
// sequence number's parity: a CTA can push exchange e + 2 into a slot
// only after every CTA pushed e + 1, which each does after all its warps
// read exchange e's slots, so the two parities never collide; and a CTA
// finishes only after every push into it has arrived.  No cluster
// barrier runs inside the wave loop (on an H100, K4 on the order-10 seq
// stream took 2.98 us a wave with one cluster barrier a wave, 2.60 us
// with a push-and-poll rank).  A poll that never sees its tag traps (a
// fault, not a hang).
#pragma once

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "lane_walk.cuh"

namespace fqk {

namespace cg = cooperative_groups;

constexpr int kCtas = 8;            // CTAs a cluster (the portable maximum)
constexpr int kOneThreads = 512;    // threads a CTA, one lane a thread
constexpr int kMultiThreads = 1024; // threads a CTA, several lanes a thread
constexpr uint32_t kFull = 0xFFFFFFFFu;

struct Shape {
    int ctas, threads, per;
    bool one;         // one lane a thread, state in registers
};

// spread: one lane a thread over as many CTAs (up to 8) as have a warp's
// worth of lanes each, not as few as hold them.
inline Shape shape_for(int32_t L, bool spread = false) {
    Shape s;
    int64_t need;
    if (L <= kCtas * kOneThreads) {
        s.one = true;
        s.per = 1;
        need = L;
        s.ctas = static_cast<int>(
            spread ? (need + 31) / 32 : (need + kOneThreads - 1) / kOneThreads);
        if (s.ctas > kCtas) s.ctas = kCtas;
    } else {
        s.one = false;
        s.per = static_cast<int>((int64_t(L) + kCtas * kMultiThreads - 1)
                                 / (kCtas * kMultiThreads));
        need = (int64_t(L) + s.per - 1) / s.per;
        s.ctas = kCtas;
    }
    if (s.ctas < 1) s.ctas = 1;
    const int64_t t = (need + s.ctas - 1) / s.ctas;
    s.threads = static_cast<int>(((t + 31) / 32) * 32);
    if (s.threads < 32) s.threads = 32;
    return s;
}

inline cudaLaunchConfig_t cluster_config(const Shape& sh, cudaStream_t st,
                                         cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(sh.ctas, 1, 1);
    cfg.blockDim = dim3(sh.threads, 1, 1);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = sh.ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

// out[0] the cluster's CTAs, out[1] threads a CTA, out[2] lanes a thread,
// out[3] how many such clusters of kernel k the card can hold at once
// (cudaOccupancyMaxActiveClusters; 0: the card cannot run it).
inline int report_shape(const Shape& sh, const void* k, int32_t* out) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = cluster_config(sh, nullptr, attr);
    int clusters = 0;
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, k, &cfg);
    out[0] = sh.ctas;
    out[1] = sh.threads;
    out[2] = sh.per;
    out[3] = clusters;
    return static_cast<int>(e);
}

struct RankSmem {
    int32_t wsum[2][32];          // per warp: inclusive sum of its needs
    uint64_t slot[2][kCtas];      // per CTA r of the cluster: its value,
                                  // pushed by r, tagged (exchange << 32)
};

// Release this thread's earlier global-memory writes (and, through the
// __syncthreads before it, its CTA's) to the cluster, or acquire the
// cluster's writes released before what this thread just observed.
__device__ __forceinline__ void fence_cluster() {
    asm volatile("fence.acq_rel.cluster;" ::: "memory");
}

// Before the first exchange: no slot holds a tag, and no CTA pushes into
// another's slots before that CTA has cleared them.
__device__ __forceinline__ void rank_init(cg::cluster_group& cl,
                                          RankSmem& sm) {
    if (threadIdx.x < 2 * kCtas) (&sm.slot[0][0])[threadIdx.x] = ~0ull;
    cl.sync();
}

// Warp 0 pushes `v`, tagged with exchange e, into slot [e & 1][this CTA's
// rank] of every CTA; each warp then polls its own CTA's slots until all
// carry tag e.  Lane r < nctas of every warp returns CTA r's value, the
// other lanes 0.
__device__ __forceinline__ int32_t push_poll(cg::cluster_group& cl,
                                             RankSmem& sm, int32_t e,
                                             int32_t v, bool release) {
    const int p = e & 1;
    const int lane = threadIdx.x & 31;
    const int nctas = static_cast<int>(cl.num_blocks());
    const int rank = static_cast<int>(cl.block_rank());
    const uint32_t tag = static_cast<uint32_t>(e);
    if ((threadIdx.x >> 5) == 0 && lane < nctas) {
        if (release) fence_cluster();
        *reinterpret_cast<volatile uint64_t*>(
            cl.map_shared_rank(&sm.slot[p][rank], lane)) =
            (uint64_t(tag) << 32) | static_cast<uint32_t>(v);
    }
    int32_t got = 0;
    if (lane < nctas) {
        const volatile uint64_t* s = &sm.slot[p][lane];
        uint64_t x = *s;
        for (uint32_t spins = 0; static_cast<uint32_t>(x >> 32) != tag;
             x = *s)
            if (++spins == (1u << 28)) __trap();
        got = static_cast<int32_t>(static_cast<uint32_t>(x));
    }
    return got;
}

// This thread's exclusive rank among the cluster's need counts of
// exchange e, and (*grand) their sum over the cluster.  The CTA scans its
// need counts (one __syncthreads; each warp scans the warp sums itself),
// then pushes its total.  No memory fence: every thread's loads before
// the rank have returned (their values made its need), so a CTA that has
// seen every total may write what they read.
__device__ __forceinline__ int32_t cluster_rank(cg::cluster_group& cl,
                                                RankSmem& sm, int32_t e,
                                                int32_t need,
                                                int32_t* grand) {
    const int p = e & 1;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    const int rank = static_cast<int>(cl.block_rank());
    const int32_t incl = warp_inclusive(need, lane);
    if (lane == 31) sm.wsum[p][warp] = incl;
    __syncthreads();
    const int32_t v = lane < nw ? sm.wsum[p][lane] : 0;
    const int32_t vi = warp_inclusive(v, lane);
    const int32_t below = __shfl_sync(kFull, vi - v, warp);
    const int32_t cta_total = __shfl_sync(kFull, vi, 31);
    const int32_t tot = push_poll(cl, sm, e, cta_total, false);
    *grand = __reduce_add_sync(kFull, tot);
    const int32_t lower = __reduce_add_sync(kFull, lane < rank ? tot : 0);
    return lower + below + incl - need;
}

// True on every thread of the cluster if `pred` holds on any, as a
// barrier that orders global memory at cluster scope: every global write
// a thread made before it (an atomic, a store) is visible to every thread
// of the cluster after it.  The CTA's __syncthreads_or orders its
// threads' writes before warp 0's release fence and push; each thread
// fences (acquire) after its warp's poll.
__device__ __forceinline__ bool cluster_any(cg::cluster_group& cl,
                                            RankSmem& sm, int32_t e,
                                            bool pred) {
    const int any = __syncthreads_or(pred);
    const int32_t got = push_poll(cl, sm, e, any, true);
    const bool r = __any_sync(kFull, got != 0);
    fence_cluster();
    return r;
}

// --- the reads of a wave ---------------------------------------------------

// The aligned 16-byte segments holding one table row; NSEG of them are
// loaded at once (a longer row loads the rest in batches of NSEG when it
// is searched).
template <int NSEG>
struct Row {
    uint4 seg[NSEG];
    const uint4* base;   // first aligned segment
    int32_t head;        // byte offset of the row in it
    int32_t nseg;        // segments holding the row
};

template <int NSEG>
__device__ __forceinline__ void load_batch(Row<NSEG>& r, int32_t i0) {
#pragma unroll
    for (int i = 0; i < NSEG; ++i)
        r.seg[i] = i0 + i < r.nseg ? __ldg(r.base + i0 + i)
                                   : make_uint4(0, 0, 0, 0);
}

// The row of `bytes` bytes at p; its first batch loaded.
template <int NSEG>
__device__ __forceinline__ void row_at(Row<NSEG>& r, const void* p,
                                       int32_t bytes) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    r.base = reinterpret_cast<const uint4*>(a & ~uintptr_t(15));
    r.head = static_cast<int32_t>(a & 15);
    r.nseg = (r.head + bytes + 15) >> 4;
    load_batch(r, 0);
}

// Once off is known, rank 0 asks L2 for the next wave's window of words
// (at most L of them): 64 words a line.
__device__ __forceinline__ void prefetch_words(cg::cluster_group& cl,
                                               const uint16_t* words,
                                               int64_t W, int32_t L,
                                               int64_t off) {
    if (cl.block_rank() != 0) return;
    const int64_t w = off + int64_t(threadIdx.x) * 64;
    if (w < W && int64_t(threadIdx.x) * 64 < L)
        asm volatile("prefetch.global.L2 [%0];" :: "l"(words + w));
}

// Renormalization word w, read as words[min(w, W - 1)]: the clamp keeps a
// corrupt payload inside the padded buffer, as the reference's does.
__device__ __forceinline__ uint16_t word_at(const uint16_t* words, int64_t W,
                                            int64_t w) {
    return __ldg(words + (w < W ? w : W - 1));
}

}  // namespace fqk
