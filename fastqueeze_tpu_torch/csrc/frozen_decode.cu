// K4 frozen_decode: frozen-table rANS decode of one stream, one thread
// block cluster.
//
// Replaces fastqueeze_tpu/ops/engine.py _device_aux (B1) and
// _decode_frozen (B6).  The body is frozen_wave.cuh's, which K18 shares
// (with the table cut into row shards): one cluster of up to 8 CTAs, one
// lane a thread with its state in registers up to 4096 lanes, several
// lanes a thread above; the row fetched as aligned 16-byte segments and
// searched by counting, the next wave's row fetched before the rank, the
// rank by a push-and-poll exchange between the CTAs.  What bounds it is
// the wave's dependent chain, T times over (row fetch, search, rank, word
// fetch).  The first design ran one CTA of 1,024 threads per stream, 4
// lanes a thread walked one after another with their state in global
// scratch, a dependent binary search over the row (log2 A loads) and a
// three-barrier block scan: ~35 us a wave on the order-10 seq table; on
// an H100 this one takes 2.6 us (seq) and 5.4 us (--qlevel 3 quality).

#include <cstdint>

#include <cuda_runtime.h>

#include "frozen_wave.cuh"

// lanes: scratch of L * sizeof(WaveLane) bytes (fq_decode_lane_bytes()),
// used when L > 4096 (several lanes a thread).
extern "C" int64_t fq_decode_lane_bytes() { return sizeof(WaveLane); }

// The cluster K4 launches for L lanes: out[0] CTAs (the cluster's size),
// out[1] threads a CTA, out[2] lanes a thread, out[3] how many such
// clusters the card can hold at once (cudaOccupancyMaxActiveClusters;
// 0: the card cannot run it).
extern "C" int fq_frozen_decode_shape(int32_t L, int32_t kind,
                                      int32_t* out) {
    return wave_shape<WholeRows>(L, kind, out);
}

extern "C" int fq_frozen_decode(
        const uint32_t* states0, const uint16_t* words, int64_t W,
        const int32_t* cgrid, int32_t J, int32_t T, int32_t L,
        const uint16_t* cum, int32_t A, int32_t kind, int64_t a, int64_t b,
        int64_t c, int64_t d, int64_t e, int64_t f, int64_t g, void* lanes,
        uint8_t* out, void* stream) {
    const ModelSpec m{kind, a, b, c, d, e, f, g};
    const WaveArgs<WholeRows> args{states0, words, W, cgrid, J, T, L,
                                   WholeRows{cum, A},
                                   static_cast<WaveLane*>(lanes), 1, out,
                                   nullptr};
    return wave_decode(args, m, static_cast<cudaStream_t>(stream));
}
