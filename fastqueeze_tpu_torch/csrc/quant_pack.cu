// K1 quant_pack: frozen count table -> quantized cumulative frequencies.
//
// Replaces fastqueeze_tpu/ops/engine.py _quant / _quant_full and the
// table half of _pass1_frozen (B3), and _widen_i32 (counts0_dev): the
// count table is read in the type it travels in, u8, u16 or i32 (frozen
// tables are narrow: the seq cap is under 2^8, the qual caps under 2^16),
// so the upload moves the narrow table and no widened copy is made.  One
// thread per context row: F[0] = 0, F[i] = floor(cum_i * 2^14 / C) in
// 64-bit (equal to the reference's two 7-bit division digits, which
// exist only because JAX runs without int64).  Writes the (n_ctx, A+1)
// u16 table the decoder searches and the (n_ctx * A) u32 words
// F[s] | F[s+1] << 16 the encoder gathers once per symbol.  Runs once per
// table and device (the result is cached); bound by device-memory
// traffic, 1-4 B read and 6 B written per entry, and by the strided row
// reads of one thread per row.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

template <typename C>
__global__ void quant_pack(const C* __restrict__ counts, int64_t n_ctx,
                           int32_t A, uint16_t* __restrict__ cum,
                           uint32_t* __restrict__ packed) {
    const int64_t r = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
    if (r >= n_ctx) return;
    const C* row = counts + r * A;
    int64_t tot = 0;
    for (int32_t a = 0; a < A; ++a) tot += row[a];
    if (tot <= 0) tot = 1;      // unreachable: trained tables have init >= 1
    uint16_t* out = cum + r * (A + 1);
    uint32_t* pk = packed + r * A;
    int64_t acc = 0;
    uint32_t prev = 0;
    out[0] = 0;
    for (int32_t a = 0; a < A; ++a) {
        acc += row[a];
        const uint32_t F = static_cast<uint32_t>((acc << 14) / tot);
        out[a + 1] = static_cast<uint16_t>(F);
        pk[a] = prev | (F << 16);
        prev = F;
    }
}

}  // namespace

// width: bytes a count, 1 (u8), 2 (u16) or 4 (i32).
extern "C" int fq_quant_pack(const void* counts, int64_t n_ctx, int32_t A,
                             int32_t width, uint16_t* cum, uint32_t* packed,
                             void* stream) {
    const int threads = 256;
    const int64_t blocks = (n_ctx + threads - 1) / threads;
    if (blocks == 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (width == 1)
        quant_pack<<<blocks, threads, 0, st>>>(
            static_cast<const uint8_t*>(counts), n_ctx, A, cum, packed);
    else if (width == 2)
        quant_pack<<<blocks, threads, 0, st>>>(
            static_cast<const uint16_t*>(counts), n_ctx, A, cum, packed);
    else if (width == 4)
        quant_pack<<<blocks, threads, 0, st>>>(
            static_cast<const int32_t*>(counts), n_ctx, A, cum, packed);
    else
        return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
}
