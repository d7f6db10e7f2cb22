// Bounds checks of the checked build (ops/kernels.py build(checked=True)
// compiles every source with -DFQK_CHECK -lineinfo).  In the checked build
// FQK_BOUND prints the kernel, what was read or written, the index and its
// bound, then traps, so the first out-of-range access stops the launch
// where it happens; in the normal build it compiles to nothing.
#pragma once

#include <cstdint>
#include <cstdio>

#ifdef FQK_CHECK
#define FQK_BOUND(kernel, what, idx, bound)                                   \
    do {                                                                      \
        const long long fqk_i_ = static_cast<long long>(idx);                 \
        const long long fqk_b_ = static_cast<long long>(bound);               \
        if (fqk_i_ < 0 || fqk_i_ >= fqk_b_) {                                 \
            printf("FQK_CHECK %s: %s index %lld outside [0, %lld) "           \
                   "(block %d thread %d)\n", kernel, what, fqk_i_, fqk_b_,    \
                   static_cast<int>(blockIdx.x),                              \
                   static_cast<int>(threadIdx.x));                            \
            __trap();                                                         \
        }                                                                     \
    } while (0)
#else
#define FQK_BOUND(kernel, what, idx, bound) ((void)0)
#endif
