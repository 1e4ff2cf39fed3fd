// Shared helpers of the pyiga_tpu_torch CUDA kernels.
//
// Every C entry point launches on the stream it is given, allocates
// nothing, and returns cudaGetLastError() so that the Python wrapper can
// raise on a refused launch (a launch refused for its configuration never
// runs, and a later synchronize does not report it).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define PYIGA_EXPORT extern "C" __attribute__((visibility("default")))

// Grid size for a grid-stride loop over n items with `threads` per block:
// enough blocks to fill the card, capped so the loop does the rest.
static inline unsigned int pyiga_grid_1d(long long n, int threads) {
    long long blocks = (n + threads - 1) / threads;
    const long long cap = 132LL * 32;
    if (blocks > cap) blocks = cap;
    if (blocks < 1) blocks = 1;
    return (unsigned int)blocks;
}
