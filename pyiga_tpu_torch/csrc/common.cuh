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

static inline bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The order in which the folds (K3, K3 f32, K7b) visit n terms: grouped
// by their table pointer `tab[t]`, groups in order of first appearance,
// terms in their given order within a group (a fixed order: the kernels
// are deterministic).  Fills order[n] with term indices and end[g] with
// one past group g's last position; returns the number of groups.
static inline int group_by_table(const uint64_t* tab, int n, int* order,
                                 int* end) {
    int q = 0, groups = 0;
    for (int u = 0; u < n; ++u) {
        bool first = true;
        for (int v = 0; v < u; ++v) first = first && tab[v] != tab[u];
        if (!first) continue;
        for (int t = u; t < n; ++t)
            if (tab[t] == tab[u]) order[q++] = t;
        end[groups++] = q;
    }
    return groups;
}
