"""A host-compiler emulation of the CUDA features the port's field and
generated K5 kernels use, so that CPU tests can run a kernel's own source:
``__global__`` functions become host functions, a launch ``k<<<grid,
threads, smem, stream>>>(args)`` runs each block in turn with one
``std::thread`` per CUDA thread (``threadIdx`` / ``blockIdx`` thread-local),
``__syncthreads`` is a barrier of the block's threads, a warp shuffle an
exchange through a block buffer between two barriers, dynamic shared
memory one buffer a launch and ``__shared__`` arrays statics (the blocks
run one after another), ``__ldg`` a load and ``cp.async`` a copy.  The
arithmetic is the host's IEEE double and float, so a kernel's results
agree with the card's to rounding, not bitwise.  A test aid: no package
code uses it."""

import re
import subprocess

HEADER = r'''
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <math.h>
#include <cstdint>
#include <functional>
#include <thread>
#include <vector>
using std::max;
using std::min;
using std::signbit;
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __shared__ static
#define __constant__ static
struct pyiga_dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local pyiga_dim3 threadIdx, blockIdx;
inline pyiga_dim3 blockDim, gridDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
inline int cudaGetLastError() { return 0; }
template <class F>
inline int cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline std::barrier<>* pyiga_bar = nullptr;
inline double pyiga_shfl[1024];
inline std::vector<double> pyiga_smem;
inline void __syncthreads() { pyiga_bar->arrive_and_wait(); }
template <class T> inline T __shfl_xor_sync(unsigned, T v, int off) {
    const unsigned t = threadIdx.x;
    pyiga_shfl[t] = (double)v;
    pyiga_bar->arrive_and_wait();
    const T r = (T)pyiga_shfl[(t & ~31u) | ((t & 31u) ^ (unsigned)off)];
    pyiga_bar->arrive_and_wait();
    return r;
}
inline unsigned long long __cvta_generic_to_shared(const void* p) {
    return (unsigned long long)p;
}
inline void pyiga_launch(unsigned grid, int threads, size_t smem, void*,
                         std::function<void()> f) {
    gridDim.x = grid;
    blockDim.x = threads;
    pyiga_smem.assign(smem / 8 + 16, 0.0);
    for (unsigned b = 0; b < grid; ++b) {
        std::barrier<> bar(threads);
        pyiga_bar = &bar;
        std::vector<std::thread> ts;
        for (int t = 0; t < threads; ++t)
            ts.emplace_back([&, t, b] {
                threadIdx.x = t;
                blockIdx.x = b;
                f();
            });
        for (auto& th : ts) th.join();
    }
}
'''

# csrc/dmma.cuh's cp.async helpers as plain copies (the only part of it
# the field kernels use)
DMMA = r'''
#pragma once
namespace dmma {
template <int BYTES>
inline void cp_async(double* dst, const double* src, int) { *dst = *src; }
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}
}
'''


def translate(source):
    """A CUDA source as host C++ under :data:`HEADER`: launches through
    ``pyiga_launch``, dynamic shared memory its buffer, the one inline
    ``cp.async`` of 4 bytes a copy."""
    s = re.sub(r'([\w:]+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\s*\((.*?)\);',
               lambda m: 'pyiga_launch(%s, [&]() { %s(%s); });'
               % (m.group(2), m.group(1), m.group(3)), source, flags=re.S)
    s = re.sub(r'asm volatile\("cp\.async\.ca\.shared\.global \[%0\], '
               r'\[%1\], 4, 4;\\n"\s*:: "r"\(d\), "l"\(src\)\);',
               '*dst = *src; (void)d;', s, flags=re.S)
    s = re.sub(r'extern __shared__ double (\w+)\[\];',
               r'double* \1 = pyiga_smem.data();', s)
    s = s.replace('extern "C" __global__', '__global__')
    return s.replace('#include <cuda_runtime.h>', '#include "cuda_runtime.h"')


def build(directory, name, sources, headers=()):
    """Compile `sources` (``{file name: CUDA text}``, each translated) with
    the host compiler into ``lib<name>.so`` in `directory`, one process
    per source, all started together, beside `headers` (``{file name:
    text}``, translated) and the emulation's own; returns its path."""
    directory.mkdir(parents=True, exist_ok=True)
    (directory / 'cuda_runtime.h').write_text(HEADER)
    (directory / 'dmma.cuh').write_text(DMMA)
    for fname, text in dict(headers).items():
        (directory / fname).write_text(translate(text))
    procs, objs = [], []
    for fname, text in sources.items():
        src = directory / (fname + '.cc')
        src.write_text(translate(text))
        obj = directory / (fname + '.o')
        objs.append(str(obj))
        procs.append(subprocess.Popen(
            ['g++', '-std=c++20', '-O1', '-fPIC', '-pthread', '-w', '-I',
             str(directory), '-c', '-o', str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        out = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError('g++ failed:\n' + out[:4000])
    lib = directory / ('lib%s.so' % name)
    subprocess.run(['g++', '-shared', '-pthread', '-o', str(lib), *objs],
                   check=True)
    return lib
