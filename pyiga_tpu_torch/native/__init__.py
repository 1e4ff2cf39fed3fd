"""Native (C++) host kernels: the Gauss-Seidel sweeps of the local
multigrid smoother's host path and the rank-1 update of the 2D ACA (a
copy of :mod:`pyiga_tpu.native`).

``iga_kernels.cc`` is compiled with g++ at first use into
``build/pyiga_tpu_torch/native/`` beside the package (named by a hash of
the source) and loaded with ctypes.  Without a compiler the numpy loops
below run instead, with the same visit order.  Nothing is compiled at
import time.
"""

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / 'iga_kernels.cc'
BUILD_DIR = (Path(__file__).resolve().parent.parent.parent / 'build'
             / 'pyiga_tpu_torch' / 'native')

_lock = threading.Lock()
_LIB = None
_TRIED = False


def _build_library():
    src = _SRC.read_bytes()
    out = BUILD_DIR / ('libiga_%s.so' % hashlib.sha256(src).hexdigest()[:16])
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(out.name + '.tmp.%d' % os.getpid())
        subprocess.run(['g++', '-O3', '-march=native', '-shared', '-fPIC',
                        '-o', str(tmp), str(_SRC)],
                       check=True, capture_output=True)
        os.replace(tmp, out)
    return out


def get_lib():
    """Load (building if necessary) the native kernel library, or None."""
    global _LIB, _TRIED
    with _lock:
        if _TRIED:
            return _LIB
        _TRIED = True
        try:
            lib = ctypes.CDLL(str(_build_library()))
        except (OSError, subprocess.CalledProcessError) as e:
            print('pyiga_tpu_torch.native: using the numpy loops (%s)' % e,
                  file=sys.stderr)
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.gauss_seidel_csr.argtypes = [
            i64p, i64p, f64p, f64p, f64p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
        lib.gauss_seidel_csr.restype = None
        lib.gauss_seidel_csr_indexed.argtypes = [
            i64p, i64p, f64p, f64p, f64p, i64p,
            ctypes.c_int64, ctypes.c_int]
        lib.gauss_seidel_csr_indexed.restype = None
        lib.rank_1_update.argtypes = [f64p, ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_double, f64p, f64p]
        lib.rank_1_update.restype = None
        _LIB = lib
        return _LIB


def _i64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _f64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _csr_arrays(A):
    indptr = np.asarray(A.indptr, dtype=np.int64)
    indices = np.asarray(A.indices, dtype=np.int64)
    data = np.asarray(A.data, dtype=np.float64)
    return indptr, indices, data


def _x_buffer(x):
    """A float64 C-contiguous buffer for the in-place update.  Returns
    ``(buf, writeback)``: `buf` aliases `x` when it already has the right
    dtype and layout; otherwise a converted copy that the caller copies
    back (a float32 or strided buffer passed to the C kernel would be
    reinterpreted as double*)."""
    if (isinstance(x, np.ndarray) and x.dtype == np.float64
            and x.flags.c_contiguous):
        return x, False
    return np.ascontiguousarray(x, dtype=np.float64), True


def _sweep_rows_numpy(indptr, indices, data, x, b, order):
    for i in order:
        lo, hi = indptr[i], indptr[i + 1]
        cols = indices[lo:hi]
        vals = data[lo:hi]
        z = vals @ x[cols]
        dv = vals[cols == i]
        diag = dv[0] if len(dv) else 0.0
        if diag != 0.0:             # zero/missing diagonal: skip
            x[i] = (b[i] - (z - diag * x[i])) / diag


def gauss_seidel_sweep(A, x, b, reverse=False):
    """One forward/backward Gauss-Seidel sweep on CSR matrix `A`, in
    place (a non-contiguous or non-f64 `x` is updated through a
    copy-back)."""
    indptr, indices, data = _csr_arrays(A)
    x_in = x
    x, writeback = _x_buffer(x)
    b = np.ascontiguousarray(b, dtype=np.float64)
    N = A.shape[0]
    lib = get_lib()
    if lib is not None:
        start, end, step = (N - 1, -1, -1) if reverse else (0, N, 1)
        lib.gauss_seidel_csr(_i64(indptr), _i64(indices), _f64(data),
                             _f64(x), _f64(b), start, end, step)
    else:
        _sweep_rows_numpy(indptr, indices, data, x, b,
                          range(N - 1, -1, -1) if reverse else range(N))
    if writeback:
        x_in[...] = x
        return x_in
    return x


def gauss_seidel_sweep_indexed(A, x, b, rows, reverse=False):
    """Gauss-Seidel sweep over the given row subset, in the given order
    (a non-contiguous or non-f64 `x` is updated through a copy-back)."""
    indptr, indices, data = _csr_arrays(A)
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    x_in = x
    x, writeback = _x_buffer(x)
    b = np.ascontiguousarray(b, dtype=np.float64)
    lib = get_lib()
    if lib is not None:
        lib.gauss_seidel_csr_indexed(_i64(indptr), _i64(indices), _f64(data),
                                     _f64(x), _f64(b), _i64(rows), len(rows),
                                     int(reverse))
    else:
        _sweep_rows_numpy(indptr, indices, data, x, b,
                          rows[::-1] if reverse else rows)
    if writeback:
        x_in[...] = x
        return x_in
    return x


def rank_1_update(A, alpha, x, y):
    """In-place ``A += alpha * outer(x, y)`` (single-threaded native
    kernel; numpy for a non-contiguous or non-f64 `A`)."""
    lib = get_lib()
    if lib is not None and A.dtype == np.float64 and A.flags.c_contiguous:
        lib.rank_1_update(_f64(A), A.shape[0], A.shape[1], float(alpha),
                          _f64(np.ascontiguousarray(x, dtype=np.float64)),
                          _f64(np.ascontiguousarray(y, dtype=np.float64)))
        return A
    A += alpha * np.outer(x, y)
    return A
