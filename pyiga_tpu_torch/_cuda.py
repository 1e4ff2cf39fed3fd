"""Build, load and call the package's CUDA kernels (``csrc/*.cu``).

The sources are compiled at first use, one ``nvcc`` process per source,
all started together, and linked into a shared library with a plain C
interface, loaded with :mod:`ctypes`.  The
library lands in ``build/pyiga_tpu_torch/`` beside the package, named by a
hash of the sources and flags, so an edit rebuilds and an unchanged tree
reuses the library.  Kernels generated at run time (one per variational
form, :mod:`pyiga_tpu_torch.ops.cuda_vform`) go through
:func:`build_generated` into libraries of their own under ``gen/``.
Nothing is compiled or loaded at import time: this module imports on
machines without a GPU or a CUDA toolkit, where the kernel wrappers run
their plain PyTorch versions on CPU tensors.

Every C entry returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on a nonzero code.  Each wrapper counts its launches
in :data:`LAUNCHES` (a plain dict of integers), so a run can show that it
went through the kernels.
"""

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

SRC_DIR = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parent.parent / 'build' / 'pyiga_tpu_torch'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-Xcompiler', '-fPIC', '-Xptxas=-v')

# kernel name -> launches since the last reset_launches()
LAUNCHES = {'fields': 0, 'geo_jac_fields': 0, 'mass_fields': 0,
            'host_jac_fields': 0, 'stage': 0, 'fold': 0, 'stage_T': 0,
            'tail_fused': 0, 'flat_banded_f64': 0, 'flat_banded_f32': 0,
            'vform_fields': 0, 'vcycle': 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double
_SIGNATURES = {
    'pyiga_stiff_fields_f64': (_P, _P, _P, _P, _P, _I, _I, _L, _I, _I, _P),
    'pyiga_mass_fields_f64': (_P, _P, _P, _P, _P, _I, _I, _L, _I, _I, _P),
    'pyiga_host_jac_fields_f64': (_P, _P, _P, _I, _L, _P),
    'pyiga_geo_jac_fields_f64': (_P, _P, _P, _I, _I, _L, _I, _I, _P),
    'pyiga_stage_f64': (_P, _P, _P, _I, _L, _I, _P),
    'pyiga_fold_f64': (_P, _P, _I, _P, _I, _L, _I, _P),
    'pyiga_stage_T_f64': (_P, _P, _P, _I, _L, _I, _P),
    'pyiga_tail_fused_f64': (_P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P),
    'pyiga_flat_banded_f64': (_P, _P, _P, _P, _I, _L, _L, _P),
    'pyiga_flat_banded_f32': (_P, _P, _P, _P, _I, _L, _L, _P),
    'pyiga_vcycle_blocks': (_I, _L, _P),
    'pyiga_vcycle_f64': (_P, _P, _P, _P, _P, _P, _D, _D, _I, _P, _I, _I, _L,
                         _P),
}

_lock = threading.Lock()
_lib = None
# what the last build reported: library path, seconds, nvcc's output
BUILD_INFO = {}
# generated libraries: path -> loaded CDLL, and path -> build record
_gen_libs = {}
GEN_BUILDS = {}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _sources():
    return sorted(SRC_DIR.glob('*.cu')) + sorted(SRC_DIR.glob('*.cuh'))


def _nvcc():
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    if home and (Path(home) / 'bin' / 'nvcc').exists():
        return str(Path(home) / 'bin' / 'nvcc')
    found = shutil.which('nvcc')
    if found:
        return found
    default = Path('/usr/local/cuda/bin/nvcc')
    if default.exists():
        return str(default)
    raise RuntimeError('nvcc not found (set CUDA_HOME): the CUDA kernels '
                       'are built from csrc/ at first use on a GPU machine')


def _run(cmd, what):
    """Run an nvcc command; returns its output, raises with it on failure."""
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError('nvcc failed on %s (%d):\n%s\n%s'
                           % (what, res.returncode, res.stdout, res.stderr))
    return (res.stdout + res.stderr).strip()


def build():
    """Compile ``csrc/*.cu`` into the hashed shared library unless it
    exists; returns its path.  Every source compiles in its own ``nvcc``
    process, all at once, then one ``nvcc -shared`` links the objects.
    Records the build in :data:`BUILD_INFO`."""
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    lib = BUILD_DIR / ('libpyiga_tpu_torch_%s.so' % h.hexdigest()[:16])
    if lib.exists():
        BUILD_INFO.update(path=str(lib), seconds=0.0, log='(cached)')
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        srcs = [p for p in _sources() if p.suffix == '.cu']
        objs = [os.path.join(tmpdir, p.stem + '.o') for p in srcs]
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, '-c', '-o', o,
                                   str(p)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for p, o in zip(srcs, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        for p, proc, out in zip(srcs, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError('nvcc failed on %s (%d):\n%s'
                                   % (p, proc.returncode, out))
        tmp = os.path.join(tmpdir, lib.name)
        logs.append(_run([_nvcc(), '-shared', '-o', tmp, *objs], 'the link'))
        os.replace(tmp, lib)
    BUILD_INFO.update(path=str(lib), seconds=time.perf_counter() - t0,
                      log='\n'.join(x.strip() for x in logs if x.strip()))
    return lib


def build_generated(name, source):
    """Compile a generated CUDA source into its own shared library and
    load it (cached per process, and on disk across processes: an
    unchanged source is never rebuilt).

    The source is written to ``build/pyiga_tpu_torch/gen/`` under a name
    hashed from the source and :data:`NVCC_FLAGS`, compiled with those
    flags and loaded with ctypes; the caller declares its entry points.
    A failed build raises with nvcc's output.  Records the build in
    :data:`GEN_BUILDS` (library path -> seconds, nvcc's output)."""
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    h.update(source.encode())
    stem = '%s_%s' % (name, h.hexdigest()[:16])
    gen_dir = BUILD_DIR / 'gen'
    lib = gen_dir / ('lib%s.so' % stem)
    with _lock:
        if str(lib) in _gen_libs:
            return _gen_libs[str(lib)]
        if lib.exists():
            GEN_BUILDS[str(lib)] = dict(seconds=0.0, log='(cached)')
        else:
            gen_dir.mkdir(parents=True, exist_ok=True)
            src = gen_dir / ('%s.cu' % stem)
            src.write_text(source)
            fd, tmp = tempfile.mkstemp(suffix='.so', dir=gen_dir)
            os.close(fd)
            t0 = time.perf_counter()
            try:
                log = _run([_nvcc(), *NVCC_FLAGS, '-shared', '-o', tmp,
                            str(src)], src)
            except RuntimeError:
                os.unlink(tmp)
                raise
            os.replace(tmp, lib)
            GEN_BUILDS[str(lib)] = dict(seconds=time.perf_counter() - t0,
                                        log=log)
        _gen_libs[str(lib)] = ctypes.CDLL(str(lib))
        return _gen_libs[str(lib)]


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            lib.pyiga_vcycle_smem.argtypes = [_L]
            lib.pyiga_vcycle_smem.restype = _L
            lib.pyiga_error_string.argtypes = [ctypes.c_int]
            lib.pyiga_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err, name):
    if err != 0:
        msg = library().pyiga_error_string(err).decode()
        raise RuntimeError('%s: CUDA launch failed: %s (%d)' % (name, msg, err))


def stream_of(t):
    """Handle of PyTorch's current stream on `t`'s device (the raw handle:
    building a ``torch.cuda.Stream`` for it costs microseconds a launch)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


_SAME_DEVICE = contextlib.nullcontext()


def device_of(t):
    """A context that makes `t`'s device current for a launch: nothing to
    do when it already is (the usual case; switching and restoring costs
    microseconds a launch)."""
    if torch._C._cuda_getDevice() == t.device.index:
        return _SAME_DEVICE
    return torch.cuda.device(t.device)


def require(t, name, dtype, ndim):
    """Check a kernel operand: CUDA, `dtype`, contiguous, rank `ndim`."""
    if not t.is_cuda:
        raise ValueError('%s must be a CUDA tensor' % name)
    if t.dtype != dtype:
        raise ValueError('%s must be %s, got %s' % (name, dtype, t.dtype))
    if not t.is_contiguous():
        raise ValueError('%s must be contiguous' % name)
    if t.dim() != ndim:
        raise ValueError('%s must have %d dims, got shape %s'
                         % (name, ndim, tuple(t.shape)))
