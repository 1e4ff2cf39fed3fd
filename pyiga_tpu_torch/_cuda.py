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
went through the kernels.  A wrapper whose kernel has no backward calls
:func:`no_grad_operands` before it launches: its output is written through
a raw pointer, so autograd would lose every gradient there without a word.
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
            'vform_fields': 0, 'vcycle': 0, 'vcycle_wavefront': 0,
            'wavefront_gs': 0,
            # the backward kernels of the differentiable assembly (diff.py)
            'fields_bwd': 0, 'mass_fields_bwd': 0, 'geo_jac_fields_bwd': 0,
            'stage_bwd': 0, 'fold_bwd': 0, 'vform_adjoint': 0,
            # the windowed route (csrc/windowed.cu)
            'windowed_stage': 0, 'windowed_fold': 0,
            # the float32 instances of K1 (stiffness, mass), K2 and K3
            'fields_f32': 0, 'mass_fields_f32': 0, 'stage_f32': 0,
            'fold_f32': 0,
            # ... and of K1's jac kind, K1', K5, K8 and K8f
            'geo_jac_fields_f32': 0, 'host_jac_fields_f32': 0,
            'vform_fields_f32': 0, 'windowed_stage_f32': 0,
            'windowed_fold_f32': 0,
            # ... and of the backward kernels and K5's adjoint
            'fields_bwd_f32': 0, 'mass_fields_bwd_f32': 0,
            'geo_jac_fields_bwd_f32': 0, 'stage_bwd_f32': 0,
            'fold_bwd_f32': 0, 'vform_adjoint_f32': 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double
_SIGNATURES = {
    'pyiga_stiff_fields_f64': (_P, _P, _P, _P, _P, _I, _I, _L, _I, _I, _P),
    'pyiga_mass_fields_f64': (_P, _P, _P, _P, _P, _I, _I, _L, _I, _I, _P),
    'pyiga_stiff_fields_f32': (_P, _P, _P, _P, _P, _I, _I, _L, _I, _I, _P),
    'pyiga_mass_fields_f32': (_P, _P, _P, _P, _P, _I, _I, _L, _I, _I, _P),
    'pyiga_host_jac_fields_f64': (_P, _P, _P, _P, _I, _L, _I, _P),
    'pyiga_host_jac_fields_f32': (_P, _P, _P, _P, _I, _L, _I, _P),
    'pyiga_geo_jac_fields_f64': (_P, _P, _P, _I, _I, _I, _L, _I, _I, _P),
    'pyiga_geo_jac_fields_f32': (_P, _P, _P, _I, _I, _I, _L, _I, _I, _P),
    'pyiga_fields_bwd_f64': (_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _L, _I,
                             _I, _P),
    'pyiga_fields_bwd_f32': (_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _L, _I,
                             _I, _P),
    'pyiga_stage_f64': (_P, _P, _P, _I, _L, _I, _P),
    'pyiga_fold_f64': (_P, _P, _I, _P, _I, _L, _I, _P),
    'pyiga_stage_f32': (_P, _P, _P, _I, _L, _I, _P),
    'pyiga_fold_f32': (_P, _P, _I, _P, _I, _L, _I, _P),
    'pyiga_stage_bwd_f64': (_P, _I, _P, _P, _I, _L, _I, _P),
    'pyiga_stage_bwd_f32': (_P, _I, _P, _P, _I, _L, _I, _I, _I, _P, _P, _P),
    'pyiga_stage_bwd_f32_tiles': (_P, _I),
    'pyiga_stage_T_f64': (_P, _P, _P, _I, _L, _I, _P),
    'pyiga_tail_fused_f64': (_P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P),
    'pyiga_flat_banded_f64': (_P, _P, _P, _P, _I, _L, _L, _P),
    'pyiga_flat_banded_f32': (_P, _P, _P, _P, _I, _L, _L, _P),
    'pyiga_vcycle_blocks': (_I, _L, _P),
    'pyiga_vcycle_f64': (_P, _P, _P, _P, _P, _P, _D, _D, _I, _P, _I, _I, _L,
                         _P),
    'pyiga_wavefront_gs_f64': (_P, _I, _I, _P, _P, _L, _P),
    'pyiga_wavefront_quotient_f64': (_P, _P, _P, _P, _L, _P),
    'pyiga_wavefront_layout': (_I,),
    'pyiga_windowed_stage_f64': (_P, _P, _P, _P, _L, _L, _I, _I, _I, _I, _P),
    'pyiga_windowed_fold_f64': (_P, _P, _I, _P, _P, _L, _L, _I, _I, _I, _I,
                                _P),
    'pyiga_windowed_stage_f32': (_P, _P, _P, _P, _L, _L, _I, _I, _I, _I, _P),
    'pyiga_windowed_fold_f32': (_P, _P, _I, _P, _P, _L, _L, _I, _I, _I, _I,
                                _P),
    'pyiga_windowed_plan': (_L, _L, _I, _I, _I, _I, _I, _I, _P),
    'pyiga_windowed_plan_f32': (_L, _L, _I, _I, _I, _I, _I, _I, _P),
    'pyiga_windowed_last_copy': (),
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
    """The loaded kernel library (built on first call; later calls take
    no lock)."""
    global _lib
    if _lib is not None:
        return _lib
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


_SM_COUNTS = {}


def sm_count(t):
    """The number of SMs of `t`'s CUDA device (cached per device)."""
    i = t.device.index
    if i not in _SM_COUNTS:
        _SM_COUNTS[i] = torch.cuda.get_device_properties(
            t.device).multi_processor_count
    return _SM_COUNTS[i]


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


def no_grad_operands(name, *tensors):
    """Raise if autograd would record a call of the kernel `name` on
    `tensors`: grad mode on and an operand that requires grad.  For the
    CUDA branch of a wrapper whose kernel has no backward (its output is
    written through a raw pointer, so the gradient would be lost without
    a word, while the plain version on the CPU has one)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            '%s: the CUDA kernel has no backward; call it under '
            'torch.no_grad() or on operands that do not require grad'
            % name)


def constant_operands(name, *tensors):
    """Raise if a gradient is asked of an operand that the differentiable
    assembly holds constant (basis tables, Gauss weights): its Function
    gives that operand none, and would drop it without a word."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError('%s: tables and weights are constants, no '
                           'gradient flows to them' % name)


def loop_vmap(apply):
    """A custom Function's ``vmap`` rule that applies it to each member of
    the batch in turn and stacks the results (the kernels behind the
    Functions are ctypes calls, which ``torch.func.vmap`` cannot trace).
    A Function with several outputs gets each of them stacked."""
    def vmap(info, in_dims, *args):
        outs = [apply(*[a.select(d, b).contiguous()
                        if isinstance(a, torch.Tensor) and d is not None
                        else a for a, d in zip(args, in_dims)])
                for b in range(info.batch_size)]
        if isinstance(outs[0], tuple):
            return (tuple(torch.stack(o) for o in zip(*outs)),
                    (0,) * len(outs[0]))
        return torch.stack(outs), 0
    return staticmethod(vmap)


def _functorch_wrapped(t):
    return torch._C._functorch.is_functorch_wrapped_tensor(t)


def no_double_backward(name, *tensors):
    """The guard of a backward kernel's wrapper: :func:`no_grad_operands`
    on the operands that autograd records directly.  An operand wrapped by
    a ``torch.func`` transform (``grad``, ``vjp``, ``jacrev``: they always
    record the backward pass) is left to the Function the wrapper
    launches through, whose own backward raises (:func:`refuse_backward`)
    if a second derivative is ever asked of it."""
    no_grad_operands(name, *(t for t in tensors
                             if t is not None and not _functorch_wrapped(t)))


def refuse_backward(name):
    """Raise as a backward kernel's Function does when autograd asks for
    its own backward (a second derivative through the assembly on the
    card; the plain versions on the CPU have one)."""
    raise RuntimeError('%s: the CUDA kernel has no backward; a second '
                       'derivative through it runs on the CPU only' % name)
