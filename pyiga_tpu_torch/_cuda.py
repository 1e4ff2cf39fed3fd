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
The kernels of the differentiable assembly launch through autograd
Functions whose rules are kernels too (their ``jvp``, ``backward`` and
``vmap``, :func:`loop_vmap`), so first and second derivatives, in either
mode, run on the card.
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
from torch.autograd import forward_ad

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
            'fold_bwd_f32': 0, 'vform_adjoint_f32': 0,
            # forward mode and second derivatives: K1-jvp, K1-hvp, and the
            # generated K5 tangent and second-order adjoint programs
            'fields_jvp': 0, 'mass_fields_jvp': 0, 'geo_jac_fields_jvp': 0,
            'fields_hvp': 0, 'mass_fields_hvp': 0, 'geo_jac_fields_hvp': 0,
            'vform_tangent': 0, 'vform_second': 0,
            'fields_jvp_f32': 0, 'mass_fields_jvp_f32': 0,
            'geo_jac_fields_jvp_f32': 0, 'fields_hvp_f32': 0,
            'mass_fields_hvp_f32': 0, 'geo_jac_fields_hvp_f32': 0,
            'vform_tangent_f32': 0, 'vform_second_f32': 0}

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
    'pyiga_fields_jvp_f64': (_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _L, _I,
                             _I, _P),
    'pyiga_fields_jvp_f32': (_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _L, _I,
                             _I, _P),
    'pyiga_fields_hvp_f64': (_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _L,
                             _I, _I, _P),
    'pyiga_fields_hvp_f32': (_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _L,
                             _I, _I, _P),
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
    Records the build in :data:`BUILD_INFO` (its ``sources``: the
    seconds each source's nvcc took, slowest first)."""
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
        logs, done = [None] * len(procs), {}

        def wait(i):        # one thread a process: its time and its output
            logs[i] = procs[i].communicate()[0]
            done[srcs[i].name] = time.perf_counter() - t0
        waits = [threading.Thread(target=wait, args=(i,))
                 for i in range(len(procs))]
        for w in waits:
            w.start()
        for w in waits:
            w.join()
        for p, proc, out in zip(srcs, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError('nvcc failed on %s (%d):\n%s'
                                   % (p, proc.returncode, out))
        tmp = os.path.join(tmpdir, lib.name)
        logs.append(_run([_nvcc(), '-shared', '-o', tmp, *objs], 'the link'))
        os.replace(tmp, lib)
    BUILD_INFO.update(path=str(lib), seconds=time.perf_counter() - t0,
                      sources={k: round(v, 1) for k, v in sorted(
                          done.items(), key=lambda kv: -kv[1])},
                      log='\n'.join(x.strip() for x in logs if x.strip()))
    return lib


def generated_path(name, source):
    """The library :func:`build_generated` builds `source` into:
    ``build/pyiga_tpu_torch/gen/lib<name>_<hash>.so``, the hash of the
    source and :data:`NVCC_FLAGS`."""
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    h.update(source.encode())
    return BUILD_DIR / 'gen' / ('lib%s_%s.so' % (name, h.hexdigest()[:16]))


def build_generated(name, source):
    """Compile a generated CUDA source into its own shared library and
    load it (cached per process, and on disk across processes: an
    unchanged source is never rebuilt).

    The source is written to ``build/pyiga_tpu_torch/gen/`` under a name
    hashed from the source and :data:`NVCC_FLAGS`, compiled with those
    flags and loaded with ctypes; the caller declares its entry points.
    A failed build raises with nvcc's output.  Records the build in
    :data:`GEN_BUILDS` (library path -> seconds, nvcc's output)."""
    lib = generated_path(name, source)
    gen_dir, stem = lib.parent, lib.stem[3:]
    with _lock:
        if str(lib) in _gen_libs:
            return _gen_libs[str(lib)]
        cached = lib.exists()
    if not cached:
        # nvcc runs outside the lock: threads building different sources
        # compile at once (each into a file of its own, then renamed)
        gen_dir.mkdir(parents=True, exist_ok=True)
        fd, src = tempfile.mkstemp(suffix='.cu', prefix=stem + '_',
                                   dir=gen_dir)
        with os.fdopen(fd, 'w') as f:
            f.write(source)
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=gen_dir)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            log = _run([_nvcc(), *NVCC_FLAGS, '-shared', '-o', tmp, src],
                       src)
        except RuntimeError:
            os.unlink(tmp)
            raise
        finally:
            os.replace(src, gen_dir / ('%s.cu' % stem))
        os.replace(tmp, lib)
        built = dict(seconds=time.perf_counter() - t0, log=log)
    with _lock:
        if str(lib) not in _gen_libs:
            GEN_BUILDS[str(lib)] = (built if not cached
                                    else dict(seconds=0.0, log='(cached)'))
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


def _has_tangent(t):
    """Whether forward mode may carry a tangent on `t`: a dual tensor of
    ``torch.autograd.forward_ad`` with its tangent at the current level,
    or a tensor wrapped by a ``torch.func`` transform (the wrapper does
    not tell ``jvp``'s from ``vmap``'s or ``grad``'s; the kernels behind
    raw launches can take none of them)."""
    if torch._C._functorch.is_functorch_wrapped_tensor(t):
        return True
    return (forward_ad._current_level >= 0
            and forward_ad.unpack_dual(t).tangent is not None)


def differentiated(*tensors):
    """Whether a call on `tensors` would be differentiated: grad mode on
    and one of them requires grad, or one carries a forward-mode tangent
    (:func:`_has_tangent`; forward mode runs whatever grad mode says).
    None entries are skipped."""
    ts = [t for t in tensors if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        return True
    return any(_has_tangent(t) for t in ts)


def no_grad_operands(name, *tensors):
    """Raise if a call of the kernel `name` on `tensors` would be
    differentiated (:func:`differentiated`: grad mode on and an operand
    that requires grad, or an operand with a forward-mode tangent).  For
    the CUDA branch of a wrapper whose kernel has no derivative (its
    output is written through a raw pointer, so the gradient or tangent
    would be lost without a word, while the plain version on the CPU has
    one)."""
    if differentiated(*tensors):
        raise RuntimeError(
            '%s: the CUDA kernel has no backward and no forward-mode rule; '
            'call it under torch.no_grad() on operands that carry no '
            'tangent, or on operands that do not require grad' % name)


def constant_operands(name, *tensors):
    """Raise if a gradient is asked of an operand that the differentiable
    assembly holds constant (basis tables, Gauss weights): its Function
    gives that operand none, and would drop it without a word."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError('%s: tables and weights are constants, no '
                           'gradient flows to them' % name)


def constant_tangents(name, *tangents):
    """Raise if a forward-mode tangent reaches an operand that the
    differentiable assembly holds constant (tables, weights): the
    Function's ``jvp`` would drop it without a word (the counterpart of
    :func:`constant_operands` for forward mode)."""
    if any(t is not None for t in tangents):
        raise RuntimeError('%s: tables and weights are constants, no '
                           'tangent flows through them' % name)


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


class Launch(torch.autograd.Function):
    """``apply(fn, *args)``: ``fn(*args)``, a raw kernel launch (a ctypes
    call, which ``torch.func.vmap`` cannot trace), with a ``vmap`` rule
    that calls it once a member of the batch.  The rules of the
    differentiable Functions launch their kernels through it (K1-jvp,
    K1-hvp, K5's tangent and second-order programs, the Krylov solve of
    ``diff.implicit_cg_solve``); it has no derivative of its own."""

    @staticmethod
    def forward(fn, *args):
        return fn(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    vmap = loop_vmap(lambda *a: Launch.apply(*a))
