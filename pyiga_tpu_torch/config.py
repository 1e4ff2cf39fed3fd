"""Compute dtype, host threads and default device of the port.

The compute dtype is process-wide state, as in the JAX package
(:func:`set_dtype`, :func:`get_dtype`): float64 by default, float32 for
the f32 line.  Under float32 every assembly path runs its kernels'
float32 instances and nothing of it computes in float64: the Poisson and
mass assemblers (K1's stiffness and ``mass`` kinds, K2, K3, K4), VForm
assembly with ``assemble()``, ``stiffness`` / ``mass``, boundary and
surface forms, the ACA slices and the hierarchical per-level assemblies
(K1's ``jac`` kind and the generated K5), the windowed route (K8, K8f)
and the stiffness of a host-evaluated geometry (K1'), and so does the
differentiable assembly (:mod:`~pyiga_tpu_torch.diff`: K1's backward,
K2-bwd / K3-bwd and K5's adjoint in float32).  The local-multigrid
solves take the matrix the float32 hierarchical assembly returns and
solve in float64 (K6 and the wavefront smoothers), as the JAX package's
``ops/mg.py`` and ``solvers.py`` do whatever the dtype; the time
steppers' device operators are float64 too.  The fused tail K7 has no
float32 instance: float32 chains take K2 + K3, as the JAX package's f32
line runs no fused tail.  The host thread count (:func:`get_max_threads`)
is process-wide too.

Every entry point takes ``device=``, and omitting it means the card
(``torch.device('cuda')``).  Pass ``device='cpu'`` to run on the CPU,
where each kernel wrapper runs its plain PyTorch version.  No entry point
checks for a card or falls back to the CPU: on a machine without one, a
call that omits ``device=`` fails where torch first touches CUDA.

The JAX package's config also selects a backend, Pallas interpret mode, a
persistent XLA cache and two dof cutoffs that route small hierarchical
assemblies and local-MG solves to the host.  The first three are TPU and
XLA machinery with no counterpart here.  The cutoffs route by problem
size; the port routes by ``device=`` and ``relax_backend=`` instead, and
has no such switch: on the H100 the card wins at every size the JAX
cutoffs would send to the host (the HB (24, 3) and (48, 3) hierarchies'
assembly and local-MG solve, timed both ways by
``scripts/torch_parallel_phase.py --cutoffs``).
"""

import contextlib
import os

import numpy as np
import torch

# float64, the dtype of the paths that compute in float64 whatever the
# compute dtype, as the JAX package's (local MG, the time steppers'
# device operators; the f32 Krylov operators of solvers.cg_ir name
# float32 themselves)
DTYPE = torch.float64
DEFAULT_DEVICE = torch.device('cuda')

_DTYPES = {np.dtype(np.float64): torch.float64,
           np.dtype(np.float32): torch.float32}


class _State:
    # process-wide, as the JAX package's: a setting made on one thread is
    # seen by the others
    dtype = torch.float64
    max_threads = os.cpu_count() or 1


_state = _State()


def resolve_device(device):
    """``device`` as a :class:`torch.device` (None -> the card)."""
    return DEFAULT_DEVICE if device is None else torch.device(device)


def get_dtype():
    """The compute dtype of the assembly and solve paths, a torch dtype
    (``torch.float64`` unless :func:`set_dtype` chose float32)."""
    return _state.dtype


def set_dtype(dtype):
    """Set the compute dtype: what the JAX package's ``set_dtype`` takes
    (``np.float32``, ``np.float64``, their names or numpy dtypes) or a
    torch dtype.  Only float32 and float64 are compute dtypes."""
    if isinstance(dtype, torch.dtype):
        if dtype not in (torch.float32, torch.float64):
            raise ValueError('compute dtype must be float32 or float64, got '
                             '%s' % dtype)
        _state.dtype = dtype
        return
    key = np.dtype(dtype)
    if key not in _DTYPES:
        raise ValueError('compute dtype must be float32 or float64, got %s'
                         % key)
    _state.dtype = _DTYPES[key]


def get_max_threads():
    """Number of host threads for host-side helpers (API parity with
    pyiga's ``get_max_threads``)."""
    return _state.max_threads


def set_max_threads(n):
    _state.max_threads = int(n)


def default_assembly_mode():
    """The default assembly mode: ``'exact'`` for both dtypes.  The JAX
    package answers ``'ozaki'`` for float64 on an accelerator, whose
    float64 is emulated there: its Ozaki route computes f64 products from
    bf16 chunks on the TPU's matrix unit.  The H100 has native float64
    arithmetic and f64 tensor cores, so the port has no Ozaki route and
    its one route is the exact chain."""
    return 'exact'


@contextlib.contextmanager
def no_tf32(dtype=torch.float32):
    """Run float32 matrix products in full float32 inside the block, and
    restore the caller's settings after it: torch's float32 matmul
    precision (which also decides ``torch.backends.cuda.matmul.
    allow_tf32``) and ``torch.backends.cudnn.allow_tf32``.  The f32 line
    holds to exact float32 arithmetic, as the JAX package's f32 chains;
    TF32 keeps about three decimal digits.  For a `dtype` other than
    float32 (the operands' dtype) it does nothing."""
    if dtype != torch.float32:
        yield
        return
    precision = torch.get_float32_matmul_precision()
    cudnn = torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision('highest')
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(precision)
        torch.backends.cudnn.allow_tf32 = cudnn
