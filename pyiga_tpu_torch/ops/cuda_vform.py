# -*- coding: utf-8 -*-
"""Kernel K5: the coefficient fields of a compiled variational form,
generated as one CUDA kernel per form (counterpart of
``pyiga_tpu.compile.VFormAssembler._eval_combo_fields_pair_pallas``,
whose ``pallas_call`` is at compile.py:974).

The integrand of a form depends on the form, so no fixed kernel can
evaluate it.  As the reference did with Cython code generation, the form
is evaluated once on *symbolic scalars* (:class:`Sym`): every leaf of the
evaluation — the Gauss weight, the physical geometry values and Jacobian
(from K1's ``jac`` kind), the input-field components — is a load
``y[leaf*N + i]``, every parameter component a load ``p[k]``.  Arithmetic
on symbols appends straight-line SSA instructions (``const double t17 =
t3 * t9;``) with constant folding of the exact identities (``x*1``,
``x+0``, ``x*0``) and common-subexpression elimination; the FIELD-scope
cache is shared by all combos, so the inverse Jacobian and the measure
are emitted once.  The program becomes a CUDA C source (one thread per
Gauss point, grid-stride; ``(NY, N)`` leaves in, ``(n_combos, N)`` fields
out, both coalesced), built by :func:`pyiga_tpu_torch._cuda.
build_generated` into its own library.  Parameters are a device array
argument, not baked into the source: new parameter values never rebuild.

Bound: device memory, ``(NY + n_combos) * 8`` bytes per Gauss point
(~30 MB for the 2D p=3 n=128 convection-diffusion form); the arithmetic
per point is a few dozen flops.

:func:`combo_fields` is the wrapper: a CPU tensor runs
:func:`combo_fields_plain` (the torch :class:`~pyiga_tpu_torch.compile.
AsmContext` evaluation, counterpart of ``_eval_combo_fields``), a CUDA
tensor launches the generated kernel or raises.  :func:`run_program_plain`
runs a generated program with torch ops; it exists so that the CPU tests
can check the generator (expression walk, level-order leaves, CSE)
without a GPU, and no device path uses it.
"""

import ctypes
import math
import numbers

import numpy as np
import torch

from .. import _cuda
from . import geom

_BINARY = {'add': '+', 'sub': '-', 'mul': '*', 'div': '/'}
_C_FUNCS = {'sqrt': 'sqrt', 'exp': 'exp', 'log': 'log', 'sin': 'sin',
            'cos': 'cos', 'tan': 'tan', 'abs': 'fabs'}
_TORCH_OPS = {
    'add': lambda a, b: a + b, 'sub': lambda a, b: a - b,
    'mul': lambda a, b: a * b, 'div': lambda a, b: a / b,
    'neg': lambda a: -a, 'sqrt': torch.sqrt, 'exp': torch.exp,
    'log': torch.log, 'sin': torch.sin, 'cos': torch.cos, 'tan': torch.tan,
    'abs': torch.abs}


################################################################################
# Symbolic evaluation -> SSA program
################################################################################

class Sym:
    """A symbolic f64 scalar of an :class:`SSARecorder`: a leaf, a
    parameter or an SSA temporary (`ref`)."""

    __slots__ = ('rec', 'ref')

    def __init__(self, rec, ref):
        self.rec, self.ref = rec, ref

    def __add__(self, o):
        return self.rec.op('add', self, o)

    def __radd__(self, o):
        return self.rec.op('add', o, self)

    def __sub__(self, o):
        return self.rec.op('sub', self, o)

    def __rsub__(self, o):
        return self.rec.op('sub', o, self)

    def __mul__(self, o):
        return self.rec.op('mul', self, o)

    def __rmul__(self, o):
        return self.rec.op('mul', o, self)

    def __truediv__(self, o):
        return self.rec.op('div', self, o)

    def __rtruediv__(self, o):
        return self.rec.op('div', o, self)

    def __neg__(self):
        return self.rec.op('neg', self)

    def __abs__(self):
        return self.rec.op('abs', self)

    def apply(self, func):
        """A builtin function (``vform.BuiltinFuncExpr``) of this scalar."""
        return self.rec.op(func, self)


def _operand(x):
    if isinstance(x, Sym):
        return x.ref
    if isinstance(x, numbers.Real) and not isinstance(x, bool):
        return float(x)
    raise TypeError('generator: unsupported operand %r' % (x,))


class SSARecorder:
    """Collects the SSA instructions of a symbolic evaluation.  Refs are
    ``('l', key)`` (leaf), ``('p', key)`` (parameter component) or
    ``('t', i)`` (temporary); constants are Python floats."""

    def __init__(self):
        self.instrs = []
        self._cse = {}

    def leaf(self, key):
        return Sym(self, ('l', key))

    def param(self, key):
        return Sym(self, ('p', key))

    def op(self, name, *args):
        args = tuple(_operand(a) for a in args)    # one or more refs
        if name == 'mul' and -1.0 in args:      # (-1) * x is exactly -x
            return self.op('neg', Sym(self, args[1] if args[0] == -1.0
                                      else args[0]))
        folded = _fold(name, args)
        if folded is not None:
            return folded if isinstance(folded, float) else Sym(self, folded)
        key = (name, args)
        sym = self._cse.get(key)
        if sym is None:
            self.instrs.append(key)
            sym = self._cse[key] = Sym(self, ('t', len(self.instrs) - 1))
        return sym

    def finish(self, outputs):
        """The :class:`Program` computing `outputs` (one Sym or float per
        combo), with dead instructions dropped and leaves, parameters and
        temporaries numbered densely in order of first use."""
        outs = [_operand(o) for o in outputs]
        live = set()
        stack = [o for o in outs if isinstance(o, tuple) and o[0] == 't']
        while stack:
            i = stack.pop()[1]
            if i in live:
                continue
            live.add(i)
            stack.extend(a for a in self.instrs[i][1]
                         if isinstance(a, tuple) and a[0] == 't')
        tnum, leaves, params = {}, {}, {}

        def renum(a):
            if not isinstance(a, tuple):
                return a
            kind, key = a
            if kind == 't':
                return ('t', tnum[key])
            table = leaves if kind == 'l' else params
            return (kind, table.setdefault(key, len(table)))

        instrs = []
        for i, (name, args) in enumerate(self.instrs):
            if i in live:
                instrs.append((name, tuple(renum(a) for a in args)))
                tnum[i] = len(instrs) - 1
        outs = [renum(o) for o in outs]
        return Program(list(leaves), list(params), instrs, outs)


def _fold(name, args):
    """Exact algebraic identities with one constant operand: the folded
    ref or float, else None (``x * 0`` folds to 0, as the fields are
    finite)."""
    if name in ('add', 'sub', 'mul', 'div'):
        a, b = args
        if name == 'add':
            if a == 0.0 and isinstance(a, float):
                return b
            if b == 0.0 and isinstance(b, float):
                return a
        elif name == 'sub':
            if b == 0.0 and isinstance(b, float):
                return a
        elif name == 'mul':
            for x, y in ((a, b), (b, a)):
                if isinstance(x, float):
                    if x == 0.0:
                        return 0.0
                    if x == 1.0:
                        return y
        elif name == 'div':
            if isinstance(b, float) and b == 1.0:
                return a
            if isinstance(a, float) and a == 0.0:
                return 0.0
    return None


class Program:
    """A generated coefficient-field program.

    Attributes:
        leaves: leaf keys, row order of the leaf array ``Y (NY, N)``:
            ``('gw',)``, ``('geo_val', c)``, ``('geo_jac', c, k)`` (level
            order) or ``('input', name, comp)``.
        params: parameter keys ``('param', name, idx)``, order of ``P``.
        instrs: SSA list of ``(op, args)``; args are ``('l', j)``,
            ``('p', j)``, ``('t', i)`` or float constants.
        outputs: one arg per combo.
    """

    def __init__(self, leaves, params, instrs, outputs):
        self.leaves, self.params = leaves, params
        self.instrs, self.outputs = instrs, outputs
        self._source = None

    @property
    def source(self):
        """The CUDA C source of the program's kernel."""
        if self._source is None:
            self._source = emit_cuda(self)
        return self._source


def det_and_inv_sym(J):
    """Determinant and inverse of a small symbolic matrix ``J[a][b]`` by
    the adjugate, with the operations of
    :func:`~pyiga_tpu_torch.ops.geom.det_and_inv` in the same order."""
    d = len(J)
    if d == 1:
        det = J[0][0]
        return det, [[1.0 / det]]
    if d == 2:
        a, b = J[0][0], J[0][1]
        c, e = J[1][0], J[1][1]
        det = a * e - b * c
        return det, [[e / det, -b / det], [-c / det, a / det]]
    if d == 3:
        c00 = J[1][1] * J[2][2] - J[1][2] * J[2][1]
        c01 = J[1][2] * J[2][0] - J[1][0] * J[2][2]
        c02 = J[1][0] * J[2][1] - J[1][1] * J[2][0]
        det = J[0][0] * c00 + J[0][1] * c01 + J[0][2] * c02
        adj = [[c00,
                J[0][2] * J[2][1] - J[0][1] * J[2][2],
                J[0][1] * J[1][2] - J[0][2] * J[1][1]],
               [c01,
                J[0][0] * J[2][2] - J[0][2] * J[2][0],
                J[0][2] * J[1][0] - J[0][0] * J[1][2]],
               [c02,
                J[0][1] * J[2][0] - J[0][0] * J[2][1],
                J[0][0] * J[1][1] - J[0][1] * J[1][0]]]
        return det, [[x / det for x in row] for row in adj]
    raise NotImplementedError('det_and_inv only implemented for d <= 3')


def generate(asm, combos):
    """The :class:`Program` of every combo's coefficient field of the
    assembler `asm` (a :class:`~pyiga_tpu_torch.compile.VFormAssembler`):
    its form evaluated through its own context class on symbolic leaves,
    with the FIELD-scope cache shared by the combos and seeded with the
    Gauss weight leaf and the symbolic inverse Jacobian (the seeding of
    the TPU kernel, compile.py:951-956)."""
    b = SSARecorder()
    d, gd = asm.dim, asm.vf.geo_dim
    arrays = {'geo_val_lvl': [b.leaf(('geo_val', c)) for c in range(gd)],
              'geo_jac_lvl': [[b.leaf(('geo_jac', c, k)) for k in range(d)]
                              for c in range(gd)]}
    for key, arr in asm._host_arrays.items():
        kind, _, name = key.partition(':')
        if kind == 'input':
            lead = np.shape(arr)[:np.ndim(arr) - d]
            syms = np.empty(lead, dtype=object)
            for li in np.ndindex(*lead):
                syms[li] = b.leaf(('input', name, li))
            arrays[key] = syms
        elif kind == 'param':
            shape = np.shape(arr)
            if shape == ():
                arrays[key] = b.param(('param', name, ()))
            else:
                syms = np.empty(shape, dtype=object)
                for li in np.ndindex(*shape):
                    syms[li] = b.param(('param', name, li))
                arrays[key] = syms
    shared = {('gw',): b.leaf(('gw',)),
              ('_jacinv_lvl',): det_and_inv_sym(arrays['geo_jac_lvl'])[1]}
    outputs = []
    for su, sv in combos:
        ctx = asm._make_context(arrays, su, sv)
        ctx._cache = shared
        C = 0.0
        for e in asm.vf.exprs:
            C = C + e.eval(ctx)
        outputs.append(C)
    return b.finish(outputs)


################################################################################
# CUDA source and the plain program runner
################################################################################

def _c_arg(a):
    if isinstance(a, float):
        if not math.isfinite(a):
            raise ValueError('generator: non-finite constant %r' % a)
        return '(%r)' % a
    return '%s%d' % a


def emit_cuda(program):
    """CUDA C source of `program`: ``vform_fields_kernel`` and its C entry
    ``pyiga_vform_fields(y, p, out, N, stream)`` returning
    ``cudaGetLastError()``."""
    body = ['        const double l%d = y[%dLL * N + i];' % (j, j)
            for j in range(len(program.leaves))]
    for i, (name, args) in enumerate(program.instrs):
        if name in _BINARY:
            expr = '%s %s %s' % (_c_arg(args[0]), _BINARY[name],
                                 _c_arg(args[1]))
        elif name == 'neg':
            expr = '-%s' % _c_arg(args[0])
        else:
            expr = '%s(%s)' % (_C_FUNCS[name], _c_arg(args[0]))
        body.append('        const double t%d = %s;' % (i, expr))
    body += ['        out[%dLL * N + i] = %s;' % (c, _c_arg(o))
             for c, o in enumerate(program.outputs)]
    params = ['    const double p%d = p[%d];' % (k, k)
              for k in range(len(program.params))]
    return _SOURCE % dict(n_leaves=len(program.leaves),
                          n_params=len(program.params),
                          n_out=len(program.outputs),
                          params='\n'.join(params), body='\n'.join(body))


_SOURCE = '''\
// Coefficient fields of one variational form (kernel K5 of
// pyiga_tpu_torch, generated by ops/cuda_vform.py): %(n_leaves)d leaf
// rows and %(n_params)d parameters in, %(n_out)d fields out, one thread
// per Gauss point.
#include <cuda_runtime.h>

extern "C" __global__ void __launch_bounds__(256)
vform_fields_kernel(const double* __restrict__ y,
                    const double* __restrict__ p,
                    double* __restrict__ out, long long N) {
%(params)s
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         i < N; i += (long long)gridDim.x * blockDim.x) {
%(body)s
    }
}

extern "C" __attribute__((visibility("default")))
int pyiga_vform_fields(const double* y, const double* p, double* out,
                       long long N, void* stream) {
    const int threads = 256;
    long long blocks = (N + threads - 1) / threads;
    if (blocks > 132LL * 32) blocks = 132LL * 32;
    if (blocks < 1) blocks = 1;
    vform_fields_kernel<<<(unsigned int)blocks, threads, 0,
                          (cudaStream_t)stream>>>(y, p, out, N);
    return (int)cudaGetLastError();
}
'''


def run_program_plain(program, Y, P):
    """Run `program` with torch ops on leaves ``Y (NY, N)`` and
    parameters ``P (NP,)``; returns ``(n_combos, N)``.  A test aid for
    the generator (see the module docstring)."""
    N = Y.shape[1]
    tmps = []

    def get(a):
        if isinstance(a, float):
            return a
        kind, j = a
        return {'l': Y, 'p': P, 't': tmps}[kind][j]

    for name, args in program.instrs:
        tmps.append(_TORCH_OPS[name](*[get(a) for a in args]))
    return torch.stack([torch.broadcast_to(torch.as_tensor(
        get(o), dtype=Y.dtype, device=Y.device), (N,))
        for o in program.outputs])


################################################################################
# Leaves, the wrapper and its plain version
################################################################################

def leaf_rows(program, arrays):
    """The leaf array ``Y (NY, N)`` and parameter vector ``P`` of
    `program` from an assembler's device arrays (``weights``,
    ``geo_val_lvl``, ``geo_jac_lvl``, ``input:*``, ``param:*``)."""
    W = geom.gauss_weight_field(arrays['weights'])
    N, dev = W.numel(), W.device

    def leaf(key):
        if key[0] == 'gw':
            return W
        if key[0] == 'geo_val':
            return arrays['geo_val_lvl'][key[1]]
        if key[0] == 'geo_jac':
            return arrays['geo_jac_lvl'][key[1]][key[2]]
        return arrays['input:' + key[1]][key[2]]

    Y = (torch.stack([leaf(k).reshape(N) for k in program.leaves])
         if program.leaves else torch.empty((0, N), dtype=W.dtype,
                                            device=dev))
    P = torch.stack([arrays['param:' + name][idx].reshape(())
                     for _p, name, idx in program.params]) \
        if program.params else torch.zeros(1, dtype=W.dtype, device=dev)
    return Y.contiguous(), P.to(W.dtype).contiguous()


def combo_fields_plain(asm, arrays, combos):
    """Plain PyTorch version of :func:`combo_fields` (the counterpart of
    ``VFormAssembler._eval_combo_fields``): each combo's integrand
    evaluated with torch ops, the FIELD-scope cache shared by the combos.
    Returns one field per combo on the Gauss grid."""
    grid_shape = tuple(w.shape[0] for w in arrays['weights'])
    shared = {}
    fields = []
    for su, sv in combos:
        ctx = asm._make_context(arrays, su, sv)
        ctx._cache = shared
        C = 0.0
        for e in asm.vf.exprs:
            C = C + e.eval(ctx)
        ref = arrays['weights'][0]
        fields.append(torch.broadcast_to(
            torch.as_tensor(C, dtype=ref.dtype, device=ref.device),
            grid_shape).contiguous())
    return fields


def combo_fields(asm, arrays, combos):
    """K5: every combo's coefficient field on the Gauss grid.

    `arrays` are the assembler's tensors (see :func:`leaf_rows`).  On
    CUDA the form's generated kernel runs (built once per source by
    :func:`~pyiga_tpu_torch._cuda.build_generated`); on the CPU the plain
    version.  Returns one contiguous field per combo."""
    W0 = arrays['weights'][0]
    if W0.device.type == 'cpu':
        return combo_fields_plain(asm, arrays, combos)
    if not W0.is_cuda:
        raise ValueError('combo_fields: unsupported device %s' % W0.device)
    program = asm._program(combos)
    Y, P = leaf_rows(program, arrays)
    out = vform_fields(program, Y, P)
    grid_shape = tuple(w.shape[0] for w in arrays['weights'])
    return [out[c].reshape(grid_shape) for c in range(out.shape[0])]


def vform_fields(program, Y, P):
    """Launch `program`'s generated kernel on CUDA leaves ``Y (NY, N)``
    and parameters `P`; returns ``(n_combos, N)`` float64."""
    f64 = torch.float64
    _cuda.require(Y, 'Y', f64, 2)
    _cuda.require(P, 'P', f64, 1)
    if Y.shape[0] != len(program.leaves) or P.device != Y.device \
            or P.shape[0] < max(len(program.params), 1):
        raise ValueError('vform_fields: Y %s / P %s do not match the '
                         'program (%d leaves, %d params)'
                         % (tuple(Y.shape), tuple(P.shape),
                            len(program.leaves), len(program.params)))
    fn = _entry(program)
    N = Y.shape[1]
    out = torch.empty((len(program.outputs), N), dtype=f64, device=Y.device)
    with _cuda.device_of(Y):
        err = fn(Y.data_ptr(), P.data_ptr(), out.data_ptr(), N,
                 _cuda.stream_of(Y))
    _cuda.check(err, 'vform_fields')
    _cuda.LAUNCHES['vform_fields'] += 1
    return out


def _entry(program):
    """The program's C entry point (building its library on first use)."""
    lib = _cuda.build_generated('vform_fields', program.source)
    fn = lib.pyiga_vform_fields
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
