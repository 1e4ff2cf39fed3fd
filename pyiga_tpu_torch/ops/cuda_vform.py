# -*- coding: utf-8 -*-
"""Kernel K5: the coefficient fields of a compiled variational form,
generated as one CUDA kernel per form (counterpart of
``pyiga_tpu.compile.VFormAssembler._eval_combo_fields_pair_pallas``,
whose ``pallas_call`` is at compile.py:974).

The integrand of a form depends on the form, so no fixed kernel can
evaluate it.  As the reference did with Cython code generation, the form
is evaluated once on *symbolic scalars* (:class:`Sym`): every leaf of the
evaluation — the Gauss weight, the physical geometry values and Jacobian
(from K1's ``jac`` kind, or uploaded for a geometry evaluated on the
host), the geometry's parametric Hessian (from K2 stages), the
input-field components and their first and second derivatives — is a
load, every
parameter component a load ``p[slot]``.  Arithmetic on symbols appends
straight-line SSA instructions (``const double t17 = t3 * t9;``) with
constant folding of the exact identities (``x*1``, ``x+0``, ``x*0``) and
common-subexpression elimination; the FIELD-scope cache is shared by all
combos, so the inverse Jacobian and the measure are emitted once.  The
program becomes a CUDA C source built by :func:`pyiga_tpu_torch._cuda.
build_generated` into its own library.

The kernel reads every leaf where it lies: it takes one base pointer per
tensor the program reads (``geo_val_lvl``, ``geo_jac_lvl``,
``geo_hess_lvl``, ``input:*``, ``ideriv:*``) with each leaf's row baked
into the source, and forms the
Gauss weight from the per-axis weight vectors, ``(w0 w1) w2`` as
:func:`~pyiga_tpu_torch.ops.geom.gauss_weight_field` does (bitwise the
same field).  Parameters are read from the assembler's flat parameter
vector (:func:`param_vector`, cached with its device operands), each at a
slot baked into the source; the slots depend on the parameters' shapes
only, so new parameter values never rebuild.

Forward mode and second derivatives (:func:`tangent_program`,
:class:`SecondOrderProgram`): the forward sweep of forward mode over a
program's SSA gives its tangent program, and over its adjoint's SSA the
second-order program (the Hessian of ``<gout, F>`` applied to the
tangents), one pair per form and tangent mask (which sources, and the
parameters, have a tangent), emitted and launched as the program and its
adjoint are; they give ``_ComboFields`` its ``jvp`` and the adjoint's
Function its ``jvp`` and ``backward``.

The f32 line (:func:`~pyiga_tpu_torch.config.set_dtype`) runs a float32
instance of the same program (:attr:`Program.dtype`): float pointers,
loads, temporaries and ``f``-suffixed constants, the float functions
(``sqrtf``, ``fabsf``, ...), so that nothing of it computes in double,
as the JAX package evaluates its fields on float32 operands
(``pyiga_tpu/compile.py:1250-1262``).  The assembler caches its programs
per combos and dtype.  A float32 program's adjoint is float32 too, a
library of its own (``vform_adjoint_f32``), as ``pyiga_tpu/diff.py``
differentiates the float32 form.

Bound: device memory, ``(leaf rows + n_combos) * 8`` bytes per Gauss
point (4 in float32) plus the weight vectors (~21 MB for the 2D p=3 n=128
convection-diffusion form: 4 Jacobian rows in, 6 fields out); the
arithmetic per point is a few dozen flops.  So, as K1 since its redesign,
one rule (``vform_shape``, in the source of both generated kernels) maps
the points to threads by the axis that has them: a block owns up to 16
rows of the leading grid axes (their weight products staged in shared
memory once), a thread owns columns of the last axis, loads go through
the read-only path and stores are coalesced along the last axis; no
index is divided per point, and the row loop is unrolled twice (two
points in flight).  Below 8 points a row (a boundary Gauss grid's last
axis has one) a thread owns a row and a block 128 rows; the point code
is the same, so the fields are bitwise those of the first mapping.

:func:`combo_fields` is the wrapper: a CPU tensor runs
:func:`combo_fields_plain` (the torch :class:`~pyiga_tpu_torch.compile.
AsmContext` evaluation, counterpart of ``_eval_combo_fields``), a CUDA
tensor launches the generated kernel or raises.  A launch costs one
output allocation and one ctypes call: the program's C entry is built
and declared once (:meth:`Program.entry`).  :func:`run_program_plain`
runs a generated program with torch ops on the same operands as the
kernel; it exists so that the CPU tests can check the generator
(expression walk, leaf rows, parameter slots, CSE) without a GPU, and no
device path uses it.
"""

import ctypes
import math
import numbers

import numpy as np
import torch

from .. import _cuda
from . import geom

_BINARY = {'add': '+', 'sub': '-', 'mul': '*', 'div': '/'}
# 'sign' (torch.sign: 0 at 0) occurs only in the adjoint, tangent and
# second-order programs: the derivative of abs
_C_FUNCS = {'sqrt': 'sqrt', 'exp': 'exp', 'log': 'log', 'sin': 'sin',
            'cos': 'cos', 'tan': 'tan', 'abs': 'fabs', 'sign': 'pyiga_sign'}
# the float32 instance's: the float functions of CUDA's math library (a
# double function would promote its argument and run in double)
_C_FUNCS_F32 = {'sqrt': 'sqrtf', 'exp': 'expf', 'log': 'logf',
                'sin': 'sinf', 'cos': 'cosf', 'tan': 'tanf', 'abs': 'fabsf',
                'sign': 'pyiga_sign'}
# a program's scalar: its C type and the generated libraries' names (also
# their launch counters), of the program and of its adjoint
_CTYPES = {torch.float64: 'double', torch.float32: 'float'}
_LIBNAMES = {torch.float64: 'vform_fields', torch.float32: 'vform_fields_f32'}
_ADJ_LIBNAMES = {torch.float64: 'vform_adjoint',
                 torch.float32: 'vform_adjoint_f32'}
# ... and of the tangent program and the second-order adjoint
_TAN_LIBNAMES = {torch.float64: 'vform_tangent',
                 torch.float32: 'vform_tangent_f32'}
_SECOND_LIBNAMES = {torch.float64: 'vform_second',
                    torch.float32: 'vform_second_f32'}
_TORCH_OPS = {
    'add': lambda a, b: a + b, 'sub': lambda a, b: a - b,
    'mul': lambda a, b: a * b, 'div': lambda a, b: a / b,
    'neg': lambda a: -a, 'sqrt': torch.sqrt, 'exp': torch.exp,
    'log': torch.log, 'sin': torch.sin, 'cos': torch.cos, 'tan': torch.tan,
    'abs': torch.abs, 'sign': torch.sign}


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

    def finish(self, outputs, dim, leaf_loc=None, param_slot=None,
               dtype=torch.float64):
        """The :class:`Program` computing `outputs` (one Sym or float per
        combo) on a `dim`-dimensional Gauss grid in `dtype`, with dead
        instructions dropped and leaves, parameters and temporaries
        numbered densely in order of first use.  `leaf_loc` maps each leaf
        key but ``('gw',)`` to its ``(array key, row)``, `param_slot` each
        parameter key to its slot in the flat parameter vector."""
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
        return Program(list(leaves), list(params), instrs, outs, dim,
                       leaf_loc or {}, param_slot or {}, dtype)


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
        dim: the Gauss grid's dimension (the number of weight vectors).
        dtype: the scalar its kernel computes in, reads and writes
            (``torch.float64``, or ``torch.float32``: every constant,
            temporary, load and function of the float32 instance is
            float; its launches count under ``vform_fields_f32``).
        leaves: leaf keys in order of first use: ``('gw',)`` (the Gauss
            weight), ``('geo_val', c)``, ``('geo_jac', c, k)``,
            ``('geo_hess', c, k, l)`` with ``k <= l`` (level order),
            ``('input', name, comp)``, ``('ideriv', name + ':1', comp +
            (i,))`` (XYZ derivative axis `i`) or ``('ideriv', name +
            ':2', comp + (s,))`` (symmetric pair `s`).
        params: parameter keys ``('param', name, idx)``, order of first
            use; ``param_slots`` their slots in the flat parameter vector.
        sources: the array keys the leaves are read from, in order of
            first use (the kernel's source pointers ``s0, s1, ...``);
            ``leaf_src`` gives per leaf ``(source index, row)``, or None
            for the Gauss weight.
        instrs: SSA list of ``(op, args)``; args are ``('l', j)``,
            ``('p', j)``, ``('t', i)`` or float constants.
        outputs: one arg per combo.
    """

    def __init__(self, leaves, params, instrs, outputs, dim, leaf_loc,
                 param_slot, dtype=torch.float64):
        if dtype not in _CTYPES:
            raise ValueError('vform_fields: a program computes in float64 or '
                             'float32, not %s' % dtype)
        self.leaves, self.params = leaves, params
        self.instrs, self.outputs, self.dim = instrs, outputs, dim
        self.dtype = dtype
        self.counter = _LIBNAMES[dtype]
        self.sources, self.leaf_src = [], []
        for key in leaves:
            if key == ('gw',):
                self.leaf_src.append(None)
                continue
            akey, row = leaf_loc[key]
            if akey not in self.sources:
                self.sources.append(akey)
            self.leaf_src.append((self.sources.index(akey), row))
        # rows each source must hold, for the wrapper's check
        self._rows = [0] * len(self.sources)
        for sr in self.leaf_src:
            if sr is not None:
                self._rows[sr[0]] = max(self._rows[sr[0]], sr[1] + 1)
        self.param_slots = [param_slot[k] for k in params]
        # the operand its parameter pointer reads (a tangent program reads
        # the parameters and their tangents concatenated)
        self.param_key = 'params'
        self._source = None
        self._entry = None
        self._adjoint = None
        self._tangents = {}
        self._seconds = {}

    def adjoint(self):
        """The program's :class:`AdjointProgram` (built on the first
        call, then kept), in the program's dtype."""
        if self._adjoint is None:
            self._adjoint = AdjointProgram(self)
        return self._adjoint

    def tangent(self, mask):
        """The program's tangent :class:`Program` for the tangents
        `mask` (per source, then the parameters: whether it has one; built
        on the first call per mask, then kept): :func:`tangent_program`."""
        if mask not in self._tangents:
            self._tangents[mask] = tangent_program(self, mask)
        return self._tangents[mask]

    def second(self, mask):
        """The program's :class:`SecondOrderProgram` for the tangents
        `mask` (as :meth:`tangent`'s; kept per mask)."""
        if mask not in self._seconds:
            self._seconds[mask] = SecondOrderProgram(self, mask)
        return self._seconds[mask]

    def launch(self, arrays):
        """Run the program's kernel on CUDA tensors (`arrays` as
        :meth:`operands` takes them): one allocation of the ``(n_combos,)
        + grid`` output, one ctypes call; returns the output."""
        W = arrays['weights']
        out = W[0].new_empty((len(self.outputs),)
                             + tuple(w.shape[0] for w in W))
        argv = self.arguments(arrays, out, _cuda.stream_of(out))
        fn = self.entry()
        with _cuda.device_of(out):
            err = fn(*argv)
        _cuda.check(err, self.counter)
        _cuda.LAUNCHES[self.counter] += 1
        return out

    @property
    def source(self):
        """The CUDA C source of the program's kernel."""
        if self._source is None:
            self._source = emit_cuda(self)
        return self._source

    def entry(self):
        """The C entry ``pyiga_vform_fields`` of the program's kernel,
        built, loaded and declared on the first call; later calls return
        it as it is (no source hash, no lock)."""
        if self._entry is None:
            fn = _cuda.build_generated(self.counter,
                                       self.source).pyiga_vform_fields
            n_ptr = self.dim + len(self.sources) + int(bool(self.params)) + 1
            fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 3
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._entry = fn
        return self._entry

    def operands(self, arrays, dev, gout=None):
        """The kernel's input tensors from `arrays` (the per-axis
        ``weights``, the program's sources and, if it reads parameters,
        the flat ``params`` vector), in the order of its pointers, each
        checked: contiguous, of the program's dtype, on `dev`, on the
        weights' grid, with the rows and parameter slots the program
        reads.  An adjoint program's source ``gout`` is `gout`."""
        W = arrays['weights']
        grid = tuple(w.shape[0] for w in W)
        QL, Q12 = grid[-1], math.prod(grid[:-1])
        N = Q12 * QL
        ops = W + [gout if k == 'gout' else arrays[k] for k in self.sources]
        if self.params:
            ops.append(arrays[self.param_key])
        for i, t in enumerate(ops):
            if t.dtype != self.dtype or t.device != dev \
                    or not t.is_contiguous():
                names = (['weights[%d]' % k for k in range(len(W))]
                         + self.sources + ['params'] * bool(self.params))
                raise ValueError('vform_fields: %s must be a contiguous '
                                 '%s tensor on %s, got %s on %s'
                                 % (names[i], self.dtype, dev, t.dtype,
                                    t.device))
        if len(grid) != self.dim or any(w.dim() != 1 for w in W) \
                or not (0 < Q12 < 2 ** 31 - 16 and 0 < QL < 2 ** 31):
            raise ValueError('vform_fields: weights %s do not fit a %dD '
                             'program' % ([tuple(w.shape) for w in W],
                                          self.dim))
        for key, t, rows in zip(self.sources, ops[self.dim:], self._rows):
            if t.shape[t.dim() - self.dim:] != grid or t.numel() < rows * N:
                raise ValueError('vform_fields: %s is %s, expected %d rows '
                                 'on the grid %s' % (key, tuple(t.shape),
                                                     rows, grid))
        if self.params and (ops[-1].dim() != 1 or ops[-1].shape[0]
                            <= max(self.param_slots)):
            raise ValueError('vform_fields: params %s lacks slot %d'
                             % (tuple(ops[-1].shape), max(self.param_slots)))
        return ops

    def arguments(self, arrays, out, stream):
        """The C entry's arguments for the device tensors `arrays` (see
        :meth:`operands`) and the output `out` ``(n_combos,) + grid``, to
        launch on `stream`.  Raises on an operand the kernel does not
        take."""
        ops = self.operands(arrays, out.device)
        grid = tuple(w.shape[0] for w in arrays['weights'])
        if out.dtype != self.dtype or not out.is_contiguous() \
                or out.shape != (len(self.outputs),) + grid:
            raise ValueError('vform_fields: out %s %s does not fit a %s '
                             'program of %d fields on the grid %s'
                             % (tuple(out.shape), out.dtype, self.dtype,
                                len(self.outputs), grid))
        return (*[t.data_ptr() for t in ops], out.data_ptr(),
                math.prod(grid[:-1]), grid[-1],
                grid[1] if self.dim == 3 else 1, stream)


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


def generate(asm, combos, dtype=torch.float64):
    """The :class:`Program` of every combo's coefficient field of the
    assembler `asm` (a :class:`~pyiga_tpu_torch.compile.VFormAssembler`)
    in `dtype` (float64, or float32 for the f32 line):
    its form evaluated through its own context class on symbolic leaves,
    with the FIELD-scope cache shared by the combos and seeded with the
    Gauss weight leaf and the symbolic inverse Jacobian (the seeding of
    the TPU kernel, compile.py:951-956; a surface's Jacobian is not
    square and seeds no inverse).  Each leaf is located in the tensor
    that holds it (row c of ``geo_val_lvl``, row ``c d + k`` of
    ``geo_jac_lvl``, row ``(c d + k) d + l`` of ``geo_hess_lvl`` for
    ``k <= l``, the mirrored entry reading the same row, the flat
    component of ``input:name`` or of its derivatives
    ``ideriv:name:<order>``), each parameter in :func:`param_vector`'s
    layout.  Vector and two-space forms need nothing else here: their
    combos carry the components."""
    b = SSARecorder()
    d, gd = asm.dim, asm.vf.geo_dim
    loc = {}

    def leaf(key, akey, row):
        loc[key] = (akey, row)
        return b.leaf(key)

    def hess_leaf(c, k, l):
        k, l = min(k, l), max(k, l)
        return leaf(('geo_hess', c, k, l), 'geo_hess_lvl', (c * d + k) * d + l)
    arrays = {'geo_val_lvl': [leaf(('geo_val', c), 'geo_val_lvl', c)
                              for c in range(gd)],
              'geo_jac_lvl': [[leaf(('geo_jac', c, k), 'geo_jac_lvl',
                                    c * d + k) for k in range(d)]
                              for c in range(gd)],
              'geo_hess_lvl': [[[hess_leaf(c, k, l) for l in range(d)]
                                for k in range(d)] for c in range(gd)]}
    for key, arr in asm._host_arrays.items():
        kind, _, name = key.partition(':')
        if kind in ('input', 'ideriv'):
            # an input field's components, or its first derivatives
            # (components, then the XYZ derivative axis), row-major
            lead = np.shape(arr)[:np.ndim(arr) - d]
            syms = np.empty(lead, dtype=object)
            for row, li in enumerate(np.ndindex(*lead)):
                syms[li] = leaf((kind, name, li), key, row)
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
    slots = {k: s for s, (k, _v) in
             enumerate(_param_components(asm._host_arrays))}
    shared = {('gw',): b.leaf(('gw',))}
    if gd == d:
        shared[('_jacinv_lvl',)] = det_and_inv_sym(arrays['geo_jac_lvl'])[1]
    outputs = []
    for su, sv in combos:
        ctx = asm._make_context(arrays, su, sv)
        ctx._cache = shared
        C = 0.0
        for e in asm.vf.exprs:
            C = C + e.eval(ctx)
        outputs.append(C)
    return b.finish(outputs, d, loc, slots, dtype)


def _param_components(host_arrays):
    """``(key, value)`` of every parameter component, in the order of the
    flat parameter vector: the ``param:*`` arrays in their order, each
    raveled (C order)."""
    for key, arr in host_arrays.items():
        kind, _, name = key.partition(':')
        if kind == 'param':
            arr = np.asarray(arr, dtype=float)
            for idx in np.ndindex(*arr.shape):
                yield ('param', name, idx), float(arr[idx])


def param_vector(host_arrays):
    """The flat parameter vector a generated kernel reads (numpy float64;
    empty for a form without parameters).  Its layout depends on the
    parameters' shapes only."""
    return np.array([v for _k, v in _param_components(host_arrays)],
                    dtype=float)


################################################################################
# CUDA source and the plain program runner
################################################################################

def _c_arg(a, ctype='double'):
    """An SSA argument in C: a ref's name, or a constant literal of the
    scalar `ctype` (a float constant is the Python float rounded to
    float32 as torch rounds it, written with its ``f`` suffix: a double
    literal would promote every product it enters to double)."""
    if isinstance(a, float):
        if ctype == 'float':
            with np.errstate(over='ignore'):
                a32 = float(np.float32(a))
            if not math.isfinite(a32):
                raise ValueError('generator: constant %r is no finite '
                                 'float32' % a)
            return '(%rf)' % a32
        if not math.isfinite(a):
            raise ValueError('generator: non-finite constant %r' % a)
        return '(%r)' % a
    return '%s%d' % a


def _row_offset(row):
    return 'g' if row == 0 else '%dLL * N + g' % row


def _weight_code(program):
    """The Gauss weight's code, if the program reads it: the rows of the
    block staged in shared memory (one division per staged row, none per
    point) and the last-axis weight of a column.  Returns ``(prologue,
    column)``; the weight is ``(w0 w1) w2 = w12[r] * wL[c]``,
    gauss_weight_field's order."""
    if ('gw',) not in program.leaves:
        return '', ''
    T = _CTYPES[program.dtype]
    w12 = {1: _c_arg(1.0, T), 2: '__ldg(w0 + r)',
           3: '__ldg(w0 + r / Q1) * __ldg(w1 + r % Q1)'}[program.dim]
    return (_PROLOGUE % dict(w12=w12, T=T),
            '        const %s wl = __ldg(w%d + c);\n' % (T, program.dim - 1))


def _point_code(program):
    """A generated kernel's code per point: the leaf loads and the SSA
    instructions, in the program's scalar."""
    T = _CTYPES[program.dtype]
    funcs = _C_FUNCS_F32 if T == 'float' else _C_FUNCS
    body = []
    for j, src in enumerate(program.leaf_src):
        if src is None:
            body.append('const %s l%d = sw12[r] * wl;' % (T, j))
        else:
            body.append('const %s l%d = __ldg(s%d + %s);'
                        % (T, j, src[0], _row_offset(src[1])))
    for i, (name, args) in enumerate(program.instrs):
        if name in _BINARY:
            expr = '%s %s %s' % (_c_arg(args[0], T), _BINARY[name],
                                 _c_arg(args[1], T))
        elif name == 'neg':
            expr = '-%s' % _c_arg(args[0], T)
        else:
            expr = '%s(%s)' % (funcs[name], _c_arg(args[0], T))
        body.append('const %s t%d = %s;' % (T, i, expr))
    return body


def _mapped_loops(program, tail):
    """A generated kernel's loops over its points, in either mapping of
    ``vform_shape`` (its ``by_rows`` argument), running at every point
    the point code and then the lines `tail`: one body for both, so that
    the point code is compiled once and the same in both."""
    prologue, column = _weight_code(program)
    params = ''.join('    const %s p%d = __ldg(p + %d);\n'
                     % (_CTYPES[program.dtype], k, slot)
                     for k, slot in enumerate(program.param_slots))
    return _MAPPED % dict(
        prologue=prologue, params=params, column=column,
        body=''.join(' ' * 12 + x + '\n'
                     for x in _point_code(program) + tail))


def _pointer_args(program):
    """The C names of a program's input pointers: the weight vectors, one
    per source tensor, the flat parameter vector if it reads one."""
    return (['w%d' % k for k in range(program.dim)]
            + ['s%d' % s for s in range(len(program.sources))]
            + (['p'] if program.params else []))


def _declare(ptrs, writes, indent, restrict=True, ctype='double'):
    """Pointer parameters of the scalar `ctype`, `indent` spaces before
    each continuation line: `ptrs` read, `writes` written
    (``__restrict__`` for a kernel)."""
    sep = ',\n' + ' ' * indent
    q = ' __restrict__' if restrict else ''
    return ''.join('const %s*%s %s%s' % (ctype, q, x, sep) for x in ptrs) \
        + ''.join('%s*%s %s%s' % (ctype, q, x, sep) for x in writes)


def _sign(T):
    """``pyiga_sign`` in the scalar `T` (``double`` or ``float``)."""
    zero, one = ('0.0f', '1.0f') if T == 'float' else ('0.0', '1.0')
    return _SIGN % dict(T=T, zero=zero, one=one)


def emit_cuda(program):
    """CUDA C source of `program`: ``vform_fields_kernel`` and its C entry
    ``pyiga_vform_fields(w0, .., s0, .., [p,] out, Q12, QL, Q1, stream)``
    returning ``cudaGetLastError()``: the d weight vectors, one pointer
    per source tensor, the flat parameter vector if the program reads
    one, the output ``(n_combos, Q12, QL)``, the grid as its leading rows
    and last axis (Q1: the middle axis of a 3D grid) and the stream.  Every
    pointer, load, constant, temporary and function is of the program's
    scalar (double, or float for a float32 program)."""
    T = _CTYPES[program.dtype]
    ptrs = _pointer_args(program)
    stores = ['out[%s] = %s;' % (_row_offset(c), _c_arg(o, T))
              for c, o in enumerate(program.outputs)]
    return _SOURCE % dict(
        n_leaves=len(program.leaves), n_src=len(program.sources),
        n_params=len(program.params), n_out=len(program.outputs),
        dim=program.dim, shape=_SHAPE, T=T, sign=_sign(T),
        kargs=_declare(ptrs, [], 20, ctype=T),
        cargs=_declare(ptrs, [], 23, False, ctype=T),
        names=''.join('%s, ' % x for x in ptrs),
        loops=_mapped_loops(program, stores))


# The one rule of both generated kernels (plain C++: the CPU tests compile
# it with the host compiler).
_SHAPE = """\
// The mapping of points to threads, one rule for K5 and its adjoint.
// Below K5_ROWS_QL points a row (a boundary Gauss grid has QL = 1) a
// thread owns a row and walks its QL points, a block 128 rows: mapped to
// the last axis, such a grid would leave one lane of each warp working.
// Else a block owns RB rows (16, halved while the grid has fewer than
// min_blocks blocks; their weight products staged once) and a thread the
// columns c of the last axis (min(256, QL rounded up to a warp) threads),
// stores coalesced along it and no index divided per point.  min_blocks:
// two an SM for the forward; one an SM for the adjoint, whose threads
// hold 74-240 registers, so fewer blocks fit an SM: there a thread's two
// rows in flight beat a second wave of blocks.
#define K5_ROWS_QL 8
#define K5_FWD_MIN_BLOCKS (2 * 132)
#define K5_ADJ_MIN_BLOCKS 132
struct VformShape { int rows, threads, rb, blocks; };
static VformShape vform_shape(int Q12, int QL, int min_blocks) {
    VformShape s;
    s.rows = QL < K5_ROWS_QL;
    if (s.rows) {
        s.threads = s.rb = 128;
    } else {
        s.rb = 16;
        while (s.rb > 1 && (Q12 + s.rb - 1) / s.rb < min_blocks) s.rb /= 2;
        s.threads = (QL + 31) / 32 * 32;
        if (s.threads > 256) s.threads = 256;
    }
    s.blocks = (int)(((long long)Q12 + s.rb - 1) / s.rb);
    return s;
}
"""

_PROLOGUE = """\
    __shared__ %(T)s sw12[128];
    if (threadIdx.x < rows) {
        const int r = r0 + threadIdx.x;
        sw12[threadIdx.x] = %(w12)s;
    }
    __syncthreads();
"""

# a kernel's loops: a block owns RB rows from r0; by rows, a thread owns
# one of them and all its QL points, else the columns c = threadIdx.x,
# threadIdx.x + blockDim.x, ... of each; point g = (r0 + r) QL + c.  No
# thread returns early, so every thread of a block reaches the adjoint's
# sums.
_MAPPED = """\
    const int r0 = blockIdx.x * RB;
    const int rows = min(RB, Q12 - r0);
    const int r_lo = by_rows ? (int)threadIdx.x : 0;
    const int r_hi = by_rows ? min(r_lo + 1, rows) : rows;
    const int c_step = by_rows ? 1 : (int)blockDim.x;
%(prologue)s%(params)s    for (int c = by_rows ? 0 : threadIdx.x; c < QL; c += c_step) {
%(column)s#pragma unroll 2
        for (int r = r_lo; r < r_hi; ++r) {
            const long long g = (long long)(r0 + r) * QL + c;
%(body)s        }
    }
"""

# sign(x) as torch.sign (0 at 0), the derivative of abs: in the adjoint,
# tangent and second-order programs
_SIGN = """\
__device__ __forceinline__ %(T)s pyiga_sign(%(T)s x) {
    return x > %(zero)s ? %(one)s : (x < %(zero)s ? -%(one)s : x);
}
"""

_SOURCE = """\
// Coefficient fields of one variational form (kernel K5 of
// pyiga_tpu_torch, generated by ops/cuda_vform.py), in %(T)s.
// In: %(n_leaves)d leaves from %(n_src)d tensors and the %(dim)d Gauss
// weight vectors, %(n_params)d parameters.  Out: %(n_out)d fields.
#include <cuda_runtime.h>

%(shape)s
%(sign)sextern "C" __global__ void __launch_bounds__(256)
vform_fields_kernel(%(kargs)s%(T)s* __restrict__ out,
                    int Q12, int QL, int Q1, int RB, int by_rows) {
    const long long N = (long long)Q12 * QL;
%(loops)s}

extern "C" __attribute__((visibility("default")))
int pyiga_vform_fields(%(cargs)s%(T)s* out,
                       int Q12, int QL, int Q1, void* stream) {
    if (Q12 < 1 || QL < 1) return (int)cudaErrorInvalidValue;
    const VformShape sh = vform_shape(Q12, QL, K5_FWD_MIN_BLOCKS);
    vform_fields_kernel<<<sh.blocks, sh.threads, 0, (cudaStream_t)stream>>>(
        %(names)sout, Q12, QL, Q1, sh.rb, sh.rows);
    return (int)cudaGetLastError();
}
"""


def run_program_plain(program, arrays):
    """Run `program` with torch ops on the kernel's operands: the
    per-axis ``weights``, the source tensors and the flat ``params``
    vector in `arrays`.  Returns ``(n_combos, N)``.  A test aid for the
    generator (see the module docstring)."""
    w12, wL = geom.gauss_weight_factors(arrays['weights'])
    gw = (w12[:, None] * wL).reshape(-1)
    N = gw.shape[0]
    srcs = [arrays[key].reshape(-1, N) for key in program.sources]
    leaves = [gw if src is None else srcs[src[0]][src[1]]
              for src in program.leaf_src]
    params = [arrays[program.param_key][s] for s in program.param_slots]
    tmps = []

    def get(a):
        if isinstance(a, float):
            return a
        kind, j = a
        return {'l': leaves, 'p': params, 't': tmps}[kind][j]

    for name, args in program.instrs:
        tmps.append(_TORCH_OPS[name](*[get(a) for a in args]))
    return torch.stack([torch.broadcast_to(torch.as_tensor(
        get(o), dtype=gw.dtype, device=gw.device), (N,))
        for o in program.outputs])


################################################################################
# The adjoint program: K5's backward
################################################################################

def _adjoint_sweep(program, rec):
    """Replay `program`'s instructions on `rec` and run the reverse sweep.
    Returns ``(bar, gouts)``: the adjoint of every forward leaf and
    parameter that one reaches (keys ``('l', j)`` / ``('p', j)``, values
    Syms or floats), and the output-gradient leaves ``('gout', c)``.

    One derivative rule per op, each as torch defines it: ``div`` gives
    the divisor ``-g a / (b b)``, ``sqrt`` ``g / (2 sqrt a)`` (infinite at
    0), ``tan`` ``g (1 + tan^2 a)``, ``abs`` ``g sign(a)`` (0 at 0)."""
    leaves = [rec.leaf(key) for key in program.leaves]
    params = [rec.param(key) for key in program.params]
    tmps = []

    def get(a):
        if isinstance(a, float):
            return a
        kind, j = a
        return {'l': leaves, 'p': params, 't': tmps}[kind][j]

    for name, args in program.instrs:
        tmps.append(rec.op(name, *[get(a) for a in args]))
    bar, gouts = {}, {}

    def acc(a, v):
        if not isinstance(a, float):
            bar[a] = v if a not in bar else bar[a] + v

    for c, o in enumerate(program.outputs):
        if not isinstance(o, float):
            gouts[c] = rec.leaf(('gout', c))
            acc(o, gouts[c])
    for i in reversed(range(len(program.instrs))):
        g = bar.pop(('t', i), None)
        if g is None:
            continue
        name, args = program.instrs[i]
        x = [get(a) for a in args]
        t = tmps[i]
        a0 = args[0]
        if name == 'add':
            acc(a0, g)
            acc(args[1], g)
        elif name == 'sub':
            acc(a0, g)
            acc(args[1], -g)
        elif name == 'mul':
            acc(a0, g * x[1])
            acc(args[1], g * x[0])
        elif name == 'div':
            acc(a0, g / x[1])
            acc(args[1], -g * x[0] / (x[1] * x[1]))
        elif name == 'neg':
            acc(a0, -g)
        elif name == 'sqrt':
            acc(a0, g / (2.0 * t))
        elif name == 'exp':
            acc(a0, g * t)
        elif name == 'log':
            acc(a0, g / x[0])
        elif name == 'sin':
            acc(a0, g * rec.op('cos', x[0]))
        elif name == 'cos':
            acc(a0, g * -rec.op('sin', x[0]))
        elif name == 'tan':
            acc(a0, g * (1.0 + t * t))
        elif name == 'abs':
            acc(a0, g * rec.op('sign', x[0]))
        else:
            raise NotImplementedError('no derivative rule for %r' % name)
    return bar, gouts


def _tangent_rule(rec, name, x, dx, t):
    """The tangent of one SSA instruction ``t = name(*x)`` from the
    tangents `dx` of its arguments (a float 0.0 where none reaches), each
    as torch's forward mode defines it; the recorder folds the zero
    terms away."""
    if all(isinstance(v, float) and v == 0.0 for v in dx):
        return 0.0
    d0 = dx[0]
    if name == 'add':
        return d0 + dx[1]
    if name == 'sub':
        return d0 - dx[1]
    if name == 'mul':
        return d0 * x[1] + x[0] * dx[1]
    if name == 'div':
        return (d0 - t * dx[1]) / x[1]
    if name == 'neg':
        return -d0
    if name == 'sqrt':
        return d0 / (2.0 * t)
    if name == 'exp':
        return d0 * t
    if name == 'log':
        return d0 / x[0]
    if name == 'sin':
        return d0 * rec.op('cos', x[0])
    if name == 'cos':
        return -(d0 * rec.op('sin', x[0]))
    if name == 'tan':
        return d0 * (1.0 + t * t)
    if name == 'abs':
        return d0 * rec.op('sign', x[0])
    if name == 'sign':
        return 0.0
    raise NotImplementedError('no tangent rule for %r' % name)


def _tangent_sweep(program, rec, tan_sources, tan_params):
    """Replay `program`'s instructions on `rec` with their tangents (the
    forward sweep of forward mode).  A leaf read from a source in
    `tan_sources` has the tangent leaf ``('tan', key)``, read from that
    source's tangent ``tan:<source>`` at its row; with `tan_params` a
    parameter ``key`` has the tangent parameter ``('tan', key)``.
    Returns ``dget``: the tangent of an argument of the program (a ref or
    a float)."""
    leaves = [rec.leaf(key) for key in program.leaves]
    params = [rec.param(key) for key in program.params]
    dleaves = [rec.leaf(('tan', key))
               if src is not None and program.sources[src[0]] in tan_sources
               else 0.0 for key, src in zip(program.leaves, program.leaf_src)]
    dparams = [rec.param(('tan', key)) if tan_params else 0.0
               for key in program.params]
    tmps, dtmps = [], []
    refs = {'l': leaves, 'p': params, 't': tmps}
    drefs = {'l': dleaves, 'p': dparams, 't': dtmps}

    def get(a):
        return a if isinstance(a, float) else refs[a[0]][a[1]]

    def dget(a):
        return 0.0 if isinstance(a, float) else drefs[a[0]][a[1]]

    for name, args in program.instrs:
        x = [get(a) for a in args]
        t = rec.op(name, *x)
        tmps.append(t)
        dtmps.append(_tangent_rule(rec, name, x, [dget(a) for a in args], t))
    return dget


def _mask_sources(program, mask):
    """The sources and whether the parameters have a tangent, from a
    tangent mask (per source of `program`, then the parameters)."""
    if len(mask) != len(program.sources) + int(bool(program.params)):
        raise ValueError('vform_tangent: mask %s does not fit a program of '
                         '%d sources%s' % (mask, len(program.sources),
                                           ' and parameters'
                                           if program.params else ''))
    tan_sources = {k for k, m in zip(program.sources, mask) if m}
    return tan_sources, bool(program.params) and bool(mask[-1])


def _tangent_locations(program, tan_sources, tan_params, n):
    """``(leaf_loc, param_slot)`` of a program built on `program`'s leaves
    and parameters and their tangents: a tangent leaf reads its source's
    tangent ``tan:<source>`` at the leaf's row; the parameters and their
    tangents are one vector, ``params+tan``, the tangent of slot ``s`` at
    ``n + s`` (``n`` one past the largest slot the forward program reads:
    :func:`tangent_operands`)."""
    leaf_loc = {}
    for key, src in zip(program.leaves, program.leaf_src):
        if src is None:
            continue
        akey = program.sources[src[0]]
        leaf_loc[key] = (akey, src[1])
        if akey in tan_sources:
            leaf_loc[('tan', key)] = ('tan:' + akey, src[1])
    param_slot = dict(zip(program.params, program.param_slots))
    if tan_params:
        param_slot.update((('tan', k), n + s)
                          for k, s in zip(program.params, program.param_slots))
    return leaf_loc, param_slot


def tangent_program(program, mask):
    """The tangent of `program`'s fields for the tangents `mask` (per
    source, then the parameters: whether it has one), as a
    :class:`Program` of its own (K5's forward mode): the forward sweep of
    forward mode over the program's SSA (:func:`_tangent_sweep`), with CSE
    and the same constant folding, emitted by :func:`emit_cuda` with the
    forward's mapping.  Its leaves are the forward's and the tangents of
    those read from a source in the mask (``tan:<source>``); with the
    parameters in the mask it reads ``params+tan``
    (:func:`tangent_operands`).  Its outputs are the fields' tangents;
    its launches count under ``vform_tangent`` (``_f32`` for float32)."""
    tan_sources, tan_params = _mask_sources(program, mask)
    rec = SSARecorder()
    dget = _tangent_sweep(program, rec, tan_sources, tan_params)
    leaf_loc, param_slot = _tangent_locations(
        program, tan_sources, tan_params,
        max(program.param_slots, default=-1) + 1)
    prog = rec.finish([dget(o) for o in program.outputs], program.dim,
                      leaf_loc, param_slot, program.dtype)
    prog.counter = _TAN_LIBNAMES[program.dtype]
    if tan_params:
        prog.param_key = 'params+tan'
    return prog


def tangent_operands(program, mask, arrays, tangents):
    """`arrays` (the operands of `program`'s kernel) with the tangents of
    its tangent program for `mask`: ``tan:<source>`` for each source in
    the mask and, with the parameters in it, ``params+tan`` (the
    parameters the program reads, then their tangents).  `tangents` maps
    a source key, or ``'params'``, to its tangent."""
    tan_sources, tan_params = _mask_sources(program, mask)
    out = dict(arrays)
    for key in tan_sources:
        out['tan:' + key] = tangents[key]
    if tan_params:
        n = max(program.param_slots) + 1
        out['params+tan'] = torch.cat((arrays['params'][:n],
                                       tangents['params'][:n]))
    return out


class AdjointProgram:
    """The adjoint of a :class:`Program`: for the gradient ``gout``
    ``(n_combos,) + grid`` of its output, the gradient of every source
    tensor the program reads and of the flat parameter vector.

    Built by a reverse sweep over the program's SSA (:func:`_adjoint_sweep`)
    into a second SSA program (:attr:`program`, a :class:`Program` whose
    leaves are the forward's and the ``gout`` rows, its instructions the
    forward's recomputed, then the adjoint's, with CSE and the same
    constant folding).  Its outputs are the gradients of the source rows
    in :attr:`src_targets` (``(array key, row)``: leaves that read one
    row add their gradients), then those of the parameter slots in
    :attr:`param_targets`, which are summed over the Gauss points.  A row
    or parameter whose gradient folds to zero has no target (it is zero).

    It computes in the forward program's dtype (:attr:`counter`:
    ``vform_adjoint``, or ``vform_adjoint_f32`` for a float32 program,
    whose source has only float pointers, temporaries, constants and
    sums, as the forward's float32 instance).
    :meth:`source` is a second generated kernel with the forward's mapping
    of points to threads (``vform_shape``).  At each point it writes every
    row of every forward source's gradient (a target's value, else 0: the
    untargeted rows, the mirrored Hessian rows, rows past those the
    program reads), so the gradients need no memset.  It sums the
    parameters' gradients in a fixed order, with no atomics: each thread
    over its points, a butterfly of shuffles in each warp, the warps in
    order into one partial per block; a second kernel writes the whole
    parameter gradient (each target slot the sum of its partials, a warp
    a slot, in block order; 0 elsewhere).  Bitwise equal on a repeat."""

    def __init__(self, program):
        self.forward = program
        rec = SSARecorder()
        bar, gouts = _adjoint_sweep(program, rec)
        rows = {}
        for j, src in enumerate(program.leaf_src):
            v = bar.get(('l', j))
            if src is None or v is None or isinstance(v, float):
                continue
            key = (program.sources[src[0]], src[1])
            rows[key] = v if key not in rows else rows[key] + v
        params = [(slot, bar[('p', j)])
                  for j, slot in enumerate(program.param_slots)
                  if ('p', j) in bar and not isinstance(bar[('p', j)], float)]
        self.src_targets = list(rows)
        self.param_targets = [slot for slot, _v in params]
        leaf_loc = {key: (program.sources[src[0]], src[1])
                    for key, src in zip(program.leaves, program.leaf_src)
                    if src is not None}
        leaf_loc.update({('gout', c): ('gout', c) for c in gouts})
        self._setup(program, rec.finish(
            list(rows.values()) + [v for _s, v in params], program.dim,
            leaf_loc, dict(zip(program.params, program.param_slots)),
            program.dtype), _ADJ_LIBNAMES[program.dtype])

    def _setup(self, program, prog, counter):
        self.forward, self.program = program, prog
        self.dtype = program.dtype
        self.counter = counter
        self._source = None
        self._entry = None
        self._shape_fn = None
        self._shapes = {}          # (Q12, QL) -> vform_shape's launch
        self._max_slot = max(program.param_slots, default=-1)

    @property
    def source(self):
        """The CUDA C source of the adjoint's kernels."""
        if self._source is None:
            self._source = emit_cuda_adjoint(self)
        return self._source

    def entry(self):
        """The C entry ``pyiga_vform_adjoint``, built, loaded and declared
        on the first call (as :meth:`Program.entry`)."""
        if self._entry is None:
            lib = _cuda.build_generated(self.counter, self.source)
            fwd, prog = self.forward, self.program
            has_p = bool(fwd.params)
            fn = lib.pyiga_vform_adjoint
            fn.argtypes = ([ctypes.c_void_p] * (
                len(_pointer_args(prog)) + len(fwd.sources) + 2 * has_p)
                + [ctypes.c_int] * (5 + len(fwd.sources) + has_p)
                + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            shape = lib.pyiga_vform_shape
            shape.argtypes = [ctypes.c_int, ctypes.c_int,
                              ctypes.POINTER(ctypes.c_int)]
            shape.restype = ctypes.c_int
            self._shape_fn, self._entry = shape, fn
        return self._entry

    def shape(self, Q12, QL):
        """``(rows, threads, RB, blocks)`` of a launch on a grid of `Q12`
        rows of `QL` points: ``vform_shape``, the one rule of the forward
        and the adjoint kernel (which sizes the partials), read from the
        adjoint's library once per grid."""
        sh = self._shapes.get((Q12, QL))
        if sh is None:
            self.entry()
            out = (ctypes.c_int * 4)()
            if self._shape_fn(Q12, QL, out) != 0:
                raise ValueError('vform_adjoint: no launch for a grid of '
                                 '%d rows of %d points' % (Q12, QL))
            sh = self._shapes[(Q12, QL)] = tuple(out)
        return sh

    def outputs(self, arrays):
        """What a launch on `arrays` writes, allocated uninitialized (the
        kernels write every element): ``(grads, gparams, part)``, per
        forward source a gradient tensor of its shape (one tensor object
        each), and with parameters one allocation: the flat parameters'
        gradient, then the per-block partials of their sums (else None,
        None)."""
        fwd = self.forward
        W = arrays['weights']
        dev = W[0].device
        grads = {key: torch.empty(arrays[key].shape, dtype=self.dtype,
                                  device=dev) for key in fwd.sources}
        if not fwd.params:
            return grads, None, None
        P = arrays['params'].shape[0]
        nb = self.shape(math.prod(w.shape[0] for w in W[:-1]),
                        W[-1].shape[0])[3]
        buf = torch.empty(P + max(1, len(self.param_targets) * nb),
                          dtype=self.dtype, device=dev)
        return grads, buf[:P], buf[P:]

    def arguments(self, arrays, g, outs, stream):
        """The C entry's arguments for `arrays` as the forward takes them
        (``weights``, the sources, ``params``), the output's gradient `g`
        ``(n_combos,) + grid`` and the tensors `outs` to write (as
        :meth:`outputs` allocates them for `arrays`), to launch on
        `stream`: the adjoint program's inputs, the gradients and, with
        parameters, their gradient and partials; the grid, RB and the
        block count, each gradient's rows and the parameter count.
        Raises on an operand the kernel does not take."""
        fwd, prog = self.forward, self.program
        grads, gparams, part = outs
        grid = tuple(w.shape[0] for w in arrays['weights'])
        QL, Q12 = grid[-1], math.prod(grid[:-1])
        N = Q12 * QL
        if g.shape != (len(fwd.outputs),) + grid or g.dtype != self.dtype \
                or not g.is_contiguous():
            raise ValueError('vform_adjoint: gradient %s %s, expected %s '
                             '%s, contiguous'
                             % (tuple(g.shape), g.dtype,
                                (len(fwd.outputs),) + grid, self.dtype))
        ptrs = [t.data_ptr() for t in prog.operands(arrays, g.device, g)]
        ints = [Q12, QL, grid[1] if len(grid) == 3 else 1]
        ints += self.shape(Q12, QL)[2:]
        for key, need in zip(fwd.sources, fwd._rows):
            t = arrays[key]
            if t.shape[t.dim() - len(grid):] != grid or t.numel() < need * N:
                raise ValueError('vform_adjoint: %s is %s, expected %d rows '
                                 'on the grid %s' % (key, tuple(t.shape),
                                                     need, grid))
            ptrs.append(grads[key].data_ptr())
            ints.append(t.numel() // N)
        if fwd.params:
            P = arrays['params']
            if P.dim() != 1 or P.shape[0] <= self._max_slot:
                raise ValueError('vform_adjoint: params %s lacks slot %d'
                                 % (tuple(P.shape), self._max_slot))
            ptrs += [gparams.data_ptr(), part.data_ptr()]
            ints.append(P.shape[0])
        return (*ptrs, *ints, stream)

    def launch(self, arrays, g):
        """Run the adjoint kernel on CUDA tensors: `arrays` as the forward
        takes them (``weights``, the sources, ``params``), `g` the output's
        gradient ``(n_combos,) + grid``.  Returns ``(grads, gparams)``:
        per forward source a tensor of its shape (zero where no target
        writes) and the flat parameters' gradient (None without
        parameters), all written by the kernels: allocations and one
        ctypes call.  Raises on an operand the kernel does not take."""
        g = g.contiguous()
        outs = self.outputs(arrays)
        argv = self.arguments(arrays, g, outs, _cuda.stream_of(g))
        fn = self.entry()
        with _cuda.device_of(g):
            err = fn(*argv)
        _cuda.check(err, self.counter)
        _cuda.LAUNCHES[self.counter] += 1
        return outs[0], outs[1]


class SecondOrderProgram(AdjointProgram):
    """The tangent of a program's adjoint for the tangents `mask` (per
    source, then the parameters) with the output's gradient held: for
    ``gout`` the Hessian of ``<gout, F>`` (F the program's fields as a
    function of its sources and parameters) applied to the tangents, in
    the adjoint's layout.  It is the forward mode of K5's backward
    (forward over reverse) and, the Hessian being symmetric, the backward
    of the adjoint with respect to its sources (reverse over reverse).

    Built by the forward sweep of forward mode (:func:`_tangent_sweep`)
    over the :class:`AdjointProgram`'s SSA, the ``gout`` leaves with no
    tangent; its targets are the adjoint's rows and parameter slots whose
    tangent does not fold to zero.  It is emitted and launched as the
    adjoint is (:func:`emit_cuda_adjoint`: every row of every forward
    source's result written, the parameter sums in the adjoint's fixed order,
    no atomics), reading the tangents as :func:`tangent_program` does
    (``tan:<source>``, ``params+tan``); its launches count under
    ``vform_second`` (``_f32`` for float32)."""

    def __init__(self, program, mask):
        adj = program.adjoint()
        tan_sources, tan_params = _mask_sources(program, mask)
        rec = SSARecorder()
        dget = _tangent_sweep(adj.program, rec, tan_sources, tan_params)
        n_src = len(adj.src_targets)
        outs = [dget(o) for o in adj.program.outputs]
        keep = [i for i, o in enumerate(outs) if not isinstance(o, float)]
        self.src_targets = [adj.src_targets[i] for i in keep if i < n_src]
        self.param_targets = [adj.param_targets[i - n_src] for i in keep
                              if i >= n_src]
        leaf_loc, param_slot = _tangent_locations(
            adj.program, tan_sources, tan_params,
            max(program.param_slots, default=-1) + 1)
        prog = rec.finish([outs[i] for i in keep], program.dim, leaf_loc,
                          param_slot, program.dtype)
        if tan_params:
            prog.param_key = 'params+tan'
        self._setup(program, prog, _SECOND_LIBNAMES[program.dtype])


def emit_cuda_adjoint(adj):
    """CUDA C source of an :class:`AdjointProgram`: ``vform_adjoint_kernel``
    (the adjoint program per point: every row of every forward source's
    gradient written, the parameter gradients summed into one partial per
    block), ``vform_param_sum_kernel`` (the whole parameter gradient from
    the partials), ``pyiga_vform_shape(Q12, QL, shape)`` (``vform_shape``:
    rows, threads, RB, blocks) and the C entry ``pyiga_vform_adjoint(w0,
    .., s0, .., [p,] g0, .., [gp, part,] Q12, QL, Q1, RB, NB, R0, ..,
    [P,] stream)``: the adjoint program's inputs as :func:`emit_cuda`'s
    (the ``gout`` rows among its sources), one gradient per forward
    source, with parameters their gradient and the partials ``(n_targets,
    NB)``; the grid, the launch's RB and block count (refused unless
    ``vform_shape``'s), the rows of each gradient tensor and the length of
    the parameter vector.  Every pointer, temporary, constant and sum is of
    the program's scalar (double, or float for a float32 program)."""
    fwd, prog = adj.forward, adj.program
    T = _CTYPES[prog.dtype]
    zero, one = ('0.0f', '1.0f') if T == 'float' else ('0.0', '1.0')
    ptrs = _pointer_args(prog)
    gptrs = ['g%d' % k for k in range(len(fwd.sources))]
    n_src, n_p = len(adj.src_targets), len(adj.param_targets)
    target = {t: i for i, t in enumerate(adj.src_targets)}
    tail = []
    for k, key in enumerate(fwd.sources):
        for row in range(fwd._rows[k]):
            i = target.get((key, row))
            tail.append('g%d[%s] = %s;' % (
                k, _row_offset(row),
                zero if i is None else _c_arg(prog.outputs[i], T)))
        tail.append('for (int j = %d; j < R%d; ++j) g%d[j * N + g] = %s;'
                    % (fwd._rows[k], k, k, zero))
    tail += ['acc[%d] += %s;' % (m, _c_arg(prog.outputs[n_src + m], T))
             for m in range(n_p)]
    has_p = bool(fwd.params)
    rows = ''.join(', int R%d' % k for k in range(len(gptrs)))
    return _ADJ_SOURCE % dict(
        n_src=n_src, n_p=n_p, n_grad=len(gptrs), n_instrs=len(prog.instrs),
        shape=_SHAPE, T=T, zero=zero, one=one, sign=_sign(T),
        kargs=_declare(ptrs, gptrs + ['part'] * bool(n_p), 21, ctype=T),
        cargs=_declare(ptrs, gptrs + ['gp', 'part'] * has_p, 24, False,
                       ctype=T),
        names=''.join('%s, ' % x for x in ptrs + gptrs
                      + ['part'] * bool(n_p)),
        rows=rows, rows_names=''.join(', R%d' % k for k in range(len(gptrs))),
        p_arg=', int P' if has_p else '',
        acc_decl=('    %s acc[%d];\n#pragma unroll\n    for (int m = 0; '
                  'm < %d; ++m) acc[m] = %s;\n' % (T, n_p, n_p, zero))
        if n_p else '',
        loops=_mapped_loops(prog, tail),
        reduce=_ADJ_REDUCE % dict(n_p=n_p, T=T, zero=zero) if n_p else '',
        psum=_PSUM % dict(n_p=n_p, slots=', '.join(
            str(s) for s in adj.param_targets) or '-1',
            n_slot=max(n_p, 1), T=T, zero=zero) if has_p else '',
        second=('    if (e == cudaSuccess) {\n'
                '        vform_param_sum_kernel<<<1, %d, 0, s>>>(part, NB, '
                'gp, P);\n        e = cudaGetLastError();\n    }\n'
                % (32 * min(max(n_p, 1), 8))) if has_p else '')


_ADJ_REDUCE = """\
    // the block's partial sums in a fixed order: a butterfly of shuffles in
    // each warp (every lane ends with the same sum), then the warps in order
    __shared__ %(T)s sred[8][%(n_p)d];
#pragma unroll
    for (int m = 0; m < %(n_p)d; ++m) {
        %(T)s v = acc[m];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, off);
        if ((threadIdx.x & 31) == 0) sred[threadIdx.x >> 5][m] = v;
    }
    __syncthreads();
    for (int m = threadIdx.x; m < %(n_p)d; m += blockDim.x) {
        %(T)s s = %(zero)s;
        for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += sred[w][m];
        part[(long long)m * gridDim.x + blockIdx.x] = s;
    }
"""

_PSUM = """
// the parameter slots with a gradient, in the order of the partials
__constant__ int kSlot[%(n_slot)d] = {%(slots)s};

// the second pass, one block: every slot of the parameter gradient, slot
// kSlot[m] the sum of target m's partials (a warp a target: lane l over
// the blocks l, l + 32, ... in order, then a butterfly), the others 0
__global__ void __launch_bounds__(256)
vform_param_sum_kernel(const %(T)s* __restrict__ part, int nb,
                       %(T)s* __restrict__ gp, int P) {
    for (int i = threadIdx.x; i < P; i += blockDim.x) {
        bool target = false;
        for (int m = 0; m < %(n_p)d; ++m) target |= kSlot[m] == i;
        if (!target) gp[i] = %(zero)s;
    }
    const int lane = threadIdx.x & 31;
    for (int m = threadIdx.x >> 5; m < %(n_p)d; m += blockDim.x >> 5) {
        const %(T)s* q = part + (long long)m * nb;
        %(T)s a = %(zero)s;
#pragma unroll 4
        for (int i = lane; i < nb; i += 32) a += __ldg(q + i);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            a += __shfl_xor_sync(0xffffffffu, a, off);
        if (lane == 0) gp[kSlot[m]] = a;
    }
}
"""

_ADJ_SOURCE = """\
// Adjoint of the coefficient fields of one variational form (the backward
// of kernel K5 of pyiga_tpu_torch, generated by ops/cuda_vform.py), in
// %(T)s.
// Per Gauss point: the form's SSA recomputed, then its reverse sweep
// (%(n_instrs)d instructions in all); out: every row of the gradients of
// the %(n_grad)d forward sources (%(n_src)d target rows, 0 in the others),
// %(n_p)d parameter gradients summed over the points in a fixed order (no
// atomics) and the whole parameter gradient by a second kernel.
#include <cuda_runtime.h>

%(shape)s
%(sign)s
extern "C" __global__ void __launch_bounds__(256)
vform_adjoint_kernel(%(kargs)sint Q12, int QL, int Q1, int RB, int by_rows%(rows)s) {
    const long long N = (long long)Q12 * QL;
%(acc_decl)s%(loops)s%(reduce)s}
%(psum)s
extern "C" __attribute__((visibility("default")))
int pyiga_vform_shape(int Q12, int QL, int* shape) {
    if (Q12 < 1 || QL < 1) return (int)cudaErrorInvalidValue;
    const VformShape s = vform_shape(Q12, QL, K5_ADJ_MIN_BLOCKS);
    shape[0] = s.rows;
    shape[1] = s.threads;
    shape[2] = s.rb;
    shape[3] = s.blocks;
    return 0;
}

extern "C" __attribute__((visibility("default")))
int pyiga_vform_adjoint(%(cargs)sint Q12, int QL, int Q1, int RB, int NB%(rows)s%(p_arg)s,
                        void* stream) {
    if (Q12 < 1 || QL < 1) return (int)cudaErrorInvalidValue;
    const VformShape sh = vform_shape(Q12, QL, K5_ADJ_MIN_BLOCKS);
    // the wrapper sized the partials by the same rule
    if (RB != sh.rb || NB != sh.blocks) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    vform_adjoint_kernel<<<NB, sh.threads, 0, s>>>(
        %(names)sQ12, QL, Q1, RB, sh.rows%(rows_names)s);
    cudaError_t e = cudaGetLastError();
%(second)s    return (int)e;
}
"""


def run_adjoint_plain(program, arrays, g, adj=None):
    """Run `program`'s adjoint (:meth:`Program.adjoint`, or `adj`: a
    :class:`SecondOrderProgram` of it, whose ``tan:*`` and ``params+tan``
    operands `arrays` then holds) with torch ops on the kernel's operands
    (`arrays` as for :func:`run_program_plain`, `g` the output's gradient
    ``(n_combos,) + grid``).  Returns ``(grads, gparams)`` as
    :meth:`AdjointProgram.launch`: the plain version of the adjoint (or
    second-order) kernel."""
    adj = program.adjoint() if adj is None else adj
    vals = run_program_plain(adj.program, dict(arrays, gout=g))
    N = vals.shape[1]
    grads = {key: torch.zeros_like(arrays[key]) for key in program.sources}
    for (key, row), v in zip(adj.src_targets, vals):
        grads[key].view(-1, N)[row] = v
    gparams = None
    if program.params:
        gparams = torch.zeros_like(arrays['params'])
        for slot, v in zip(adj.param_targets, vals[len(adj.src_targets):]):
            gparams[slot] = v.sum()
    return grads, gparams


def run_tangent_plain(program, mask, arrays, tangents):
    """The plain version of the tangent kernel: `program`'s tangent
    program for `mask` run with torch ops (:func:`run_program_plain`) on
    `arrays` and the `tangents` (:func:`tangent_operands`); returns
    ``(n_combos, N)``."""
    return run_program_plain(program.tangent(mask), tangent_operands(
        program, mask, arrays, tangents))


def run_second_plain(program, mask, arrays, g, tangents):
    """The plain version of the second-order kernel: `program`'s
    :class:`SecondOrderProgram` for `mask` run with torch ops
    (:func:`run_adjoint_plain`); returns ``(grads, gparams)``."""
    return run_adjoint_plain(program, tangent_operands(
        program, mask, arrays, tangents), g, program.second(mask))


def _on_card(t, name='vform_fields'):
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.is_cuda:
        return True
    if t.device.type == 'cpu':
        return False
    raise ValueError('%s: unsupported device %s' % (name, t.device))


def _tangent_mask(program, n_w, dtensors):
    """The tangent mask and the tangents present, from the tangents of a
    Function's operands ``(*weights, *sources[, params])``."""
    _cuda.constant_tangents(program.counter, *dtensors[:n_w])
    rest = dtensors[n_w:]
    mask = tuple(d is not None for d in rest)
    return mask, [d.contiguous() for d in rest if d is not None]


def _tangent_dict(program, mask, present):
    """The tangents present as :func:`tangent_operands` takes them."""
    keys = list(program.sources) + ['params'] * bool(program.params)
    return dict(zip([k for k, m in zip(keys, mask) if m], present))


class _ComboFields(torch.autograd.Function):
    """K5 on CUDA tensors as a function of the tensors its program reads:
    ``apply(program, n_weights, *weights, *sources[, params])`` ->
    ``(n_combos,) + grid``.  Its backward is the generated adjoint kernel
    (:meth:`AdjointProgram.launch`), its ``jvp`` the generated tangent
    kernel (:func:`tangent_program`) on the tangents present; the Gauss
    weights are constants."""

    @staticmethod
    def forward(program, n_w, *tensors):
        return program.launch(_program_arrays(program, n_w, tensors))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.program, ctx.n_w = inputs[0], inputs[1]
        ctx.save_for_backward(*inputs[2:])
        ctx.save_for_forward(*inputs[2:])
        ctx.set_materialize_grads(False)   # None: no tangent

    @staticmethod
    def backward(ctx, g):
        program, n_w = ctx.program, ctx.n_w
        tensors = ctx.saved_tensors
        grads = _AdjointLaunch.apply(program, n_w, g.contiguous(), *tensors)
        return (None, None) + (None,) * n_w + tuple(grads)

    @staticmethod
    def jvp(ctx, _program, _n_w, *dtensors):
        mask, present = _tangent_mask(ctx.program, ctx.n_w, dtensors)
        return _cuda.Launch.apply(_tangent_launch, ctx.program, ctx.n_w,
                                  mask, *ctx.saved_tensors, *present)

    vmap = _cuda.loop_vmap(lambda *a: _ComboFields.apply(*a))


def _tangent_launch(program, n_w, mask, *tensors):
    """K5's generated tangent kernel on CUDA tensors ``(*weights,
    *sources[, params], *tangents)`` -> ``(n_combos,) + grid``:
    `program`'s tangent program for `mask`, the tangents those the mask
    names, in order (launched through :class:`~pyiga_tpu_torch._cuda.
    Launch`, once a member of a ``vmap`` batch)."""
    n = n_w + len(program.sources) + int(bool(program.params))
    arrays = tangent_operands(
        program, mask, _program_arrays(program, n_w, tensors[:n]),
        _tangent_dict(program, mask, tensors[n:]))
    return program.tangent(mask).launch(arrays)


class _AdjointLaunch(torch.autograd.Function):
    """K5's adjoint kernel as a Function ``apply(program, n_weights, g,
    *weights, *sources[, params])`` -> the gradients of the sources (and
    of ``params``) in :func:`_program_arrays` order, with a ``vmap`` rule
    that launches it once a member of the batch.  It is linear in `g`,
    and ``<g, F>`` has a symmetric Hessian in the sources and parameters,
    so the tangent and second-order kernels give both its rules: ``jvp``
    is the adjoint on the tangent of `g` plus the second-order kernel
    (:class:`SecondOrderProgram`) on the other tangents, and a cotangent
    `u` of its outputs goes back as the tangent kernel on `u` to `g` and
    the second-order kernel on `u` to the sources (reverse over
    reverse)."""

    @staticmethod
    def forward(program, n_w, g, *tensors):
        arrays = _program_arrays(program, n_w, tensors)
        grads, gparams = program.adjoint().launch(arrays, g)
        out = tuple(grads[k] for k in program.sources)
        return out + (gparams,) if program.params else out

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.program, ctx.n_w = inputs[0], inputs[1]
        ctx.save_for_backward(*inputs[2:])
        ctx.save_for_forward(*inputs[2:])
        ctx.set_materialize_grads(False)   # None: no tangent

    @staticmethod
    def backward(ctx, *uu):
        program, n_w = ctx.program, ctx.n_w
        g, *tensors = ctx.saved_tensors
        _cuda.constant_operands(program.adjoint().counter, *tensors[:n_w])
        mask = tuple(u is not None for u in uu)
        present = [u.contiguous() for u in uu if u is not None]
        gg = gs = None
        if any(mask) and ctx.needs_input_grad[2]:
            gg = _cuda.Launch.apply(_tangent_launch, program, n_w, mask,
                                    *tensors, *present)
        if any(mask) and any(ctx.needs_input_grad[3 + n_w:]):
            gs = _cuda.Launch.apply(_second_launch, program, n_w, mask, g,
                                    *tensors, *present)
        return ((None, None, gg) + (None,) * n_w
                + (tuple(gs) if gs is not None
                   else (None,) * (len(tensors) - n_w)))

    @staticmethod
    def jvp(ctx, _program, _n_w, dg, *dtensors):
        program, n_w = ctx.program, ctx.n_w
        g, *tensors = ctx.saved_tensors
        mask, present = _tangent_mask(program, n_w, dtensors)
        out = None
        if dg is not None:
            out = _AdjointLaunch.apply(program, n_w, dg.contiguous(),
                                       *tensors)
        if any(mask):
            s = _cuda.Launch.apply(_second_launch, program, n_w, mask, g,
                                   *tensors, *present)
            out = s if out is None else tuple(a + b for a, b in zip(out, s))
        return out

    vmap = _cuda.loop_vmap(lambda *a: _AdjointLaunch.apply(*a))


def _second_launch(program, n_w, mask, g, *tensors):
    """K5's generated second-order kernel (:class:`SecondOrderProgram`) on
    CUDA tensors ``(g, *weights, *sources[, params], *tangents)`` -> the
    adjoint's outputs' tangents, in :class:`_AdjointLaunch`'s order
    (launched through :class:`~pyiga_tpu_torch._cuda.Launch`)."""
    n = n_w + len(program.sources) + int(bool(program.params))
    arrays = tangent_operands(
        program, mask, _program_arrays(program, n_w, tensors[:n]),
        _tangent_dict(program, mask, tensors[n:]))
    grads, gparams = program.second(mask).launch(arrays, g)
    out = tuple(grads[k] for k in program.sources)
    return out + (gparams,) if program.params else out


def _program_arrays(program, n_w, tensors):
    """The ``arrays`` dict of a program's kernel from the flat operand
    list ``(*weights, *sources[, params])``."""
    arrays = {'weights': list(tensors[:n_w])}
    arrays.update(zip(program.sources, tensors[n_w:]))
    if program.params:
        arrays['params'] = tensors[-1]
    return arrays


################################################################################
# The wrapper and its plain version
################################################################################

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

    `arrays` are the assembler's tensors (``asm.device_arrays()``:
    ``weights``, ``geo_val_lvl``, ``geo_jac_lvl``, ``input:*``,
    ``param:*`` and the flat ``params``; all of one dtype, float64 or
    float32).  On CUDA the form's generated kernel of that dtype runs
    (:func:`generate`; a float32 program is a library of its own, its
    launches counted under ``vform_fields_f32``): one allocation of the
    ``(n_combos,) + grid`` output, one ctypes call into the program's
    entry (:meth:`Program.entry`, :meth:`Program.arguments`), the fields
    returned as views of the output; it is differentiable in the tensors
    the program reads, its backward the generated adjoint kernel
    (:class:`AdjointProgram`, in the program's dtype).  On the CPU the plain
    version, which autograd differentiates.  Returns one contiguous field
    per combo."""
    W = arrays['weights']
    if not _on_card(W[0], 'combo_fields'):
        return combo_fields_plain(asm, arrays, combos)
    program = asm._program(combos, W[0].dtype)
    _cuda.constant_operands('vform_fields', *W)
    tensors = list(W) + [arrays[k] for k in program.sources]
    if program.params:
        tensors.append(arrays['params'])
    return list(_ComboFields.apply(program, len(W), *tensors).unbind(0))
