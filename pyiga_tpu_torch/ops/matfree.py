# -*- coding: utf-8 -*-
"""Matrix-free operator application by sum factorization, and the
restriction of an operator to a free-dof subset (port of
:mod:`pyiga_tpu.ops.matfree`).

Instead of multiplying with an assembled matrix, the operator is applied
through quadrature each time:

    y = sum_t  B_test(dv_t)^T [ C_t  *  B_trial(du_t) x ]

where ``B(d) x`` evaluates the d-th derivative combination of the trial
function on the tensor Gauss grid (a chain of per-axis ``(Q_k, n_k)``
tensordots), ``C_t`` are the coefficient fields (from kernel K1 or K5 on
the card, computed once), and the transposed test chain accumulates back
to coefficients.  The JAX package leaves these contractions to XLA
outside any Pallas kernel; here they are ``torch.tensordot``.

A box-shaped free set — the interior dofs of an all-Dirichlet problem —
restricts by slicing, with no index tensor at all.
"""

import copy

import numpy as np
import torch

from ..config import get_dtype, no_tf32
from . import cuda_vform


def box_restriction(free_dofs, ns):
    """If the raveled `free_dofs` indices form an axis-aligned box in the
    `ns` grid (e.g. the interior dofs of an 'all'-Dirichlet problem), return
    ``(los, box_shape)``; else None."""
    free = np.asarray(free_dofs)
    if free.ndim != 1 or len(free) == 0:
        return None
    idx = np.unravel_index(free, ns)
    axes = [np.unique(ix) for ix in idx]
    shape = tuple(len(a) for a in axes)
    if len(free) != int(np.prod(shape)):
        return None
    for a in axes:
        if a[-1] - a[0] + 1 != len(a):
            return None
    grid = np.stack(np.meshgrid(*axes, indexing='ij'), 0).reshape(len(ns), -1)
    if not np.array_equal(free, np.ravel_multi_index(tuple(grid), ns)):
        return None
    return tuple(int(a[0]) for a in axes), shape


def _forward_chain(tabs, X):
    """Contract coefficients ``(n_1..n_d)`` with per-axis ``(Q_k, n_k)``
    tables."""
    for k in range(len(tabs)):
        X = torch.movedim(torch.tensordot(tabs[k], X, dims=([1], [k])), 0, k)
    return X


def _backward_chain(tabs, X):
    """Adjoint: contract grid values ``(Q_1..Q_d)`` with the ``(Q_k,
    n_k)`` tables transposed."""
    for k in range(len(tabs)):
        X = torch.movedim(torch.tensordot(tabs[k], X, dims=([0], [k])), 0, k)
    return X


def matfree_apply(trial_tabs, test_tabs, fields, trial_of_term, test_of_term,
                  field_of_term, ns_in, ns_out, x):
    """Operator application.

    Args:
        trial_tabs / test_tabs: per unique derivative combination, the
            chain of per-axis ``(Q_k, n_k)`` tables.
        fields: the coefficient fields on the Gauss grid.
        trial_of_term / test_of_term / field_of_term: per term, the
            indices into the above lists.
        ns_in / ns_out: trial / test dof shapes.
        x: raveled input vector.
    """
    with no_tf32(x.dtype):
        return _matfree_apply(trial_tabs, test_tabs, fields, trial_of_term,
                              test_of_term, field_of_term, ns_in, ns_out, x)


def _matfree_apply(trial_tabs, test_tabs, fields, trial_of_term,
                   test_of_term, field_of_term, ns_in, ns_out, x):
    X = x.reshape(ns_in)
    # forward-evaluate each needed trial derivative combination once
    U = [None] * len(trial_tabs)
    for t in sorted(set(trial_of_term)):
        U[t] = _forward_chain(trial_tabs[t], X)
    # accumulate grid-space contributions per unique test combination
    Z = [None] * len(test_tabs)
    for term in range(len(trial_of_term)):
        contrib = fields[field_of_term[term]] * U[trial_of_term[term]]
        s = test_of_term[term]
        Z[s] = contrib if Z[s] is None else Z[s] + contrib
    # adjoint test chains back to coefficients
    y = None
    for s, Zs in enumerate(Z):
        if Zs is None:
            continue
        contrib = _backward_chain(test_tabs[s], Zs)
        y = contrib if y is None else y + contrib
    return y.reshape(-1)


class MatrixFreeOperator:
    """Matrix-free operator of a sum-factorization assembler: a Gauss
    assembler of :mod:`pyiga_tpu_torch.assemblers` or a compiled VForm
    assembler of a scalar bilinear form.

    The coefficient fields are computed once, in the compute dtype on the
    assembler's device (K2 + K1 for a Gauss assembler, K2 + K1 ``jac`` +
    K5 for a VForm, float64 only), and kept in `dtype` (default the
    compute dtype; float64 or float32) on `device` (default: the
    assembler's device) with the per-axis basis tables.  A float32
    operator applies its products in full float32
    (:func:`~pyiga_tpu_torch.config.no_tf32`), whatever torch's global
    TF32 setting.
    Pass `free_dofs` (raveled indices) for the operator on the free dofs
    (zero extension and restriction built in; a box-shaped set by
    slicing)."""

    def __init__(self, asm, free_dofs=None, dtype=None, device=None):
        dtype = get_dtype() if dtype is None else dtype
        device = asm.device if device is None else torch.device(device)
        d = asm.dim
        if hasattr(asm, 'terms'):           # Gauss assembler
            terms = asm.terms
            fields = asm.field_fn(asm.geo_inputs())
        else:                               # compiled VForm assembler
            if asm.arity != 2 or asm.vf.vec:
                raise ValueError('MatrixFreeOperator needs a scalar '
                                 'bilinear form')
            terms = [(tuple(reversed(su[1])), tuple(reversed(sv[1])))
                     for su, sv in asm.combos]
            fields = cuda_vform.combo_fields(asm, asm.device_arrays(),
                                             asm.combos)
        self._fields = [F.to(device=device, dtype=dtype) for F in fields]

        # unique trial/test derivative combos -> table chains (Q_k, n_k)
        trial_combos = sorted(set(du for du, dv in terms))
        test_combos = sorted(set(dv for du, dv in terms))
        tt = asm.tables

        def chain(space_tabs, combo):
            return [torch.as_tensor(np.ascontiguousarray(
                space_tabs[k][combo[k]].T), dtype=dtype, device=device)
                for k in range(d)]

        self._trial_tabs = [chain(tt.trial, c) for c in trial_combos]
        self._test_tabs = [chain(tt.test, c) for c in test_combos]
        self._trial_of_term = [trial_combos.index(du) for du, dv in terms]
        self._test_of_term = [test_combos.index(dv) for du, dv in terms]
        self._field_of_term = list(range(len(terms)))

        # one space: the trial and test dof grids agree
        self.ns = self.ns_in = self.ns_out = tuple(
            b[0] for b in asm.structure.bs)
        self.dtype, self.device = dtype, device
        self.shape = 2 * (int(np.prod(self.ns)),)
        self._restricted = None
        if free_dofs is not None:
            # the restriction wraps an unrestricted copy sharing the tensors
            self._restricted = RestrictedOperator(copy.copy(self), free_dofs)
            self.shape = self._restricted.shape

    def matvec(self, x):
        if self._restricted is not None:
            return self._restricted(x)
        return matfree_apply(self._trial_tabs, self._test_tabs, self._fields,
                             self._trial_of_term, self._test_of_term,
                             self._field_of_term, self.ns, self.ns, x)

    __call__ = matvec


class RestrictedOperator:
    """Restrict an operator on the full TP space (a callable on raveled
    vectors with attributes ``dtype`` and ``device``) to the `free_dofs`
    subset: the input is placed into a zero full vector, the operator
    applied, and the free rows taken — ``A[free][:, free]`` for a
    homogeneous Dirichlet elimination.  `ns`, the dofs per axis, defaults
    to ``op.ns``; with it, a free set that is a box is cut by slices.
    Without `ns` and ``op.ns``, `n_full` is required."""

    def __init__(self, op, free_dofs, n_full=None, ns=None):
        self.op = op
        if ns is None:
            ns = getattr(op, 'ns', None)
        if ns is None and n_full is None:
            raise ValueError('RestrictedOperator needs ns, op.ns or n_full')
        self.ns = None if ns is None else tuple(ns)
        self.n_full = int(np.prod(self.ns)) if n_full is None else n_full
        self.shape = (len(free_dofs), len(free_dofs))
        self.dtype, self.device = op.dtype, op.device
        box = (None if self.ns is None
               else box_restriction(free_dofs, self.ns))
        if box is not None:
            los, bshape = box
            self._box = tuple(slice(lo, lo + s) for lo, s in zip(los, bshape))
            self._free = None
        else:
            self._box = None
            self._free = torch.as_tensor(np.asarray(free_dofs, np.int64),
                                         device=op.device)

    def matvec(self, x):
        if self._box is not None:
            xf = torch.zeros(self.ns, dtype=x.dtype, device=x.device)
            xf[self._box] = x.reshape(xf[self._box].shape)
            y = self.op(xf.reshape(-1))
            return y.reshape(self.ns)[self._box].reshape(-1)
        xf = torch.zeros(self.n_full, dtype=x.dtype, device=x.device)
        xf[self._free] = x
        return self.op(xf)[self._free]

    __call__ = matvec
