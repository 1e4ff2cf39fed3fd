# -*- coding: utf-8 -*-
"""Mode products of dense tensors and the lazy sum and product formats
(host, numpy): a copy of the part of :mod:`pyiga_tpu.tensor` that the
Kronecker operators, interpolation, L2 projection and the low-rank
assembly (:func:`~pyiga_tpu_torch.lowrank.aca_3d` with ``lr=True``)
use.  :func:`apply_tprod` applies one operator per axis — a dense or
sparse matrix or a LinearOperator — through explicit matricization
(``unfold @ fold``).  The CP and Tucker formats and the approximation
algorithms of the JAX module are not ported yet.
"""

from functools import reduce

import numpy as np
import scipy.sparse


def matricize(X, k):
    """Mode-`k` unfolding: a ``(shape[k], prod(other dims))`` matrix whose
    rows are the mode-`k` fibers, remaining axes kept in original order."""
    return np.moveaxis(X, k, 0).reshape(X.shape[k], -1)


def _fold(M, k, shape):
    """Inverse of :func:`matricize`: fold a ``(m, prod(other))`` matrix back
    into a tensor of the given shape with ``shape[k]`` replaced by `m`."""
    inter = (M.shape[0],) + tuple(shape[:k]) + tuple(shape[k + 1:])
    return np.moveaxis(np.asarray(M).reshape(inter), 0, k)


def modek_tprod(B, k, X):
    """Mode-`k` product: apply the matrix (or sparse matrix /
    LinearOperator) `B` along axis `k` of the tensor `X`."""
    return _fold(B @ matricize(X, k), k, X.shape)


def apply_tprod(ops, A):
    """Apply one operator per axis (``None`` = identity) to the tensor `A`.

    Equivalent to multiplying ``vec(A)`` by ``kron(ops[0], ops[1], ...)``.
    Axes beyond ``len(ops)`` are untouched.  Structured tensors that know
    how to apply per-axis operators to themselves (``nway_prod``) are
    delegated to."""
    if hasattr(A, 'nway_prod'):
        return A.nway_prod(ops)
    Y = np.asanyarray(A)
    for k, B in enumerate(ops):
        if B is not None:
            Y = modek_tprod(B, k, Y)
    return Y


def fro_norm(X):
    """Frobenius norm of an array or structured tensor."""
    try:
        return X.norm()
    except AttributeError:
        return np.linalg.norm(np.ravel(X))


def asarray(X):
    """Densify a structured tensor; pass numpy arrays/scalars through."""
    try:
        return X.asarray()
    except AttributeError:
        return np.asanyarray(X)


def outer(*xs):
    """Outer product of vectors: ``outer(x, y, z)[i,j,k] = x[i] y[j] z[k]``
    (of arrays in general: the axes concatenate)."""
    return reduce(np.multiply.outer, xs)


def _normalize_indices(I, shape):
    """Canonicalize an indexing expression over `shape`.

    Returns ``(per_axis, new_shape, singletons)`` where each `per_axis`
    entry is a ``range`` (for scalars and slices) or an integer array (for
    fancy indices), `new_shape` keeps scalar axes as length-1, and
    `singletons` lists the scalar-indexed axes (to be squeezed)."""
    idx = I if isinstance(I, tuple) else (I,)
    if len(idx) > len(shape):
        raise ValueError('got %d indices but have only %d axes'
                         % (len(idx), len(shape)))
    idx = idx + (len(shape) - len(idx)) * (slice(None),)

    per_axis, new_shape, singletons = [], [], []
    for ax, (spec, n) in enumerate(zip(idx, shape)):
        if isinstance(spec, slice):
            sel = range(n)[spec]
        elif np.isscalar(spec):
            pos = range(n)[spec]        # bounds check + negative wrap
            sel = range(pos, pos + 1)
            singletons.append(ax)
        else:
            sel = np.arange(n)[spec]
        per_axis.append(sel)
        new_shape.append(len(sel))
    return tuple(per_axis), tuple(new_shape), tuple(singletons)


def _selection_matrix(sel, n):
    """Sparse 0/1 matrix extracting the rows `sel` from a length-`n` axis."""
    m = len(sel)
    return scipy.sparse.csr_matrix(
        (np.ones(m), (np.arange(m), np.fromiter(sel, dtype=np.intp, count=m))),
        shape=(m, n))


class _FormatBase:
    """Shared behavior of the structured tensor formats: raveling,
    subtraction, norm, indexing (via per-axis restriction) and squeezing."""

    def ravel(self):
        return self.asarray().ravel()

    def norm(self):
        return np.linalg.norm(self.ravel())

    def __sub__(self, other):
        return self + (-other)

    def _restricted(self, per_axis):
        """Same-format tensor restricted to the given per-axis index
        ranges; default goes through selection-matrix mode products."""
        sels = [_selection_matrix(sel, n)
                for sel, n in zip(per_axis, self.shape)]
        return self.nway_prod(sels)

    def __getitem__(self, I):
        per_axis, new_shape, singletons = _normalize_indices(I, self.shape)
        sub = self._restricted(per_axis)
        return sub.squeeze(axis=singletons) if singletons else sub

    def _squeeze_axes(self, axis):
        if axis is None:
            return tuple(k for k, n in enumerate(self.shape) if n == 1)
        axis = (axis,) if np.isscalar(axis) else tuple(axis)
        if any(self.shape[k] != 1 for k in axis):
            raise ValueError('all given axes must be singletons!')
        return axis


class TensorSum(_FormatBase):
    """Lazy sum of tensors of identical shape (mixed formats allowed)."""

    def __init__(self, *Xs):
        if not Xs:
            raise ValueError('cannot form sum of empty list of tensors')
        self.Xs = tuple(Xs)
        self.ndim = self.Xs[0].ndim
        self.shape = self.Xs[0].shape
        if not all(X.shape == self.shape for X in self.Xs):
            raise ValueError('all terms of a TensorSum must have the same '
                             'shape (a mismatch would silently broadcast)')

    def __repr__(self):
        return 'TensorSum(%d terms, shape=%s)' % (len(self.Xs), self.shape)

    def asarray(self):
        return reduce(np.add, (asarray(X) for X in self.Xs))

    def nway_prod(self, Bs):
        return TensorSum(*(apply_tprod(Bs, X) for X in self.Xs))

    def __neg__(self):
        return TensorSum(*(-X for X in self.Xs))

    def __add__(self, other):
        return TensorSum(*self.Xs, other)

    def __sub__(self, other):
        return TensorSum(*self.Xs, -other)

    def __getitem__(self, I):
        parts = tuple(X[I] for X in self.Xs)
        if all(np.isscalar(p) for p in parts):
            return sum(parts)
        return TensorSum(*parts)


class TensorProd(_FormatBase):
    """Lazy outer product of tensors (axes concatenate)."""

    def __init__(self, *Xs):
        self.Xs = tuple(Xs)
        self.slices = []
        pos = 0
        for X in self.Xs:
            self.slices.append(slice(pos, pos + X.ndim))
            pos += X.ndim
        self.shape = tuple(n for X in self.Xs for n in X.shape)
        self.ndim = pos

    def __repr__(self):
        return 'TensorProd(%d factors, shape=%s)' % (len(self.Xs), self.shape)

    def asarray(self):
        return outer(*(asarray(X) for X in self.Xs))

    def nway_prod(self, Bs):
        Bs = tuple(Bs) + (self.ndim - len(Bs)) * (None,)
        return TensorProd(*(apply_tprod(Bs[s], X)
                            for s, X in zip(self.slices, self.Xs)))

    def __neg__(self):
        return TensorProd(-self.Xs[0], *self.Xs[1:])

    def __add__(self, other):
        return TensorSum(self, other)

    def __sub__(self, other):
        return TensorSum(self, -other)

    def __getitem__(self, I):
        idx = I if isinstance(I, tuple) else (I,)
        if len(idx) > self.ndim:
            raise ValueError('too many indices')
        idx = idx + (self.ndim - len(idx)) * (slice(None),)
        parts = tuple(X[idx[s]] for s, X in zip(self.slices, self.Xs))
        if all(np.isscalar(p) for p in parts):
            return float(np.prod(parts))
        return TensorProd(*parts)
