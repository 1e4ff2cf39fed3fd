# -*- coding: utf-8 -*-
"""Host operators (a copy of parts of :mod:`pyiga_tpu.operators`):
:func:`make_solver` wraps a factorization of a scipy sparse or numpy
dense matrix as a :class:`scipy.sparse.linalg.LinearOperator` that
applies the inverse (the implicit time integrators and the local
multigrid's coarse solves use it); :class:`NullOperator`,
:class:`IdentityOperator`, :class:`DiagonalOperator`, the matrix-free
:class:`KroneckerOperator` and :func:`make_kronecker_solver` (the L2
projection and the Gauss-weighted right-hand sides use them), the block
operators (:class:`BaseBlockOperator`, :func:`BlockDiagonalOperator`,
:func:`BlockOperator`) and the additive :class:`SubspaceOperator` of the
subspace-correction smoothers.  MKL PARDISO is not available
(:data:`HAVE_MKL` is False; :class:`PardisoSolverWrapper` raises
ImportError), so sparse direct solves use SuperLU.  The device operator
of the matrix-free solve is
:class:`~pyiga_tpu_torch.ops.matfree.MatrixFreeOperator`.
"""

import numpy as np
import scipy.linalg
import scipy.sparse
import scipy.sparse.linalg
from scipy.sparse.linalg import LinearOperator

from . import kronecker


class SolverWrapper(LinearOperator):
    """Expose a factorization's ``solve`` callable as a LinearOperator."""

    def __init__(self, shape, dtype, solve):
        self._solve = solve
        super().__init__(shape=shape, dtype=dtype)

    _matvec = _matmat = property(lambda self: self._solve)


def make_solver(B, symmetric=False, spd=False):
    """A LinearOperator that applies ``B^{-1}`` via a direct factorization.

    Sparse inputs use SuperLU with the COLAMD fill-reducing ordering;
    dense symmetric or SPD inputs use a Cholesky factorization and general
    dense ones LU (scipy, as in the JAX package)."""
    if scipy.sparse.issparse(B):
        lu = scipy.sparse.linalg.splu(B.tocsc(), permc_spec='COLAMD')
        apply_inv = lu.solve
    elif symmetric or spd:
        cho = scipy.linalg.cho_factor(B, check_finite=False)

        def apply_inv(rhs):
            return scipy.linalg.cho_solve(cho, rhs, check_finite=False)
    else:
        lu = scipy.linalg.lu_factor(B, check_finite=False)

        def apply_inv(rhs):
            return scipy.linalg.lu_solve(lu, rhs, check_finite=False)
    return SolverWrapper(B.shape, B.dtype, apply_inv)


def make_kronecker_solver(*Bs):
    """Inverse of a Kronecker product, applied factor-wise."""
    return KroneckerOperator(*(make_solver(B) for B in Bs))


class NullOperator(LinearOperator):
    """All-zeros operator (placeholder for empty blocks)."""

    def __init__(self, shape, dtype=np.float64):
        super().__init__(shape=shape, dtype=dtype)

    def _matvec(self, x):
        return np.zeros(self.shape[0], dtype=self.dtype)

    def _matmat(self, X):
        return np.zeros((self.shape[0], X.shape[1]), dtype=self.dtype)

    def _transpose(self):
        return NullOperator(self.shape[::-1], dtype=self.dtype)


class IdentityOperator(LinearOperator):
    """Identity on R^n."""

    def __init__(self, n, dtype=np.float64):
        super().__init__(shape=(n, n), dtype=dtype)

    _matvec = _matmat = staticmethod(lambda x: x)

    def _transpose(self):
        return self


class DiagonalOperator(LinearOperator):
    """Multiplication by a fixed diagonal."""

    def __init__(self, diag):
        diag = np.squeeze(diag)
        if diag.ndim != 1:
            raise ValueError('diagonal must be a vector')
        self.diag = diag
        n = diag.shape[0]
        super().__init__(shape=(n, n), dtype=diag.dtype)

    def _matvec(self, x):
        d = self.diag
        return d * x if x.ndim == 1 else d[:, None] * x

    _matmat = _matvec

    def _transpose(self):
        return self


class KroneckerOperator(LinearOperator):
    """Matrix-free Kronecker product of the given factors."""

    def __init__(self, *factors):
        self.ops = factors
        rows = int(np.prod([f.shape[0] for f in factors]))
        cols = int(np.prod([f.shape[1] for f in factors]))
        square = all(f.shape[0] == f.shape[1] for f in factors)
        dense = all(isinstance(f, np.ndarray) for f in factors)
        # the per-axis LinearOperator route needs square factors
        self._apply = (kronecker._apply_kronecker_linops
                       if square and not dense
                       else kronecker._apply_kronecker_dense)
        super().__init__(dtype=factors[0].dtype, shape=(rows, cols))

    def _matvec(self, x):
        return self._apply(self.ops, x)

    _matmat = _matvec

    def _transpose(self):
        return KroneckerOperator(*(f.T for f in self.ops))

    def _adjoint(self):
        return KroneckerOperator(*(f.H for f in self.ops))


################################################################################
# Block and subspace structure
################################################################################

class BaseBlockOperator(LinearOperator):
    """Sub-operators scattered into row and column ranges."""

    def __init__(self, shape, ops, ran_out, ran_in):
        self.ops = tuple(ops)
        self.ran_out = tuple(ran_out)
        self.ran_in = tuple(ran_in)
        super().__init__(self.ops[0].dtype, shape)

    def _apply_blocks(self, x, out_shape):
        y = np.zeros(out_shape)
        for block, rows, cols in zip(self.ops, self.ran_out, self.ran_in):
            y[rows] += block.dot(x[cols])
        return y

    def _matvec(self, x):
        if x.ndim == 2:
            x = x[:, 0]
        return self._apply_blocks(x, self.shape[0])

    def _matmat(self, X):
        return self._apply_blocks(X, (self.shape[0], X.shape[1]))

    def _transpose(self):
        return BaseBlockOperator(self.shape[::-1], [b.T for b in self.ops],
                                 self.ran_in, self.ran_out)

    def _adjoint(self):
        return BaseBlockOperator(self.shape[::-1], [b.H for b in self.ops],
                                 self.ran_in, self.ran_out)


def _partition(sizes):
    """Consecutive index ranges with the given lengths."""
    edges = np.concatenate(([0], np.cumsum(list(sizes))))
    return [range(a, b) for a, b in zip(edges[:-1], edges[1:])]


def BlockDiagonalOperator(*ops):
    """Operators stacked along the diagonal."""
    rows = _partition(b.shape[0] for b in ops)
    cols = _partition(b.shape[1] for b in ops)
    return BaseBlockOperator((rows[-1].stop, cols[-1].stop), ops, rows, cols)


def BlockOperator(ops):
    """An operator from a rectangular list of lists of blocks (None or a
    :class:`NullOperator` for empty positions), as :func:`numpy.block`."""
    nrows, ncols = len(ops), len(ops[0])

    def _size(line, axis, what, idx):
        # the first block that is not None gives the row height or the
        # column width
        for blk in line:
            if blk is not None:
                return blk.shape[axis]
        raise ValueError('%s %d of the block structure is all None' %
                         (what, idx))

    rows = _partition(_size(ops[i], 0, 'row', i) for i in range(nrows))
    cols = _partition(_size([ops[i][j] for i in range(nrows)], 1,
                            'column', j) for j in range(ncols))
    shape = (rows[-1].stop, cols[-1].stop)

    kept, kept_rows, kept_cols = [], [], []
    for i, row in enumerate(ops):
        if len(row) != ncols:
            raise ValueError('ragged block structure in row %d' % i)
        for j, blk in enumerate(row):
            if blk is None or isinstance(blk, NullOperator):
                continue
            expect = (len(rows[i]), len(cols[j]))
            if blk.shape != expect:
                raise ValueError('block (%d, %d) has shape %s, expected %s'
                                 % (i, j, blk.shape, expect))
            kept.append(blk)
            kept_rows.append(rows[i])
            kept_cols.append(cols[j])
    if not kept:
        return NullOperator(shape)
    return BaseBlockOperator(shape, kept, kept_rows, kept_cols)


class SubspaceOperator(LinearOperator):
    r"""Additive subspace correction :math:`x \mapsto \sum_j P_j B_j P_j^T
    x` for prolongators `P_j` and square operators `B_j`."""

    def __init__(self, subspaces, Bs):
        self.subspaces = tuple(subspaces)
        self.Bs = tuple(Bs)
        if not self.Bs or len(self.subspaces) != len(self.Bs):
            raise ValueError('need one operator per subspace')
        self._flip = False
        n = self.subspaces[0].shape[0]
        super().__init__(shape=(n, n), dtype=self.Bs[0].dtype)

    def _matvec(self, x):
        if x.ndim > 1:
            x = np.squeeze(x)
        acc = np.zeros(x.shape[0])
        for P, B in zip(self.subspaces, self.Bs):
            w = P.T.dot(x)
            acc += P.dot(B.T.dot(w) if self._flip else B.dot(w))
        return acc

    def _transpose(self):
        out = SubspaceOperator(self.subspaces, self.Bs)
        out._flip = not self._flip
        return out


# MKL PARDISO (through pyMKL) is not a dependency: sparse direct solves
# always use SuperLU
HAVE_MKL = False


class PardisoSolverWrapper:
    """Stand-in for an MKL PARDISO solver wrapper; PARDISO is not
    available (:func:`make_solver` uses SuperLU)."""

    def __init__(self, *args, **kwargs):
        raise ImportError('MKL PARDISO (pyMKL) is not available; '
                          'make_solver() uses SuperLU')
