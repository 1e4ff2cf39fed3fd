# -*- coding: utf-8 -*-
"""Host operators (a copy of parts of :mod:`pyiga_tpu.operators`):
:func:`make_solver` wraps a factorization of a scipy sparse or numpy
dense matrix as a :class:`scipy.sparse.linalg.LinearOperator` that
applies the inverse (the implicit time integrators and the local
multigrid's coarse solves use it); :class:`NullOperator`,
:class:`IdentityOperator`, :class:`DiagonalOperator`, the matrix-free
:class:`KroneckerOperator` and :func:`make_kronecker_solver` (the L2
projection and the Gauss-weighted right-hand sides use them).  The
block and subspace operators are not ported yet.  The device operator
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
