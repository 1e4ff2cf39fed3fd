# -*- coding: utf-8 -*-
"""Direct solvers on the host (a copy of the direct-solver part of
:mod:`pyiga_tpu.operators`): :func:`make_solver` wraps a factorization
of a scipy sparse or numpy dense matrix as a
:class:`scipy.sparse.linalg.LinearOperator` that applies the inverse.
The implicit time integrators and the local multigrid's coarse solves
use it.
"""

import scipy.linalg
import scipy.sparse
import scipy.sparse.linalg
from scipy.sparse.linalg import LinearOperator


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
