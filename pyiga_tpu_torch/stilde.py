# -*- coding: utf-8 -*-
"""Basis for the subspace S-tilde: splines whose odd derivatives vanish at
the domain boundary (Hofreither & Takacs, "Robust Multigrid for Isogeometric
Analysis Based on Stable Splittings of Spline Spaces").

A host copy of :mod:`pyiga_tpu.stilde`: ``Stilde_basis_side(kv, side)``
and ``Stilde_basis(kv)``."""

import numpy as np
import scipy.linalg

from . import bspline


def _odd_deriv_constraints(kv, side):
    """Rows = odd boundary derivatives (scaled by h^k), columns = the p
    boundary-active basis functions at the chosen end (the outermost
    function, which trivially satisfies all constraints, is dropped)."""
    p = kv.p
    endpoint = kv.kv[0 if side == 0 else -1]
    D = bspline.active_deriv(kv, endpoint, p - 1)       # (p, p+1)
    D = D[:, :-1] if side == 0 else D[:, 1:]
    scale = kv.meshsize_avg() ** np.arange(p)
    D = scale[:, None] * D
    D[0::2, :] = 0.0        # zero the even-derivative rows
    return D


def Stilde_basis_side(kv, side):
    """SVD-based splitting at one boundary: returns ``(N, C)`` where the
    columns of `N` span the nullspace of the odd-derivative constraints and
    those of `C` span its orthogonal complement."""
    D = _odd_deriv_constraints(kv, side)
    dim_null = (kv.p + 1) // 2
    V = scipy.linalg.svd(D)[2].T
    return V[:, -dim_null:], V[:, :-dim_null]


def Stilde_basis(kv):
    """Bases for S-tilde and its orthogonal complement as coefficient
    matrices ``(P_tilde, P_compl)`` over the full spline space."""
    p, n = kv.p, kv.numdofs
    NL, CL = Stilde_basis_side(kv, 0)
    NR, CR = Stilde_basis_side(kv, 1)
    interior = n - 2 * p

    # S-tilde: boundary nullspace blocks around an untouched interior
    P_tilde = scipy.linalg.block_diag(NL, np.eye(interior), NR)
    # complement: only the boundary blocks
    P_compl = np.zeros((n, CL.shape[1] + CR.shape[1]))
    P_compl[:p, :CL.shape[1]] = CL
    P_compl[n - p:, CL.shape[1]:] = CR
    return P_tilde, P_compl
