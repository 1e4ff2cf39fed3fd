# -*- coding: utf-8 -*-
"""B-spline knot vectors and vectorized basis evaluation (host, numpy).

A copy of the parts of :mod:`pyiga_tpu.bspline` that the port needs:
:class:`KnotVector`, :func:`make_knots`, :func:`findspans` and
:func:`active_deriv`.  Kept as numpy code (setup-time, tiny arrays)
and held equal to the original by ``tests/test_torch_host.py``.

Conventions: knot vectors are open (first/last knot repeated ``p+1``
times); ``active_deriv(kv, u, nd)`` returns shape ``(nd+1, p+1, npts)``
where the ``r``-th active function at ``u`` is ``findspan(u)-p+r``.
"""

import numpy as np


class KnotVector:
    """An open B-spline knot vector together with a spline degree.

    Attributes:
        kv (ndarray): the knots (first and last repeated ``p+1`` times).
        p (int): the spline degree.
    """

    def __init__(self, knots, p):
        knots = np.asarray(knots, dtype=float)
        if not np.all(np.diff(knots) >= 0.0):
            raise ValueError('knots should be increasing')
        self.kv = knots
        self.p = int(p)
        self._mesh = None

    def __repr__(self):
        return 'KnotVector(%r, %r)' % (self.kv, self.p)

    def __eq__(self, other):
        return (isinstance(other, KnotVector) and self.p == other.p
                and len(self.kv) == len(other.kv)
                and np.allclose(self.kv, other.kv, atol=1e-8, rtol=1e-8))

    __hash__ = None

    @property
    def numdofs(self):
        """Dimension of the spline space over this knot vector."""
        return self.kv.size - self.p - 1

    @property
    def mesh(self):
        """The unique knots (breakpoints)."""
        if self._mesh is None:
            self._mesh = np.unique(self.kv)
        return self._mesh

    @property
    def numspans(self):
        """Number of nonempty knot spans."""
        return self.mesh.size - 1

    def support(self, j=None):
        """Support interval of the whole space or of the ``j``-th B-spline."""
        if j is None:
            return (self.kv[0], self.kv[-1])
        return (self.kv[j], self.kv[j + self.p + 1])

    def mesh_support_idx_all(self):
        """``(numdofs, 2)`` array: first and last mesh index of the
        support of every B-spline."""
        knots_to_mesh = np.searchsorted(self.mesh, self.kv)
        n = self.numdofs
        idx = np.stack((np.arange(n), np.arange(self.p + 1, n + self.p + 1)),
                       axis=1)
        return knots_to_mesh[idx]


def make_knots(p, a, b, n, mult=1):
    """Open knot vector of degree `p` over ``(a, b)`` with `n` knot spans and
    interior-knot multiplicity `mult`."""
    interior = np.arange(a, b, (b - a) / n)[1:]
    kv = np.concatenate((np.repeat(a, p + 1), np.repeat(interior, mult),
                         np.repeat(b, p + 1)))
    return KnotVector(kv, p)


def findspans(knotvec, u):
    """Largest ``i`` with ``kv[i] <= u < kv[i+1]`` for every point of `u`,
    clamped to ``p <= i < numknots - 1 - p``."""
    kv, p = knotvec.kv, knotvec.p
    spans = np.searchsorted(kv, np.asarray(u), side='right') - 1
    return np.clip(spans, p, kv.size - p - 2).astype(np.int64)


def active_deriv(knotvec, u, numderiv):
    """All active B-splines and their derivatives up to order `numderiv` at
    the points `u` (Cox-de Boor triangle + derivative recurrence, The NURBS
    Book A2.3, vectorized over points).

    Returns ``(numderiv+1, p+1)`` for scalar `u`, else
    ``(numderiv+1, p+1, len(u))``; entry ``[k, r, j]`` is the `k`-th
    derivative of basis function ``findspan(u[j]) - p + r`` at ``u[j]``.
    """
    scalar = np.isscalar(u)
    u = np.atleast_1d(np.asarray(u, dtype=float))
    kv, p = knotvec.kv, knotvec.p
    npts = u.size
    nd = int(numderiv)

    span = findspans(knotvec, u)

    # ndu[:, r, j] (r <= j): value of the r-th active function of degree j;
    # the lower triangle ndu[:, j, r] (j > r) holds knot differences
    ndu = np.zeros((npts, p + 1, p + 1))
    ndu[:, 0, 0] = 1.0
    left = np.zeros((npts, p + 1))
    right = np.zeros((npts, p + 1))
    for j in range(1, p + 1):
        left[:, j] = u - kv[span + 1 - j]
        right[:, j] = kv[span + j] - u
        saved = np.zeros(npts)
        for r in range(j):
            ndu[:, j, r] = right[:, r + 1] + left[:, j - r]
            temp = ndu[:, r, j - 1] / ndu[:, j, r]
            ndu[:, r, j] = saved + right[:, r + 1] * temp
            saved = left[:, j - r] * temp
        ndu[:, j, j] = saved

    out = np.zeros((nd + 1, p + 1, npts))
    out[0] = ndu[:, :, p].T

    if nd > 0:
        # derivative recurrence; a holds the two alternating coefficient rows
        a = np.zeros((npts, 2, p + 1))
        for r in range(p + 1):
            a[:] = 0.0
            a[:, 0, 0] = 1.0
            s1, s2 = 0, 1
            fac = float(p)
            for k in range(1, nd + 1):
                d = np.zeros(npts)
                rk, pk = r - k, p - k
                if r >= k:
                    a[:, s2, 0] = a[:, s1, 0] / ndu[:, pk + 1, rk]
                    d = a[:, s2, 0] * ndu[:, rk, pk]
                j1 = 1 if rk >= -1 else -rk
                j2 = k - 1 if r - 1 <= pk else p - r
                for j in range(j1, j2 + 1):
                    a[:, s2, j] = ((a[:, s1, j] - a[:, s1, j - 1])
                                   / ndu[:, pk + 1, rk + j])
                    d = d + a[:, s2, j] * ndu[:, rk + j, pk]
                if r <= pk:
                    a[:, s2, k] = -a[:, s1, k - 1] / ndu[:, pk + 1, r]
                    d = d + a[:, s2, k] * ndu[:, r, pk]
                out[k, r, :] = d * fac
                fac *= pk
                s1, s2 = s2, s1

    if scalar:
        return out[:, :, 0]
    return out
