# -*- coding: utf-8 -*-
"""B-spline knot vectors and vectorized basis evaluation (host, numpy).

A copy of the parts of :mod:`pyiga_tpu.bspline` that the port needs:
:class:`KnotVector` (with the mesh queries and ``refine`` that the
hierarchical spaces use), :func:`make_knots`, :func:`findspans`,
:func:`active_deriv`, :func:`collocation` and :func:`prolongation`, and
the boundary-spec parser.  Kept as numpy code (setup-time, tiny arrays)
and held equal to the original by ``tests/test_torch_host.py`` and
``tests/test_torch_hierarchical.py``.

Conventions: knot vectors are open (first/last knot repeated ``p+1``
times); ``active_deriv(kv, u, nd)`` returns shape ``(nd+1, p+1, npts)``
where the ``r``-th active function at ``u`` is ``findspan(u)-p+r``.
"""

import numpy as np
import scipy.sparse
import scipy.sparse.linalg


def _parse_bdspec(bdspec, dim):
    """Normalize a boundary specification to an ``(axis, side)`` pair.

    Accepts the named sides ``'left'/'right'`` (last axis), ``'bottom'/'top'``
    (second-to-last axis) and ``'front'/'back'`` (third-to-last axis), or an
    explicit ``(axis, side)`` tuple with ``side`` in ``(0, 1)``."""
    names = {
        'left':   (dim - 1, 0), 'right': (dim - 1, 1),
        'bottom': (dim - 2, 0), 'top':   (dim - 2, 1),
        'front':  (dim - 3, 0), 'back':  (dim - 3, 1),
    }
    bd = names.get(bdspec, bdspec) if isinstance(bdspec, str) else bdspec
    try:
        axis, side = bd
    except (TypeError, ValueError):
        raise ValueError('invalid bdspec %r' % (bdspec,))
    if side not in (0, 1) or not (0 <= axis < dim):
        raise ValueError('invalid bdspec %r for dimension %d' % (bdspec, dim))
    return (axis, side)


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
        self._knots_to_mesh = None

    def __repr__(self):
        return 'KnotVector(%r, %r)' % (self.kv, self.p)

    def __eq__(self, other):
        return (isinstance(other, KnotVector) and self.p == other.p
                and len(self.kv) == len(other.kv)
                and np.allclose(self.kv, other.kv, atol=1e-8, rtol=1e-8))

    def __hash__(self):
        # degree + endpoint knots rounded to the __eq__ tolerance grid, so
        # allclose-equal knot vectors hash equal (values straddling a
        # rounding-grid edge may still hash apart: a missed cache hit,
        # never a wrong lookup)
        return hash((self.p, self.kv.size,
                     round(float(self.kv[0]), 6),
                     round(float(self.kv[-1]), 6)))

    @property
    def numdofs(self):
        """Dimension of the spline space over this knot vector."""
        return self.kv.size - self.p - 1

    @property
    def numspans(self):
        """Number of nonempty knot spans."""
        return self.mesh.size - 1

    def support(self, j=None):
        """Support interval of the whole space or of the ``j``-th B-spline."""
        if j is None:
            return (self.kv[0], self.kv[-1])
        return (self.kv[j], self.kv[j + self.p + 1])

    def support_idx(self, j):
        """Knot indices delimiting the support of the ``j``-th B-spline."""
        return (j, j + self.p + 1)

    def _ensure_mesh(self):
        if self._knots_to_mesh is None:
            self._mesh, self._knots_to_mesh = np.unique(self.kv,
                                                        return_inverse=True)

    @property
    def mesh(self):
        """The unique knots (breakpoints)."""
        self._ensure_mesh()
        return self._mesh

    def mesh_support_idx(self, j):
        """First and last mesh (breakpoint) index of the support of
        B-spline ``j``."""
        self._ensure_mesh()
        lo, hi = self.support_idx(j)
        return (self._knots_to_mesh[lo], self._knots_to_mesh[hi])

    def mesh_support_idx_all(self):
        """``(numdofs, 2)`` array: first and last mesh index of the
        support of every B-spline."""
        self._ensure_mesh()
        n = self.numdofs
        idx = np.stack((np.arange(n), np.arange(self.p + 1, n + self.p + 1)),
                       axis=1)
        return self._knots_to_mesh[idx]

    def mesh_span_indices(self):
        """Knot indices ``i`` with ``kv[i] != kv[i+1]`` (the nonempty
        spans)."""
        self._ensure_mesh()
        k2m = self._knots_to_mesh
        return np.where(k2m[1:] != k2m[:-1])[0]

    def greville(self):
        """Greville abscissae (knot averages) of this knot vector."""
        p = self.p
        if p == 0:
            return 0.5 * (self.kv[1:] + self.kv[:-1])
        # running average of p consecutive interior knots
        csum = np.concatenate(([0.0], np.cumsum(self.kv)))
        g = (csum[p + 1:-1] - csum[1:-p - 1]) / p
        return np.clip(g, self.kv[0], self.kv[-1])

    def refine(self, new_knots=None):
        """Insert ``new_knots`` (or bisect every span if None) and return
        the refined knot vector."""
        if new_knots is None:
            m = self.mesh
            new_knots = 0.5 * (m[1:] + m[:-1])
        return KnotVector(np.sort(np.concatenate((self.kv, new_knots))),
                          self.p)


def make_knots(p, a, b, n, mult=1):
    """Open knot vector of degree `p` over ``(a, b)`` with `n` knot spans and
    interior-knot multiplicity `mult`."""
    interior = np.arange(a, b, (b - a) / n)[1:]
    kv = np.concatenate((np.repeat(a, p + 1), np.repeat(interior, mult),
                         np.repeat(b, p + 1)))
    return KnotVector(kv, p)


def findspans(knotvec, u):
    """Largest ``i`` with ``kv[i] <= u < kv[i+1]`` for every point of `u`,
    clamped to ``p <= i < len(kv) - 1 - p``."""
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


def collocation(kv, nodes):
    """Sparse collocation matrix ``C[i,j] = B_j(nodes[i])`` (CSR)."""
    nodes = np.asarray(nodes, dtype=float)
    m, n, p = len(nodes), kv.numdofs, kv.p
    values = active_deriv(kv, nodes, 0)[0].T               # (m, p+1)
    indices = findspans(kv, nodes) - p
    I = np.repeat(np.arange(m), p + 1)
    J = (indices[:, None] + np.arange(p + 1)[None, :]).ravel()
    return scipy.sparse.coo_matrix((values.ravel(), (I, J)),
                                   shape=(m, n)).tocsr()


def prolongation(kv1, kv2):
    """Coefficient prolongation matrix from the space over `kv1` into the
    (finer) space over `kv2`, computed by collocating at the Greville
    points of `kv2`.  Returns a pruned CSR matrix."""
    g = kv2.greville()
    C1 = collocation(kv1, g).toarray()
    C2 = collocation(kv2, g)
    P = scipy.sparse.linalg.spsolve(C2.tocsc(), C1)
    if scipy.sparse.issparse(P):
        P = P.toarray()
    P[np.abs(P) < 1e-15] = 0.0
    return scipy.sparse.csr_matrix(P)
