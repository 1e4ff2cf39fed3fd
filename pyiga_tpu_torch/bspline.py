# -*- coding: utf-8 -*-
"""B-spline knot vectors and vectorized basis evaluation (host, numpy).

A copy of the parts of :mod:`pyiga_tpu.bspline` that the port needs:
:class:`KnotVector` (with the mesh and span queries and ``refine``),
:func:`make_knots`, :func:`findspans`, basis and spline evaluation
(:func:`active_deriv`, :func:`active_ev`, :func:`ev`, :func:`deriv`,
:func:`single_ev`), collocation, interpolation, L2 projection
(:func:`load_vector`, :func:`project_L2`), :func:`prolongation` and
:func:`knot_insertion`, the pointwise tensor-product evaluation of
spline functions at unstructured points (:func:`tp_bsp_eval_pointwise`,
:func:`tp_bsp_jac_pointwise`, :func:`tp_bsp_eval_with_jac_pointwise`),
and the boundary-spec parser.  Kept as numpy
code (setup-time, tiny arrays) and held equal to the original by
``tests/test_torch_host.py``, ``tests/test_torch_hierarchical.py`` and
``tests/test_torch_bspline.py``.

Conventions: knot vectors are open (first/last knot repeated ``p+1``
times); ``active_deriv(kv, u, nd)`` returns shape ``(nd+1, p+1, npts)``
where the ``r``-th active function at ``u`` is ``findspan(u)-p+r``.
"""

import numpy as np
import scipy.interpolate
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

    def __str__(self):
        return '<KnotVector p=%d sz=%d>' % (self.p, self.kv.size)

    def __repr__(self):
        return 'KnotVector(%r, %r)' % (self.kv, self.p)

    def copy(self):
        return KnotVector(self.kv.copy(), self.p)

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
    def numknots(self):
        return self.kv.size

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

    def findspan(self, u):
        """Largest index ``i`` with ``kv[i] <= u < kv[i+1]``, clamped so
        that ``p <= i < numknots - 1 - p`` (the right end maps into the
        last span)."""
        return int(findspans(self, np.asarray([u]))[0])

    def first_active(self, k):
        """Index of the first active basis function on span ``k``."""
        return k - self.p

    def first_active_at(self, u):
        """Index of the first active basis function at parameter value
        ``u``."""
        return self.findspan(u) - self.p

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

    def meshsize_avg(self):
        """Average knot span length."""
        return abs(self.kv[-1] - self.kv[0]) / self.numspans


def numdofs(kvs):
    """Total dimension of a knot vector or a tensor-product tuple of them."""
    if isinstance(kvs, KnotVector):
        return kvs.numdofs
    return int(np.prod([kv.numdofs for kv in kvs]))


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


def active_ev(knotvec, u):
    """All active B-spline values at the points `u`; shape ``(p+1,
    len(u))`` (``(p+1,)`` for a scalar `u`)."""
    return active_deriv(knotvec, u, 0)[0]


def ev(knotvec, coeffs, u):
    """Evaluate a spline with coefficients `coeffs` at all points `u`."""
    if len(coeffs) != knotvec.numdofs:
        raise ValueError('wrong size of coefficient vector')
    return scipy.interpolate.splev(u, (knotvec.kv, coeffs, knotvec.p))


def deriv(knotvec, coeffs, deriv, u):
    """Evaluate the `deriv`-th derivative of a spline at all points
    `u`."""
    if len(coeffs) != knotvec.numdofs:
        raise ValueError('wrong size of coefficient vector')
    return scipy.interpolate.splev(u, (knotvec.kv, coeffs, knotvec.p),
                                   der=deriv)


def single_ev(knotvec, i, u):
    """Evaluate the `i`-th B-spline alone at all points `u`."""
    e = np.zeros(knotvec.numdofs)
    e[i] = 1.0
    return ev(knotvec, e, u)


def collocation_info(kv, nodes):
    """Row-wise collocation data: per node, the index of its first active
    B-spline and the ``p+1`` active basis values; shapes ``(n,)`` and
    ``(n, p+1)``."""
    nodes = np.asarray(nodes, dtype=float)
    values = active_ev(kv, nodes)                   # (p+1, n)
    indices = findspans(kv, nodes) - kv.p
    return indices, np.ascontiguousarray(values.T)


def _collocation_csr(kv, values, indices):
    """CSR matrix with rows ``values[i]`` at columns ``indices[i] + r``."""
    m, p = values.shape[0], kv.p
    I = np.repeat(np.arange(m), p + 1)
    J = (indices[:, None] + np.arange(p + 1)[None, :]).ravel()
    return scipy.sparse.coo_matrix((values.ravel(), (I, J)),
                                   shape=(m, kv.numdofs)).tocsr()


def collocation(kv, nodes):
    """Sparse collocation matrix ``C[i,j] = B_j(nodes[i])`` (CSR)."""
    nodes = np.asarray(nodes, dtype=float)
    values = active_deriv(kv, nodes, 0)[0].T               # (m, p+1)
    return _collocation_csr(kv, values, findspans(kv, nodes) - kv.p)


def collocation_derivs(kv, nodes, derivs=1):
    """List of `derivs`+1 sparse collocation matrices (values, 1st, ...,
    `derivs`-th derivatives)."""
    nodes = np.asarray(nodes, dtype=float)
    values = active_deriv(kv, nodes, derivs)         # (derivs+1, p+1, m)
    indices = findspans(kv, nodes) - kv.p
    return [_collocation_csr(kv, values[k].T, indices)
            for k in range(derivs + 1)]


def interpolate(kv, func, nodes=None):
    """Interpolate `func` in the B-spline basis at `nodes` (default: the
    Greville abscissae)."""
    nodes = kv.greville() if nodes is None else np.asarray(nodes)
    C = collocation(kv, nodes)
    return scipy.sparse.linalg.spsolve(C.tocsc(), func(nodes))


def load_vector(kv, f):
    """L2 inner products of all basis functions with the function `f`."""
    from .quadrature import make_iterated_quadrature
    nodes, weights = make_iterated_quadrature(kv.mesh, kv.p + 1)
    C = collocation(kv, nodes)
    return C.T.dot(weights * f(nodes))


def project_L2(kv, f):
    """B-spline coefficients of the L2 projection of `f`."""
    from .assemble import bsp_mass_1d
    M = bsp_mass_1d(kv)
    return scipy.sparse.linalg.spsolve(M.tocsc(), load_vector(kv, f))


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


def knot_insertion(kv, u):
    """Boehm single-knot insertion: the sparse ``(n+1, n)`` matrix mapping
    coefficients over `kv` to coefficients over ``kv.refine([u])``."""
    n, p, knots = kv.numdofs, kv.p, kv.kv
    k = kv.findspan(u)
    rows, cols, vals = [], [], []
    for i in range(n + 1):
        if i <= k - p:
            rows.append(i); cols.append(i); vals.append(1.0)
        elif i > k:
            rows.append(i); cols.append(i - 1); vals.append(1.0)
        else:
            a = (u - knots[i]) / (knots[i + p] - knots[i])
            rows += [i, i]; cols += [i - 1, i]; vals += [1.0 - a, a]
    return scipy.sparse.csr_matrix((vals, (rows, cols)), shape=(n + 1, n))


################################################################################
# Pointwise tensor-product evaluation (unstructured points)
################################################################################

def collocation_derivs_info(kv, nodes, derivs=1):
    """First active basis index per node and the active values with
    derivatives up to order `derivs`, shaped ``(derivs+1, n, p+1)``."""
    nodes = np.asarray(nodes, dtype=float)
    values = active_deriv(kv, nodes, derivs)        # (derivs+1, p+1, n)
    indices = findspans(kv, nodes) - kv.p
    return indices, np.ascontiguousarray(values.swapaxes(-2, -1))


def _tp_gather_active(kvs, coeffs, XY, derivs=1):
    """Per-axis collocation data and the gathered active coefficient
    blocks ``(n, p_0+1, ..., p_d+1) + output shape`` of the points `XY`
    (``kvs[d]`` pairs with coordinate ``XY[sdim-1-d]``, ZYX order)."""
    sdim = len(kvs)
    n = XY[0].size
    coll = [collocation_derivs_info(kvs[d], XY[sdim - 1 - d], derivs=derivs)
            for d in range(sdim)]
    block_idx = []
    for d in range(sdim):
        arange = np.arange(kvs[d].p + 1).reshape(
            [1] * (1 + d) + [-1] + [1] * (sdim - d - 1))
        block_idx.append(coll[d][0].reshape([n] + [1] * sdim) + arange)
    return coll, coeffs[tuple(block_idx)]


def _tp_contract(coll, C_active, deriv_axes):
    """Contract the gathered blocks with per-axis basis values (0) or
    first derivatives (1) as `deriv_axes` selects."""
    res = C_active
    for d in range(len(coll)):
        vecs = coll[d][1][deriv_axes[d]]            # (n, p+1)
        res = (res * vecs.reshape(vecs.shape + (1,) * (res.ndim - 2))) \
            .sum(axis=1)
    return res


def _check_points(points):
    if not all(np.shape(x) == np.shape(points[0]) for x in points):
        raise ValueError('All coordinate arrays should have the same shape')
    return tuple(np.asarray(x, dtype=float).ravel() for x in points)


def tp_bsp_eval_pointwise(kvs, coeffs, points):
    """Values of a tensor-product spline function at unstructured points;
    ``points[i]`` holds the coordinates of dimension i in XYZ order, all of
    one shape."""
    XY = _check_points(points)
    sdim = len(XY)
    coll, C_active = _tp_gather_active(kvs, coeffs, XY, derivs=0)
    vals = _tp_contract(coll, C_active, (0,) * sdim)
    return vals.reshape(np.shape(points[0]) + coeffs.shape[sdim:])


def tp_bsp_jac_pointwise(kvs, coeffs, points):
    """Jacobians of a tensor-product spline function at unstructured
    points; the last axis is the derivative direction in XYZ order."""
    return tp_bsp_eval_with_jac_pointwise(kvs, coeffs, points)[1]


def tp_bsp_eval_with_jac_pointwise(kvs, coeffs, points):
    """Values and Jacobians of a tensor-product spline function at
    unstructured points."""
    XY = _check_points(points)
    sdim = len(XY)
    coll, C_active = _tp_gather_active(kvs, coeffs, XY)
    vals = _tp_contract(coll, C_active, (0,) * sdim)
    jacs = [_tp_contract(coll, C_active,
                         tuple(int(d == i) for d in range(sdim)))
            for i in range(sdim)]
    # the x derivative (level axis sdim-1) comes first
    jac = np.stack(jacs[::-1], axis=-1)
    shape = np.shape(points[0])
    out = coeffs.shape[sdim:]
    return (vals.reshape(shape + out), jac.reshape(shape + out + (sdim,)))
