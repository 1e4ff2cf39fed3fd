# -*- coding: utf-8 -*-
"""Host helpers (numpy/scipy; copies of parts of :mod:`pyiga_tpu.utils`):
evaluation of functions over tensor grids, and the sparse Kronecker
products of the hierarchical spaces.

Grid axes are given in ZYX order (the last axis is x); plain callables
receive XYZ-ordered coordinate arrays.  Input fields of a variational
form are evaluated here once, at assembler setup.
"""

from functools import reduce

import numpy as np
import scipy.sparse


def _open_mesh(grid):
    """Open (broadcastable) coordinate arrays of a tensor grid, ij-indexed:
    axis k's array has shape (1,...,n_k,...,1)."""
    d = len(grid)
    return [np.reshape(g, (-1,) + (d - 1 - k) * (1,))
            for k, g in enumerate(grid)]


def _as_grid_array(values, grid_shape):
    """Normalize a function's return value over a tensor grid: broadcast up
    to the grid (constants / ignored arguments), stack tuple components into
    a trailing axis."""
    if isinstance(values, tuple):
        parts = [_as_grid_array(v, grid_shape) for v in values]
        return np.stack(parts, axis=-1)
    values = np.asanyarray(values)
    target = grid_shape + values.shape[len(grid_shape):]
    if values.shape != target:
        values = np.broadcast_to(values, target)
    return values


def grid_eval(f, grid):
    """Evaluate `f` over the tensor grid `grid` (axes in ZYX order; a plain
    callable receives XYZ-ordered coordinate arrays)."""
    if hasattr(f, 'grid_eval'):
        return f.grid_eval(grid)
    xyz = _open_mesh(grid)[::-1]        # grid axes are ZYX; args are XYZ
    return _as_grid_array(f(*xyz), tuple(len(g) for g in grid))


def grid_eval_transformed(f, grid, geo):
    """Evaluate `f` at the physical images of the tensor grid points under
    the geometry map `geo`."""
    pts = grid_eval(geo, grid)
    return _as_grid_array(f(*np.moveaxis(pts, -1, 0)),
                          tuple(len(g) for g in grid))


def multi_kron_sparse(As, format='csr'):
    """Sparse Kronecker product of a sequence of sparse matrices."""
    As = list(As)
    if len(As) == 1:
        return As[0].asformat(format, copy=True)
    # right-associated fold: entry products group as a*(b*(c*...)), the
    # grouping the hierarchical prolongators are validated against
    return reduce(lambda Y, X: scipy.sparse.kron(X, Y, format=format),
                  reversed(As))


def _rowwise_kron(X, Y):
    """Sparse face-splitting (row-wise Kronecker) product: both operands
    have the same row count `m`; the result is ``(m, X.cols * Y.cols)``
    with row i equal to ``kron(X[i], Y[i])``."""
    X, Y = X.tocsr(), Y.tocsr()
    m = X.shape[0]
    nnx, nny = np.diff(X.indptr), np.diff(Y.indptr)
    counts = nnx * nny
    indptr = np.concatenate([[0], np.cumsum(counts)])
    indices = np.empty(indptr[-1], dtype=np.intp)
    data = np.empty(indptr[-1])
    w = Y.shape[1]
    for i in range(m):
        xs, xe = X.indptr[i], X.indptr[i + 1]
        ys, ye = Y.indptr[i], Y.indptr[i + 1]
        block = (X.indices[xs:xe, None] * w + Y.indices[None, ys:ye]).ravel()
        vals = (X.data[xs:xe, None] * Y.data[None, ys:ye]).ravel()
        indices[indptr[i]:indptr[i + 1]] = block
        data[indptr[i]:indptr[i + 1]] = vals
    return scipy.sparse.csr_matrix((data, indices, indptr),
                                   shape=(m, X.shape[1] * w))


def kron_partial(As, rows, restrict=False, format='csr'):
    """Assemble only the given `rows` of ``kron(As[0], ..., As[-1])``.

    Row ``i`` of the Kronecker product is the Kronecker product of the
    per-axis rows of `i`'s unraveled multi-index, so the requested block
    is the row-wise (face-splitting) product of per-axis row slices.
    With ``restrict=True`` the result has ``len(rows)`` rows; otherwise
    full height with the other rows zero."""
    As = [scipy.sparse.csr_matrix(A) for A in As]
    heights = tuple(A.shape[0] for A in As)
    full_shape = (int(np.prod(heights)),
                  int(np.prod([A.shape[1] for A in As])))
    rows = np.asarray(rows, dtype=np.intp)
    if rows.size == 0:
        shape = (0, full_shape[1]) if restrict else full_shape
        return scipy.sparse.csr_matrix(shape).asformat(format)

    multi = np.unravel_index(rows, heights)
    # right-associated like multi_kron_sparse, so both prolongator paths
    # produce bit-identical entries
    block = reduce(lambda Y, X: _rowwise_kron(X, Y),
                   reversed([A[mi] for A, mi in zip(As, multi)]))
    if restrict:
        return block.asformat(format)
    coo = block.tocoo()
    return scipy.sparse.coo_matrix(
        (coo.data, (rows[coo.row], coo.col)),
        shape=full_shape).asformat(format)
