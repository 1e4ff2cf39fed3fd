# -*- coding: utf-8 -*-
"""Host helpers (numpy/scipy; copies of :mod:`pyiga_tpu.utils`):
evaluation of functions over tensor grids (also lazily, tile by tile:
:class:`LazyArray`, :class:`LazyCachingArray`), the sparse Kronecker
products of the hierarchical spaces, the Cartesian product of index
arrays (the low-rank generators' entry lists), the golden-fixture
reader :func:`read_sparse_matrix`, CSR row views, :class:`BijectiveIndex`
and the progress bar of the time integrators (tqdm when installed, else
a silent stand-in).

Grid axes are given in ZYX order (the last axis is x); plain callables
receive XYZ-ordered coordinate arrays.  Input fields of a variational
form are evaluated here once, at assembler setup.
"""

import itertools
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


def cartesian_product(arrays):
    """All combinations of entries of the 1D `arrays`, as an ``(N, L)``
    array with the last input axis varying fastest."""
    grids = np.meshgrid(*arrays, indexing='ij')
    return np.stack([g.ravel() for g in grids], axis=-1)


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


def read_sparse_matrix(fname):
    """Load a 1-based ``i j value`` triplet text file (the golden-fixture
    format, e.g. ``tests/fixtures/*.mtx.gz``) as a CSR matrix."""
    data = np.loadtxt(fname, skiprows=1, ndmin=2)
    ij = data[:, :2].astype(np.intp) - 1
    return scipy.sparse.coo_matrix((data[:, 2], (ij[:, 0], ij[:, 1]))).tocsr()


class _CSRRowsView:
    """Matrix-like view of a subset of the rows of a CSR matrix: the
    submatrix is extracted once, products delegate to scipy."""

    def __init__(self, A, sub):
        if not scipy.sparse.issparse(A):
            raise TypeError('expected a sparse matrix')
        self._sub = sub.tocsr()
        self.shape = self._sub.shape
        self.dtype = self._sub.dtype

    def dot(self, other):
        return self._sub.dot(other)

    __mul__ = dot
    __matmul__ = dot


class CSRRowSlice(_CSRRowsView):
    """Contiguous row block ``A[lo:hi]`` of a CSR matrix."""

    def __init__(self, A, row_bounds):
        lo, hi = row_bounds
        if not (0 <= lo <= hi <= A.shape[0]):
            raise ValueError('invalid row bounds')
        super().__init__(A, A[lo:hi])
        self.bounds = (lo, hi)


class CSRRowSubset(_CSRRowsView):
    """Arbitrary row subset ``A[rows]`` of a CSR matrix."""

    def __init__(self, A, rows):
        rows = np.asarray(rows, dtype=np.int64)
        super().__init__(A, A[rows])
        self.rows = rows


class LazyArray:
    """Array-like object evaluating a function over sub-rectangles of a
    tensor grid on demand (``LA[I0, I1, ...]`` with per-axis indices);
    `mode` ``'eval'`` gives values, ``'jac'`` Jacobians."""

    def __init__(self, f, grid, mode='eval'):
        self.f = f
        self.grid = tuple(grid)
        self.mode = mode

    def _eval(self, subgrid):
        if self.mode == 'jac':
            return self.f.grid_jacobian(subgrid)
        if self.mode != 'eval':
            raise ValueError('invalid mode: %s' % (self.mode,))
        return grid_eval(self.f, subgrid)

    def __getitem__(self, I):
        if len(I) != len(self.grid):
            raise IndexError('Wrong number of indices')
        return self._eval(tuple(g[sel] for g, sel in zip(self.grid, I)))


class LazyCachingArray(LazyArray):
    """A :class:`LazyArray` that memoizes whole tiles of `tilesize`
    points per axis; correct only when the output is requested in full
    consecutive tiles (slices aligned to the tiles)."""

    def __init__(self, f, outshape, grid, tilesize, mode='eval'):
        super().__init__(f, grid, mode)
        self.outshape = tuple(outshape)
        self.ts = int(tilesize)
        self.tiles = {}

    def get_tile(self, tile_idx):
        """Dense values over one tile (cached)."""
        try:
            return self.tiles[tile_idx]
        except KeyError:
            ts = self.ts
            sub = tuple(g[t * ts:(t + 1) * ts]
                        for g, t in zip(self.grid, tile_idx))
            vals = self._eval(sub)
            self.tiles[tile_idx] = vals
            return vals

    def __getitem__(self, I):
        if len(I) != len(self.grid):
            raise IndexError('Wrong number of indices')
        ts = self.ts
        starts = [sel.start for sel in I]
        stops = [sel.stop for sel in I]
        t_lo = [s // ts for s in starts]
        t_hi = [(e - 1) // ts + 1 for e in stops]
        out = np.empty(tuple(e - s for s, e in zip(starts, stops))
                       + self.outshape)
        for T in itertools.product(*(range(lo, hi)
                                     for lo, hi in zip(t_lo, t_hi))):
            window = tuple(slice((t - lo) * ts, (t - lo + 1) * ts)
                           for t, lo in zip(T, t_lo))
            out[window] = self.get_tile(T)
        return out


class BijectiveIndex:
    """Bidirectional map between a sequence of (hashable) values and
    their positions."""

    def __init__(self, values):
        self.values = values
        self._pos = dict(map(reversed, enumerate(values)))

    def __len__(self):
        return len(self.values)

    def __getitem__(self, i):
        return self.values[i]

    def index(self, v):
        return self._pos[v]


class _SilentPbar:
    """Interface-compatible no-op replacement for a tqdm progress bar."""

    def __init__(self, iterable=None, **kwargs):
        self._iterable = iterable

    def __iter__(self):
        return iter(() if self._iterable is None else self._iterable)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __getattr__(self, name):        # update/close/set_postfix/...
        return lambda *a, **k: None


def progress_bar(enable=True):
    """The tqdm class when installed and enabled, else a no-op stand-in."""
    if not enable:
        return _SilentPbar
    try:
        import tqdm
    except ImportError:
        return _SilentPbar
    import warnings
    warnings.simplefilter('ignore', tqdm.TqdmWarning)
    return tqdm.tqdm
