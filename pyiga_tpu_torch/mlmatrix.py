# -*- coding: utf-8 -*-
"""Multilevel (Kronecker) sparsity structures and compact matrices (host,
numpy).

A copy of :mod:`pyiga_tpu.mlmatrix`: per axis, the nonzero basis pairs
``bidx`` of the 1D pattern (spline or banded), the transpose index map,
:class:`MLStructure` over a tensor-product space (joined with a dense
component level for the packed layout of vector forms; reordered,
sliced, transposed, queried by rows or columns), :class:`MLMatrix`, the
compact data tensor over a structure with its scipy expansion, and the
Van Loan-Pitsianis reindexing with the compact entry generators of the
low-rank assembly.  The
device matvec on the same data is
:func:`pyiga_tpu_torch.ops.mlmatvec.ml_matvec`.
"""

import numpy as np
import scipy.sparse
import scipy.sparse.linalg


def compute_banded_sparsity(n, bw):
    """Raveled indices of the nonzeros of an ``n x n`` banded matrix with
    bandwidth `bw` (row-major order)."""
    IJ = compute_banded_sparsity_ij(n, bw)
    return (IJ[:, 0].astype(np.int64) * n + IJ[:, 1]).astype(np.int64)


def compute_banded_sparsity_ij(n, bw):
    """``N x 2`` array of the (i, j) nonzero positions of an ``n x n``
    banded matrix with bandwidth `bw`, ordered row-major."""
    i = np.arange(n)
    lo = np.maximum(0, i - bw)
    hi = np.minimum(n, i + bw + 1)
    I = np.repeat(i, hi - lo)
    J = np.concatenate([np.arange(l, h) for l, h in zip(lo, hi)]) \
        if n > 0 else np.empty(0, dtype=np.int64)
    return np.column_stack((I, J)).astype(np.uint32)


def compute_sparsity_ij(kv1, kv2):
    """``N x 2`` array of pairs (i, j) such that B-spline `i` of `kv2` (rows)
    and B-spline `j` of `kv1` (columns) have overlapping support — the 1D
    stiffness sparsity pattern.  Ordered row-major."""
    ms1 = kv1.mesh_support_idx_all()    # columns
    ms2 = kv2.mesh_support_idx_all()    # rows
    n2 = ms2.shape[0]
    # for row i: columns j with ms1[j,1] > ms2[i,0] and ms1[j,0] < ms2[i,1]
    j_start = np.searchsorted(ms1[:, 1], ms2[:, 0], side='right')
    j_end = np.searchsorted(ms1[:, 0], ms2[:, 1], side='left')
    j_end = np.maximum(j_end, j_start)
    counts = j_end - j_start
    I = np.repeat(np.arange(n2), counts)
    J = np.concatenate([np.arange(a, b) for a, b in zip(j_start, j_end)]) \
        if n2 > 0 else np.empty(0, dtype=np.int64)
    return np.column_stack((I, J)).astype(np.uint32)


def compute_dense_ij(m, n):
    """All (i, j) indices of a dense ``m x n`` matrix, row-major."""
    I, J = np.divmod(np.arange(m * n), n)
    return np.column_stack((I, J)).astype(np.uint32)


def transpose_idx_for_bidx(bidx):
    """For each entry s of `bidx` (pairs over a square block), the index of
    the transposed pair (j, i) in `bidx`."""
    n = int(bidx.max()) + 1 if len(bidx) else 0
    keys = bidx[:, 0].astype(np.int64) * n + bidx[:, 1]
    tkeys = bidx[:, 1].astype(np.int64) * n + bidx[:, 0]
    order = np.argsort(keys)
    pos = np.searchsorted(keys[order], tkeys)
    idx = order[pos]
    if not np.array_equal(keys[idx], tkeys):
        raise ValueError('bidx is not structurally symmetric')
    return idx


# the reference's name
get_transpose_idx_for_bidx = transpose_idx_for_bidx


def ml_nonzero(bidx, block_sizes, lower_tri=False):
    """Global (row, col) indices of all nonzeros of a multilevel matrix,
    in C order of the compact data tensor.

    Args:
        bidx: per-level ``nnz_k x 2`` index arrays.
        block_sizes: per-level (rows, cols) block sizes.
        lower_tri: only return entries with ``row >= col``.
    """
    I = J = np.zeros((), dtype=np.int64)
    for bx, (m, n) in zip(bidx, block_sizes):
        I = I[..., np.newaxis] * m + bx[:, 0].astype(np.int64)
        J = J[..., np.newaxis] * n + bx[:, 1].astype(np.int64)
    I, J = I.ravel(), J.ravel()
    if lower_tri:
        mask = I >= J
        return I[mask], J[mask]
    return I, J


class MLStructure:
    """Sparsity structure of an L-level block-structured matrix (the
    sparsity of a Kronecker product of L sparse patterns).

    Args:
        bs: per-level block sizes ``((m_1, n_1), ..., (m_L, n_L))``.
        bidx: per-level ``nnz_k x 2`` arrays of nonzero (i, j) positions.
    """

    def __init__(self, bs, bidx):
        self.bs = tuple(tuple(b) for b in bs)
        self.bidx = tuple(bidx)
        if len(self.bs) != len(self.bidx):
            raise ValueError('bs and bidx differ in length')
        self.L = len(self.bs)
        self.shape = (int(np.prod([b[0] for b in self.bs])),
                      int(np.prod([b[1] for b in self.bs])))

    @staticmethod
    def multi_banded(bs, bw):
        """Square multi-level banded structure with sizes `bs` and
        bandwidths `bw`."""
        return MLStructure(
            tuple((n, n) for n in bs),
            tuple(compute_banded_sparsity_ij(n, p) for n, p in zip(bs, bw)))

    @staticmethod
    def from_matrix(A):
        """One-level structure with the sparsity pattern of `A`, in the
        matrix's ``nonzero()`` order (row-major for CSR)."""
        I, J = A.nonzero()
        return MLStructure((tuple(A.shape),),
                           (np.column_stack((I, J)).astype(np.uint32),))

    @staticmethod
    def from_kronecker(As):
        """Structure of the Kronecker product of the matrices `As`."""
        S = MLStructure.from_matrix(As[0])
        for A in As[1:]:
            S = S.join(MLStructure.from_matrix(A))
        return S

    @staticmethod
    def from_kvs(kvs0, kvs1):
        """Structure of a matrix over trial space `kvs0` / test space `kvs1`
        (rows = test functions)."""
        bs = tuple((kv1.numdofs, kv0.numdofs) for kv0, kv1 in zip(kvs0, kvs1))
        bidx = tuple(compute_sparsity_ij(kv0, kv1)
                     for kv0, kv1 in zip(kvs0, kvs1))
        return MLStructure(bs, bidx)

    @staticmethod
    def dense(shape):
        """One-level dense structure (``pyiga_tpu/mlmatrix.py:152``)."""
        return MLStructure((tuple(shape),), (compute_dense_ij(*shape),))

    def join(self, other):
        """Concatenate the levels of two structures
        (``pyiga_tpu/mlmatrix.py:184``)."""
        return MLStructure(self.bs + other.bs, self.bidx + other.bidx)

    def reorder(self, axes):
        """Permute the levels according to `axes`."""
        if len(axes) != self.L:
            raise ValueError('need one axis per level')
        return MLStructure(tuple(self.bs[j] for j in axes),
                           tuple(self.bidx[j] for j in axes))

    def slice(self, start, end=None):
        """Sub-structure of one or several consecutive levels."""
        if not 0 <= start < self.L:
            raise ValueError('invalid slice index')
        if end is None:
            end = start + 1
        return MLStructure(self.bs[start:end], self.bidx[start:end])

    def transpose(self):
        """Structure of the transposed matrix (bidx keeps its order)."""
        bs = tuple((b[1], b[0]) for b in self.bs)
        bidx = tuple(np.ascontiguousarray(bx[:, ::-1]) for bx in self.bidx)
        return MLStructure(bs, bidx)

    def make_mlmatrix(self, data=None, matrix=None):
        """An :class:`MLMatrix` over this structure (arguments as there)."""
        return MLMatrix(self, data=data, matrix=matrix)

    def nonzero(self, lower_tri=False):
        """(rows, cols) arrays of all nonzeros, in C order of the data
        tensor (only ``row >= col`` with `lower_tri`)."""
        return ml_nonzero(self.bidx, self.bs, lower_tri=lower_tri)

    def _level_rowwise_interactions(self, k):
        """Per row index of level `k`, the interacting column indices."""
        result = [[] for _ in range(self.bs[k][0])]
        for i, j in self.bidx[k]:
            result[i].append(j)
        return [np.array(r, dtype=np.int64) for r in result]

    def nonzeros_for_rows(self, row_indices, renumber_rows=False):
        """(I, J) arrays of the nonzeros in the given global rows; with
        ``renumber_rows=True`` also each entry's row position within
        `row_indices`."""
        row_indices = np.asarray(row_indices, dtype=np.int64)
        if len(row_indices) == 0:
            empty = np.empty(0, dtype=np.int64)
            return (empty, empty, empty) if renumber_rows else (empty, empty)
        L = self.L
        lvia = [self._level_rowwise_interactions(k) for k in range(L)]
        bs_I = tuple(self.bs[k][0] for k in range(L))
        bs_J = np.array([self.bs[k][1] for k in range(L)], dtype=np.int64)
        ix = np.column_stack(np.unravel_index(row_indices, bs_I))
        # per row: the raveled product of the per-level column sets
        Js, counts = [], []
        for r in range(len(row_indices)):
            J = lvia[0][ix[r, 0]]
            for k in range(1, L):
                J = (J[:, None] * bs_J[k]
                     + lvia[k][ix[r, k]][None, :]).ravel()
            Js.append(J)
            counts.append(len(J))
        counts = np.array(counts)
        Is = np.repeat(row_indices, counts)
        Js = np.concatenate(Js)
        if renumber_rows:
            return Is, Js, np.repeat(np.arange(len(row_indices)), counts)
        return Is, Js

    def nonzeros_for_columns(self, col_indices):
        """(I, J) arrays of the nonzeros in the given global columns."""
        J, I = self.transpose().nonzeros_for_rows(col_indices)
        return I, J

    def sequential_bidx(self):
        """Per-level raveled nonzero indices ``i * cols + j``."""
        return [self.bs[j][1] * self.bidx[j][:, 0].astype(np.int64)
                + self.bidx[j][:, 1] for j in range(self.L)]


class MLMatrix(scipy.sparse.linalg.LinearOperator):
    """Compact multilevel matrix: an L-way dense data tensor (numpy) over
    an :class:`MLStructure`, acting as a scipy LinearOperator on the
    host.  The data is given as the compact tensor `data`, or taken from
    the structure's nonzeros of a dense or sparse `matrix`; with neither,
    the matrix has no data (``data is None``)."""

    def __init__(self, structure, data=None, matrix=None):
        self.structure = structure
        self.datashape = tuple(len(bi) for bi in structure.bidx)
        if data is not None and matrix is not None:
            raise ValueError('give only one of data and matrix')
        if matrix is not None:
            if matrix.shape != structure.shape:
                raise ValueError('matrix has shape %s, expected %s'
                                 % (matrix.shape, structure.shape))
            data = np.asarray(matrix[self.nonzero()]).reshape(self.datashape)
        self._data = None
        self._csr_cache = None
        super().__init__(shape=structure.shape, dtype=np.float64)
        if data is not None:
            self.data = data

    @property
    def nnz(self):
        return int(np.prod(self.datashape))

    @property
    def data(self):
        return self._data

    @data.setter
    def data(self, X):
        if X.shape != self.datashape:
            raise ValueError('data has shape %s, expected %s'
                             % (X.shape, self.datashape))
        self._data = np.ascontiguousarray(X)
        self._csr_cache = None
        self.dtype = self._data.dtype

    def asmatrix(self, format='csr'):
        """Expand to a scipy sparse matrix."""
        if self.data is None:
            raise ValueError('matrix has no data')
        A = scipy.sparse.csr_matrix((self.data.ravel(), self.nonzero()),
                                    shape=self.shape)
        return A.asformat(format)

    def _matvec(self, x):
        if self._csr_cache is None:
            self._csr_cache = self.asmatrix('csr')
        return self._csr_cache.dot(x)

    def nonzero(self, lower_tri=False):
        return self.structure.nonzero(lower_tri=lower_tri)

    def reorder(self, axes):
        """Permute the levels of the matrix according to `axes`."""
        if len(axes) != self.structure.L:
            raise ValueError('need one axis per level')
        newdata = None if self.data is None else np.transpose(self.data, axes)
        return MLMatrix(self.structure.reorder(axes), data=newdata)


################################################################################
# Reordering / reindexing (Van Loan-Pitsianis) and the compact generators
################################################################################

def reorder(X, m1, n1):
    """Reorder a dense matrix of ``m1 x n1`` blocks of size ``m2 x n2`` so
    that each block becomes one row of the output ([Van Loan, Pitsianis
    1993])."""
    M, N = X.shape
    m2, n2 = M // m1, N // n1
    if M != m1 * m2 or N != n1 * n2:
        raise ValueError('invalid block size')
    return (X.reshape(m1, m2, n1, n2)
             .transpose(0, 2, 1, 3)
             .reshape(m1 * n1, m2 * n2))


def reindex_from_reordered(i, j, m1, n1, m2, n2):
    """Map an index (i, j) of ``reorder(X, m1, n1)`` back to one of X."""
    bi0, bi1 = divmod(i, n1)
    ii0, ii1 = divmod(j, n2)
    return (bi0 * m2 + ii0, bi1 * n2 + ii1)


def from_seq(i, dims):
    """Lexicographic index -> multi-index (list)."""
    L = len(dims)
    I = L * [0]
    for k in reversed(range(L)):
        i, I[k] = divmod(i, dims[k])
    return I


def to_seq(I, dims):
    """Multi-index -> lexicographic index."""
    i = 0
    for k in range(len(dims)):
        i = i * dims[k] + I[k]
    return i


def reindex_to_multilevel(i, j, bs):
    """Global (i, j) -> per-level raveled pair indices."""
    bs = np.asarray(bs)
    I, J = from_seq(i, bs[:, 0]), from_seq(j, bs[:, 1])
    return tuple(to_seq((I[k], J[k]), bs[k, :]) for k in range(bs.shape[0]))


def reindex_from_multilevel(M, bs):
    """Per-level raveled pair indices -> global (i, j)."""
    bs = np.asarray(bs)
    IJ = np.stack([from_seq(M[k], bs[k, :]) for k in range(len(M))], axis=0)
    return tuple(to_seq(IJ[:, m], bs[:, m]) for m in range(2))


def ReorderedMatrixGenerator(multiasm, structure):
    """2D compact-matrix generator backed by a multi-entry assembler
    callback."""
    from . import lowrank
    if structure.L != 2:
        raise ValueError('need a two-level structure')
    n1, m1 = structure.bs[0]
    n2, m2 = structure.bs[1]
    sparsidx = structure.sequential_bidx()

    def multientryfunc(indices):
        return multiasm(
            [reindex_from_reordered(sparsidx[0][i], sparsidx[1][j],
                                    n1, m1, n2, m2)
             for (i, j) in indices])

    shp = tuple(len(si) for si in sparsidx)
    return lowrank.MatrixGenerator(shp[0], shp[1],
                                   multientryfunc=multientryfunc)


def ReorderedTensorGenerator(multiasm, structure):
    """L-dimensional compact-tensor generator backed by a multi-entry
    assembler callback."""
    from . import lowrank
    L = structure.L
    bs = np.array(structure.bs)
    sparsidx = structure.sequential_bidx()

    def multientryfunc(indices):
        return multiasm([reindex_from_multilevel(
            [sparsidx[k][idx[k]] for k in range(L)], bs)
            for idx in indices])

    shp = tuple(len(si) for si in sparsidx)
    return lowrank.TensorGenerator(shp, multientryfunc=multientryfunc)
