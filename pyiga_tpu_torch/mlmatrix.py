# -*- coding: utf-8 -*-
"""Multilevel (Kronecker) sparsity structures and compact matrices (host,
numpy).

The parts of :mod:`pyiga_tpu.mlmatrix` the assembly needs: per axis, the
nonzero basis pairs ``bidx`` of the 1D pattern, the transpose index map,
:class:`MLStructure` over a tensor-product space (joined with a dense
component level for the packed layout of vector forms), and
:class:`MLMatrix`,
the compact data tensor over a structure with its scipy expansion.  The
device matvec on the same data is
:func:`pyiga_tpu_torch.ops.mlmatvec.ml_matvec`.
"""

import numpy as np
import scipy.sparse
import scipy.sparse.linalg


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

    def make_mlmatrix(self, data=None, matrix=None):
        """An :class:`MLMatrix` over this structure (arguments as there)."""
        return MLMatrix(self, data=data, matrix=matrix)

    def nonzero(self, lower_tri=False):
        """(rows, cols) arrays of all nonzeros, in C order of the data
        tensor (only ``row >= col`` with `lower_tri`)."""
        return ml_nonzero(self.bidx, self.bs, lower_tri=lower_tri)


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
        self.data = None if data is None else np.ascontiguousarray(data)
        if self.data is not None and self.data.shape != self.datashape:
            raise ValueError('data has shape %s, expected %s'
                             % (self.data.shape, self.datashape))
        self._csr_cache = None
        super().__init__(shape=structure.shape,
                         dtype=np.float64 if data is None else self.data.dtype)

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
