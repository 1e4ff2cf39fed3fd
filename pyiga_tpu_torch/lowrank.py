# -*- coding: utf-8 -*-
"""Low-rank (ACA) assembly (port of :mod:`pyiga_tpu.lowrank`).

The reordered compact matrix of an IgA operator has low rank for smooth
geometries, so adaptive cross approximation needs only O(rank * n)
entry evaluations.  Every row, column or slice request is served by one
evaluation of the whole fiber or slice of the compact tensor
(:meth:`~pyiga_tpu_torch.compile.VFormAssembler.compact_slice`, f64
tensordot chains over coefficient fields kept on the device).

:func:`aca`, :func:`aca_lr` and :func:`aca_3d` are host copies of the
JAX package's drivers (numpy; the generators' slices come back to the
host).  :func:`aca_3d_device` keeps the crosses on the assembler's
device: each pivot evaluates the residual fiber and slice, takes the
argmaxes and appends the cross there, and the host reads four numbers a
pivot (the verdict).  The JAX version's devices for a remote TPU (two
speculative pivots a dispatch, a whole-loop program, chunked cross sums
and pulls) are not ported: the pivot sequence and the accept, skip and
stop rules are, with one change.  A symmetric form's compact tensor has
exactly equal mirrored entries, and a strict argmax lets rounding pick
among them, so the pivot count follows the device and the summation
order (3D p=3 n=48: 29 pivots in the JAX package on the CPU, 32 in the
port on the CPU and 33 on the card under the strict rule).
:func:`aca_3d_device` takes the lowest index among the entries within
``TIE_TOL`` times the tensor's scale of the largest.  The skip draws
come from ``np.random``.
"""

import numpy as np
import torch

from . import native, tensor, utils


################################################################################
# Entrywise/slicewise tensor generators
################################################################################

class TensorGenerator:
    """A tensor defined by an entry function and (optionally) a fast
    slice function.

    Args:
        shape: tensor shape.
        entryfunc: maps one multi-index to the entry value.
        multientryfunc: maps a sequence of multi-indices to a value array.
        slicefunc: maps a dict ``axis -> index`` (the pinned axes) to the
            dense array over the remaining axes (fast path for ACA).
    """

    def __init__(self, shape, entryfunc=None, multientryfunc=None,
                 slicefunc=None):
        self.shape = tuple(shape)
        self.ndim = len(self.shape)
        assert entryfunc is not None or multientryfunc is not None \
            or slicefunc is not None, 'need an entry or slice function'
        if entryfunc is not None:
            self.entry = entryfunc
        if multientryfunc is not None:
            self.compute_entries = multientryfunc
        self.slicefunc = slicefunc

    @staticmethod
    def from_array(X):
        # np.array copy: basic indexing would return live views of X, and
        # ACA drivers mutate the slices they receive (pivot zeroing)
        return TensorGenerator(
            X.shape, lambda I: X[tuple(I)],
            slicefunc=lambda fixed: np.array(X[tuple(
                fixed.get(k, slice(None)) for k in range(X.ndim))]))

    def entry(self, I):
        if self.slicefunc is not None:
            return self.slicefunc(dict(enumerate(I)))
        return self.compute_entries([I])[0]

    def compute_entries(self, indices):
        indices = list(indices)
        out = np.empty(len(indices))
        for i, I in enumerate(indices):
            out[i] = self.entry(tuple(I))
        return out

    def __getitem__(self, I):
        I, shp, singl = tensor._normalize_indices(I, self.shape)
        # fast path: every axis is either pinned or taken in full
        if self.slicefunc is not None:
            fixed = {}
            full = True
            for k, ik in enumerate(I):
                if len(ik) == 1:
                    fixed[k] = ik.start if isinstance(ik, range) else int(ik[0])
                elif isinstance(ik, range) and ik == range(self.shape[k]):
                    pass
                else:
                    full = False
                    break
            if full:
                X = np.asarray(self.slicefunc(fixed))
                # re-insert pinned axes, reshape to shp, squeeze scalars
                return X.reshape(shp).squeeze(axis=singl) if singl else \
                    X.reshape(shp)
        arange = [np.arange(ik.start, ik.stop, ik.step)
                  if isinstance(ik, range) else ik for ik in I]
        indices = utils.cartesian_product(arange)
        X = self.compute_entries(indices).reshape(shp)
        return np.squeeze(X, axis=singl)

    def matrix_at(self, I, axes):
        """Generator for the 2D slice through index `I` along `axes`."""
        assert len(axes) == 2 and len(I) == len(self.shape)
        I = list(I)

        def multientryfunc(indices):
            indices = list(indices)
            for k in range(len(indices)):
                I[axes[0]], I[axes[1]] = indices[k]
                indices[k] = tuple(I)
            return self.compute_entries(indices)

        slicefunc = None
        if self.slicefunc is not None:
            def slicefunc(fixed):
                outer_fixed = {k: I[k] for k in range(self.ndim)
                               if k not in axes}
                outer_fixed.update({axes[j]: v for j, v in fixed.items()})
                return self.slicefunc(outer_fixed)

        return TensorGenerator((self.shape[axes[0]], self.shape[axes[1]]),
                               multientryfunc=multientryfunc,
                               slicefunc=slicefunc)

    def asarray(self):
        if self.slicefunc is not None:
            return np.asarray(self.slicefunc({}))
        I = utils.cartesian_product(tuple(np.arange(n) for n in self.shape))
        return self.compute_entries(I).reshape(self.shape, order='C')


class MatrixGenerator(TensorGenerator):
    """2D special case of :class:`TensorGenerator`."""

    def __init__(self, m, n, entryfunc=None, multientryfunc=None,
                 slicefunc=None):
        super().__init__((m, n), entryfunc=entryfunc,
                         multientryfunc=multientryfunc, slicefunc=slicefunc)

    @staticmethod
    def from_array(X):
        assert X.ndim == 2
        return MatrixGenerator(
            X.shape[0], X.shape[1], lambda I: X[tuple(I)],
            slicefunc=lambda fixed: X[fixed.get(0, slice(None)),
                                      fixed.get(1, slice(None))])

    def row(self, i):
        return self[i, :]

    def column(self, j):
        return self[:, j]


def rank_1_update(X, alpha, u, v):
    """In-place ``X += alpha * outer(u, v)`` (native kernel)."""
    return native.rank_1_update(X, alpha, u, v)


def aca3d_update(X, alpha, col, mat):
    """In-place ``X += alpha * col (x) mat`` for a 3D tensor."""
    X += alpha * col[:, None, None] * mat[None, :, :]
    return X


################################################################################
# Adaptive cross approximation
################################################################################


class _PivotControl:
    """Shared pivot bookkeeping of the ACA drivers: counts consecutive
    below-tolerance pivots and zero-pivot skips, enforces the iteration
    cap, and emits the verbose log of the JAX package's drivers (the
    stopping rules of pyiga's C++ ACA core)."""

    def __init__(self, tol, maxiter, skipcount, tolcount, verbose,
                 what='it.'):
        self.tol, self.maxiter = tol, maxiter
        self.max_skips, self.max_hits = skipcount, tolcount
        self.verbose, self.what = verbose, what
        self.it = self.skips = self.hits = 0

    def classify(self, e, where):
        """Classify a pivot magnitude: 'skip' (degenerate pivot — repivot,
        then ask :meth:`skipped_out`), 'stop', or 'take'."""
        if e < 1e-15:
            if self.verbose >= 2:
                print('skipping', where)
            return 'skip'
        if e < self.tol:
            self.hits += 1
            if self.hits >= self.max_hits:
                if self.verbose >= 1:
                    print('desired tolerance reached', self.hits,
                          'times; stopping (%d %s)' % (self.it, self.what))
                return 'stop'
        else:
            self.skips = self.hits = 0
        return 'take'

    def skipped_out(self):
        """Count one skip; True when the skip budget is exhausted."""
        self.skips += 1
        if self.skips >= self.max_skips:
            if self.verbose >= 1:
                print('maximum skip count reached; stopping (%d %s)'
                      % (self.it, self.what))
            return True
        return False

    def advance(self):
        """Count one accepted cross; True while under the iteration cap."""
        self.it += 1
        if self.it >= self.maxiter:
            if self.verbose >= 1:
                print('Maximum iteration count reached; aborting (%d %s)'
                      % (self.it, self.what))
            return False
        return True


def aca(A, tol=1e-10, maxiter=100, skipcount=3, tolcount=3, verbose=2,
        startval=None):
    """Row-pivoted adaptive cross approximation of a matrix (generator);
    returns the dense approximation.  Stopping: `tolcount` hits below `tol`
    or `skipcount` zero-pivot rows."""
    if not isinstance(A, TensorGenerator):
        A = MatrixGenerator.from_array(np.asarray(A))
    assert A.ndim == 2
    X = (np.array(startval, order='C') if startval is not None
         else np.zeros(A.shape, order='C'))
    assert X.shape == A.shape

    ctl = _PivotControl(tol, maxiter, skipcount, tolcount, verbose)
    i = A.shape[0] // 2
    while True:
        E_row = X[i, :] - A[i, :]
        j0 = abs(E_row).argmax()
        verdict = ctl.classify(abs(E_row[j0]), i)
        if verdict == 'stop':
            break
        if verdict == 'skip':
            i = np.random.randint(A.shape[0])
            if ctl.skipped_out():
                break
            continue
        if verbose >= 2:
            print(i, '\t', j0, '\t', abs(E_row[j0]))

        col = A[:, j0] - X[:, j0]
        rank_1_update(X, 1.0 / E_row[j0], col, E_row)

        col[i] = 0
        i = abs(col).argmax()
        if not ctl.advance():
            break
    return X


def aca_lr(A, tol=1e-10, maxiter=100, verbose=2):
    """ACA returning the rank-1 crosses ``(col, row)`` instead of the full
    matrix."""
    if not isinstance(A, TensorGenerator):
        A = MatrixGenerator.from_array(np.asarray(A))
    assert A.ndim == 2
    crosses = []

    def X_row(i):
        return sum((c[i] * r for c, r in crosses), np.zeros(A.shape[1]))

    def X_col(j):
        return sum((c * r[j] for c, r in crosses), np.zeros(A.shape[0]))

    ctl = _PivotControl(tol, maxiter, 3, 3, verbose)
    i = A.shape[0] // 2
    while True:
        err_i = X_row(i) - A[i, :]
        j0 = abs(err_i).argmax()
        verdict = ctl.classify(abs(err_i[j0]), i)
        if verdict == 'stop':
            break
        if verdict == 'skip':
            i = np.random.randint(A.shape[0])
            if ctl.skipped_out():
                break
            continue
        if verbose >= 2:
            print(i, '\t', j0, '\t', abs(err_i[j0]))
        c = (A[:, j0] - X_col(j0)) / err_i[j0]
        crosses.append((c, err_i))
        i = abs(c).argmax()
        if not ctl.advance():
            break
    return crosses


def aca_3d(A, tol=1e-10, maxiter=100, skipcount=3, tolcount=3, verbose=2,
           lr=False, slices='auto'):
    """Nested 3D ACA: outer pivoting over fibers, each pivot slice either
    evaluated exactly in one slice call or approximated by an inner 2D ACA
    warm-started from the current approximation.

    ``slices='materialize'`` fetches each outer pivot slice with a single
    ``slicefunc`` call instead of running the inner 2D ACA: for the
    compact generator a whole 2D slice costs one contraction chain,
    barely more than the single column the inner ACA would fetch per
    iteration.  'auto' materializes whenever the generator has a slice
    function; 'aca' forces the inner 2D ACA."""
    if not isinstance(A, TensorGenerator):
        A = TensorGenerator.from_array(np.asarray(A))
    assert A.ndim == 3
    assert slices in ('auto', 'materialize', 'aca')
    if slices == 'auto':
        slices = 'materialize' if A.slicefunc is not None else 'aca'

    # The approximation is held as crosses (cols[r], mats[r]) with
    # X = sum_r cols[r] (x) mats[r]; residual fibers/slices are evaluated
    # from the crosses in O(R n) / O(R n^2), so the dense n^3 tensor is
    # touched only once, at the final inflation (in 'aca' mode the inner
    # 2D ACA needs the running slice anyway, so there the classic dense
    # accumulation costs nothing extra).
    cols, mats = [], []

    def X_fiber(i1, i2):
        out = np.zeros(A.shape[0])
        for c, M in zip(cols, mats):
            out += M[i1, i2] * c
        return out

    def X_slice(i0):
        out = np.zeros(A.shape[1:])
        for c, M in zip(cols, mats):
            out += c[i0] * M
        return out

    dense = (slices == 'aca') and not lr
    if dense:
        X = np.zeros(A.shape)

    ctl = _PivotControl(tol, maxiter, skipcount, tolcount, verbose,
                        what='outer it.')
    I = [m // 2 for m in A.shape]
    while True:
        E_col = A[:, I[1], I[2]] - (X[:, I[1], I[2]] if dense
                                    else X_fiber(I[1], I[2]))
        i0 = abs(E_col).argmax()
        verdict = ctl.classify(abs(E_col[i0]), I)
        if verdict == 'stop':
            break
        if verdict == 'skip':
            I[:] = [np.random.randint(m) for m in A.shape]
            if ctl.skipped_out():
                break
            continue

        I[0] = i0
        if verbose >= 2:
            print(I, '\t', abs(E_col[i0]))

        X_i0 = X[i0, :, :] if dense else X_slice(i0)
        if slices == 'materialize':
            A_mat = np.asarray(A[i0, :, :])
        else:
            A_mat = aca(A.matrix_at(I, axes=(1, 2)), startval=X_i0,
                        tol=tol, maxiter=maxiter, skipcount=skipcount,
                        tolcount=tolcount, verbose=min(verbose, 1))
        E_mat = A_mat - X_i0

        cols.append(E_col / E_col[i0])
        mats.append(E_mat.copy())
        if dense:
            aca3d_update(X, 1.0 / E_col[i0], E_col, E_mat)

        E_mat[tuple(I[1:])] = 0
        I[1:] = np.unravel_index(abs(E_mat).argmax(), E_mat.shape)
        if not ctl.advance():
            break
    if lr:
        if not cols:        # no cross accepted (e.g. zero tensor)
            return tensor.TensorSum(tensor.TensorProd(
                np.zeros(A.shape[0]), np.zeros(A.shape[1:])))
        return tensor.TensorSum(*(tensor.TensorProd(c, M)
                                  for c, M in zip(cols, mats)))
    if dense:
        return X
    if not cols:
        return np.zeros(A.shape)
    C, M = np.stack(cols), np.stack(mats)
    # one BLAS product: einsum('ri,rjk->ijk') would not use BLAS
    return (C.T @ M.reshape(len(cols), -1)).reshape(
        C.shape[1], *M.shape[1:])


# entries within this fraction of the tensor's scale (the first fiber's
# largest entry) of the largest are ties: a symmetric form's compact
# tensor has exactly equal mirrored entries, which rounding would order
# differently on every device and summation order (see _first_max)
TIE_TOL = 1e-11


def _first_max(a, tie):
    """The first index of the flattened `a` whose entry is within `tie`
    of its largest (a device tensor; no host read)."""
    return torch.argmax((a >= a.max() - tie).to(torch.int8).reshape(-1))


def _aca_pivot(fiber_fn, slice_fn, fields, tables, cols, mats, count, I,
               scale):
    """One pivot of :func:`aca_3d_device` on the device: the residual
    fiber at ``(:, I[1], I[2])``, its argmax ``i0``, the residual slice at
    ``i0`` (appended with the scaled fiber at slot `count`, which the
    host makes part of the approximation by counting it) and the argmax
    of the slice with ``(I[1], I[2])`` zeroed.  Returns the verdict
    ``[i0, |e0|, j1, j2]`` as a float64 device tensor.  `scale` (a 0-dim
    device tensor, the first fiber's largest entry; None on the first
    pivot) sets the tie tolerance of both argmaxes."""
    n1, n2 = mats.shape[1:]
    idx = torch.tensor(I[1:], dtype=torch.int64, device=cols.device)
    fiber = fiber_fn(fields, tables, idx)
    if scale is None:
        scale = fiber.abs().max()
    tie = TIE_TOL * scale
    Ef = fiber - mats[:count, I[1], I[2]] @ cols[:count]
    i0 = _first_max(Ef.abs(), tie)
    e0 = Ef[i0]
    S = slice_fn(fields, tables, i0.reshape(1))
    Xs = (cols[:count, i0] @ mats[:count].reshape(count, n1 * n2)).reshape(
        n1, n2)
    Em = S - Xs
    cols[count] = Ef / e0
    mats[count] = Em
    Em[I[1], I[2]] = 0.0
    flat = _first_max(Em.abs(), tie)
    return torch.stack([i0.to(cols.dtype), e0.abs(),
                        (flat // n2).to(cols.dtype),
                        (flat % n2).to(cols.dtype)]), scale


def aca_3d_device(asm, tol=1e-10, maxiter=100, skipcount=3, tolcount=3,
                  verbose=2):
    """Nested 3D ACA over an assembler's compact tensor with the crosses
    on the assembler's device (``asm.device``; the card unless the
    assembler was built for the CPU): per outer pivot one device
    evaluation of the residual fiber and slice (:func:`_aca_pivot`) and
    one host read of its 4-number verdict; the crosses live in
    ``(maxiter + 1)``-slot buffers and are inflated once at the end.
    Same pivoting rules and arithmetic as :func:`aca_3d` with
    ``slices='materialize'``.  The slices come in the compute dtype
    (float32 under float32: K1 ``jac``, K5 and the chains in float32)
    and the crosses accumulate in float64, as the JAX package's
    (``pyiga_tpu/lowrank.py:602-607``).  Returns the dense compact data
    tensor (host numpy, float64)."""
    fiber_fn = asm._slice_fn_cached((1, 2))
    slice_fn = asm._slice_fn_cached((0,))
    fields, tables = asm._slice_operands()
    shape = tuple(len(bx) for bx in asm.structure.bidx)
    n0, n1, n2 = shape
    cols = torch.zeros((maxiter + 1, n0), dtype=torch.float64,
                       device=asm.device)
    mats = torch.zeros((maxiter + 1, n1, n2), dtype=torch.float64,
                       device=asm.device)
    count = 0
    I = [m // 2 for m in shape]
    ctl = _PivotControl(tol, maxiter, skipcount, tolcount, verbose,
                        what='outer it.')
    scale = None
    while True:
        verdict, scale = _aca_pivot(fiber_fn, slice_fn, fields, tables, cols,
                                    mats, count, I, scale)
        i0, e0, j1, j2 = verdict.tolist()
        verdict = ctl.classify(e0, I)
        if verdict == 'stop':
            break
        if verdict == 'skip':
            I[:] = [np.random.randint(m) for m in shape]
            if ctl.skipped_out():
                break
            continue
        I[0] = int(i0)
        if verbose >= 2:
            print(I, '\t', e0)
        count += 1
        I[1], I[2] = int(j1), int(j2)
        if not ctl.advance():
            break
    return _aca_inflate(cols, mats, count, shape)


def _aca_inflate(cols, mats, count, shape):
    """The dense compact tensor ``sum_r cols[r] (x) mats[r]`` of the first
    `count` crosses: one product on the crosses' device, one copy to the
    host."""
    if count == 0:
        return np.zeros(shape)
    X = cols[:count].T @ mats[:count].reshape(count, -1)
    return X.reshape(shape).cpu().numpy()


################################################################################
# Fast assembling driver
################################################################################

def compact_generator(asm):
    """A :class:`TensorGenerator` over the compact (reordered) data tensor of
    the given assembler; slices are evaluated on the assembler's device."""
    S = asm.structure
    shape = tuple(len(bx) for bx in S.bidx)
    return TensorGenerator(shape, slicefunc=asm.compact_slice)


def fast_assemble(asm, kvs, tol=1e-10, maxiter=100, skipcount=3,
                  tolcount=3, verbose=2, method='auto'):
    """Assemble the matrix of `asm` by low-rank ACA over the compact
    (reordered) matrix; returns a scipy CSR matrix.

    The compact tensor is the reordered matrix, so the ACA result is the
    MLMatrix data tensor.  In 3D, ``method='auto'`` runs
    :func:`aca_3d_device` when the assembler lies on a CUDA device and
    the materialized-slice host driver :func:`aca_3d` otherwise;
    ``method='host'`` forces the host driver."""
    if method not in ('auto', 'host'):
        raise ValueError("method must be 'auto' or 'host'")
    S = asm.structure
    if S.L == 2:
        X = aca(compact_generator(asm), tol=tol, maxiter=maxiter,
                skipcount=skipcount, tolcount=tolcount, verbose=verbose)
    elif S.L == 3:
        if method == 'auto' and asm.device.type == 'cuda':
            X = aca_3d_device(asm, tol=tol, maxiter=maxiter,
                              skipcount=skipcount, tolcount=tolcount,
                              verbose=verbose)
        else:
            X = aca_3d(compact_generator(asm), tol=tol, maxiter=maxiter,
                       skipcount=skipcount, tolcount=tolcount,
                       verbose=verbose)
    else:
        raise NotImplementedError('fast assembling only for 2D and 3D')
    return S.make_mlmatrix(data=X).asmatrix('csr')
