"""Order-exact indexed Gauss-Seidel relaxation on the device (port of
:mod:`pyiga_tpu.ops.relax`).

The local multigrid smoother is a strictly sequential Gauss-Seidel sweep
over a subset of rows in a prescribed order; the solver's iteration
counts depend on that order, so a Jacobi-like or red-black relaxation is
not admissible.  The sweep is split into dependency wavefronts instead:
row ``t`` waits for an earlier row ``s`` of the sweep iff it reads the
value ``s`` writes (``A[t, s] != 0``), and, for a structurally
nonsymmetric matrix, a row that an earlier row reads may not be
overwritten in an earlier level than that read (write after read).  The
greedy longest-path levels (:func:`level_schedule`) group rows that
update at once with the values the sequential sweep would give them;
only the order of each row's own sum differs.

:class:`DeviceIndexedGS` applies ``iterations`` sweeps over a fixed set
on one device: on the card in one launch of the wavefront kernel
(:func:`~pyiga_tpu_torch.ops.cuda_mg.wavefront_gs`, ``csrc/mg.cu``), on
the CPU through its plain version, a loop over the levels with one
gather and one scatter per level.  It computes in float64
(``config.DTYPE``) under either compute dtype, as the JAX package's
``ops/relax.py``.
"""

import numpy as np
import scipy.sparse
import torch

from ..config import DTYPE, resolve_device
from . import cuda_mg

SWEEP_DIRS = {'forward': (False,), 'backward': (True,),
              'symmetric': (False, True)}


def level_schedule(A, indices, reverse=False):
    """Greedy wavefront levels for a Gauss-Seidel sweep over `indices` (in
    order; reversed if `reverse`) on the CSR matrix `A`.

    Returns ``(order, level)`` where ``order`` is the sweep order (row ids)
    and ``level[r]`` the wavefront level of ``order[r]``: the longest
    dependency path from any earlier sweep position whose value row
    ``order[r]`` reads."""
    if not scipy.sparse.isspmatrix_csr(A):
        A = scipy.sparse.csr_matrix(A)
    ind = np.asarray(indices, dtype=np.int64)
    assert len(np.unique(ind)) == len(ind), 'smoothing indices must be unique'
    order = ind[::-1] if reverse else ind
    n = A.shape[0]
    rank = np.full(n, -1, dtype=np.int64)
    rank[order] = np.arange(len(order))
    level = np.zeros(len(order), dtype=np.int64)
    indptr, cols = A.indptr, A.indices
    Acsc = A.tocsc()
    for r, i in enumerate(order):
        # flow dependency: row i reads values updated earlier in the sweep
        rs = rank[cols[indptr[i]:indptr[i + 1]]]
        rs = rs[(rs >= 0) & (rs < r)]
        lv = level[rs].max() + 1 if rs.size else 0
        # anti-dependency (WAR): earlier sweep positions whose rows READ
        # column i must see its OLD value -- within a level all reads
        # precede all writes, so level[r] >= their level suffices.  For
        # structurally symmetric A this never raises the level further.
        rd = rank[Acsc.indices[Acsc.indptr[i]:Acsc.indptr[i + 1]]]
        rd = rd[(rd >= 0) & (rd < r)]
        if rd.size:
            lv = max(lv, int(level[rd].max()))
        level[r] = lv
    return order, level


def _pack_sweep(A, order, level):
    """Pad one sweep's rows into rectangular per-level arrays:
    ``rows (L, P)`` (pad = n, a dead slot), ``cols (L, P, W)`` /
    ``vals (L, P, W)`` (the row's off-diagonal CSR entries, zero padded)
    and ``diag (L, P)`` (pad 1)."""
    n = A.shape[0]
    indptr, cols_all, data = A.indptr, A.indices, A.data
    m = len(order)
    if m == 0:
        return (np.full((1, 1), n, np.int32), np.zeros((1, 1, 1), np.int32),
                np.zeros((1, 1, 1), np.float64), np.ones((1, 1), np.float64))
    L = int(level.max()) + 1
    counts = np.bincount(level, minlength=L)
    P = int(counts.max())
    W = int(max(indptr[i + 1] - indptr[i] for i in order))
    rows = np.full((L, P), n, dtype=np.int32)
    cols = np.zeros((L, P, W), dtype=np.int32)
    vals = np.zeros((L, P, W), dtype=np.float64)
    diag = np.ones((L, P), dtype=np.float64)
    slot = np.zeros(L, dtype=np.int64)
    for r, i in enumerate(order):
        l = level[r]
        p = slot[l]
        slot[l] += 1
        c = cols_all[indptr[i]:indptr[i + 1]]
        v = data[indptr[i]:indptr[i + 1]].copy()
        dmask = c == i
        if not dmask.any() or v[dmask][0] == 0.0:
            # zero/missing diagonal: skip the row (the sequential sweep's
            # semantics; rows[l, p] stays at the dead slot n)
            continue
        rows[l, p] = i
        diag[l, p] = v[dmask][0]
        v[dmask] = 0.0
        cols[l, p, :len(c)] = c
        vals[l, p, :len(c)] = v
    return rows, cols, vals, diag


def sweep_packs(A, indices, reverse_flags):
    """The rectangular pack of a sweep over `indices` for each direction
    in `reverse_flags` (each distinct direction scheduled once; a pack
    shared by two entries is the same object)."""
    A = scipy.sparse.csr_matrix(A)
    done = {}
    for reverse in reverse_flags:
        if reverse not in done:
            order, level = level_schedule(A, indices, reverse=reverse)
            done[reverse] = _pack_sweep(A, order, level)
    return [done[r] for r in reverse_flags]


class DeviceIndexedGS:
    """Indexed Gauss-Seidel smoother for a fixed matrix, index subset,
    sweep direction and iteration count, on `device` (default: the card).

    ``apply(x, b)`` updates the host array `x` in place; all relaxation
    arithmetic runs in one kernel launch on a CUDA device (the plain
    level loop on the CPU)."""

    def __init__(self, A, indices, sweep='forward', iterations=1,
                 device=None):
        try:
            dirs = SWEEP_DIRS[sweep]
        except KeyError:
            raise ValueError("valid sweep directions are 'forward', "
                             "'backward', and 'symmetric'")
        A = scipy.sparse.csr_matrix(A)
        self.device = resolve_device(device)
        self.iterations = int(iterations)
        self.sweeps = cuda_mg.WavefrontSweeps(
            A.shape[0], indices, [sweep_packs(A, indices, dirs)],
            self.device)

    def apply(self, x, b):
        xt = torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=DTYPE,
                             device=self.device)
        bt = torch.as_tensor(np.asarray(b, dtype=np.float64), dtype=DTYPE,
                             device=self.device)
        cuda_mg.wavefront_gs(self.sweeps, 0, self.iterations, xt, bt)
        x[:] = xt.cpu().numpy()
        return x
