"""Device local-multigrid solver (port of :mod:`pyiga_tpu.ops.mg`).

:class:`DeviceMGSolver` runs the local multigrid V-cycle of
:func:`pyiga_tpu_torch.solvers.local_mg_step` with the convergence test
of :func:`~pyiga_tpu_torch.solvers.iterative_solve`, on a fixed matrix
hierarchy.  The operation order is the host path's (pre-smooth, restrict,
coarse solve, prolongate, post-smooth), so the iteration counts agree
with it; they are the numerical contract.

Each Gauss-Seidel sweep over a smoothing set ``S`` is applied in its
algebraic form ``x_S += T (b - A x)_S``, with ``T`` the inverse of the
lower (upper, for a backward sweep) triangle of ``A[S][:, S]`` in sweep
order (:func:`_tri_inverse`), built once on the host.  A whole solve
(every V-cycle, the masked residual norm and the convergence test) is one
launch of kernel K6 (:mod:`~pyiga_tpu_torch.ops.cuda_mg`); the host reads
the cycle count and the residual once per solve.  The JAX package's
two-float cycle exists for the TPU's missing f64 and is not ported; K6
takes the place of its ``'tri'`` set up to ``tri_block_cutoff``, and its
``'wavefront'`` set beyond that waits for ``ops/relax.py``.
"""

import numpy as np
import scipy.sparse
import torch

from ..config import DTYPE, resolve_device
from . import cuda_mg

_SWEEP_DIRS = {'forward': (False,), 'backward': (True,),
               'symmetric': (False, True)}


def ell_pack(A, dtype=np.float64):
    """CSR matrix -> padded ELL arrays ``(cols (n, W) int32, vals (n, W))``
    with zero padding (column 0, value 0); the matvec is
    ``sum(vals * x[cols], axis=-1)``."""
    A = scipy.sparse.csr_matrix(A)
    A.sort_indices()
    n = A.shape[0]
    counts = np.diff(A.indptr)
    W = max(int(counts.max()) if n else 0, 1)
    cols = np.zeros((n, W), dtype=np.int32)
    vals = np.zeros((n, W), dtype=dtype)
    rows = np.repeat(np.arange(n), counts)
    pos = np.arange(A.nnz) - A.indptr[rows]
    cols[rows, pos] = A.indices
    vals[rows, pos] = A.data
    return cols, vals


def _tri_inverse(A_SS, reverse=False):
    """Dense inverse of the GS sweep matrix: lower (upper, for a reversed
    sweep) triangle of ``A[S][:, S]`` in sweep-order basis.  Zero-diagonal
    rows keep the skip semantics of the sequential sweep (their update is
    zeroed and later rows see the old value through the zero
    contribution)."""
    M = np.triu(A_SS) if reverse else np.tril(A_SS)
    diag = np.diagonal(A_SS).copy()
    dead = diag == 0.0
    if dead.any():
        # skip semantics need BOTH: dx_dead = 0 (row zeroed in T below)
        # AND no coupling of later rows to the dead update (column zeroed
        # BEFORE inversion, or rows after the dead index would absorb a
        # phantom dx_dead = r_dead through the forward substitution)
        M[dead, :] = 0.0
        M[:, dead] = 0.0
        M[dead, dead] = 1.0
    T = np.linalg.inv(M)
    if dead.any():
        T[dead, :] = 0.0
    return T


def _tri_smoother_pack(A, indices, reverse=False):
    """Dense-triangular form of one GS sweep over `indices` (in order;
    reversed if `reverse`) on CSR ``A``: the sweep is algebraically
    ``x_S += M^{-1} (b - A x)_S`` with ``M`` the lower (upper, for a
    reversed sweep) triangle of ``A[S][:, S]`` in sweep-order basis.
    Returns ``(S int32, ell_rows, T)`` with ``ell_rows`` the padded-ELL
    rows ``A[S, :]`` and ``T = M^{-1}`` dense."""
    S = np.asarray(indices, dtype=np.int64)
    T = _tri_inverse(A[S][:, S].toarray(), reverse=reverse)
    return S.astype(np.int32), ell_pack(A[S]), T


class DeviceMGSolver:
    """Local multigrid solver for a fixed hierarchy, one K6 launch per
    solve.

    Args mirror :func:`pyiga_tpu_torch.solvers.local_mg_step`: the
    Galerkin matrix hierarchy `As` (finest last), the virtual-hierarchy
    prolongators `Ps` (``Ps[lv]``: level lv -> lv+1), the per-level
    smoothing index sets `lv_inds`, the GS sweep directions
    ``(pre, post)`` and `smooth_steps`.  `active_dofs` masks the
    convergence residual (``iterative_solve`` semantics).  `device`
    holds the operands (default: the card).

    `smoother_impl`:

    * ``'fused'``: the solve loop through :func:`~pyiga_tpu_torch.ops.
      cuda_mg.vcycle_solve`, which launches K6 once on a CUDA device (and
      runs its plain version, the host loop over the plain cycle, on the
      CPU), at any size that fits the device;
    * ``'dense'``: the plain PyTorch f64 cycle
      (:func:`~pyiga_tpu_torch.ops.cuda_mg.vcycle_plain`) on any device;
    * ``'auto'``: ``'fused'`` for ``n <= dense_cutoff`` finest dofs, for
      single-level hierarchies, and above the cutoff while the largest
      smoothing set above the coarsest level has at most
      `tri_block_cutoff` dofs: K6 densifies each set into triangular
      inverses, as the JAX package's ``'tri'`` set does, and that is the
      JAX package's own limit for them.  Past it the JAX package switches
      to its ``'wavefront'`` set (``ops/relax.py``), which is not ported
      (ROADMAP §1 item 3): ``'auto'`` raises there.
    """

    def __init__(self, As, Ps, lv_inds, sweeps, smooth_steps,
                 active_dofs=None, smoother_impl='auto', dense_cutoff=6000,
                 tri_block_cutoff=8192, device=None):
        L = len(As)
        if len(Ps) != L - 1 or len(lv_inds) != L:
            raise ValueError('need L matrices, L-1 prolongators and L '
                             'smoothing sets')
        n = As[-1].shape[0]
        max_block = max((len(lv_inds[lv]) for lv in range(1, L)), default=0)
        if smoother_impl == 'auto':
            if n > dense_cutoff and max_block > tri_block_cutoff:
                raise NotImplementedError(
                    "a smoothing set of %d dofs exceeds tri_block_cutoff = "
                    "%d, where the JAX package switches to its 'wavefront' "
                    "smoother (ops/relax.py), which is not ported yet "
                    "(ROADMAP item 3); pass smoother_impl='fused' to run K6 "
                    "at this size" % (max_block, tri_block_cutoff))
            smoother_impl = 'fused'
        if smoother_impl in ('tri', 'wavefront', 'df'):
            raise NotImplementedError("smoother_impl=%r is not ported yet"
                                      % smoother_impl)
        if smoother_impl not in ('fused', 'dense'):
            raise ValueError("smoother_impl must be 'auto', 'fused' or "
                             "'dense'")
        self.device = resolve_device(device)
        self.smoother_impl = smoother_impl
        self.ops = cuda_mg.VCycleOperands(
            self._host_levels(As, Ps, lv_inds, sweeps),
            np.asarray(lv_inds[0], dtype=np.int32),
            self._coarse_inverse(As[0], lv_inds[0]),
            self._mask(n, active_dofs), smooth_steps, self.device)

    @staticmethod
    def _host_levels(As, Ps, lv_inds, sweeps):
        """Per level the host operands of the cycle: the padded-ELL matrix
        ``A`` and, above the coarsest level, the smoothing set ``S``, the
        ELL rows ``A[S, :]``, the triangular inverses of the pre- and
        post-smoothing sweep directions (shared when the directions
        agree) and the ELL prolongator ``P`` into the level and its
        transpose ``PT``."""
        pre, post = sweeps
        levels = []
        for lv, A in enumerate(As):
            A = scipy.sparse.csr_matrix(A)
            lev = {'A': ell_pack(A)}
            if lv > 0:
                packs = {rev: _tri_smoother_pack(A, lv_inds[lv], reverse=rev)
                         for rev in set(_SWEEP_DIRS[pre] + _SWEEP_DIRS[post])}
                S, AS, _T = next(iter(packs.values()))
                lev.update(S=S, AS=AS,
                           pre=[packs[r][2] for r in _SWEEP_DIRS[pre]],
                           post=[packs[r][2] for r in _SWEEP_DIRS[post]],
                           P=ell_pack(Ps[lv - 1]),
                           PT=ell_pack(scipy.sparse.csr_matrix(Ps[lv - 1]).T))
            levels.append(lev)
        return levels

    @staticmethod
    def _coarse_inverse(A0, ind0):
        """Dense inverse of the coarsest smoothing-set block, applied as a
        matvec (the host path's sparse LU solve up to rounding)."""
        A0 = scipy.sparse.csr_matrix(A0)
        return np.linalg.inv(A0[ind0][:, ind0].toarray())

    @staticmethod
    def _mask(n, active_dofs):
        mask = np.zeros(n)
        if active_dofs is None:
            mask[:] = 1.0
        else:
            mask[np.asarray(active_dofs)] = 1.0
        return mask

    def solve(self, f, tol=1e-8, maxiter=5000):
        """Run ``x <- vcycle(x)`` from zero until the masked residual drops
        by `tol`; returns ``(x, iterations)`` (host numpy `x`) with
        ``inf`` iterations on non-convergence (the semantics and the
        comparison form of ``iterative_solve``).  ``'fused'`` runs the
        whole loop in one K6 launch on a CUDA device; ``'dense'`` loops on
        the host over the plain cycle."""
        ops = self.ops
        solve = (cuda_mg.vcycle_solve if self.smoother_impl == 'fused'
                 else cuda_mg.vcycle_solve_plain)
        f = torch.as_tensor(np.asarray(f, dtype=np.float64), dtype=DTYPE,
                            device=self.device)
        res0 = np.float64(torch.linalg.vector_norm(f * ops.mask).item())
        x, it, res, _hist = solve(ops, f, res0, tol, maxiter)
        with np.errstate(divide='ignore', invalid='ignore'):
            converged = res / res0 < tol
        return x.cpu().numpy(), (it if converged else np.inf)
