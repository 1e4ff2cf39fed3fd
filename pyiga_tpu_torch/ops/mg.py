"""Device local-multigrid solver (port of :mod:`pyiga_tpu.ops.mg`).

:class:`DeviceMGSolver` runs the local multigrid V-cycle of
:func:`pyiga_tpu_torch.solvers.local_mg_step` with the convergence test
of :func:`~pyiga_tpu_torch.solvers.iterative_solve`, on a fixed matrix
hierarchy.  The operation order is the host path's (pre-smooth, restrict,
coarse solve, prolongate, post-smooth), so the iteration counts agree
with it; they are the numerical contract.

Each Gauss-Seidel sweep over a smoothing set ``S`` is applied in one of
two forms.  Up to ``tri_block_cutoff`` dofs a set, the algebraic form
``x_S += T (b - A x)_S``, with ``T`` the inverse of the lower (upper, for
a backward sweep) triangle of ``A[S][:, S]`` in sweep order
(:func:`_tri_inverse`), built once on the host (the JAX package's
``'tri'`` set).  Above it the order-exact wavefront sweep of
:mod:`~pyiga_tpu_torch.ops.relax` (its ``'wavefront'`` set), which needs
no dense matrix.  Either way a whole solve (every V-cycle, the masked
residual norm and the convergence test) is one launch of kernel K6
(:mod:`~pyiga_tpu_torch.ops.cuda_mg`); the host reads the cycle count and
the residual once per solve.  The JAX package's two-float cycle (``'df'``)
exists for the TPU's missing f64 and is not ported.

The solver computes in float64 (``config.DTYPE``) under either compute
dtype: under ``set_dtype(np.float32)`` it takes the float64 matrix that
the float32 hierarchical assembly returns, as the JAX package's
``pyiga_tpu/ops/mg.py`` never reads ``get_dtype`` (``ell_pack`` and
``_init_plain`` build float64 operands).
"""

import time

import numpy as np
import scipy.sparse
import torch

from ..config import DTYPE, resolve_device
from . import cuda_mg
from .relax import SWEEP_DIRS as _SWEEP_DIRS, sweep_packs


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

    * ``'fused'`` (or its JAX name ``'tri'``): the solve loop through
      :func:`~pyiga_tpu_torch.ops.cuda_mg.vcycle_solve` with the dense
      triangular inverses, which launches K6 once on a CUDA device (and
      runs its plain version, the host loop over the plain cycle, on the
      CPU), at any size that fits the device;
    * ``'wavefront'``: the same loop with the wavefront sweeps
      (:class:`~pyiga_tpu_torch.ops.cuda_mg.WavefrontSweeps`) in place of
      the dense inverses: block 0 of K6 runs each smoothing half;
    * ``'dense'``: the plain PyTorch f64 cycle with the dense inverses
      (:func:`~pyiga_tpu_torch.ops.cuda_mg.vcycle_plain`) on any device;
    * ``'auto'``: ``'fused'`` for ``n <= dense_cutoff`` finest dofs, for
      single-level hierarchies, and above the cutoff while the largest
      smoothing set above the coarsest level has at most
      `tri_block_cutoff` dofs (the JAX package's limit for its ``'tri'``
      set, which densifies the same blocks); ``'wavefront'`` past it, as
      the JAX package does.
    * ``'df'``, the JAX package's two-float cycle, is for the TPU only and
      raises.

    On a CUDA device the coarse inverse is formed on the card in f64.
    ``setup_ms`` records the host-clock milliseconds of the setup's parts
    (the wavefront schedules or the triangular inverses, the coarse
    inverse, the operands' upload).
    """

    def __init__(self, As, Ps, lv_inds, sweeps, smooth_steps,
                 active_dofs=None, smoother_impl='auto', dense_cutoff=6000,
                 tri_block_cutoff=8192, device=None):
        L = len(As)
        if len(Ps) != L - 1 or len(lv_inds) != L:
            raise ValueError('need L matrices, L-1 prolongators and L '
                             'smoothing sets')
        n = As[-1].shape[0]
        if smoother_impl == 'auto':
            max_block = max((len(s) for s in lv_inds[1:]), default=0)
            smoother_impl = ('wavefront' if n > dense_cutoff
                             and max_block > tri_block_cutoff else 'fused')
        elif smoother_impl == 'df':
            raise NotImplementedError(
                "smoother_impl='df' is the JAX package's two-float cycle "
                "for the TPU's missing f64; the port computes in f64")
        elif smoother_impl not in ('fused', 'tri', 'wavefront', 'dense'):
            raise ValueError("smoother_impl must be 'auto', 'fused', 'tri', "
                             "'wavefront' or 'dense'")
        self.device = resolve_device(device)
        self.smoother_impl = smoother_impl
        self.setup_ms = {}
        t0 = time.perf_counter()
        levels = self._host_levels(As, Ps, lv_inds, sweeps,
                                   smoother_impl == 'wavefront')
        t1 = time.perf_counter()
        Cinv = self._coarse_inverse(As[0], lv_inds[0], self.device)
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        t2 = time.perf_counter()
        self.ops = cuda_mg.VCycleOperands(
            levels, np.asarray(lv_inds[0], dtype=np.int32), Cinv,
            self._mask(n, active_dofs), smooth_steps, self.device)
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        self.setup_ms = dict(smoothers=1e3 * (t1 - t0),
                             coarse_inverse=1e3 * (t2 - t1),
                             operands=1e3 * (time.perf_counter() - t2))

    @staticmethod
    def _host_levels(As, Ps, lv_inds, sweeps, wave=False):
        """Per level the host operands of the cycle: the padded-ELL matrix
        ``A`` and, above the coarsest level, the ELL prolongator ``P``
        into the level and its transpose ``PT``, and either (`wave`) the
        smoothing set with the rectangular wavefront packs of the pre-
        and post-smoothing passes (``wave``: each direction scheduled
        once), or the smoothing set ``S``, the ELL rows ``A[S, :]`` and
        the triangular inverses of the pre- and post-smoothing sweep
        directions (shared when the directions agree)."""
        pre, post = sweeps
        levels = []
        for lv, A in enumerate(As):
            A = scipy.sparse.csr_matrix(A)
            lev = {'A': ell_pack(A)}
            if lv > 0:
                lev.update(P=ell_pack(Ps[lv - 1]),
                           PT=ell_pack(scipy.sparse.csr_matrix(Ps[lv - 1]).T))
                dirs = _SWEEP_DIRS[pre] + _SWEEP_DIRS[post]
                if wave:
                    packs = sweep_packs(A, lv_inds[lv], dirs)
                    npre = len(_SWEEP_DIRS[pre])
                    lev['wave'] = (lv_inds[lv], [packs[:npre], packs[npre:]])
                else:
                    packs = {rev: _tri_smoother_pack(A, lv_inds[lv],
                                                     reverse=rev)
                             for rev in set(dirs)}
                    S, AS, _T = next(iter(packs.values()))
                    lev.update(S=S, AS=AS,
                               pre=[packs[r][2] for r in _SWEEP_DIRS[pre]],
                               post=[packs[r][2]
                                     for r in _SWEEP_DIRS[post]])
            levels.append(lev)
        return levels

    @staticmethod
    def _coarse_inverse(A0, ind0, device):
        """Dense inverse of the coarsest smoothing-set block, applied as a
        matvec (the host path's sparse LU solve up to rounding): formed
        in f64 on a CUDA `device`, by numpy otherwise."""
        A0 = scipy.sparse.csr_matrix(A0)
        B = A0[ind0][:, ind0].toarray()
        if device.type == 'cuda':
            return torch.linalg.inv(torch.as_tensor(B, dtype=DTYPE,
                                                    device=device))
        return np.linalg.inv(B)

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
        comparison form of ``iterative_solve``).  ``'fused'``, ``'tri'``
        and ``'wavefront'`` run the whole loop in one K6 launch on a CUDA
        device; ``'dense'`` loops on the host over the plain cycle."""
        ops = self.ops
        solve = (cuda_mg.vcycle_solve_plain if self.smoother_impl == 'dense'
                 else cuda_mg.vcycle_solve)
        f = torch.as_tensor(np.asarray(f, dtype=np.float64), dtype=DTYPE,
                            device=self.device)
        res0 = np.float64(torch.linalg.vector_norm(f * ops.mask).item())
        x, it, res, _hist = solve(ops, f, res0, tol, maxiter)
        with np.errstate(divide='ignore', invalid='ignore'):
            converged = res / res0 < tol
        return x.cpu().numpy(), (it if converged else np.inf)
