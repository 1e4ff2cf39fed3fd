# -*- coding: utf-8 -*-
"""3D Poisson on the twisted box over :mod:`pyiga_tpu_torch` (the port of
``examples/poisson_3d.py``): sum-factorization assembly of the compact
stiffness tensor on `device` (K1, K2 and K3 on the card), homogeneous
Dirichlet conditions by the box restriction, and the matrix-free
preconditioned solve: float32 CG with the geometry-weighted
fast-diagonalization preconditioner, refined to float64 accuracy by
:func:`~pyiga_tpu_torch.solvers.cg_ir`.

Run ``python examples/torch_poisson_3d.py`` on a machine with a CUDA
card, or ``python examples/torch_poisson_3d.py cpu`` on the CPU."""

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

from pyiga_tpu_torch import bspline, geometry, solvers  # noqa: E402
from pyiga_tpu_torch.assemblers import StiffnessAssembler  # noqa: E402
from pyiga_tpu_torch.ops.fastdiag import (  # noqa: E402
    fastdiag_precond_weighted, interior_dofs)
from pyiga_tpu_torch.ops.matfree import MatrixFreeOperator  # noqa: E402


def main(n=16, p=3, device=None):
    """Solve with `n` elements per axis and degree `p`; returns the
    solution on the free dofs (numpy) and the ``cg_ir`` info."""
    kvs = 3 * (bspline.make_knots(p, 0.0, 1.0, n),)
    geo = geometry.twisted_box()
    ndofs = int(np.prod([kv.numdofs for kv in kvs]))
    print('dofs:', ndofs)

    asm = StiffnessAssembler(kvs, geo, device=device)
    t0 = time.perf_counter()
    K = asm.assemble()                  # compact MLMatrix (float64)
    print('assembly: %.3fs' % (time.perf_counter() - t0))

    # Dirichlet Poisson on the interior dofs, matrix-free
    free = interior_dofs(kvs)
    op64 = MatrixFreeOperator(asm, free_dofs=free, dtype=torch.float64)
    op32 = MatrixFreeOperator(asm, free_dofs=free, dtype=torch.float32)
    P32 = fastdiag_precond_weighted(asm, dirichlet=True,
                                    dtype=torch.float32)

    b = np.ones(len(free))
    t0 = time.perf_counter()
    u, info = solvers.cg_ir(op64, op32, torch.as_tensor(b, device=asm.device),
                            tol=1e-10, precond_lo=P32)
    u = u.cpu().numpy()
    print('cg_ir: %d outer / %s inner iterations, %.3fs'
          % (info['outer'], info['inner_iters'], time.perf_counter() - t0))

    Kff = K.asmatrix().tocsr()[free][:, free]
    res = np.linalg.norm(Kff @ u - b) / np.linalg.norm(b)
    print('true residual: %.2e' % res)
    assert res < 1e-9
    return u, info


if __name__ == '__main__':
    main(device=sys.argv[1] if len(sys.argv) > 1 else None)
