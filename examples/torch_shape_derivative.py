# -*- coding: utf-8 -*-
"""Discrete shape derivatives through assembly AND solve over
:mod:`pyiga_tpu_torch` (the port of ``examples/shape_derivative.py``; it
assembles on `device`, the card unless ``'cpu'`` is given).

The compliance J(c) = f^T u(c) of a Poisson problem, where A(c) u = f
and c are the geometry control points, is differentiated end to end
with ``torch.autograd``: the assembly (pyiga_tpu_torch.diff.
assembly_coeff_fn) runs the port's kernels, each with a backward kernel,
and the dense solve contributes its adjoint.  A few steps of gradient
descent on the interior control points then *stiffen* the domain
(compliance decreases monotonically): the core loop of IGA shape
optimization.

Run ``python examples/torch_shape_derivative.py`` on a machine with a
CUDA card, or ``python examples/torch_shape_derivative.py cpu``."""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))


def main(p=2, n=8, steps=3, lr=2e-3, device=None):
    from pyiga_tpu_torch import approx, assemble, bspline, geometry
    from pyiga_tpu_torch.assemblers import StiffnessAssembler
    from pyiga_tpu_torch.diff import assembly_coeff_fn
    from pyiga_tpu_torch.ops.fastdiag import interior_dofs

    kvs = 2 * (bspline.make_knots(p, 0.0, 1.0, n),)
    # refine the coarse quarter-annulus control net into the discretization
    # space (exact for p >= 2) so there are interior control points to move
    coarse = geometry.bspline_quarter_annulus()
    geo = geometry.BSplineFunc(kvs, np.asarray(approx.interpolate(kvs,
                                                                  coarse)))
    asm = StiffnessAssembler(kvs, geo, device=device)
    dev = asm.device
    fn, coeffs0 = assembly_coeff_fn(asm)

    # fixed unit load; homogeneous Dirichlet boundary
    free = torch.as_tensor(interior_dofs(kvs), device=dev)
    N = int(np.prod([kv.numdofs for kv in kvs]))
    I, J = (torch.as_tensor(ix.astype(np.int64), device=dev)
            for ix in asm.structure.nonzero())   # C order of the data
    f = torch.as_tensor(np.asarray(assemble.inner_products(
        kvs, lambda *x: np.ones_like(x[0]), geo=geo)).reshape(-1),
        dtype=torch.float64, device=dev)[free]

    # boundary control points stay fixed: optimize interior ones only
    bmask = np.zeros(coeffs0.shape, dtype=bool)
    bmask[0, :] = bmask[-1, :] = bmask[:, 0] = bmask[:, -1] = True
    interior = torch.as_tensor(~bmask, device=dev)

    def compliance(coeffs):
        data = fn(coeffs)
        A = torch.zeros((N, N), dtype=data.dtype, device=dev).index_put(
            (I, J), data.reshape(-1))
        u = torch.linalg.solve(A[free][:, free], f)
        return torch.dot(f, u)

    c = torch.as_tensor(coeffs0, dtype=torch.float64, device=dev)
    history = []
    for k in range(steps + 1):
        c = c.detach().requires_grad_(True)
        Jc = compliance(c)
        g, = torch.autograd.grad(Jc, c)
        g = torch.where(interior, g, 0.0)
        history.append(float(Jc.detach()))
        print('step %d: compliance %.6f   |dJ/dc|_interior %.4f'
              % (k, history[-1], float(torch.linalg.vector_norm(g))))
        if k < steps:
            c = c - lr * g

    assert all(b < a for a, b in zip(history, history[1:])), \
        'gradient descent should reduce compliance monotonically'
    return history


if __name__ == '__main__':
    main(device=sys.argv[1] if len(sys.argv) > 1 else None)
