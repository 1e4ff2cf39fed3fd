"""What the ranks of ``tests/test_torch_parallel.py`` run (each a function
``fn(device, *args)`` that a rank of
:class:`pyiga_tpu_torch.parallel._launch.RankPool` calls).  Kept apart
from the test module so that the rank processes import neither jax nor
the JAX package.  Every result is numpy or plain Python."""

import numpy as np
import torch

from pyiga_tpu_torch import geometry, parallel
from pyiga_tpu_torch.assemblers import MassAssembler, StiffnessAssembler
from pyiga_tpu_torch.bspline import make_knots


def _np(t):
    return t.detach().cpu().numpy()


def dryrun(device, n, dim, nspans, p, cg_iters):
    data, X = parallel.dryrun(n, dim=dim, nspans=nspans, p=p,
                              cg_iters=cg_iters, device='cpu')
    return data, X


def make_mesh_raises(device, n):
    try:
        parallel.make_mesh(n_devices=n, device='cpu')
    except RuntimeError as e:
        return str(e)
    return None


def stiffness_step(device, kind, nspans, shape, cg_iters, num_rhs):
    kvs = 2 * (make_knots(2, 0.0, 1.0, nspans),)
    cls = MassAssembler if kind == 'mass' else StiffnessAssembler
    asm = cls(kvs, geometry.quarter_annulus(), device='cpu')
    mesh = parallel.make_mesh(shape=shape, axis_names=('space', 'rhs'),
                              device='cpu')
    step, args = parallel.sharded_stiffness_step(asm, mesh,
                                                 cg_iters=cg_iters,
                                                 num_rhs=num_rhs)
    data, X = step(*args)
    sizes = tuple(parallel.axis_size(mesh, name)
                  for name in ('space', 'rhs', 'b'))
    return _np(data), _np(X), _np(args[2]), sizes


def matfree_cg(device, n_ranks, tol, maxiter, free, mass_shift=None):
    """The 3D p=2 n=5 mass system on the twisted box by the sharded
    matrix-free CG; with `mass_shift`, preconditioned by the
    parameter-domain fastdiag of that shift."""
    from pyiga_tpu_torch.ops.fastdiag import fastdiag_precond, interior_dofs
    kvs = 3 * (make_knots(2, 0.0, 1.0, 5),)
    asm = MassAssembler(kvs, geometry.twisted_box(), device='cpu')
    mesh = parallel.make_mesh(n_ranks, axis_names=('space',), device='cpu')
    n = int(np.prod([kv.numdofs for kv in kvs]))
    free_dofs = None
    if free:
        free_dofs = interior_dofs(kvs)
        n = len(free_dofs)
    pc = None
    if mass_shift is not None:
        pc = fastdiag_precond(kvs, free_dofs=free_dofs, mass_shift=mass_shift,
                              device='cpu')
    solve, ops = parallel.sharded_matfree_cg(asm, mesh, free_dofs=free_dofs,
                                             precond=pc, tol=tol,
                                             maxiter=maxiter)
    b = np.random.RandomState(0).rand(n)
    x, it = solve(ops, b)
    return _np(x), it, b


def _three_patches(nspans):
    from pyiga_tpu_torch.assemble import Multipatch
    kvs = 2 * (make_knots(2, 0.0, 1.0, nspans),)
    squ = geometry.unit_square()
    geos = (squ, squ.translate((1, 0)),
            squ.scale((-1, 1)).translate((2, 1)))
    MP = Multipatch([(kvs, g) for g in geos])
    MP.join_boundaries(0, 'right', 1, 'left')
    MP.join_boundaries(1, 'top', 2, 'bottom', flip=(True,))
    MP.finalize()
    return kvs, geos, MP


def multipatch_stiffness(device, n_ranks):
    kvs, geos, MP = _three_patches(6)
    mesh = parallel.make_mesh(n_ranks, axis_names=('space',), device='cpu')
    asms = [StiffnessAssembler(kvs, g, device='cpu') for g in geos]
    data = parallel.sharded_multipatch_data(asms, mesh)
    A = parallel.multipatch_assemble_stiffness(MP, mesh)
    return data, A


def multipatch_system(device, n_ranks):
    from pyiga_tpu_torch import vform
    _kvs, _geos, MP = _three_patches(5)
    mesh = parallel.make_mesh(n_ranks, axis_names=('space',), device='cpu')
    form = ('(inner(grad(u), grad(v)) + dot(b, grad(u)) * v + u * v) '
            '* dx')
    return (parallel.multipatch_assemble_system(MP, mesh, 'mass'),
            parallel.multipatch_assemble_system(
                MP, mesh, form, args={'b': np.array([2.0, -1.0])}),
            parallel.multipatch_assemble_system(MP, mesh,
                                                vform.divdiv_vf(2)))


def multipatch_errors(device, n_ranks):
    """The ValueErrors of unequal patches: (geometry structure, knot
    vectors)."""
    from pyiga_tpu_torch.compile import compile_vform
    from pyiga_tpu_torch import vform
    mesh = parallel.make_mesh(n_ranks, axis_names=('space',), device='cpu')
    kv = make_knots(2, 0.0, 1.0, 4)
    msgs = []
    try:
        parallel.sharded_multipatch_data(
            [StiffnessAssembler((kv, kv), geometry.unit_square(),
                                device='cpu'),
             StiffnessAssembler((kv, make_knots(2, 0.0, 1.0, 5)),
                                geometry.unit_square(), device='cpu')],
            mesh)
    except ValueError as e:
        msgs.append(str(e))
    cls = compile_vform(vform.stiffness_vf(2))
    try:
        parallel.sharded_multipatch_vform_data(
            [cls((kv, kv), geo=geometry.unit_square(), device='cpu'),
             cls((kv, make_knots(2, 0.0, 2.0, 4)),
                 geo=geometry.unit_square(), device='cpu')], mesh)
    except ValueError as e:
        msgs.append(str(e))
    return msgs


def flagship(device, n_ranks, n):
    from pyiga_tpu_torch.parallel.flagship import sharded_flagship_pipeline
    from pyiga_tpu_torch.solvers import cg_ir_info
    kvs = 2 * (make_knots(3, 0.0, 1.0, n),)
    asm = StiffnessAssembler(kvs, geometry.quarter_annulus(), device='cpu')
    mesh = parallel.make_mesh(n_ranks, axis_names=('space',), device='cpu')
    fn, args = sharded_flagship_pipeline(asm, mesh)
    D, u, info = fn(*args)
    space = parallel.axis_comm(mesh, 'space')
    s0 = int(np.prod(fn.ns[1:]))
    counts = [q1 - q0 for q0, q1 in space.slabs(fn.ns[0])]
    D = space.gather(D.reshape(D.shape[0], -1, s0), counts, dim=1)
    return (_np(D.reshape(D.shape[0], -1)), _np(u), cg_ir_info(info),
            _np(args[0]))


def grad_batch(device, n_ranks, batch):
    """``vmap(grad(obj))`` of the 2D mass objective with the batch split
    over the ranks, gathered; and the loop of ``grad`` over the batch."""
    from pyiga_tpu_torch.diff import assembly_coeff_fn
    kvs = 2 * (make_knots(2, 0.0, 1.0, 4),)
    asm = MassAssembler(kvs, geometry.bspline_quarter_annulus(),
                        device='cpu')
    fn, coeffs0 = assembly_coeff_fn(asm)
    w = torch.as_tensor(np.random.RandomState(42).rand(*fn(coeffs0).shape))

    def obj(c):
        return torch.sum(w * fn(c))

    mesh = parallel.make_mesh(n_ranks, axis_names=('b',), device='cpu')
    comm = parallel.axis_comm(mesh, 'b')
    lo, hi = comm.slab(batch.shape[0])
    mine = torch.func.vmap(torch.func.grad(obj))(torch.as_tensor(
        batch[lo:hi]))
    counts = [q1 - q0 for q0, q1 in comm.slabs(batch.shape[0])]
    g = comm.gather(mine, counts)
    loop = torch.stack([torch.func.grad(obj)(torch.as_tensor(c))
                        for c in batch])
    return _np(g), _np(loop)


def halo(device, n, w):
    """Every rank's rows with a halo of `w` on an axis of `n` rows (value
    of a row: its index), as received."""
    from pyiga_tpu_torch.parallel import _comm
    import torch.distributed as dist
    mesh = parallel.make_mesh(axis_names=('space',), devices=[
        'cpu'] * dist.get_world_size())
    comm = parallel.axis_comm(mesh, 'space')
    lo, hi = comm.slab(n)
    x = torch.arange(lo, hi, dtype=torch.float64)[:, None] * torch.ones(3)
    need = _comm.halo_need(n, comm.size, w)
    return need[comm.index], _np(comm.halo(x, n, need))
