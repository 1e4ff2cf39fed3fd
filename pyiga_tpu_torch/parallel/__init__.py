# -*- coding: utf-8 -*-
"""Multi-device (SPMD) execution over ``torch.distributed`` (port of
:mod:`pyiga_tpu.parallel`).

The JAX package annotates shardings over a ``jax.sharding.Mesh`` and lets
XLA place the collectives.  Here every rank is a process with its shard
as a plain tensor on its own device, and the collectives are written out
in one place (:mod:`._comm`: the ``'space'`` halo exchange, the
``all_reduce`` of dot products, the ``all_gather`` of results):

* **Assembly**: each ``'space'`` rank owns a contiguous slab of the first
  dof axis (uneven and empty slabs allowed) and assembles the level-0
  rows of the compact data that its slab owns: the geometry fields (K1)
  on the Gauss points its rows' supports reach, then the contraction
  chains (K2 stages, one K3 fold) over its rows of the first axis's pair
  tables.  No rank forms the whole field tensor.
* **Solvers**: dof vectors split the same way; a matvec receives the
  planes its rows couple to from the neighbouring slabs (a halo
  exchange), and CG dot products are reduced over ``'space'``.
* A second mesh axis ``'rhs'`` splits batched right-hand sides.
* **Multipatch**: the patch axis goes over ``'space'``; each rank
  assembles its patches and an ``all_gather`` returns the stack.

Ranks are started by the caller (``torchrun``, or
:class:`~pyiga_tpu_torch.parallel._launch.RankPool` and
``__graft_entry__.dryrun_multichip`` of this package, which meet through
a file store); :func:`make_mesh` joins them into a
:class:`torch.distributed.device_mesh.DeviceMesh`.  With no process group
a mesh of one rank starts one of its own.  The flagship f64 pipeline
(fields, banded chains, the flat banded K4 matvec on each slab, the
weighted fastdiag preconditioner, ``cg_ir``) is
:mod:`~pyiga_tpu_torch.parallel.flagship`.
"""

import copy
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..config import get_dtype
from ..ops import sumfac
from ._comm import Comm, halo_need

_HOW = ("start that many ranks first: torchrun --nproc-per-node=N, "
        "pyiga_tpu_torch.parallel._launch.RankPool(N), or "
        "pyiga_tpu_torch.__graft_entry__.dryrun_multichip(N)")


def make_mesh(n_devices=None, shape=None, axis_names=('space', 'rhs'),
              devices=None, device=None):
    """A :class:`~torch.distributed.device_mesh.DeviceMesh` over the
    ranks of the default process group.  By default all ranks on a 1D
    ``'space'`` axis (two names: a ``(n, 1)`` mesh); `shape` makes it
    ``(space, rhs)``.  A mesh of fewer ranks than the group holds is
    repeated over the group on a leading ``'replica'`` axis, so that every
    rank runs it (the group's size must be a multiple of the mesh's).

    The rank's device is ``cuda:<local rank % device_count>`` (local rank:
    ``LOCAL_RANK``, else the rank), ``devices[rank]`` where `devices` is
    given, or the CPU for ``device='cpu'``; :func:`rank_device` returns
    it.  Several ranks on one card need the ``'gloo'`` backend.

    Raises ``RuntimeError`` (instead of building a smaller mesh) when
    fewer ranks exist than asked for, and when NCCL ranks would share a
    card.  Without a process group a mesh of one rank starts a group of
    one (NCCL on the card, gloo on the CPU)."""
    want = n_devices if n_devices is not None else (
        int(np.prod(shape)) if shape is not None else None)
    cpu = device is not None and torch.device(device).type == 'cpu'
    if not dist.is_initialized():
        if want not in (None, 1):
            raise RuntimeError(
                'make_mesh: requested %d ranks but torch.distributed has '
                'no process group; %s' % (want, _HOW))
        dist.init_process_group('gloo' if cpu else 'nccl',
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    world, rank = dist.get_world_size(), dist.get_rank()
    if want is not None and world < want:
        raise RuntimeError(
            'make_mesh: requested %d ranks but only %d exist; %s'
            % (want, world, _HOW.replace('N', str(want))))
    if want is None:
        want = world
    if world % want:
        raise ValueError('make_mesh: %d ranks do not split into meshes of '
                         '%d' % (world, want))
    if shape is None:
        shape = (want, 1) if len(axis_names) == 2 else (want,)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != want:
        raise ValueError('make_mesh: shape %s holds %d ranks, not %d'
                         % (shape, int(np.prod(shape)), want))
    if devices is not None:
        dev = torch.device(devices[rank])
    elif cpu:
        dev = torch.device('cpu')
    else:
        count = torch.cuda.device_count()
        if dist.get_backend() == 'nccl' and world > count:
            raise RuntimeError(
                'make_mesh: %d NCCL ranks but %d cards; ranks share a card '
                "only under backend='gloo'" % (world, count))
        local = int(os.environ.get('LOCAL_RANK', rank))
        dev = torch.device('cuda', local % count)
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    names = tuple(axis_names[:len(shape)])
    ranks = torch.arange(world)
    if world > want:
        shape, names = (world // want,) + shape, ('replica',) + names
    mesh = DeviceMesh(dev.type, ranks.reshape(shape), mesh_dim_names=names)
    mesh.pyiga_device = dev
    return mesh


def rank_device(mesh):
    """This rank's device in `mesh` (:func:`make_mesh`)."""
    dev = getattr(mesh, 'pyiga_device', None)
    if dev is not None:
        return dev
    if mesh.device_type == 'cuda':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh, name):
    """The size of `mesh`'s axis `name` (1 for an axis it lacks), as
    ``mesh.shape[name]`` of a JAX mesh."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(name)) if name in names else 1


def axis_comm(mesh, name):
    """This rank's :class:`~pyiga_tpu_torch.parallel._comm.Comm` over the
    axis `name` of `mesh` (a group of one for an axis it lacks)."""
    names = mesh.mesh_dim_names or ()
    group = mesh.get_group(name) if name in names else None
    return Comm(group, rank_device(mesh))


def _on_device(asm, device):
    """`asm` (a Gauss assembler of :mod:`~pyiga_tpu_torch.assemblers`) on
    `device`: itself, or a copy sharing its host tables with empty device
    caches."""
    if asm.device == device:
        return asm
    twin = copy.copy(asm)
    twin.device = device
    twin._jac_dev, twin._compact_ops, twin._windowed_ops = {}, {}, {}
    return twin


def _gauss_range(tables, rows):
    """``[q0, q1)``: the Gauss points where any of the `tables` (rows
    against Gauss points) is nonzero in `rows`."""
    nz = np.zeros(tables[0].shape[1], dtype=bool)
    for T in tables:
        nz |= np.any(np.asarray(T)[rows] != 0, axis=0)
    idx = np.nonzero(nz)[0]
    return (int(idx[0]), int(idx[-1]) + 1) if len(idx) else (0, 0)


def _slice_geo(gi, q0, q1):
    """Geometry tensors (:meth:`~pyiga_tpu_torch.assemblers.
    BaseGaussAssembler.geo_inputs`) restricted to the Gauss points
    ``[q0, q1)`` of the first axis."""
    out = dict(gi)
    out['weights'] = [gi['weights'][0][q0:q1]] + list(gi['weights'][1:])
    for key in ('geo_tables_bsp', 'geo_tables_nurbs'):
        if key in gi:
            out[key] = ([gi[key][0][:, q0:q1].contiguous()]
                        + list(gi[key][1:]))
    if 'jac' in gi:
        out['jac'] = gi['jac'][:, :, q0:q1].contiguous()
    return out


def _upload(term_tables, device):
    """Host term tables as tensors of the compute dtype on `device`, each
    distinct array once (the tables' identities, which the last-table
    groups follow, carry over)."""
    dtype, done = get_dtype(), {}

    def up(T):
        if id(T) not in done:
            done[id(T)] = torch.as_tensor(np.ascontiguousarray(T),
                                          dtype=dtype, device=device)
        return done[id(T)]
    return [[up(T) for T in tabs] for tabs in term_tables]


class _CompactRows:
    """One rank's share of a compact assembly over the first axis: the
    level-0 pairs ``[r0, r1)`` whose rows lie in the slab ``[lo, hi)``,
    the Gauss points ``[q0, q1)`` their tables reach, and every rank's
    pair counts."""

    def __init__(self, asm, space):
        S = asm.structure
        self.ns = tuple(b[0] for b in S.bs)
        rows = S.bidx[0][:, 0].astype(np.int64)
        if np.any(np.diff(rows) < 0):
            raise ValueError('the first level\'s pairs must be sorted by row')
        cuts = [(int(np.searchsorted(rows, lo)),
                 int(np.searchsorted(rows, hi)))
                for lo, hi in space.slabs(self.ns[0])]
        self.counts = [b - a for a, b in cuts]
        self.lo, self.hi = space.slab(self.ns[0])
        self.r0, self.r1 = cuts[space.index]
        host = asm.tables.term_tables(asm.terms)
        self.host_tables = host
        self.last_idx = sumfac.last_table_groups(host)
        self.q0, self.q1 = _gauss_range(
            list({id(t[0]): t[0] for t in host}.values()),
            slice(self.r0, self.r1))

    def data(self, field_fn, geo_inputs, term_tables):
        """The slab's rows of the compact data ``(r1 - r0, nnz_2, ...)``
        (chains over unfolded terms, as ``assemble_terms``)."""
        rest = tuple(T.shape[0] for T in term_tables[0][1:])
        if self.r1 == self.r0:
            w = geo_inputs['weights'][0]
            return w.new_zeros((0,) + rest)
        fields = field_fn(_slice_geo(geo_inputs, self.q0, self.q1))
        tabs = [[T[0][self.r0:self.r1, self.q0:self.q1].contiguous()]
                + list(T[1:]) for T in term_tables]
        return sumfac.assemble_terms(tabs, fields, last_idx=self.last_idx)


def sharded_stiffness_step(asm, mesh, cg_iters=8, num_rhs=None):
    """The multi-rank step of a Gauss assembler: assemble the compact data
    tensor (each ``'space'`` rank its slab's level-0 rows: K1 on the Gauss
    points they reach, K2 stages and one K3 fold over its rows of the
    first axis's pair tables), then run `cg_iters` fixed CG steps on
    `num_rhs` right-hand sides (default: the ``'rhs'`` axis's size) split
    over ``'rhs'``, each matvec on the slab's rows after a halo exchange of
    x and each dot product reduced over ``'space'``.

    Returns ``(fn, args)``; ``fn(geo_inputs, term_tables, B)`` returns
    ``(data, X)``, both gathered on every rank: data ``(nnz_1, ...,
    nnz_d)``, X ``(num_rhs, n)``.  `args` are the assembler's geometry
    tensors and term tables on this rank's device in the compute dtype
    and ``B = RandomState(0).rand(num_rhs, n)``."""
    from ..ops.mlmatvec import ml_matvec

    device = rank_device(mesh)
    space, rhs = axis_comm(mesh, 'space'), axis_comm(mesh, 'rhs')
    if num_rhs is None:
        num_rhs = rhs.size
    S = asm.structure
    ns = tuple(b[0] for b in S.bs)
    n0, rest = ns[0], ns[1:]
    s0 = int(np.prod(rest))
    part = _CompactRows(asm, space)
    lo, hi = part.lo, part.hi
    nl = hi - lo
    bx0 = S.bidx[0].astype(np.int64)
    w = int(np.max(np.abs(bx0[:, 0] - bx0[:, 1])))
    need = halo_need(n0, space.size, w)
    a, c = need[space.index]
    local = bx0[part.r0:part.r1] - np.array([lo, a])
    bidx = [torch.as_tensor(local, device=device)] + [
        torch.as_tensor(bx.astype(np.int64), device=device)
        for bx in S.bidx[1:]]
    b0, b1 = rhs.slab(num_rhs)
    nb = b1 - b0
    rhs_counts = [q1 - q0 for q0, q1 in rhs.slabs(num_rhs)]
    row_counts = [q1 - q0 for q0, q1 in space.slabs(n0)]
    field_fn = asm.field_fn

    def step(geo_inputs, term_tables, B):
        data = part.data(field_fn, geo_inputs, term_tables)

        def matvec(X):
            Xp = space.halo(X.reshape(nb, nl, s0), n0, need, dim=1)
            return torch.stack([ml_matvec(data, bidx, (nl,) + rest,
                                          (c - a,) + rest, Xp[k]).reshape(-1)
                                for k in range(nb)])

        def dots(U, V):
            return space.sum(torch.stack([torch.vdot(U[k], V[k])
                                          for k in range(nb)]))

        X = B[b0:b1].reshape(nb, n0, s0)[:, lo:hi].reshape(nb, -1)
        if nb:
            Bl = X
            X = torch.zeros_like(Bl)
            R = Bl - matvec(X)
            P, rz = R, dots(R, R)
            for _ in range(cg_iters):
                AP = matvec(P)
                alpha = rz / dots(P, AP)
                X = X + alpha[:, None] * P
                R = R - alpha[:, None] * AP
                rz_new = dots(R, R)
                P = R + (rz_new / rz)[:, None] * P
                rz = rz_new
        data = space.gather(data, part.counts)
        X = space.gather(X.reshape(nb, nl, s0), row_counts, dim=1)
        return data, rhs.gather(X.reshape(nb, n0 * s0), rhs_counts)

    B = torch.as_tensor(np.random.RandomState(0).rand(num_rhs, n0 * s0),
                        dtype=get_dtype(), device=device)
    from ..convert import geo_inputs as to_device
    args = (to_device(asm._geo_inputs, device=device),
            _upload(part.host_tables, device), B)
    return step, args


class _MatfreeRows:
    """One rank's share of a matrix-free operator (the chains of
    :class:`~pyiga_tpu_torch.ops.matfree.MatrixFreeOperator`): output
    rows ``[lo, hi)`` of the first axis, the Gauss points ``[q0, q1)``
    their test functions reach, and the trial rows ``need[index]`` those
    points see, for every rank."""

    def __init__(self, asm, space, device):
        dtype = get_dtype()
        terms = asm.terms
        self.ns = tuple(b[0] for b in asm.structure.bs)
        n0 = self.ns[0]
        tt = asm.tables
        trial_combos = sorted(set(du for du, dv in terms))
        test_combos = sorted(set(dv for du, dv in terms))
        test0 = [tt.test[0][c[0]] for c in test_combos]
        trial0 = [tt.trial[0][c[0]] for c in trial_combos]
        ranges = []
        for lo, hi in space.slabs(n0):
            q0, q1 = _gauss_range(test0, slice(lo, hi))
            t0, t1 = _gauss_range([T.T for T in trial0], slice(q0, q1))
            ranges.append((q0, q1, t0, t1) if hi > lo else (0, 0, 0, 0))
        self.need = [(r[2], r[3]) for r in ranges]
        self.q0, self.q1, self.a, self.c = ranges[space.index]
        self.lo, self.hi = space.slab(n0)

        def chain(space_tabs, combo, rows):
            out = []
            for k in range(asm.dim):
                T = space_tabs[k][combo[k]]
                if k == 0:
                    T = T[rows, self.q0:self.q1]
                out.append(torch.as_tensor(np.ascontiguousarray(T.T),
                                           dtype=dtype, device=device))
            return out
        self.trial = [chain(tt.trial, c, slice(self.a, self.c))
                      for c in trial_combos]
        self.test = [chain(tt.test, c, slice(self.lo, self.hi))
                     for c in test_combos]
        self.trial_of_term = [trial_combos.index(du) for du, dv in terms]
        self.test_of_term = [test_combos.index(dv) for du, dv in terms]
        self.field_of_term = list(range(len(terms)))


def sharded_matfree_cg(asm, mesh, free_dofs=None, precond=None,
                       tol=1e-8, maxiter=200):
    """Preconditioned CG with the matrix-free operator of a Gauss
    assembler split over the mesh's ``'space'`` axis (a compiled VForm's
    operator is not split: ``MatrixFreeOperator`` runs it on one rank):
    each rank keeps the coefficient fields (K1) on the Gauss points its
    slab's test functions reach and applies
    :class:`~pyiga_tpu_torch.ops.matfree.MatrixFreeOperator`'s chains
    there, on the trial rows it receives by a halo exchange; CG dot
    products are reduced over ``'space'``.  With `free_dofs` the solve is
    on those dofs (vectors of their length), its operator
    ``A[free][:, free]``.  `precond`, if given, is a callable on a whole
    vector (of the free dofs); it runs on every rank on the residual
    gathered from the slabs.

    Returns ``(solve, operands)``: ``solve(operands, b)`` takes `b`
    whole on every rank and returns ``(x, iterations)``, x whole on every
    rank, after ``||r|| <= tol ||b||`` or `maxiter` steps."""
    from ..convert import geo_inputs as to_device
    from ..ops.matfree import matfree_apply

    if not hasattr(asm, 'field_fn'):
        raise TypeError('sharded_matfree_cg takes a Gauss assembler '
                        '(pyiga_tpu_torch.assemblers), got %s'
                        % type(asm).__name__)
    device = rank_device(mesh)
    space = axis_comm(mesh, 'space')
    part = _MatfreeRows(asm, space, device)
    ns, n0 = part.ns, part.ns[0]
    rest = ns[1:]
    s0 = int(np.prod(rest))
    lo, hi = part.lo, part.hi
    n = n0 * s0
    counts = [q1 - q0 for q0, q1 in space.slabs(n0)]
    fields = []
    if part.q1 > part.q0:
        gi = to_device(asm._geo_inputs, device=device)
        fields = asm.field_fn(_slice_geo(gi, part.q0, part.q1))
    mask = None
    if free_dofs is not None:
        m = np.zeros(n, dtype=bool)
        m[np.asarray(free_dofs)] = True
        mask = torch.as_tensor(m.reshape(n0, s0)[lo:hi].reshape(-1),
                               dtype=get_dtype(), device=device)
        free_t = torch.as_tensor(np.asarray(free_dofs, np.int64),
                                 device=device)

    def apply(ops, x):
        xp = space.halo(x.reshape(hi - lo, s0), n0, part.need)
        if hi == lo:
            return x
        y = matfree_apply(part.trial, part.test, ops['fields'],
                          part.trial_of_term, part.test_of_term,
                          part.field_of_term, (part.c - part.a,) + rest,
                          (hi - lo,) + rest, xp.reshape(-1))
        return y if mask is None else y * mask

    def whole(v):
        v = space.gather(v.reshape(hi - lo, s0), counts).reshape(-1)
        return v if mask is None else v[free_t]

    def local(v):
        if mask is not None:
            full = v.new_zeros(n)
            full[free_t] = v
            v = full
        return v.reshape(n0, s0)[lo:hi].reshape(-1)

    pc = (lambda r: r) if precond is None else (
        lambda r: local(precond(whole(r))))

    def rz_rr(r, z):
        """``(r . z, r . r)`` in one reduction."""
        return space.sum(torch.stack([torch.dot(r, z), torch.dot(r, r)]))

    def solve(operands, b):
        b = local(torch.as_tensor(b, dtype=get_dtype(), device=device))
        r = b
        x = torch.zeros_like(b)
        z = pc(r)
        rz, rr = rz_rr(r, z)
        stop = tol * torch.sqrt(rr)
        p, it = z, 0
        while it < maxiter and bool(torch.sqrt(rr) > stop):
            Ap = apply(operands['mv'], p)
            alpha = rz / space.dot(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            z = pc(r)
            rz_new, rr = rz_rr(r, z)
            p = z + (rz_new / rz) * p
            rz = rz_new
            it += 1
        return whole(x), it

    return solve, {'mv': {'fields': fields}, 'pc': precond}


def _geo_shapes(asm):
    return tuple(sorted((k, tuple(np.shape(a) for a in v)
                         if isinstance(v, list) else np.shape(v))
                        for k, v in asm._geo_inputs.items()))


def _gather_patches(space, n_patches, local, shape, dtype):
    """Stack this rank's patch results `local` and gather them over
    `space` into ``(n_patches,) + shape`` (float64 numpy)."""
    counts = [q1 - q0 for q0, q1 in space.slabs(n_patches)]
    device = space.device
    mine = (torch.stack(local) if local
            else torch.zeros((0,) + tuple(shape), dtype=dtype, device=device))
    return space.gather(mine, counts).cpu().numpy().astype(np.float64)


def sharded_multipatch_data(asms, mesh, mode='exact'):
    """The compact data tensors of many patches, the patch axis over the
    mesh's ``'space'`` ranks: each rank assembles its slab of patches
    (``run_device``: K1, K2 stages, one K3 fold, the mirror of the folded
    terms) and an ``all_gather`` returns the stack (the reference's loop
    over patches, ``assemble.py:1337``; the shared-dof scatter ``X A_p
    X^T`` stays on the host).  All assemblers must share knot vectors and
    geometry structure.  `mode` is accepted as ``run_device`` takes it.
    Returns the ``(n_patches, nnz_1, ..., nnz_d)`` float64 array on every
    rank."""
    if len({_geo_shapes(a) for a in asms}) != 1:
        raise ValueError('sharded_multipatch_data: patches must share knot '
                         'vectors and geometry structure (unequal geo-input '
                         'shapes)')
    device = rank_device(mesh)
    space = axis_comm(mesh, 'space')
    p0, p1 = space.slab(len(asms))
    local = [_on_device(a, device).run_device(mode) for a in asms[p0:p1]]
    shape = tuple(len(bx) for bx in asms[0].structure.bidx)
    return _gather_patches(space, len(asms), local, shape, get_dtype())


def sharded_multipatch_vform_data(asms, mesh, mode='exact'):
    """Per-patch block data of a compiled VForm for many patches, the
    patch axis over the mesh's ``'space'`` ranks (the generalization of
    :func:`sharded_multipatch_data`): each rank runs its patches'
    ``run_device`` (K1 ``jac``, K5, K2 stages, K3) and an ``all_gather``
    returns each block's stack.  The assemblers must come from the same
    compiled form on the same knot vectors, on this rank's device.
    Returns the dict of blocks, each ``(n_patches, nnz_1, ...,
    nnz_d)`` float64 on every rank."""
    a0 = asms[0]
    if mode == 'ozaki':
        mode = 'exact'
    combos0 = tuple(map(repr, a0.combos))
    for a in asms:
        if tuple(map(repr, a.combos)) != combos0:
            raise ValueError('sharded_multipatch_vform_data: patches '
                             'pruned to different combo sets')
        # content equality, not just structure: every patch's tables come
        # from its own knot vectors, but the stack needs one shape
        if a.kvs0 != a0.kvs0 or a.kvs1 != a0.kvs1:
            raise ValueError('sharded_multipatch_vform_data: patches must '
                             'share knot vectors')
    if len({type(a.geo).__name__ for a in asms}) != 1:
        raise ValueError('sharded_multipatch_vform_data: patches must '
                         'share knot vectors and geometry structure')
    device = rank_device(mesh)
    for a in asms:
        if a.device != device:
            raise ValueError('sharded_multipatch_vform_data: an assembler '
                             'on %s, this rank runs on %s'
                             % (a.device, device))
    space = axis_comm(mesh, 'space')
    p0, p1 = space.slab(len(asms))
    local = [a.run_device(mode) for a in asms[p0:p1]]
    keys = sorted(a0._block_plans(), key=repr)
    shape = tuple(len(bx) for bx in a0.structure.bidx)
    return {k: _gather_patches(space, len(asms), [blk[k] for blk in local],
                               shape, get_dtype()) for k in keys}


def multipatch_assemble_system(mp, mesh, problem='stiffness', args=None,
                               mode='exact'):
    """Global multipatch system matrix for any bilinear form, the patches
    assembled over the mesh's ``'space'`` ranks
    (:func:`sharded_multipatch_vform_data`), then scattered on the host as
    ``sum_p X_p A_p X_p^T`` over the shared-dof numbering (the matrix part
    of ``Multipatch.assemble_system``, reference assemble.py:1337-1368).

    `problem` is ``'stiffness'``, ``'mass'``, a
    :class:`~pyiga_tpu_torch.vform.VForm` or a form string (parsed against
    the first patch); `args` are further assembler inputs for every patch
    (``geo`` is set per patch).  Vector forms scatter component-major.
    Returns the scipy CSR matrix on every rank."""
    import scipy.sparse

    from .. import vform as vf_mod
    from ..compile import compile_vform

    args = dict(args or {})
    kvs0, geo0 = mp.patches[0]
    dim = len(kvs0)
    if isinstance(problem, str) and problem in ('stiffness', 'mass'):
        vf = (vf_mod.stiffness_vf(dim) if problem == 'stiffness'
              else vf_mod.mass_vf(dim))
    elif isinstance(problem, vf_mod.VForm):
        vf = problem
    else:
        vf = vf_mod.parse_vf(problem, kvs0, args=dict(args, geo=geo0))
    if vf.arity != 2:
        raise ValueError('multipatch_assemble_system assembles bilinear '
                         'forms; use assemble() per patch for functionals')
    cls = compile_vform(vf)
    device = rank_device(mesh)
    asms = [cls(kvs, device=device, **dict(args, geo=geo))
            for (kvs, geo) in mp.patches]
    blocks = sharded_multipatch_vform_data(asms, mesh, mode=mode)

    n = mp.numdofs
    if not vf.vec:
        A = scipy.sparse.csr_matrix((n, n))
        for p, asm in enumerate(asms):
            X = mp.patch_to_global(p)
            A_p = asm.structure.make_mlmatrix(
                data=blocks[(None, None)][p]).asmatrix('csr')
            A = A + X @ A_p @ X.T
        return A

    ncu, ncv = (c or 1 for c in asms[0].vf.num_components()[:2])
    A = scipy.sparse.csr_matrix((ncv * n, ncu * n))
    zero = scipy.sparse.csr_matrix(asms[0].structure.shape)
    for p, asm in enumerate(asms):
        X = mp.patch_to_global(p)
        rows = [[(asm.structure.make_mlmatrix(
                    data=blocks[(cu, cv)][p]).asmatrix('csr')
                  if (cu, cv) in blocks else zero)
                 for cu in range(ncu)] for cv in range(ncv)]
        A_p = scipy.sparse.bmat(rows, format='csr')
        X_blk = scipy.sparse.kron(scipy.sparse.eye(ncv), X, format='csr')
        X_blk_u = scipy.sparse.kron(scipy.sparse.eye(ncu), X, format='csr')
        A = A + X_blk @ A_p @ X_blk_u.T
    return A


def multipatch_assemble_stiffness(mp, mesh, mode='exact'):
    """Global multipatch stiffness matrix, the patches assembled over the
    mesh's ``'space'`` ranks (:func:`sharded_multipatch_data`), then
    ``sum_p X_p A_p X_p^T`` on the host: the matrix part of
    ``Multipatch.assemble_system('stiffness', ...)`` for patches of one
    space."""
    import scipy.sparse

    from ..assemblers import StiffnessAssembler

    device = rank_device(mesh)
    asms = [StiffnessAssembler(kvs, geo, device=device)
            for (kvs, geo) in mp.patches]
    data = sharded_multipatch_data(asms, mesh, mode=mode)
    n = mp.numdofs
    A = scipy.sparse.csr_matrix((n, n))
    for p, asm in enumerate(asms):
        X = mp.patch_to_global(p)
        A_p = asm.structure.make_mlmatrix(data=data[p]).asmatrix('csr')
        A = A + X @ A_p @ X.T
    return A


def dryrun(n_devices, dim=3, nspans=4, p=3, cg_iters=4, check_parity=True,
           device=None):
    """Run one sharded assemble+solve step on an `n_devices`-rank mesh
    at small shapes (default the flagship workload: 3D degree-3 stiffness
    assembly and CG; a ``(n/2, 2)`` ``('space', 'rhs')`` mesh for an even
    `n`, else ``(n,)``), the matrix-free mass CG over the mesh, and the
    f64 flagship pipeline (:mod:`.flagship`) on a 2D problem.  With
    `check_parity` each is also run on a mesh of one rank and held to it:
    the data and iterates to 1e-10, the flagship's banded data to 1e-10,
    its solution to 1e-6 and its ``cg_ir`` counts exactly.  Every rank of
    the process group calls it.  `device` as in :func:`make_mesh`.
    Returns ``(data, X)``."""
    from .. import geometry
    from ..assemblers import MassAssembler, StiffnessAssembler
    from ..bspline import make_knots
    from ..solvers import cg_ir_info
    from .flagship import sharded_flagship_pipeline

    even = n_devices % 2 == 0 and n_devices > 1
    mesh = make_mesh(shape=(max(1, n_devices // 2), 2) if even
                     else (n_devices,),
                     axis_names=('space', 'rhs') if even else ('space',),
                     device=device)
    dev = rank_device(mesh)
    kvs = dim * (make_knots(p, 0.0, 1.0, nspans),)
    geo = (geometry.quarter_annulus() if dim == 2
           else geometry.twisted_box())
    asm = StiffnessAssembler(kvs, geo, device=dev)
    step, args = sharded_stiffness_step(asm, mesh, cg_iters=cg_iters)
    data, X = step(*args)

    # the matrix-free CG over the mesh (mass system: SPD and well
    # conditioned)
    masm = MassAssembler(kvs, geo, device=dev)
    solve, ops_ = sharded_matfree_cg(masm, mesh, tol=1e-8, maxiter=200)
    n = int(np.prod([kv.numdofs for kv in kvs]))
    b = np.random.RandomState(1).rand(n)
    x, it = solve(ops_, b)
    if not bool(torch.isfinite(x).all()):
        raise AssertionError('sharded matrix-free CG: no finite solution')

    data, X = data.cpu().numpy(), X.cpu().numpy()
    mesh1 = make_mesh(n_devices=1, shape=(1,), axis_names=('space',),
                      device=device) if check_parity else None
    if check_parity:
        step1, args1 = sharded_stiffness_step(asm, mesh1, cg_iters=cg_iters,
                                              num_rhs=X.shape[0])
        d1, x1 = step1(*args1)
        scale = max(1.0, float(np.abs(data).max()))
        err_d = float(np.abs(data - d1.cpu().numpy()).max()) / scale
        err_x = float(np.abs(X - x1.cpu().numpy()).max()) / max(
            1.0, float(np.abs(X).max()))
        if err_d > 1e-10 or err_x > 1e-10:
            raise AssertionError(
                'multi-device parity failed: data err %.2e, solution err '
                '%.2e (tol 1e-10)' % (err_d, err_x))

    # the flagship f64 pipeline over the same mesh, held to its run on
    # one rank
    kvs2 = 2 * (make_knots(max(p, 2), 0.0, 1.0, 2 * nspans),)
    asm2 = StiffnessAssembler(kvs2, geometry.quarter_annulus(), device=dev)
    fnN, argsN = sharded_flagship_pipeline(asm2, mesh)
    DN, uN, infoN = fnN(*argsN)
    if check_parity:
        fn1, args1 = sharded_flagship_pipeline(asm2, mesh1)
        D1, u1, info1 = fn1(*args1)
        space = axis_comm(mesh, 'space')
        counts = [q1 - q0 for q0, q1 in space.slabs(fnN.ns[0])]
        s0 = int(np.prod(fnN.ns[1:]))
        DN = space.gather(DN.reshape(DN.shape[0], -1, s0), counts, dim=1)
        DN = DN.reshape(D1.shape)
        err_D = float((DN - D1).abs().max()) / max(
            1.0, float(D1.abs().max()))
        err_u = float(torch.linalg.vector_norm(uN - u1)) / max(
            1.0, float(torch.linalg.vector_norm(u1)))
        cN, c1 = cg_ir_info(infoN), cg_ir_info(info1)
        if err_D > 1e-10 or err_u > 1e-6 or \
                cN['inner_iters'] != c1['inner_iters']:
            raise AssertionError(
                'flagship multi-device parity failed: banded err %.2e '
                '(tol 1e-10), solution err %.2e (tol 1e-6), counts %s vs '
                '%s' % (err_D, err_u, cN['inner_iters'], c1['inner_iters']))
    return data, X
