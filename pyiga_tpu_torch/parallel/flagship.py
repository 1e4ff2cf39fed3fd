# -*- coding: utf-8 -*-
"""The flagship pipeline over the ranks of a mesh (port of
:mod:`pyiga_tpu.parallel.flagship`), in native float64.

The single-card headline path is

    geometry fields (K1) -> banded folded chains (K2 stages, one K3 fold)
    -> the flat banded layout -> ``cg_ir``: f32 CG on the flat banded
    matvec (K4 f32) preconditioned by the weighted fastdiag, refined by
    f64 residuals (K4 f64)

(``StiffnessAssembler.assemble_banded`` + ``solvers.cg_ir``).  Here each
``'space'`` rank runs it on its slab of the first dof axis:

* the rank's rows of the flat banded layout come from the chains of the
  rows ``[lo - b, hi + b)`` (b the first axis's bandwidth): the direct
  box of each band combo is the slab's own, the mirrored box of the
  symmetric fold reads the rows around it.  K1 runs on the Gauss points
  those rows reach, K2 and K3 on their rows of the banded pair tables;
* :class:`ShardedBandedOperator` keeps the slab's rows of the flat data
  and launches K4 (f64 or f32, by the data's dtype) on the slab's padded
  x, which it fills by a halo exchange of ``b`` planes with the
  neighbouring slabs (:meth:`~pyiga_tpu_torch.parallel._comm.Comm.halo`),
  never by a gather;
* ``cg_ir``'s dot products and norms are reduced over ``'space'``;
* the weighted fastdiag preconditioner transforms along every axis, the
  first one included, so each application gathers the residual from the
  slabs (one ``all_gather`` of the free dofs in float32), applies the
  preconditioner on every rank and keeps the slab's part.

The JAX package runs this pipeline in two-float pairs, its
``ShardedBandedOperatorPair`` the refinement's operator; the H100 has
float64, so the f64 :class:`ShardedBandedOperator` is that operator here
and the pair is not ported.
"""

import numpy as np
import torch

from ..config import get_dtype
from . import _comm
from . import axis_comm, _gauss_range, _on_device, _slice_geo, rank_device


class ShardedBandedOperator:
    """The flat banded operator of `bws` and `ns` over the mesh's
    ``'space'`` ranks: `D` holds this rank's rows of the flat ``(C, F)``
    layout, ``(C, (hi - lo) * prod(ns[1:]))`` for its slab ``[lo, hi)``
    of the first axis.  Callable on the slab's part of a raveled vector;
    its dtype is `D`'s (K4 f64 or f32 on the card, the plain version on
    the CPU).  Every rank of the axis calls it together (the halo
    exchange)."""

    def __init__(self, D, bws, ns, mesh):
        from ..ops.banded import flat_banded_layout
        self.bws, self.ns = tuple(bws), tuple(ns)
        self.space = axis_comm(mesh, 'space')
        self.lo, self.hi = self.space.slab(self.ns[0])
        self.s0 = int(np.prod(self.ns[1:]))
        lay = flat_banded_layout(self.bws, self.ns)
        self.lead, self.C = lay['lead'], lay['C']
        self.F = (self.hi - self.lo) * self.s0
        if tuple(D.shape) != (self.C, self.F):
            raise ValueError('D must be this slab\'s (C, F) = (%d, %d), '
                             'got %s' % (self.C, self.F, tuple(D.shape)))
        self.D = D.contiguous()
        self.dtype, self.device = D.dtype, D.device
        self.shape = (self.F, self.F)
        self.slab_ns = (self.hi - self.lo,) + self.ns[1:]
        self.need = _comm.halo_need(self.ns[0], self.space.size,
                                    self.bws[0])
        self._offs = torch.as_tensor(lay['offs'], device=D.device)

    @property
    def operands(self):
        return {'D': self.D}

    def to(self, dtype):
        """The same operator with its data cast to `dtype`."""
        op = object.__new__(ShardedBandedOperator)
        op.__dict__.update(self.__dict__)
        op.D, op.dtype = self.D.to(dtype), dtype
        return op

    def halo_bytes(self):
        """The bytes this rank receives in one matvec's halo exchange."""
        a, c = self.need[self.space.index]
        return ((c - a) - (self.hi - self.lo)) * self.s0 * \
            self.D.element_size()

    def apply_with_operands(self, operands, x):
        from ..ops.banded import flat_banded_matvec
        D = operands['D']
        a, c = self.need[self.space.index]
        # the padded x of the slab (global flat index lo*s0 - lead + p),
        # its rows [a, c) filled by the halo exchange in place
        xp = x.new_zeros(self.F + 2 * self.lead)
        p0 = (a - self.lo) * self.s0 + self.lead
        self.space.halo(x.reshape(self.hi - self.lo, self.s0), self.ns[0],
                        self.need, out=xp[p0:p0 + (c - a) * self.s0].view(
                            c - a, self.s0))
        if self.F == 0:
            return x
        return flat_banded_matvec(D, xp, self._offs, self.lead)

    def matvec(self, x):
        return self.apply_with_operands(self.operands, x)

    __call__ = matvec


class _Flagship:
    """``fn`` of :func:`sharded_flagship_pipeline`: :meth:`assemble`,
    :meth:`solve`, and both by a call."""

    def __init__(self, asm, mesh, dirichlet, tol, inner_tol, maxiter_inner):
        from ..ops import sumfac
        from ..ops.banded import band_info
        from ..ops.fastdiag import fastdiag_precond_weighted, interior_dofs

        self.device = rank_device(mesh)
        self.asm = asm = _on_device(asm, self.device)
        self.mesh = mesh
        self.space = space = axis_comm(mesh, 'space')
        bws = band_info(asm.structure)
        if bws is None:
            raise ValueError('space is not regularly banded')
        self.bws = tuple(bws)
        self.ns = ns = tuple(b[0] for b in asm.structure.bs)
        self.lo, self.hi = lo, hi = space.slab(ns[0])
        b0 = self.bws[0]
        self.a, self.c = max(0, lo - b0), min(ns[0], hi + b0)
        ne = self.c - self.a
        plan = asm._fold()
        self.plan = plan = (plan if plan is not None
                            else [(t, False) for t in range(len(asm.terms))])
        self.any_mirror = any(m for _t, m in plan)
        btabs = asm.tables.banded_term_tables(asm.terms, self.bws)
        self.last_idx = sumfac.last_table_groups([btabs[t] for t, _ in plan])
        n0 = ns[0]
        bsz0 = 2 * b0 + 1
        ext = np.concatenate([np.arange(mu * n0 + self.a, mu * n0 + self.c)
                              for mu in range(bsz0)]) if ne else \
            np.zeros(0, np.int64)
        firsts = list({id(btabs[t][0]): btabs[t][0] for t, _ in plan}
                      .values())
        self.q0, self.q1 = _gauss_range(firsts, ext) if ne else (0, 0)
        dtype = get_dtype()
        done = {}

        def dev(T, key):
            if key not in done:
                done[key] = torch.as_tensor(np.ascontiguousarray(T),
                                            dtype=dtype, device=self.device)
            return done[key]

        self.tabs = []
        for t, mirrored in plan:
            first = btabs[t][0][ext, self.q0:self.q1]
            half = self.any_mirror and not mirrored
            # direct terms enter halved: the mirror adds each combo's
            # box and its transposed box
            first = dev(0.5 * first if half else first,
                        (id(btabs[t][0]), half))
            self.tabs.append([first] + [dev(T, (id(T), False))
                                        for T in btabs[t][1:]])
        free = interior_dofs(asm.kvs) if dirichlet else None
        n_full = int(np.prod(ns))
        s0 = int(np.prod(ns[1:]))
        mask = np.zeros(n_full, dtype=bool)
        mask[free if free is not None else slice(None)] = True
        slab_mask = mask.reshape(ns[0], s0)
        self.free_local = np.nonzero(slab_mask[lo:hi].reshape(-1))[0]
        self.counts = [int(slab_mask[q0:q1].sum())
                       for q0, q1 in space.slabs(ns[0])]
        self.offsets = _comm.offsets(self.counts)
        self.n_free = int(mask.sum())
        self.pc = fastdiag_precond_weighted(asm, dirichlet=dirichlet,
                                            dtype=torch.float32)
        self.tol, self.inner_tol = tol, inner_tol
        self.maxiter_inner = maxiter_inner
        self._ops = None

    def assemble(self):
        """This rank's rows of the flat banded f64 data ``(C, (hi - lo) *
        prod(ns[1:]))`` (in the compute dtype)."""
        from ..convert import geo_inputs as to_device
        from ..ops import cuda_sumfac
        from ..ops.banded import (flat_banded_from_padded_chain,
                                  flat_banded_layout)
        if self.hi == self.lo:
            lay = flat_banded_layout(self.bws, self.ns)
            return torch.zeros((lay['C'], 0), dtype=get_dtype(),
                               device=self.device)
        gi = _slice_geo(to_device(self.asm._geo_inputs, device=self.device),
                        self.q0, self.q1)
        F = self.asm.field_fn(gi)
        Z = cuda_sumfac.chain_folded(self.tabs, [F[t] for t, _ in self.plan],
                                     self.last_idx)
        return flat_banded_from_padded_chain(Z, self.bws, self.ns,
                                             self.any_mirror, a=self.a,
                                             lo=self.lo, hi=self.hi)

    def operators(self, D):
        """The restricted f64 and f32 operators of the slab's data `D`
        (built on the first call, their data replaced on later ones: the
        restriction's box is found once)."""
        from ..ops.matfree import RestrictedOperator
        if self._ops is None:
            hi_op = ShardedBandedOperator(D, self.bws, self.ns, self.mesh)
            ns = hi_op.slab_ns
            self._ops = (RestrictedOperator(hi_op, self.free_local, ns=ns),
                         RestrictedOperator(hi_op.to(torch.float32),
                                            self.free_local, ns=ns))
        else:
            for op, dt in zip(self._ops, (D.dtype, torch.float32)):
                op.op.D = D.to(dt).contiguous()
        return self._ops

    def precond(self, r):
        """The weighted fastdiag on the residual gathered from the
        slabs; returns the slab's part."""
        i = self.space.index
        z = self.pc(self.space.gather(r, self.counts))
        return z[self.offsets[i]:self.offsets[i + 1]]

    def local(self, b):
        """This rank's part of a whole vector of the free dofs."""
        i = self.space.index
        return b[self.offsets[i]:self.offsets[i + 1]]

    def solve(self, D, b):
        """``cg_ir`` on the slab's operators of `D` from the whole
        right-hand side `b`; returns ``(u, info)``: the whole solution on
        every rank and the packed info (:func:`~pyiga_tpu_torch.solvers.
        cg_ir_info`)."""
        from ..solvers import cg_ir_traceable
        A_hi, A_lo = self.operators(D)
        run, hi_ops, lo_ops, pc_ops = cg_ir_traceable(
            A_hi, A_lo, tol=self.tol, inner_tol=self.inner_tol,
            maxiter_inner=self.maxiter_inner, precond_lo=self.precond,
            dot=self.space.dot)
        u, info = run(self.local(b), hi_ops, lo_ops, pc_ops)
        return self.space.gather(u, self.counts), info

    def __call__(self, b):
        D = self.assemble()
        u, info = self.solve(D, b)
        return D, u, info


def sharded_flagship_pipeline(asm, mesh, *, dirichlet=True, tol=1e-8,
                              inner_tol=1e-3, maxiter_inner=200):
    """The flagship assemble+solve program of a stiffness Gauss assembler
    over the mesh's ``'space'`` ranks, in float64 (see the module's
    docstring).

    Returns ``(fn, args)``: ``fn(*args)`` returns ``(D, u, info)``: this
    rank's rows of the flat banded f64 data (``(C, (hi - lo) *
    prod(ns[1:]))``), the solution of ``A u = b`` on the homogeneous
    Dirichlet interior dofs (whole, on every rank) and the packed
    ``cg_ir`` info (:func:`~pyiga_tpu_torch.solvers.cg_ir_info`).  `args`
    is ``(b,)``, ``b = RandomState(0).rand(n_free)`` on this rank's
    device.  ``fn.assemble()`` and ``fn.solve(D, b)`` run the two halves
    (``fn.ns``: the dofs per axis); the preconditioner is built with
    ``fn``, outside both.  Every rank of the mesh calls it together."""
    fn = _Flagship(asm, mesh, dirichlet, tol, inner_tol, maxiter_inner)
    b = torch.as_tensor(np.random.RandomState(0).rand(fn.n_free),
                        dtype=torch.float64, device=fn.device)
    return fn, (b,)
