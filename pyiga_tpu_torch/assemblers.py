# -*- coding: utf-8 -*-
"""Gauss assemblers built on the sum-factorization engine (port of
:mod:`pyiga_tpu.assemblers`: the mass and stiffness assemblers, their
compact and banded solver-layout entry points).

Two entry points share the geometry fields (kernels K2 and K1 for a
spline or NURBS geometry, K1' or a plain expression for a Jacobian
evaluated on the host):

* :meth:`BaseGaussAssembler.assemble` runs the folded contraction chains
  over the compact pair tables (K2 stages, K3 final fold) and returns the
  host :class:`~pyiga_tpu_torch.mlmatrix.MLMatrix` (``run_device`` keeps
  the data on the device);
* :meth:`BaseGaussAssembler.assemble_banded` runs them over the banded
  pair tables and lays the result out for the flat banded matvec (K4),
  returning a :class:`~pyiga_tpu_torch.ops.banded.FlatBandedOperator` in
  the compute dtype on the assembler's device;
* :meth:`BaseGaussAssembler.assemble_windowed` contracts each basis pair
  over its support window only (K8 stages, one K8f fold) and returns the
  host MLMatrix, as :meth:`~BaseGaussAssembler.assemble` does.

All three routes run in the compute dtype
(:func:`~pyiga_tpu_torch.config.get_dtype`): under float32 the geometry
stages, the fields and the chains take the float32 instances of K2, K1
(or K1' for a Jacobian evaluated on the host), K3, K8 and K8f, as the
JAX package casts its inputs and tables to that dtype
(``pyiga_tpu/ops/sumfac.py:650-716``); the host MLMatrix is float64
holding the float32 results.  On the CPU the same pipelines run the
kernels' plain PyTorch versions.
"""

import numpy as np
import torch

from .bspline import KnotVector
from .config import get_dtype, resolve_device
from .mlmatrix import MLStructure, transpose_idx_for_bidx
from .ops import cuda_sumfac, geom, sumfac
from .ops.banded import FlatBandedOperator, band_info


# from a dict of geometry tensors (BaseGaussAssembler.geo_inputs):
# the mass field [W], W = gauss_weight |det J| ...
mass_fields = cuda_sumfac.mass_fields
# ... and B_ab = W (J^-1 J^-T)_ab for all axis pairs (a, b) in level
# order, row-major
stiffness_fields = cuda_sumfac.stiffness_fields


def _unit(d, k):
    e = d * [0]
    e[k] = 1
    return tuple(e)


class BaseGaussAssembler:
    """Shared setup for Gauss assemblers over a TP spline space with
    geometry.  Host setup (quadrature, sparsity, basis tables, geometry
    tables or the host-evaluated Jacobian) is numpy; device tensors are
    made on `device` when assembling (a host Jacobian is uploaded once).
    """

    arity = 2
    numderiv = 1
    # subclasses with a symmetric coefficient field set this to enable
    # symmetric-term folding
    symmetric_fields = False

    def __init__(self, kvs, geo, nqp=None, device=None):
        if isinstance(kvs, KnotVector):
            kvs = (kvs,)
        self.kvs = tuple(kvs)
        self.dim = len(self.kvs)
        self.geo = geo
        if geo.sdim != self.dim:
            raise ValueError('geometry has wrong dimension')
        self.device = resolve_device(device)
        self.grid, self.gweights = sumfac.quadrature_for(self.kvs, nqp)
        self.structure = MLStructure.from_kvs(self.kvs, self.kvs)
        self.tables = sumfac.SpaceTables(self.kvs, self.kvs, self.grid,
                                         self.structure.bidx, self.numderiv)
        self._geo_inputs = self._make_geo_inputs()
        # device tensors memoized per dtype: a switch of set_dtype never
        # reuses tables uploaded in the other one
        self._jac_dev = {}
        self._compact_ops = {}
        self._windowed_ops = {}

    def _make_geo_inputs(self):
        inputs = {'weights': [np.asarray(w) for w in self.gweights]}
        setup = geom.geo_eval_tables(self.geo, self.grid, numderiv=1)
        if setup is None:
            # no spline: the geometry's Jacobian is evaluated on the host
            inputs['jac'] = geom.host_jacobian_levelorder(self.geo, self.grid)
        else:
            tables, coeffs, is_nurbs = setup
            key = 'geo_tables_nurbs' if is_nurbs else 'geo_tables_bsp'
            inputs[key] = list(tables)
            inputs['geo_coeffs'] = coeffs
        return inputs

    def geo_inputs(self, dtype=None, geo_coeffs=None):
        """The geometry inputs as tensors of `dtype` (default the compute
        dtype) on the assembler's device (the host Jacobian of a
        non-spline geometry is uploaded on the first call in a dtype and
        kept).  `geo_coeffs` replaces the spline geometry's
        coefficients (level order, component axis leading) for this call
        and may carry autograd history: the assembly is differentiable in
        them (:mod:`~pyiga_tpu_torch.diff`)."""
        if dtype is None:
            dtype = get_dtype()

        def dev(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype,
                                   device=self.device)
        out = {}
        for k, v in self._geo_inputs.items():
            if k == 'jac':
                if dtype not in self._jac_dev:
                    self._jac_dev[dtype] = dev(v)
                out[k] = self._jac_dev[dtype]
            elif k == 'geo_coeffs' and geo_coeffs is not None:
                continue
            else:
                out[k] = [dev(a) for a in v] if isinstance(v, list) else dev(v)
        if geo_coeffs is not None:
            geom.check_replacement(self._geo_inputs.get('geo_coeffs'),
                                   geo_coeffs, dtype,
                                   out['weights'][0].device)
            out['geo_coeffs'] = geo_coeffs
        return out

    def _fold(self):
        """Symmetric fold plan of the terms (None without mirroring)."""
        if not self.symmetric_fields:
            return None
        plan = sumfac.symmetric_fold_plan(self.terms)
        if plan is None or all(not m for _, m in plan):
            return None
        return plan

    def _compact_operands(self):
        """Device tensors of the compact assembly (memoized per compute
        dtype): the compact pair tables of every term (each distinct host
        table uploaded once), their last-table groups, and the transpose
        permutations of a folded plan."""
        dtype = get_dtype()
        if dtype in self._compact_ops:
            return self._compact_ops[dtype]
        host_tabs = self.tables.term_tables(self.terms)
        uploaded = {}
        for tabs in host_tabs:
            for T in tabs:
                if id(T) not in uploaded:
                    uploaded[id(T)] = torch.as_tensor(
                        np.ascontiguousarray(T), dtype=dtype,
                        device=self.device)
        plan = self._fold()
        tperms = None
        if plan is not None:
            tperms = [torch.as_tensor(transpose_idx_for_bidx(bx),
                                      dtype=torch.int64, device=self.device)
                      for bx in self.structure.bidx]
        ops = dict(
            term_tables=[[uploaded[id(T)] for T in tabs]
                         for tabs in host_tabs],
            last_idx=sumfac.last_table_groups(host_tabs),
            plan=plan or [(t, False) for t in range(len(self.terms))],
            tperms=tperms)
        self._compact_ops[dtype] = ops
        return ops

    def run_device(self, mode=None):
        """Assemble the compact data tensor ``(nnz_1, ..., nnz_d)`` on the
        assembler's device, in the compute dtype (as the JAX package's
        ``run_matrix_assembly``): geometry fields, then the folded chains
        (K2 stages, one K3 fold per term group) and the transpose gather
        of mirrored terms.  `mode` ('exact', 'ozaki' or None) is accepted
        for API compatibility and ignored: the port has one route, the
        exact one (:func:`~pyiga_tpu_torch.config.
        default_assembly_mode`)."""
        return self._assemble_compact(self.geo_inputs())

    def _assemble_compact(self, geo_inputs):
        """The compact data tensor from the geometry tensors `geo_inputs`
        (:meth:`geo_inputs`' dict): the fields (:attr:`field_fn`), the
        folded chains over the cached compact operands and the transpose
        gather.  With `geo_inputs` carrying replaced coefficients this is
        the differentiable route of :mod:`~pyiga_tpu_torch.diff` (the
        counterpart of the JAX package's ``_gauss_assembler_fn``)."""
        ops = self._compact_operands()
        return cuda_sumfac.assemble_terms_folded(
            ops['term_tables'], self.field_fn(geo_inputs), ops['plan'],
            ops['tperms'], ops['last_idx'])

    def assemble(self, mode=None):
        """Assemble and return the matrix as a host
        :class:`~pyiga_tpu_torch.mlmatrix.MLMatrix` over
        :attr:`structure` (`mode` as in :meth:`run_device`).  Its data
        is float64 whatever the compute dtype, as in the JAX package: under
        float32 it holds the float32 results."""
        data = self.run_device(mode)
        return self.structure.make_mlmatrix(
            data=data.cpu().numpy().astype(np.float64))

    def _windowed_operands(self):
        """Device tensors of the windowed assembly (memoized per compute
        dtype): the windowed pair tables of every term (each distinct
        host table uploaded once), the window starts, the banded-flat
        transpose permutations of a folded plan and the banded-flat ->
        compact index maps."""
        dtype = get_dtype()
        if dtype in self._windowed_ops:
            return self._windowed_ops[dtype]
        bws = band_info(self.structure)
        if bws is None:
            raise ValueError('windowed assembly requires a regularly banded '
                             'space')
        host_tabs, fss = self.tables.windowed_term_tables(self.terms)

        def dev(a, dtype=torch.int64):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=self.device)
        # the pair-table cache interns shared tables: one upload each
        uploaded = {}
        for tabs in host_tabs:
            for T in tabs:
                if id(T) not in uploaded:
                    uploaded[id(T)] = dev(T, dtype)
        plan = self._fold()
        ns = tuple(b[0] for b in self.structure.bs)
        tperms = None
        if plan is not None:
            tperms = [dev(sumfac.banded_transpose_perm(n, bw))
                      for n, bw in zip(ns, bws)]
        ops = dict(
            wtabs=[[uploaded[id(T)] for T in tabs] for tabs in host_tabs],
            fss=[dev(f) for f in fss], plan=plan, tperms=tperms,
            cmaps=[dev(m) for m in
                   sumfac.compact_from_banded_maps(self.structure, bws)])
        self._windowed_ops[dtype] = ops
        return ops

    def assemble_windowed(self):
        """Assemble through the windowed pair tables: each basis pair
        contracts only the ``(p+1)*nqp`` Gauss points of its support
        window, ~(2p+1)x fewer multiply-adds than :meth:`assemble`'s
        chains (K8 stages and one K8f fold on the card, then the mirror
        of a symmetric form), and the banded-flat result is taken to the
        compact layout on the device.  Returns the host
        :class:`~pyiga_tpu_torch.mlmatrix.MLMatrix`, equal to
        :meth:`assemble`'s up to rounding (float64 data; under float32
        the float32 results of K8 / K8f's float32 instances, as the JAX
        package's).  Needs a regularly banded space with equal trial and
        test degrees (raises ValueError otherwise)."""
        ops = self._windowed_operands()
        flat = sumfac.run_windowed_assembly(
            self.field_fn, self.geo_inputs(), ops['wtabs'], ops['fss'],
            self.tables.nqps, ops['plan'], ops['tperms'])
        d = flat.dim()
        data = flat[tuple(m.reshape([-1 if a == k else 1 for a in range(d)])
                          for k, m in enumerate(ops['cmaps']))]
        return self.structure.make_mlmatrix(
            data=data.cpu().numpy().astype(np.float64))

    def assemble_banded(self, mode=None):
        """Assemble straight into the flat banded solver layout and return
        the :class:`FlatBandedOperator` in the compute dtype on the
        assembler's device (the data never leaves it; under float32 K4
        then runs its float instance).  `mode` is accepted for API
        compatibility and ignored, as in :meth:`run_device`.  The JAX
        package returns its regular-layout ``BandedOperator`` here; the
        port has that class too
        (:class:`~pyiga_tpu_torch.ops.banded.BandedOperator`, the same K4
        on a reshape), and returns the flat layout that K4 reads."""
        bws = band_info(self.structure)
        if bws is None:
            raise ValueError('space is not regularly banded '
                             '(repeated interior knots?)')
        ns = tuple(b[0] for b in self.structure.bs)
        fold_plan = self._fold()
        plan = (fold_plan if fold_plan is not None
                else [(t, False) for t in range(len(self.terms))])
        any_mirror = any(m for _t, m in plan)
        btabs = self.tables.banded_term_tables(self.terms, bws)
        # group last tables on the host arrays (the pair-table cache
        # interns shared tables), then upload each distinct array once
        last_idx = sumfac.last_table_groups([btabs[t] for t, _m in plan])
        dtype = get_dtype()
        uploaded = {}

        def dev(a):
            if id(a) not in uploaded:
                uploaded[id(a)] = (a, torch.as_tensor(a, dtype=dtype,
                                                      device=self.device))
            return uploaded[id(a)][1]

        tabs = []
        for t, mirrored in plan:
            first = btabs[t][0]
            if any_mirror and not mirrored:
                # direct terms enter halved: the relayout adds each
                # combo's box and its transposed box
                first = 0.5 * first
            tabs.append([dev(first)] + [dev(T) for T in btabs[t][1:]])
        F = self.field_fn(self.geo_inputs())
        D = cuda_sumfac.assemble_flat_banded(
            tabs, [F[t] for t, _m in plan], plan, bws, ns, last_idx)
        return FlatBandedOperator(D, bws, ns)


class MassAssembler(BaseGaussAssembler):
    """Mass matrix assembler: ``A[i,j] = int B_j B_i |det J| dx``."""

    field_fn = staticmethod(mass_fields)

    def __init__(self, kvs, geo, nqp=None, device=None):
        super().__init__(kvs, geo, nqp, device)
        zero = self.dim * (0,)
        self.terms = [(zero, zero)]


class StiffnessAssembler(BaseGaussAssembler):
    """Stiffness matrix assembler:
    ``A[i,j] = int (J^-1 J^-T grad B_j) . grad B_i |det J| dx``."""

    field_fn = staticmethod(stiffness_fields)
    symmetric_fields = True      # B = W J^-1 J^-T is symmetric

    def __init__(self, kvs, geo, nqp=None, device=None):
        super().__init__(kvs, geo, nqp, device)
        d = self.dim
        # order must match stiffness_fields: (a, b) row-major in level order
        self.terms = [(_unit(d, a), _unit(d, b))
                      for a in range(d) for b in range(d)]


# dimension-suffixed aliases of the reference API
class MassAssembler2D(MassAssembler):
    def __init__(self, kvs, geo, nqp=None, device=None):
        if len(kvs) != 2:
            raise ValueError('MassAssembler2D needs a 2D space')
        super().__init__(kvs, geo, nqp, device)


class MassAssembler3D(MassAssembler):
    def __init__(self, kvs, geo, nqp=None, device=None):
        if len(kvs) != 3:
            raise ValueError('MassAssembler3D needs a 3D space')
        super().__init__(kvs, geo, nqp, device)


class StiffnessAssembler2D(StiffnessAssembler):
    def __init__(self, kvs, geo, nqp=None, device=None):
        if len(kvs) != 2:
            raise ValueError('StiffnessAssembler2D needs a 2D space')
        super().__init__(kvs, geo, nqp, device)


class StiffnessAssembler3D(StiffnessAssembler):
    def __init__(self, kvs, geo, nqp=None, device=None):
        if len(kvs) != 3:
            raise ValueError('StiffnessAssembler3D needs a 3D space')
        super().__init__(kvs, geo, nqp, device)


################################################################################
# the reference's predefined VForm assemblers, compiled on first use
################################################################################

def _vform_asm_alias(vf_factory, dim):
    """A named assembler class for a predefined form at a fixed `dim`: an
    instance is an instance of the compiled form's assembler."""
    from .compile import compile_vform

    class _Alias:
        def __new__(cls, kvs, *args, **kwargs):
            return compile_vform(vf_factory(dim))(kvs, *args, **kwargs)

        @staticmethod
        def inputs():
            return compile_vform(vf_factory(dim)).inputs()

        @staticmethod
        def parameters():
            return compile_vform(vf_factory(dim)).parameters()

    return _Alias


def __getattr__(name):
    """The reference's predefined assembler names (``HeatAssembler_ST2D``,
    ``WaveAssembler_ST3D``, ``L2FunctionalAssembler3D``,
    ``L2FunctionalAssemblerPhys2D``, ``DivDivAssembler2D``, ...), one
    class per name."""
    from . import vform as vf_mod
    table = {
        'HeatAssembler_ST': vf_mod.heat_st_vf,
        'WaveAssembler_ST': vf_mod.wave_st_vf,
        'DivDivAssembler': vf_mod.divdiv_vf,
        'L2FunctionalAssembler': vf_mod.L2functional_vf,
        'L2FunctionalAssemblerPhys':
            lambda d: vf_mod.L2functional_vf(d, physical=True),
    }
    for prefix, factory in table.items():
        if name.startswith(prefix) and name[len(prefix):] in ('1D', '2D',
                                                              '3D'):
            cls = _vform_asm_alias(factory, int(name[len(prefix)]))
            cls.__name__ = cls.__qualname__ = name
            globals()[name] = cls      # one class object per name
            return cls
    raise AttributeError(name)
