# -*- coding: utf-8 -*-
"""Gauss assemblers built on the sum-factorization engine (port of
:mod:`pyiga_tpu.assemblers`: the stiffness assembler and its banded
solver-layout entry point).

:meth:`BaseGaussAssembler.assemble_banded` is the normal entry point: it
evaluates the geometry fields (kernels K2 and K1), runs the folded
contraction chains (K2 stages, K3 final fold) and lays the result out for
the flat banded matvec (K4), returning a float64
:class:`~pyiga_tpu_torch.ops.banded.FlatBandedOperator` on the
assembler's device.  On the CPU the same pipeline runs the kernels' plain
PyTorch versions.
"""

import numpy as np
import torch

from .bspline import KnotVector
from .config import DTYPE, resolve_device
from .mlmatrix import MLStructure
from .ops import cuda_sumfac, geom, sumfac
from .ops.banded import FlatBandedOperator, band_info


# B_ab = W (J^-1 J^-T)_ab for all axis pairs (a, b) in level order,
# row-major, from a dict of geometry tensors (BaseGaussAssembler.geo_inputs)
stiffness_fields = cuda_sumfac.stiffness_fields


def _unit(d, k):
    e = d * [0]
    e[k] = 1
    return tuple(e)


class BaseGaussAssembler:
    """Shared setup for Gauss assemblers over a TP spline space with
    geometry.  Host setup (quadrature, sparsity, basis tables, geometry
    tables) is numpy; device tensors are made on `device` when assembling.
    """

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

    def _make_geo_inputs(self):
        tables, coeffs, is_nurbs = geom.geo_eval_tables(self.geo, self.grid,
                                                        numderiv=1)
        key = 'geo_tables_nurbs' if is_nurbs else 'geo_tables_bsp'
        return {'weights': [np.asarray(w) for w in self.gweights],
                key: list(tables), 'geo_coeffs': coeffs}

    def geo_inputs(self, dtype=DTYPE):
        """The geometry inputs as tensors on the assembler's device."""
        def dev(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype,
                                   device=self.device)
        return {k: [dev(a) for a in v] if isinstance(v, list) else dev(v)
                for k, v in self._geo_inputs.items()}

    def _fold(self):
        """Symmetric fold plan of the terms (None without mirroring)."""
        if not self.symmetric_fields:
            return None
        plan = sumfac.symmetric_fold_plan(self.terms)
        if plan is None or all(not m for _, m in plan):
            return None
        return plan

    def assemble_banded(self):
        """Assemble straight into the flat banded solver layout and return
        the float64 :class:`FlatBandedOperator` on the assembler's device
        (the data never leaves it)."""
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
        uploaded = {}

        def dev(a):
            if id(a) not in uploaded:
                uploaded[id(a)] = (a, torch.as_tensor(a, dtype=DTYPE,
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
