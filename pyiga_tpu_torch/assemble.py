# -*- coding: utf-8 -*-
"""High-level assembly API (port of the VForm part of
:mod:`pyiga_tpu.assemble`): :func:`assemble` of a form string, a
:class:`~pyiga_tpu_torch.vform.VForm`, a compiled assembler class or an
assembler instance.

Matrix conventions as in the JAX package: rows are test functions,
columns trial functions.  The device is explicit (``device=``; omitted
means the CPU): problems are never rerouted to another device by size.
Also here, as host copies: the boundary index sets of a tensor-product
space (:func:`boundary_dofs`, :func:`boundary_cells`) and
:class:`RestrictedLinearSystem` for eliminating Dirichlet dofs.
Boundary integrals and vector-valued layouts are not ported yet.
"""

import numpy as np
import scipy.sparse

from . import bspline
from . import vform as vform_mod
from .compile import compile_vform


def slice_indices(ax, idx, shape, ravel=False, flip=None):
    """Dof indices of the slice at index `idx` along axis `ax` of a TP
    basis with the given `shape`; as multi-indices or raveled
    (`ravel=True`).  `flip` optionally reverses the traversal of the
    remaining axes."""
    shape = tuple(shape)
    per_axis = [np.arange(n) for n in shape]
    per_axis[ax] = np.array([range(shape[ax])[idx]])    # negative idx wraps
    if flip is not None:
        rest = [k for k in range(len(shape)) if k != ax]
        for k, flp in zip(rest, flip):
            if flp:
                per_axis[k] = per_axis[k][::-1]
    mesh = np.meshgrid(*per_axis, indexing='ij')
    multi = np.stack([m.ravel() for m in mesh], axis=-1)
    if ravel:
        return np.ravel_multi_index(tuple(multi.T), shape)
    return multi


def boundary_dofs(kvs, bdspec, ravel=False, flip=None):
    """Indices of the dofs lying on the given boundary face."""
    ax, side = bspline._parse_bdspec(bdspec, len(kvs))
    return slice_indices(ax, -side, tuple(kv.numdofs for kv in kvs),
                         ravel=ravel, flip=flip)


def boundary_cells(kvs, bdspec, ravel=False):
    """Indices of the cells lying on the given boundary face."""
    ax, side = bspline._parse_bdspec(bdspec, len(kvs))
    return slice_indices(ax, -side, tuple(kv.numspans for kv in kvs),
                         ravel=ravel)


class RestrictedLinearSystem:
    """A linear system with some dofs eliminated (fixed to given values).

    ``R_free``/``R_elim`` restrict to the free/eliminated dofs; the updated
    right-hand side is ``R_free (b - A R_elim^T values)``.  `elim_rows`
    supports Petrov-Galerkin systems where the eliminated equations differ
    from the eliminated dofs."""

    @staticmethod
    def _splitting(n, eliminated):
        """(R_keep, R_drop) 0/1 restriction matrices for a dof splitting."""
        drop = np.zeros(n, dtype=bool)
        drop[np.asarray(eliminated, dtype=np.int64)] = True
        eye = scipy.sparse.eye(n, format='csr')
        return eye[~drop], eye[drop]

    def __init__(self, A, b, bcs, elim_rows=None):
        indices, values = bcs
        if np.isscalar(b):
            b = np.broadcast_to(b, A.shape[0])
        if np.isscalar(values):
            values = np.broadcast_to(values, np.shape(indices)[0])
        # R_elim's rows are in ascending dof order, so the values are
        # sorted the same way; duplicate indices keep their first value
        indices = np.asarray(indices, dtype=np.int64)
        values = np.asarray(values)
        uniq, first = np.unique(indices, return_index=True)
        indices, values = uniq, values[first]
        self.values = values

        self.R_free, self.R_elim = self._splitting(A.shape[1], indices)
        if elim_rows is None:
            self.R_free_v, self.R_elim_v = self.R_free, self.R_elim
        else:
            self.R_free_v, self.R_elim_v = self._splitting(
                A.shape[0], sorted(elim_rows))

        self.A = self.restrict_matrix(A)
        self.b = self.restrict_rhs(b - A.dot(self.R_elim.T.dot(values)))

    def restrict(self, u):
        """Restrict a full-dof vector to the free dofs."""
        return self.R_free @ u

    def restrict_rhs(self, f):
        """Restrict a right-hand side to the non-eliminated rows."""
        return self.R_free_v @ f

    def restrict_matrix(self, B):
        """Restrict a full matrix to the free dofs (rows and columns)."""
        if not scipy.sparse.issparse(B):
            B = scipy.sparse.csr_matrix(B)
        return self.R_free_v @ B @ self.R_free.T

    def extend(self, u):
        """Zero-pad a free-dof vector to all dofs."""
        return self.R_free.T @ u

    def complete(self, u):
        """Extend a restricted solution with the eliminated dof values."""
        return self.extend(u) + self.R_elim.T @ self.values


def instantiate_assembler(problem, kvs, args, bfuns, boundary=None,
                          updatable=(), device=None):
    """Normalize `problem` (string / VForm / assembler class / instance)
    into an assembler object on `device`."""
    if boundary:
        raise NotImplementedError('boundary integrals (boundary=) are not '
                                  'ported yet')
    if updatable:
        raise NotImplementedError('updatable inputs are not ported yet')
    if isinstance(problem, str):
        problem = vform_mod.parse_vf(problem, kvs, args=args, bfuns=bfuns)
    if isinstance(problem, vform_mod.VForm):
        if problem.num_spaces() > 1:
            raise NotImplementedError('two-space forms (kvs2) are not '
                                      'ported yet')
        problem = compile_vform(problem)
    if isinstance(problem, type):
        wanted = list(problem.inputs()) + list(problem.parameters())
        missing = [inp for inp in wanted if inp not in args]
        if missing:
            raise ValueError("required input parameter '%s' missing"
                             % missing[0])
        return problem(kvs, device=device,
                       **{inp: args[inp] for inp in wanted})
    if hasattr(problem, 'assemble') or hasattr(problem, 'assemble_vector'):
        return problem
    raise TypeError("invalid type for 'problem': %s" % type(problem))


def assemble_entries(asm, symmetric=False, format='csr', mode=None):
    """Assemble all entries of the given assembler and return the matrix
    (scipy sparse in `format`, or the compact
    :class:`~pyiga_tpu_torch.mlmatrix.MLMatrix` for ``format='mlb'``) or,
    for arity-1 assemblers, the vector.  `symmetric` is accepted for API
    compatibility."""
    if asm.arity == 1:
        return asm.assemble_vector()
    mlm = asm.assemble(mode=mode)
    if format == 'mlb':
        return mlm
    return mlm.asmatrix(format)


def assemble(problem, kvs, args=None, bfuns=None, boundary=None,
             symmetric=False, format='csr', layout='blocked', mode=None,
             device=None, **kwargs):
    """Assemble a matrix or vector in a function space.

    `problem` may be a string (parsed by
    :func:`pyiga_tpu_torch.vform.parse_vf`), a
    :class:`~pyiga_tpu_torch.vform.VForm`, a compiled assembler class or an
    assembler instance; `kvs` is a TP spline space (tuple of
    KnotVectors).  Named inputs (the geometry ``geo``, coefficient
    functions, parameters) are passed in `args` or as keyword arguments.
    The assembly runs on `device` (default: the CPU).  `layout` matters
    only for vector-valued forms (not ported yet).  Structural zeros
    and symmetric term pairs are found by the JAX package's numeric
    probes (``VFormAssembler._prune_combos``)."""
    args = dict(args) if args is not None else dict()
    args.update(kwargs)
    asm = instantiate_assembler(problem, kvs, args, bfuns, boundary,
                                device=device)
    return assemble_entries(asm, symmetric=symmetric, format=format,
                            mode=mode)


def assemble_vf(vf, kvs, symmetric=False, format='csr', layout='blocked',
                args=None, device=None, **kwargs):
    """Assemble a :class:`~pyiga_tpu_torch.vform.VForm` into a matrix or
    vector."""
    args = dict(args) if args is not None else dict()
    args.update(kwargs)
    return assemble(vf, kvs, symmetric=symmetric, format=format,
                    layout=layout, args=args, device=device)
