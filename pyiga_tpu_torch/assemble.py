# -*- coding: utf-8 -*-
"""High-level assembly API (port of the VForm part of
:mod:`pyiga_tpu.assemble`): :func:`assemble` of a form string, a
:class:`~pyiga_tpu_torch.vform.VForm`, a compiled assembler class or an
assembler instance.

Matrix conventions as in the JAX package: rows are test functions,
columns trial functions.  The device is explicit (``device=``; omitted
means the CPU): problems are never rerouted to another device by size.
Hierarchical spaces, boundary integrals and vector-valued layouts are
not ported yet.
"""

from . import vform as vform_mod
from .compile import compile_vform


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
