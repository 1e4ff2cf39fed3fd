"""Command-line tools.

``str2asm_main`` is the analog of the reference's ``scripts/str2asm.py``
(there: expression string -> generated Cython assembler source; here the
pruned assembly plan of the form and, with ``--source``, the CUDA C of
its generated coefficient-field kernel).  It prints the lines of
:func:`pyiga_tpu._cli.str2asm_main` for the same arguments; in place of
``--hlo`` (the JAX package's lowered program) it takes ``--source``.

    python -m pyiga_tpu_torch._cli 'inner(grad(u), grad(v)) * dx' --dim 2
    pyiga-tpu-torch-str2asm 'v * ds' --dim 3 --boundary left --source

The plan is built on the host (``device='cpu'``); printing the source
does not build it, so the command needs no card and no CUDA toolkit.
"""

import argparse


def str2asm_main(argv=None):
    ap = argparse.ArgumentParser(
        description='parse a variational-form expression string and dump '
                    'its pruned assembly plan')
    ap.add_argument('expr', help='variational form expression string')
    ap.add_argument('--dim', type=int, default=2, help='space dimension')
    ap.add_argument('--nspans', type=int, default=4,
                    help='knot spans per axis for the probe space')
    ap.add_argument('--degree', type=int, default=2, help='spline degree')
    ap.add_argument('--boundary', default=None,
                    help="boundary spec (e.g. 'left') for boundary integrals")
    ap.add_argument('--dumptree', action='store_true',
                    help='print the expression tree')
    ap.add_argument('--source', action='store_true',
                    help='print the CUDA C source of the generated '
                         'coefficient-field kernel (the analog of dumping '
                         'generated source; not compiled)')
    args = ap.parse_args(argv)
    return _str2asm_body(args)


def _str2asm_body(args):
    from pyiga_tpu_torch import bspline, geometry, vform
    from pyiga_tpu_torch.compile import compile_vform

    kvs = args.dim * (bspline.make_knots(args.degree, 0.0, 1.0, args.nspans),)
    geo = geometry.identity([kv.support() for kv in reversed(kvs)])

    vf = vform.parse_vf(args.expr, kvs, {'geo': geo},
                        boundary=bool(args.boundary))
    print('dim=%d arity=%d vec=%s max_deriv=%d hash=%x'
          % (vf.dim, vf.arity, vf.vec, vf.max_deriv_order(),
             vf.hash() & 0xffffffffffffffff))
    if args.dumptree:
        for e in vf.exprs:
            print('  expr:', e)
    print('field keys:', sorted(map(str, vf.used_field_keys())))

    cls = compile_vform(vf)
    kwargs = {'geo': geo}
    if args.boundary:
        from pyiga_tpu_torch.assemble import _Jac_to_boundary_matrix
        bdspec = bspline._parse_bdspec(args.boundary, args.dim)
        kwargs['boundary'] = bdspec
        kwargs['Jac_to_boundary'] = _Jac_to_boundary_matrix(bdspec, args.dim)
    asm = cls(kvs, device='cpu', **kwargs)

    print('assembly plan: %d term(s) after pruning '
          '(of %d derivative/component combinations)'
          % (len(asm.combos), asm._num_combos_total))
    for su, sv in asm.combos:
        print('  term: trial seed %s  x  test seed %s' % (su, sv))

    if args.source:
        print()
        print(asm._program(asm.combos).source)


if __name__ == '__main__':
    str2asm_main()
