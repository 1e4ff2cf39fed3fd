"""The port's ``str2asm`` command (``pyiga_tpu_torch._cli``) held against
``pyiga_tpu._cli``: for the same arguments, every line it prints equals
the JAX command's (the form's dimension, arity, vector flag, derivative
order and hash, the expression tree, the field keys and the pruned
assembly plan).  The hash is Python's hash of the form's expression
tree, so both commands run in this one process.  ``--source`` (the
port's counterpart of ``--hlo``) prints the generated K5 source."""

import contextlib
import io

import pytest
import torch

from pyiga_tpu._cli import str2asm_main as jax_str2asm

from pyiga_tpu_torch._cli import str2asm_main

torch.set_num_threads(1)


def _printed(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue().splitlines()


@pytest.mark.parametrize('argv', [
    ['inner(grad(u), grad(v)) * dx', '--dim', '2'],
    ['inner(grad(u), grad(v)) * dx', '--dim', '2', '--dumptree'],
    ['v * ds', '--dim', '3', '--boundary', 'left'],
    ['inner(grad(u), grad(v)) * ds', '--dim', '3', '--boundary', 'front',
     '--dumptree'],
    # vector-valued terms: the coordinate vector, a gradient, the normal
    ['dot(x, grad(u)) * v * dx', '--dim', '2', '--degree', '3',
     '--nspans', '5', '--dumptree'],
    ['inner(n, grad(v)) * ds', '--dim', '2', '--boundary', 'top'],
    ['(inner(grad(u), grad(v)) + u * v) * dx', '--dim', '3'],
    # convection-diffusion with constants (the CLI passes no parameter)
    ['(0.05 * inner(grad(u), grad(v)) + dot(as_vector([3.0, -1.0]), '
     'grad(u)) * v) * dx', '--dim', '2', '--degree', '3'],
], ids=['stiffness2d', 'dumptree', 'boundary_left', 'boundary_front',
        'vector_terms', 'normal', 'stiffness_mass3d', 'convdiff'])
def test_str2asm_lines_match_jax(argv):
    got = _printed(str2asm_main, argv)
    ref = _printed(jax_str2asm, argv)
    assert got == ref
    assert any(line.startswith('assembly plan:') for line in got)


def test_str2asm_source():
    lines = _printed(str2asm_main, ['inner(grad(u), grad(v)) * dx',
                                    '--dim', '2', '--source'])
    ref = _printed(jax_str2asm, ['inner(grad(u), grad(v)) * dx',
                                 '--dim', '2'])
    assert lines[:len(ref)] == ref
    source = '\n'.join(lines[len(ref):])
    assert 'pyiga_vform_fields' in source
    assert '__global__' in source
