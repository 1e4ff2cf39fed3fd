"""The port's entry twin (``pyiga_tpu_torch.__graft_entry__``) held
against the JAX package's ``__graft_entry__.entry()`` step, ``jax.jit``
on the CPU: the same right-hand side, the compact data to 1e-13 and the
CG iterate to 1e-12, relative to their largest entries."""

import os
import sys

import numpy as np
import pytest
import torch

from pyiga_tpu_torch import __graft_entry__ as tentry, geometry
from pyiga_tpu_torch.assemblers import StiffnessAssembler
from pyiga_tpu_torch.bspline import make_knots

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_entry():
    sys.path.insert(0, REPO)
    import __graft_entry__ as jentry
    return jentry


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(b).max()


def test_entry_matches_jax():
    import jax
    jentry = _jax_entry()
    jfn, jargs = jentry.entry()
    jdata, jx = jax.jit(jfn)(*jargs)

    fn, args = tentry.entry(device='cpu')
    assert all(T.device.type == 'cpu' for T in args[0]['weights'])
    np.testing.assert_array_equal(args[2].numpy(), np.asarray(jargs[2]))
    data, x = fn(*args)
    assert data.shape == jdata.shape and x.shape == jx.shape
    assert data.dtype == torch.float64 and x.dtype == torch.float64
    assert _rel(data.numpy(), jdata) <= 1e-13
    assert _rel(x.numpy(), jx) <= 1e-12


@pytest.mark.parametrize('cg_iters', [0, 3])
def test_single_chip_step_matches_jax(cg_iters):
    """A 2D p=3 assembler through both packages' ``_single_chip_step``:
    the step's data, and `cg_iters` CG steps from zero (none: x = 0)."""
    import jax
    import pyiga_tpu.assemblers as jasm
    import pyiga_tpu.bspline as jbspline
    import pyiga_tpu.geometry as jgeometry
    jentry = _jax_entry()
    kvs = 2 * (make_knots(3, 0.0, 1.0, 7),)
    jkvs = 2 * (jbspline.make_knots(3, 0.0, 1.0, 7),)
    fn, args = tentry._single_chip_step(
        StiffnessAssembler(kvs, geometry.quarter_annulus(), device='cpu'),
        cg_iters=cg_iters)
    jfn, jargs = jentry._single_chip_step(
        jasm.StiffnessAssembler(jkvs, jgeometry.quarter_annulus()),
        cg_iters=cg_iters)
    data, x = fn(*args)
    jdata, jx = jax.jit(jfn)(*jargs)
    assert _rel(data.numpy(), jdata) <= 1e-13
    if cg_iters:
        assert _rel(x.numpy(), jx) <= 1e-12
    else:
        assert not x.any() and not np.asarray(jx).any()


def test_step_has_no_host_read(monkeypatch):
    """The CG loop reads nothing back to the host: no ``item``,
    ``tolist`` or ``__bool__`` of a tensor while the step runs."""
    fn, args = tentry.entry(device='cpu')

    def refuse(*a, **k):
        raise AssertionError('host read in the step')
    for name in ('item', 'tolist', '__bool__', '__float__'):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    data, x = fn(*args)
    monkeypatch.undo()
    assert bool(torch.isfinite(x).all())
