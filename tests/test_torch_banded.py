"""Flat banded matvec of the PyTorch port (kernel K4 by its plain version,
float64 and float32) held against the JAX package's banded matvecs and the
scipy CSR product."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pyiga_tpu.bspline as jbspline
import pyiga_tpu.geometry as jgeometry
from pyiga_tpu.assemblers import StiffnessAssembler as JStiffnessAssembler
from pyiga_tpu.ops import banded as jbanded

from pyiga_tpu_torch import convert, mlmatrix
from pyiga_tpu_torch.ops import banded

torch.set_num_threads(1)

CASES = [('twisted_box', 2, 5), ('twisted_box', 3, 4),
         ('quarter_annulus', 3, 8), ('bspline_quarter_annulus', 1, 9)]


def _jax_banded(name, p, n):
    """JAX-side assembled matrix: MLMatrix, bandwidths, sizes and the banded
    ``(b..., n...)`` f64 data."""
    jgeo = getattr(jgeometry, name)()
    jkvs = jgeo.sdim * (jbspline.make_knots(p, 0.0, 1.0, n),)
    mlm = JStiffnessAssembler(jkvs, jgeo).assemble(mode='exact')
    bws = jbanded.band_info(mlm.structure)
    ns = tuple(b[0] for b in mlm.structure.bs)
    return mlm, bws, ns, jbanded.banded_from_compact(mlm.data, mlm.structure,
                                                     bws)


@pytest.mark.parametrize('name,p,n', CASES)
def test_layout(name, p, n):
    mlm, bws, ns, _ = _jax_banded(name, p, n)
    structure = mlmatrix.MLStructure(mlm.structure.bs, mlm.structure.bidx)
    assert banded.band_info(structure) == bws
    lay, jlay = banded.flat_banded_layout(bws, ns), jbanded.flat_banded_layout(bws, ns)
    assert (lay['F'], lay['lead'], lay['bsz']) == (jlay['F'], jlay['lead'], jlay['bsz'])
    assert lay['C'] == jlay['C1'] * jlay['C23']


@pytest.mark.parametrize('name,p,n', CASES)
def test_matvec_f64(name, p, n):
    mlm, bws, ns, Db = _jax_banded(name, p, n)
    op = banded.FlatBandedOperator(
        convert.flat_banded(Db, bws, ns, device='cpu'), bws, ns)
    x = np.random.RandomState(0).rand(op.shape[0])
    y = op(torch.as_tensor(x)).numpy()
    y_csr = mlm.asmatrix() @ x
    y_jax = np.asarray(jbanded.banded_matvec_static(jnp.asarray(Db),
                                                    jnp.asarray(x), bws, ns))
    scale = np.abs(y_csr).max()
    assert np.abs(y - y_csr).max() / scale < 1e-14
    assert np.abs(y - y_jax).max() / scale < 1e-14
    A = banded.flat_banded_to_csr(op.D, bws, ns)
    assert abs(A - mlm.asmatrix()).max() == 0.0


@pytest.mark.parametrize('name,p,n', CASES)
def test_matvec_f32(name, p, n):
    """float32 K4 (plain) against the JAX flat banded Pallas kernel in
    interpret mode."""
    _mlm, bws, ns, Db = _jax_banded(name, p, n)
    op32 = banded.FlatBandedOperator(
        convert.flat_banded(Db, bws, ns, device='cpu',
                            dtype=torch.float32), bws, ns)
    assert op32.dtype == torch.float32
    x = np.random.RandomState(1).rand(op32.shape[0]).astype(np.float32)
    y = op32(torch.as_tensor(x)).numpy()
    jop = jbanded.FlatBandedOperator(Db, bws, ns, interpret=True)
    y_ref = np.asarray(jop.matvec(jnp.asarray(x)))
    assert y.dtype == np.float32
    assert np.abs(y - y_ref).max() / np.abs(y_ref).max() < 1e-6


def test_operator_cast_and_plain_matvec():
    _mlm, bws, ns, Db = _jax_banded('twisted_box', 2, 4)
    op = banded.FlatBandedOperator(
        convert.flat_banded(Db, bws, ns, device='cpu'), bws, ns)
    op32 = op.to(torch.float32)
    assert op32.D.dtype == torch.float32 and op32.shape == op.shape
    lay = op.lay
    x = torch.as_tensor(np.random.RandomState(2).rand(lay['F']))
    xp = torch.zeros(lay['F'] + 2 * lay['lead'], dtype=torch.float64)
    xp[lay['lead']:lay['lead'] + lay['F']] = x
    offs = torch.as_tensor(lay['offs'])
    y = banded.flat_banded_matvec(op.D, xp, offs, lay['lead'])
    assert torch.equal(y, op(x))
    with pytest.raises(ValueError):
        banded.flat_banded_matvec(op.D.to('meta'), xp.to('meta'),
                                  offs.to('meta'), lay['lead'])
