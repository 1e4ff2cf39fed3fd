"""Geometry fields of the PyTorch port (kernel K1's plain version, fed by
kernel K2's plain version) held against the JAX package's native-f64
``assemblers.stiffness_fields``, and the plain geometry helpers against
``pyiga_tpu.ops.geom``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pyiga_tpu.bspline as jbspline
import pyiga_tpu.geometry as jgeometry
from pyiga_tpu import assemblers as jassemblers
from pyiga_tpu.ops import geom as jgeom

from pyiga_tpu_torch import assemblers, convert
from pyiga_tpu_torch.ops import cuda_sumfac, geom

torch.set_num_threads(1)

# (geometry, degree, spans): 3D B-spline, 2D NURBS, 2D B-spline
CASES = [('twisted_box', 3, 6), ('quarter_annulus', 3, 10),
         ('bspline_quarter_annulus', 3, 12), ('twisted_box', 2, 5)]


def _jax_inputs(name, p, n):
    jgeo = getattr(jgeometry, name)()
    jkvs = jgeo.sdim * (jbspline.make_knots(p, 0.0, 1.0, n),)
    jasm = jassemblers.StiffnessAssembler(jkvs, jgeo)
    return jasm._geo_inputs


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize('name,p,n', CASES)
def test_stiffness_fields(name, p, n):
    gi = _jax_inputs(name, p, n)
    ref = jassemblers.stiffness_fields(
        {k: [jnp.asarray(a) for a in v] if isinstance(v, list)
         else jnp.asarray(v) for k, v in gi.items()})
    got = assemblers.stiffness_fields(convert.geo_inputs(gi, device='cpu'))
    assert len(got) == len(ref)
    # relative to the largest field: on the conformal quarter annulus the
    # off-diagonal field is rounding noise (~1e-20) on both sides
    scale = max(np.abs(np.asarray(R)).max() for R in ref)
    for F, R in zip(got, ref):
        assert F.dtype == torch.float64 and F.shape == R.shape
        assert np.abs(np.asarray(F) - np.asarray(R)).max() / scale < 1e-13


@pytest.mark.parametrize('name,p,n', CASES[:3])
def test_geo_jacobian_and_inverse(name, p, n):
    gi = _jax_inputs(name, p, n)
    nurbs = 'geo_tables_nurbs' in gi
    key = 'geo_tables_nurbs' if nurbs else 'geo_tables_bsp'
    d = len(gi[key])
    tgi = convert.geo_inputs(gi, device='cpu')
    val, jac = geom.geo_jacobian_field(tgi[key], tgi['geo_coeffs'], nurbs, d)
    jval, jjac = jgeom.geo_jacobian_field(gi[key], gi['geo_coeffs'], nurbs, d)
    assert _rel(val, jval) < 1e-14 and _rel(jac, jjac) < 1e-14
    det, inv = geom.det_and_inv(jac)
    jdet, jinv = jgeom.det_and_inv(jjac)
    assert _rel(det, jdet) < 1e-14 and _rel(inv, jinv) < 1e-14
    W = geom.gauss_weight_field(tgi['weights'])
    assert _rel(W, jgeom.gauss_weight_field(gi['weights'])) == 0.0


def test_fields_plain_nurbs_quotient():
    """K1's plain version on a NURBS map with unit weights equals the
    B-spline branch on the same control points."""
    gi = _jax_inputs('bspline_quarter_annulus', 2, 6)
    tgi = convert.geo_inputs(gi, device='cpu')
    tables, coeffs = tgi['geo_tables_bsp'], tgi['geo_coeffs']
    Y, _ = cuda_sumfac.geo_stage12(tables, coeffs, 2)
    ones = torch.ones((1,) + tuple(coeffs.shape[1:]), dtype=torch.float64)
    Yw, _ = cuda_sumfac.geo_stage12(tables, torch.cat([coeffs, ones]), 2)
    T = tables[1][:2].contiguous()
    args = (tgi['weights'][0], tgi['weights'][1])
    a = cuda_sumfac.fields_plain(Y, T, *args, nurbs=False)
    b = cuda_sumfac.fields_plain(Yw, T, *args, nurbs=True)
    assert _rel(b, a) < 1e-14


def test_kernel_wrappers_refuse_other_devices():
    """A wrapper runs its plain version only for CPU tensors: any other
    device either launches the kernel or raises (no silent fallback)."""
    meta = torch.empty((3, 3, 4, 2), dtype=torch.float64, device='meta')
    with pytest.raises(ValueError):
        cuda_sumfac.fields(meta, meta[0], meta[0, 0, :, 0], meta[0, 0, 0],
                           False)
    with pytest.raises(ValueError):
        cuda_sumfac.stage(meta[0, 0], meta[0, 0].T)
    with pytest.raises(ValueError):
        cuda_sumfac.fold([meta[0, 0]], [meta[0, 0].T], [0])
