"""Surface integrals of the PyTorch port held against the JAX package on
the CPU: ``ds`` over a face of the space (``boundary=``, the
``Jac_to_boundary`` parameter, the one-dof normal axis) and over a
surface geometry (``VForm(2, geo_dim=3)``), as vectors and matrices, on
every face in 2D and 3D and on a non-square space; the measure and the
outward normals against the faces' areas; the pruned combos and the
symmetric fold against JAX's; and K1's ``jac`` kind at the surface and
boundary shapes, its plain version fed by the K2 stage chain.  Matrices
and vectors to 1e-13 relative, indices and counts exactly."""

import numpy as np
import pytest
import torch

import pyiga_tpu.bspline as jbspline
import pyiga_tpu.geometry as jgeometry
from pyiga_tpu import assemble as jassemble
from pyiga_tpu import vform as jvform
from pyiga_tpu.ops import geom as jgeom

from pyiga_tpu_torch import assemble, bspline, compile, geometry, vform
from pyiga_tpu_torch.ops import cuda_sumfac

torch.set_num_threads(1)

FACES3 = ['left', 'right', 'bottom', 'top', 'front', 'back']
FACES2 = ['left', 'right', 'bottom', 'top']


def _dense(A):
    return A.toarray() if hasattr(A, 'toarray') else np.asarray(A)


def _rel(a, b):
    a, b = _dense(a), _dense(b)
    assert a.shape == b.shape
    return np.abs(a - b).max() / np.abs(b).max()


def _geo3(pkg):
    return pkg.tensor_product(pkg.line_segment(0.0, 1.0),
                              pkg.quarter_annulus())


def _kvs(pkg, ns, p=3):
    return tuple(pkg.make_knots(p, 0.0, 1.0, n) for n in ns)


def _both(form, ns, geo, bd, **kw):
    """`form` assembled on the face `bd` in both packages."""
    A = assemble.assemble(form, _kvs(bspline, ns), geo=geo(geometry),
                          boundary=bd, device='cpu', **kw)
    jA = jassemble.assemble(form, _kvs(jbspline, ns), geo=geo(jgeometry),
                            boundary=bd, **kw)
    return A, jA


def test_assemble_surface_vf():
    """``pyiga_tpu/tests/test_vform.py::test_assemble_surface_vf``: ``v *
    ds`` on a 3D surface over a 2D space sums to its area."""
    kvs, jkvs = _kvs(bspline, (10, 10)), _kvs(jbspline, (10, 10))
    for side, area in (('left', np.pi / 2), ('right', np.pi)):
        vf = vform.VForm(2, geo_dim=3, arity=1)
        vf.add(vf.basisfuns() * vform.ds)
        jvf = jvform.VForm(2, geo_dim=3, arity=1)
        jvf.add(jvf.basisfuns() * jvform.ds)
        f = assemble.assemble_vf(vf, kvs, geo=_geo3(geometry).boundary(side),
                                 device='cpu')
        jf = jassemble.assemble_vf(jvf, jkvs,
                                   geo=_geo3(jgeometry).boundary(side))
        assert np.allclose(f.sum(), area)
        assert _rel(f, jf) < 1e-13


@pytest.mark.parametrize('bd', FACES3)
def test_assemble_boundary_vector(bd):
    """``test_vform.py::test_assemble_boundary_vector`` at its 3-element
    size, per face: the sum is the face's area and equals JAX's, the
    normals averaged over the face are the reference's."""
    areas = {'left': np.pi / 2, 'right': np.pi, 'bottom': 1.0, 'top': 1.0,
             'front': 3 * np.pi / 4, 'back': 3 * np.pi / 4}
    normals = {'left': [-1, -1, 0], 'right': [2, 2, 0],
               'bottom': [0, -1, 0], 'top': [-1, 0, 0],
               'front': 3 * np.pi / 4 * np.array([0, 0, -1.0]),
               'back': 3 * np.pi / 4 * np.array([0, 0, 1.0])}
    f, jf = _both('v * ds', (3, 3, 3), _geo3, bd)
    shape = [6, 6, 6]
    shape[bspline._parse_bdspec(bd, 3)[0]] = 1
    assert f.shape == tuple(shape)
    assert np.allclose(f.sum(), areas[bd])
    assert _rel(f, jf) < 1e-13
    kw = dict(bfuns=[('v', 3)], layout='packed')
    nv = assemble.assemble('inner(v, n) * ds', _kvs(bspline, (3, 3, 3)),
                           geo=_geo3(geometry), boundary=bd, device='cpu',
                           **kw)
    assert np.allclose(nv.sum(axis=(0, 1, 2)), normals[bd])
    if bd in ('left', 'front'):
        # JAX compiles this form anew for every face (~7 s each on the
        # CPU): its full vector on a face of each kind, the sums above on
        # all six
        jnv = jassemble.assemble('inner(v, n) * ds',
                                 _kvs(jbspline, (3, 3, 3)),
                                 geo=_geo3(jgeometry), boundary=bd, **kw)
        assert np.abs(nv - jnv).max() <= 1e-13 * np.abs(jnv).max()


@pytest.mark.parametrize('bd,expected', [
    ('left', [-1, 0]), ('right', [1, 0]), ('bottom', [0, -1]),
    ('top', [0, 1])])
def test_boundary_normals_2d(bd, expected):
    """The 2D half of the normals check, on the unit square."""
    nv, jnv = _both('inner(v, n) * ds', (3, 3), lambda pkg:
                    pkg.unit_square(), bd, bfuns=[('v', 2)],
                    layout='packed')
    assert np.allclose(nv.sum(axis=(0, 1)), expected)
    assert np.abs(nv - jnv).max() <= 1e-13


@pytest.mark.parametrize('bd,form,shape', [
    ('left', 'inner(grad(u), grad(v)) * ds', (6 * 7, 6 * 7)),
    ('top', 'inner(grad(u), grad(v)) * ds', (6 * 8, 6 * 8)),
    ('front', 'inner(cross(n, grad(u)), cross(n, grad(v))) * ds',
     (7 * 8, 7 * 8)),
])
def test_assemble_boundary_matrix(bd, form, shape):
    """``test_vform.py::test_assemble_boundary_matrix``: the matrices'
    shapes, JAX's entries, and the tangential form on the flat 'front'
    face equal to the 2D stiffness matrix of the quarter annulus (the
    JAX package takes ~45 s on the CPU to compile that form, so it is
    held to the stiffness matrix alone)."""
    if bd == 'front':
        A = assemble.assemble(form, _kvs(bspline, (3, 4, 5)),
                              geo=_geo3(geometry), boundary=bd, device='cpu')
        A2 = assemble.stiffness(_kvs(bspline, (4, 5)),
                                geo=geometry.quarter_annulus(), device='cpu')
        assert A.shape == shape
        assert _rel(A, A2) < 1e-12
        return
    A, jA = _both(form, (3, 4, 5), _geo3, bd)
    assert A.shape == shape
    assert _rel(A, jA) < 1e-13


def test_pair_vform_boundary_sqrt_exact():
    """The exact-mode half of ``test_pair_vform.py::
    test_pair_vform_boundary_sqrt``: ``u * v * ds`` on 'left'."""
    A, jA = _both('u * v * ds', (8, 8), lambda pkg: pkg.quarter_annulus(),
                  'left', mode='exact')
    assert _rel(A, jA) < 1e-13


@pytest.mark.parametrize('dim', [2, 3])
def test_jac_to_boundary_matrix(dim):
    """``_Jac_to_boundary_matrix`` equals JAX's for every bdspec."""
    for ax in range(dim):
        for side in (0, 1):
            B = assemble._Jac_to_boundary_matrix((ax, side), dim)
            jB = jassemble._Jac_to_boundary_matrix((ax, side), dim)
            assert B.shape == (dim, dim - 1)
            assert np.array_equal(B, jB)


@pytest.mark.parametrize('bd', FACES2)
def test_faces_of_a_non_square_space(bd):
    """On a (5, 8) space each face's vector and matrix, the pruned combos,
    the fold plan (none for a boundary integral) and the parameter
    ``Jac_to_boundary`` (bound positionally, not a user parameter) are
    JAX's."""
    ns = (5, 8)
    geo = geometry.quarter_annulus()
    jgeo = jgeometry.quarter_annulus()
    for form in ('v * ds', '(inner(grad(u), grad(v)) + u * v) * ds'):
        A, jA = _both(form, ns, lambda pkg: pkg.quarter_annulus(), bd)
        assert _rel(A, jA) < 1e-13
        kvs, jkvs = _kvs(bspline, ns), _kvs(jbspline, ns)
        asm = assemble.instantiate_assembler(form, kvs, {'geo': geo}, None,
                                             boundary=bd, device='cpu')
        jasm = jassemble.instantiate_assembler(form, jkvs, {'geo': jgeo},
                                               None, boundary=bd)
        assert asm.combos == jasm.combos
        assert asm._fold_plan is None and jasm._fold_plan is None
        assert asm.bdspec == jasm.bdspec
        assert asm.structure.bs == jasm.structure.bs
        assert 'Jac_to_boundary' not in type(asm).parameters()
        assert np.array_equal(asm._host_arrays['param:Jac_to_boundary'],
                              jasm._host_arrays['param:Jac_to_boundary'])


def test_boundary_prune_key_differs_from_the_volume_form():
    """The probe cache keys a boundary form by its face: the same form on
    two faces and the volume form do not share an entry."""
    kvs = _kvs(bspline, (4, 5))
    geo = geometry.quarter_annulus()
    keys = set()
    for bd in ('left', 'top'):
        asm = assemble.instantiate_assembler('u * v * ds', kvs,
                                             {'geo': geo}, None,
                                             boundary=bd, device='cpu')
        keys.add(asm._prune_key())
    vol = compile.compile_vform(vform.parse_vf('u * v * dx', kvs))(
        kvs, geo=geo, device='cpu')
    keys.add(vol._prune_key())
    assert len(keys) == 3


@pytest.mark.parametrize('case', ['surface_bsp', 'surface_nurbs'] + [
    'bd3_%s' % f for f in FACES3])
def test_geo_jac_fields_at_the_new_shapes(case):
    """K1 ``jac`` kind (plain version, fed by the K2 stage chain) on a
    surface geometry (three components on a 2D grid, B-spline and NURBS)
    and on the boundary Gauss grids of all six faces of a 3D geometry
    (one grid axis of length 1), against ``geom.geo_jacobian_field``."""
    kvs = _kvs(bspline, (3, 4, 5))
    if case.startswith('surface'):
        if case == 'surface_bsp':
            geo = geometry.twisted_box().boundary('left')
            jgeo = jgeometry.twisted_box().boundary('left')
        else:
            geo = _geo3(geometry).boundary('top')
            jgeo = _geo3(jgeometry).boundary('top')
        from pyiga_tpu_torch.ops import sumfac
        grid, _ = sumfac.quadrature_for(kvs[1:])
    else:
        bd = bspline._parse_bdspec(case[4:], 3)
        geo, jgeo = _geo3(geometry), _geo3(jgeometry)
        from pyiga_tpu_torch.ops import sumfac
        grid, _ = sumfac.quadrature_for(kvs, bdspec=bd)
    from pyiga_tpu_torch.ops import geom
    tabs, coeffs, nurbs = geom.geo_eval_tables(geo, grid)
    jtabs, jcoeffs, jnurbs = jgeom.geo_eval_tables(jgeo, grid)
    assert nurbs == jnurbs and coeffs.shape == jcoeffs.shape
    if case.startswith('surface'):
        assert nurbs == (case == 'surface_nurbs')
    val, jac = cuda_sumfac.geometry_fields(
        [torch.as_tensor(t) for t in tabs], torch.as_tensor(coeffs), nurbs)
    jval, jjac = jgeom.geo_jacobian_field(jtabs, jcoeffs, jnurbs, len(grid))
    G = coeffs.shape[0] - nurbs
    assert val.shape == (G,) + tuple(len(g) for g in grid)
    assert jac.shape == (G, len(grid)) + tuple(len(g) for g in grid)
    assert _rel(val.numpy(), np.asarray(jval)) < 1e-13
    assert _rel(jac.numpy(), np.asarray(jjac)) < 1e-13
