"""Multipatch discretizations and the hierarchical entry points of the
PyTorch port held against the JAX package on the CPU: the global
numbering of joined and automatically matched patches (exactly JAX's),
interface detection in 2D and 3D, the union-find across patches, the
global system assembled patch by patch, the multipatch Poisson example,
and ``assemble`` / ``project_L2`` over a hierarchical space.  Matrices
and vectors to 1e-13 relative, indices and counts exactly."""

import importlib.util
import os

import numpy as np
import pytest
import scipy.sparse
import scipy.sparse.linalg
import torch

import pyiga_tpu.bspline as jbspline
import pyiga_tpu.geometry as jgeometry
import pyiga_tpu.hierarchical as jhier
from pyiga_tpu import approx as japprox
from pyiga_tpu import assemble as jassemble
from pyiga_tpu import vform as jvform

from pyiga_tpu_torch import approx, assemble, bspline, geometry, vform
from pyiga_tpu_torch import hierarchical

torch.set_num_threads(1)


def _rel(a, b):
    a = a.toarray() if hasattr(a, 'toarray') else np.asarray(a)
    b = b.toarray() if hasattr(b, 'toarray') else np.asarray(b)
    assert a.shape == b.shape
    return np.abs(a - b).max() / np.abs(b).max()


def _make_Lshape(geo, bsp, asm):
    """``test_multipatch.py``'s L shape, hand-joined, in either package."""
    kvs = 2 * (bsp.make_knots(2, 0.0, 1.0, 8),)
    squ = geo.unit_square()
    geos = (squ, squ.translate((1, 0)), squ.scale((-1, 1)).translate((2, 1)))
    MP = asm.Multipatch([(kvs, g) for g in geos])
    MP.join_boundaries(0, 'right', 1, 'left')
    MP.join_boundaries(1, 'top', 2, 'bottom', flip=(True,))
    MP.finalize()
    return MP


def _same_numbering(MP, jMP):
    assert MP.numpatches == jMP.numpatches
    assert MP.numdofs == jMP.numdofs
    assert MP.shared_per_patch == jMP.shared_per_patch
    assert MP.shared_dofs == jMP.shared_dofs
    for p in range(MP.numpatches):
        assert np.array_equal(MP.patch_to_global_idx(p),
                              jMP.patch_to_global_idx(p))


def test_multipatch():
    """``test_multipatch.py::test_multipatch``, and the numbering,
    transfer matrices and Dirichlet indices exactly JAX's."""
    MP = _make_Lshape(geometry, bspline, assemble)
    jMP = _make_Lshape(jgeometry, jbspline, jassemble)
    _same_numbering(MP, jMP)
    assert MP.numpatches == 3
    assert MP.numdofs == 90 + 81 + 90 + 2 * 10 - 1

    idx1 = MP.patch_to_global_idx(1)
    assert idx1.size == 100
    idx1 = idx1.reshape((10, 10))
    assert np.array_equal(idx1[:-1, 1:].ravel(), 90 + np.arange(9 * 9))
    assert np.array_equal(idx1[:, 0], 90 + 81 + 90 + np.arange(10))
    assert np.array_equal(idx1[-1, 1:], 90 + 81 + 90 + 10 + np.arange(9))

    u1 = np.arange(100)
    P1 = MP.patch_to_global(1)
    assert scipy.sparse.linalg.norm(
        MP.global_to_patch(1) @ P1 - scipy.sparse.eye(100)) == 0
    assert (P1 != jMP.patch_to_global(1)).nnz == 0
    assert (MP.patch_to_global(2, j_global=True)
            != jMP.patch_to_global(2, j_global=True)).nnz == 0
    ug = P1 @ u1
    u0 = (MP.global_to_patch(0) @ ug).reshape((10, 10))
    assert np.allclose(u0[:, :-1], 0)
    assert np.array_equal(u0[:, -1], np.arange(0, 100, 10))
    u2 = (MP.global_to_patch(2) @ ug).reshape((10, 10))
    assert np.allclose(u2[1:, :], 0)
    assert np.array_equal(u2[0, :], np.arange(99, 89, -1))

    bcs = [(0, 'top', lambda x, y: 1.0), (2, 'right', lambda x, y: x + y)]
    bcidx, bcvals = MP.compute_dirichlet_bcs(bcs[:1])
    assert np.array_equal(bcidx,
                          list(range(9 * 9, 10 * 9)) + [90 + 81 + 90 + 9])
    assert np.allclose(bcvals, 1.0)
    idx, vals = MP.compute_dirichlet_bcs(bcs)
    jidx, jvals = jMP.compute_dirichlet_bcs(bcs)
    assert np.array_equal(idx, jidx)
    assert _rel(vals, jvals) < 1e-13


def test_detect_interfaces():
    """``test_multipatch.py::test_detect_interfaces``: automatic matching
    gives the hand-joined numbering, and the interfaces are JAX's."""
    MP = _make_Lshape(geometry, bspline, assemble)
    MP2 = assemble.Multipatch(MP.patches, automatch=True)
    assert MP2.numdofs == MP.numdofs
    assert MP2.shared_per_patch == MP.shared_per_patch
    jMP = _make_Lshape(jgeometry, jbspline, jassemble)
    jMP2 = jassemble.Multipatch(jMP.patches, automatch=True)
    _same_numbering(MP2, jMP2)
    assert assemble.detect_interfaces(MP.patches) == \
        jassemble.detect_interfaces(jMP.patches)


def _boxes(geo, bsp):
    """Two unit cubes side by side along y, the second one mirrored in x,
    with a non-square space; and a third cube apart."""
    kvs = (bsp.make_knots(2, 0.0, 1.0, 3), bsp.make_knots(2, 0.0, 1.0, 4),
           bsp.make_knots(2, 0.0, 1.0, 3))
    cube = geo.unit_cube()
    return [(kvs, cube), (kvs, cube.scale((-1, 1, 1)).translate((1, 1, 0))),
            (kvs, cube.translate((5, 5, 5)))]


def test_detect_interfaces_3d():
    """A 3D two-patch box (the second patch mirrored, so the match needs a
    flip) beside a patch apart: one interface, not connected, and JAX's
    interfaces and numbering."""
    patches, jpatches = _boxes(geometry, bspline), _boxes(jgeometry,
                                                          jbspline)
    connected, intf = assemble.detect_interfaces(patches)
    assert (connected, intf) == jassemble.detect_interfaces(jpatches)
    assert not connected and len(intf) == 1
    p1, bd1, p2, bd2, flip = intf[0]
    assert (p1, p2) == (0, 1) and any(flip)
    MP = assemble.Multipatch(patches, automatch=True)
    jMP = jassemble.Multipatch(jpatches, automatch=True)
    _same_numbering(MP, jMP)
    assert MP.numdofs == 3 * 150 - 5 * 5


def test_union_find_chains_across_patches():
    """Three patches meeting at one corner dof: chained identifications
    (0-1, 1-2) merge into one shared group, numbered as JAX numbers it;
    the union-find itself merges by size and compresses paths."""
    uf = assemble._UnionFind(5)
    uf.union(0, 1)
    uf.union(2, 3)
    uf.union(1, 3)
    assert len({uf.find(i) for i in range(4)}) == 1 and uf.find(4) == 4
    assert uf.size[uf.find(0)] == 4

    def build(geo, bsp, asm):
        kvs = 2 * (bsp.make_knots(1, 0.0, 1.0, 2),)
        squ = geo.unit_square()
        MP = asm.Multipatch([(kvs, squ), (kvs, squ.translate((1, 0))),
                             (kvs, squ.translate((1, 1)))])
        MP.join_dofs(0, [8], 1, [6])         # 0's corner = 1's corner
        MP.join_dofs(1, [6, 7], 2, [0, 1])   # 1's corner = 2's corner
        MP.join_dofs(2, [2], 0, [2])
        MP.finalize()
        return MP
    MP = build(geometry, bspline, assemble)
    jMP = build(jgeometry, jbspline, jassemble)
    _same_numbering(MP, jMP)
    assert len(MP.shared_dofs) == 3
    assert MP.shared_dofs[0] == {(0, 8), (1, 6), (2, 0)}
    assert MP.numdofs == 27 - 4


def test_multipatch_assemble():
    """``test_multipatch.py::test_multipatch_assemble`` (n = 8): the
    two-patch system equals the single-patch system over the union domain
    and the JAX package's system."""
    def system(geo, bsp, asm, vf, **kw):
        kvs = 2 * (bsp.make_knots(2, 0.0, 1.0, 8),)
        geos = [geo.unit_square(), geo.unit_square().translate((1, 0))]
        MP = asm.Multipatch([(kvs, g) for g in geos], automatch=True)
        A, b = MP.assemble_system(vf.stiffness_vf(2),
                                  vf.L2functional_vf(2, physical=True),
                                  f=f, **kw)
        return kvs, A, b

    def f(x, y):
        return np.sin(2 * x) + np.exp(y)
    kvs, A, b = system(geometry, bspline, assemble, vform, device='cpu')
    _, jA, jb = system(jgeometry, jbspline, jassemble, jvform)
    assert _rel(A, jA) < 1e-13 and _rel(b, jb) < 1e-13

    knots_x = np.array(2 * [0.0] + list(np.linspace(0, 1.0, 9))
                       + list(np.linspace(1.0, 2.0, 9)) + 2 * [2.0])
    kvs2 = (kvs[0], bspline.KnotVector(knots_x, 2))
    geo2 = geometry.identity(kvs2)
    A2 = assemble.assemble(vform.stiffness_vf(2), kvs2, geo=geo2,
                           device='cpu')
    b2 = assemble.assemble(vform.L2functional_vf(2, physical=True), kvs2,
                           geo=geo2, f=f, device='cpu')
    Ix = np.arange(b.size)
    Ix = np.hstack((
        Ix[:9 * 10].reshape((10, 9)),
        Ix[2 * 9 * 10:].reshape((10, 1)),
        Ix[9 * 10:2 * 9 * 10].reshape((10, 9)))).ravel()
    assert np.allclose(b[Ix], b2.ravel())
    assert np.allclose(A.toarray()[Ix][:, Ix], A2.toarray())


def _load_example():
    path = os.path.join(os.path.dirname(__file__), '..', 'examples',
                        'torch_multipatch_poisson.py')
    spec = importlib.util.spec_from_file_location('torch_mp_poisson', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_multipatch_poisson_example():
    """``examples/torch_multipatch_poisson.py``'s ``main(device='cpu')``:
    its own checks (jump below 1e-12, positive maximum), and the solution
    of ``examples/multipatch_poisson.py``'s problem in the JAX package."""
    u, info = _load_example().main(device='cpu')
    MP = info['MP']
    assert MP.numdofs == 3 * 100 - 2 * 10 and info['jump'] < 1e-12
    kvs = 2 * (jbspline.make_knots(2, 0.0, 1.0, 8),)
    squ = jgeometry.unit_square()
    jMP = jassemble.Multipatch([(kvs, squ), (kvs, squ.translate((1, 0))),
                                (kvs, squ.translate((1, 1)))],
                               automatch=True)
    _same_numbering(MP, jMP)
    jA, jb = jMP.assemble_system(jvform.stiffness_vf(2),
                                 jvform.L2functional_vf(2, physical=True),
                                 f=lambda x, y: 1.0)
    assert _rel(info['A'], jA) < 1e-13 and _rel(info['b'], jb) < 1e-13


def _hspaces():
    def make(hmod, bmod):
        hs = hmod.HSpace(2 * (bmod.make_knots(3, 0.0, 1.0, 4),))
        hs.refine_region(0, lambda x, y: x > 0.5 and y > 0.5)
        hs.refine_region(1, lambda x, y: x > 0.75 and y > 0.75)
        return hs
    return make(hierarchical, bspline), make(jhier, jbspline)


@pytest.mark.parametrize('problem', ['stiffness', 'convdiff', 'rhs'])
def test_assemble_over_an_hspace(problem):
    """``assemble(problem, hs)`` dispatches to the hierarchical assembly
    (``test_hierarchical.py::test_hierarchical_assemble`` and ``_nonsym``)
    and equals JAX's, matrix and functional."""
    hs, jhs = _hspaces()
    geo, jgeo = geometry.bspline_quarter_annulus(), \
        jgeometry.bspline_quarter_annulus()
    if problem == 'rhs':
        f = lambda x, y: np.cos(x) * np.exp(y)     # noqa: E731
        got = assemble.assemble('f * v * dx', hs, f=f, geo=geo,
                                device='cpu')
        ref = jassemble.assemble('f * v * dx', jhs, f=f, geo=jgeo)
        assert got.shape == (hs.numdofs,)
    else:
        def form(mod):
            if problem == 'stiffness':
                return mod.stiffness_vf(dim=2)
            vf = mod.VForm(dim=2)
            u, v = vf.basisfuns()
            vf.add((mod.inner(mod.grad(u), mod.grad(v))
                    + mod.inner((1.0, 1.0), mod.grad(u)) * v) * mod.dx)
            return vf
        got = assemble.assemble(form(vform), hs, geo=geo, device='cpu')
        ref = jassemble.assemble(form(jvform), jhs, geo=jgeo)
        assert got.shape == (hs.numdofs, hs.numdofs)
    assert _rel(got, ref) < 1e-13


def test_project_L2_over_an_hspace():
    """``project_L2(hs, f)`` (``test_hierarchical.py::
    test_project_L2_hspace``) equals JAX's, with a geometry and with the
    identity map of the parameter domain."""
    hs, jhs = _hspaces()
    f = lambda x, y: x ** 2 - 4 * x * y + y ** 3     # noqa: E731
    u = approx.project_L2(hs, f, f_physical=True,
                          geo=geometry.unit_square(), device='cpu')
    ju = japprox.project_L2(jhs, f, f_physical=True,
                            geo=jgeometry.unit_square())
    assert u.shape == (hs.numdofs,) and _rel(u, ju) < 1e-13
    assert _rel(approx.project_L2(hs, f, device='cpu'),
                japprox.project_L2(jhs, f)) < 1e-13
