"""The port's examples (``examples/torch_*.py``) that twin
``examples/{poisson_3d,convection_diffusion,adaptive_poisson,
geometry_tour,subspace_correction_mg}.py``, run on the CPU at the reduced
sizes of ``tests/test_examples.py`` and at their default sizes: each
prints its twin's lines, with the same counts (CG-IR inner iterations,
GMRES, local MG, two-grid) and the same areas and volumes to 1e-12.

The JAX examples' outputs are constants here, printed by

    JAX_PLATFORMS=cpu python scripts/jax_poisson_counts.py examples small
    JAX_PLATFORMS=cpu python scripts/jax_poisson_counts.py examples

(the JAX examples test is marked slow, so they are not run live)."""

import contextlib
import importlib.util
import io
import os

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


COUNTS = _load(os.path.join(REPO, 'scripts', 'jax_poisson_counts.py'),
               'jax_poisson_counts')

# scripts/jax_poisson_counts.py examples small
JAX_SMALL = {
    'poisson_3d': {'outer': 4, 'inner_iters': [5, 6, 6, 6]},
    'convection_diffusion': {'gmres_precond': 113, 'gmres_plain': 151},
    'adaptive_poisson': {'sweeps': [[2, 48, 4], [3, 75, 4]]},
    'geometry_tour': {'printed': [
        'quarter annulus area',
        'b-spline variant area deviation from the circle',
        'scaled/rotated/translated area', 'disk area', 'twisted box volume',
        'cylinderized quarter annulus volume', 'find_inverse roundtrip err',
        'det J range on grid'], 'values': {
        'quarter_annulus': 2.3561944901923444,
        'bspline_quarter_annulus': 2.4999999999999996,
        'transformed': 9.424777960769378, 'disk': 7.068583470577033,
        'twisted_box': 2.3992559523809502, 'cylinder': 4.712388980384687}},
    'subspace_correction_mg': {'twogrid': [29, 25, 9, 22]},
}

# scripts/jax_poisson_counts.py examples (the geometry tour has no sizes)
JAX_DEFAULT = {
    'poisson_3d': {'outer': 4, 'inner_iters': [7, 8, 8, 8]},
    'convection_diffusion': {'gmres_precond': 227, 'gmres_plain': 327},
    'adaptive_poisson': {'sweeps': [[2, 169, 9], [3, 244, 11],
                                    [4, 352, 10]]},
    'subspace_correction_mg': {'twogrid': [31, 32, 8, 30]},
}


def _run(name, small):
    mod = _load(os.path.join(REPO, 'examples', 'torch_%s.py' % name),
                'torch_example_' + name)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = mod.main(device='cpu',
                       **(COUNTS.EXAMPLES_SMALL[name] if small else {}))
    return ret, COUNTS.parse_example(name, buf.getvalue())


@pytest.mark.parametrize('name', sorted(JAX_DEFAULT))
def test_example_default_size_matches_jax(name):
    assert _run(name, small=False)[1] == JAX_DEFAULT[name]


@pytest.mark.parametrize('name', sorted(JAX_SMALL))
def test_example_matches_jax(name):
    ret, got = _run(name, small=True)
    ref = JAX_SMALL[name]
    if name == 'geometry_tour':
        # the twin's lines, then the port's device Hessian check
        assert got['printed'][:len(ref['printed'])] == ref['printed']
        for key, v in ref['values'].items():
            assert abs(ret[key] - v) <= 1e-12 * abs(v), key
    else:
        assert got == ref
