"""The port's notebooks (``notebooks_torch/``): one copy of each notebook
of ``notebooks/``, importing the example twin ``examples/torch_*.py`` of
the JAX notebook's example and calling it with the JAX notebook's
arguments plus ``device=device`` (the import cell sets ``device =
None``, the card).  The two light ones (geometry, multipatch) run here
with ``device = 'cpu'`` set after the import cell."""

import ast
import json
import os

import nbformat
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, 'notebooks_torch')
JAX = os.path.join(REPO, 'notebooks')
NAMES = sorted(os.listdir(JAX))


def _code(path):
    nb = json.load(open(path))
    return [''.join(c['source']) for c in nb['cells']
            if c['cell_type'] == 'code']


def _imported(cells):
    return [line.split()[1] for s in cells for line in s.splitlines()
            if line.startswith('from ') and ' import *' in line]


def _calls(src):
    """(callee, positional args, keywords) of every call of an example's
    entry, as source text."""
    out = []
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in ('main', 'NavierStokes'):
            out.append((node.func.id, [ast.unparse(a) for a in node.args],
                        {k.arg: ast.unparse(k.value)
                         for k in node.keywords}))
    return out


def test_every_notebook_has_a_port():
    assert len(NAMES) == 10
    assert sorted(os.listdir(PORT)) == NAMES


@pytest.mark.parametrize('name', NAMES)
def test_notebook_copy(name):
    path = os.path.join(PORT, name)
    nbformat.validate(nbformat.read(path, as_version=4))
    cells, jcells = _code(path), _code(os.path.join(JAX, name))
    (mod,), (jmod,) = _imported(cells), _imported(jcells)
    assert mod == 'torch_' + jmod
    assert os.path.exists(os.path.join(REPO, 'examples', mod + '.py'))
    tree = ast.parse(cells[0])
    sets = [n for n in tree.body if isinstance(n, ast.Assign)
            and [t.id for t in n.targets] == ['device']]
    assert len(sets) == 1 and ast.unparse(sets[0].value) == 'None'
    assert 'jax' not in ''.join(cells) and 'pyiga_tpu.' not in ''.join(cells)
    calls, jcalls = _calls(cells[1]), _calls(jcells[1])
    assert calls and len(calls) == len(jcalls)
    for (f, args, kw), (jf, jargs, jkw) in zip(calls, jcalls):
        assert f == jf and args == jargs
        assert kw.pop('device') == 'device'
        assert kw == jkw


@pytest.mark.parametrize('name', ['geometry.ipynb', 'multipatch.ipynb'])
def test_light_notebooks_run_on_cpu(name, monkeypatch, capsys):
    monkeypatch.chdir(PORT)
    monkeypatch.setattr('sys.path', list(__import__('sys').path))
    cells = _code(name)
    g = {}
    exec(cells[0], g)
    assert g['device'] is None
    g['device'] = 'cpu'
    for src in cells[1:]:
        exec(src, g)
    out = capsys.readouterr().out
    assert ('interface jump: 0.00e+00' in out if name == 'multipatch.ipynb'
            else 'disk Hessian, cpu vs host' in out)
