"""The fused stage-2 + fold tail of the PyTorch port (kernel K7: the
transposed stage ``stage_T`` and ``tail_fused``, by their plain versions
on the CPU) held against numpy, against the K2 + K3 route it replaces,
and against the JAX package's exact f64 assembly: the banded and compact
layouts of the 3D stiffness and mass assemblers and a 3D VForm, the
golden 3D stiffness fixture, the deduplication indices of
``pallas_sumfac.stage_table_dedup_idx``, and the static gate."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pyiga_tpu.bspline as jbspline
import pyiga_tpu.geometry as jgeometry
from pyiga_tpu import assemble as jassemble
from pyiga_tpu import assemblers as jassemblers
from pyiga_tpu.mlmatrix import transpose_idx_for_bidx as jtranspose_idx
from pyiga_tpu.ops import pallas_sumfac as jps
from pyiga_tpu.ops import sumfac as jsumfac
from pyiga_tpu.utils import read_sparse_matrix

from pyiga_tpu_torch import _cuda, assemble, assemblers, bspline, geometry
from pyiga_tpu_torch.ops import cuda_sumfac, sumfac
from pyiga_tpu_torch.ops.banded import flat_banded_to_csr

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), 'fixtures')
CONVDIFF3 = ('(inner(grad(u), grad(v)) + dot(b, grad(u)) * v + u * v) '
             '* dx')


@pytest.fixture
def tail_on(monkeypatch):
    """Switch the tail route on and count its launches through the
    wrapper (the CPU runs the plain version and counts no kernel)."""
    calls = []
    wrapped = cuda_sumfac.tail_fused

    def counting(*args):
        calls.append(args)
        return wrapped(*args)
    monkeypatch.setattr(cuda_sumfac, 'TAIL_FUSED', True)
    monkeypatch.setattr(cuda_sumfac, 'tail_fused', counting)
    return calls


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def test_plain_versions_match_einsum():
    rng = np.random.RandomState(0)
    X, T = rng.rand(7, 30), rng.rand(5, 7)
    ref = np.einsum('kr,mk->mr', X, T)
    got = cuda_sumfac.stage_T_plain(torch.as_tensor(X), torch.as_tensor(T))
    assert got.shape == (5, 30) and _rel(got, ref) < 1e-15
    M1, K2, K3, M2, M3 = 4, 6, 5, 7, 3
    x1T = [rng.rand(M1, K2, K3) for _ in range(4)]
    tc2 = [rng.rand(M2, K2) for _ in range(2)]
    tc3 = [rng.rand(M3, K3) for _ in range(3)]
    idx2, idx3 = [0, 1, 1, 0], [2, 0, 1, 2]
    ref = sum(np.einsum('ajk,bj,ck->abc', x, tc2[i], tc3[k])
              for x, i, k in zip(x1T, idx2, idx3))
    args = ([torch.as_tensor(x) for x in x1T],
            [torch.as_tensor(t) for t in tc2],
            [torch.as_tensor(t) for t in tc3], idx2, idx3)
    before = dict(_cuda.LAUNCHES)
    got = cuda_sumfac.tail_fused(*args)
    assert got.shape == (M1, M2, M3) and _rel(got, ref) < 1e-14
    assert torch.equal(got, cuda_sumfac.tail_fused_plain(*args))
    assert torch.equal(cuda_sumfac.stage_T(torch.as_tensor(X),
                                           torch.as_tensor(T)),
                       cuda_sumfac.stage_T_plain(torch.as_tensor(X),
                                                 torch.as_tensor(T)))
    assert _cuda.LAUNCHES == before          # the CPU launches nothing
    with pytest.raises(ValueError):
        cuda_sumfac.tail_fused(args[0], args[1], args[2], idx2[:2], idx3)


def test_wrappers_refuse_other_devices():
    meta = torch.empty((3, 4, 5), dtype=torch.float64, device='meta')
    with pytest.raises(ValueError):
        cuda_sumfac.stage_T(meta[0], meta[0, :, :4])
    with pytest.raises(ValueError):
        cuda_sumfac.tail_fused([meta], [meta[0, :, :4]], [meta[0]], [0], [0])


def _asm(kind, p, n, geo='twisted_box'):
    kvs = 3 * (bspline.make_knots(p, 0.0, 1.0, n),)
    g = getattr(geometry, geo)()
    if kind == 'vform':
        return assemble.instantiate_assembler(
            CONVDIFF3, kvs, {'geo': g, 'b': np.array([1.0, -2.0, 0.5])},
            None, device='cpu')
    cls = {'stiffness': assemblers.StiffnessAssembler,
           'mass': assemblers.MassAssembler}[kind]
    return cls(kvs, g, device='cpu')


def _assembled(asm, layout):
    if layout == 'banded':
        return asm.assemble_banded().D
    out = asm.run_device()
    return out[(None, None)] if isinstance(out, dict) else out


@pytest.mark.parametrize('kind,layout', [
    ('stiffness', 'banded'), ('stiffness', 'compact'), ('mass', 'banded'),
    ('mass', 'compact'), ('vform', 'compact')])
def test_switch_on_equals_switch_off(kind, layout, monkeypatch):
    """``chain_folded`` with the switch on (K7) against the same call with
    it off (K2 stages + K3), for the flat banded layout (0.5-prescaled
    direct first tables), the compact layout (direct and mirrored groups)
    and a 3D VForm: 1e-14 relative."""
    asm = _asm(kind, 2, 4)
    off = _assembled(asm, layout)
    calls = []
    wrapped = cuda_sumfac.tail_fused
    monkeypatch.setattr(cuda_sumfac, 'TAIL_FUSED', True)
    monkeypatch.setattr(cuda_sumfac, 'tail_fused',
                        lambda *a: calls.append(a) or wrapped(*a))
    on = _assembled(asm, layout)
    groups = 2 if (layout == 'compact' and kind != 'mass') else 1
    assert len(calls) == groups
    assert on.shape == off.shape
    assert _rel(on, off) < 1e-14


def _jax_stiffness(p, n):
    jgeo = jgeometry.twisted_box()
    jkvs = 3 * (jbspline.make_knots(p, 0.0, 1.0, n),)
    return jkvs, jgeo, jassemblers.StiffnessAssembler(jkvs, jgeo)


def test_tail_route_matches_jax_exact(tail_on):
    """The compact tail route against ``sumfac.assemble_terms_folded
    (mode='exact')`` on JAX's own tables and fields, and
    ``assemble.stiffness`` against ``pyiga_tpu.assemble.stiffness``
    (1e-13)."""
    p, n = 3, 4
    jkvs, jgeo, jasm = _jax_stiffness(p, n)
    tabs = jasm.tables.term_tables(jasm.terms)
    plan, _ = jasm._fold()
    tperms = [jnp.asarray(jtranspose_idx(bx)) for bx in jasm.structure.bidx]
    fields = jassemblers.stiffness_fields(
        {k: [jnp.asarray(a) for a in v] if isinstance(v, list)
         else jnp.asarray(v) for k, v in jasm._geo_inputs.items()})
    ref = np.asarray(jsumfac.assemble_terms_folded(
        [[jnp.asarray(T) for T in t] for t in tabs], fields, tuple(plan),
        tperms, mode='exact'))
    asm = _asm('stiffness', p, n)
    got = asm.run_device()
    assert len(tail_on) == 2 and _rel(got, ref) < 1e-13
    kvs = 3 * (bspline.make_knots(p, 0.0, 1.0, n),)
    A = assemble.stiffness(kvs, geometry.twisted_box(), device='cpu')
    A_ref = jassemble.stiffness(jkvs, jgeo)
    assert abs(A - A_ref).max() <= 1e-13 * abs(A_ref).max()


@pytest.mark.parametrize('layout', ['compact', 'banded'])
def test_golden_fixture_through_the_tail(layout, tail_on):
    kvs = 3 * (bspline.make_knots(2, 0.0, 1.0, 10),)
    ref = read_sparse_matrix(os.path.join(
        FIXTURES, 'poisson_neu_d3_p2_n10_stiff.mtx.gz'))
    if layout == 'compact':
        A = assemble.stiffness(kvs, geometry.twisted_box(), device='cpu')
    else:
        op = assemblers.StiffnessAssembler(kvs, geometry.twisted_box(),
                                           device='cpu').assemble_banded()
        A = flat_banded_to_csr(op.D, op.bws, op.ns)
    assert tail_on and A.shape == ref.shape
    assert abs(A - ref).max() < 1e-14


@pytest.mark.parametrize('kind', ['stiffness', 'vform'])
def test_dedup_indices_match_jax(kind, tail_on):
    """Per stage, the tail route's identity groups of a plan's tables
    equal ``pallas_sumfac.stage_table_dedup_idx`` on JAX's prepared tables
    of the same plan, and the tail launch of each group receives them."""
    p, n = 2, 3
    asm = _asm(kind, p, n)
    if kind == 'vform':
        from pyiga_tpu import compile as jcompile
        from pyiga_tpu import vform as jvform
        jkvs = 3 * (jbspline.make_knots(p, 0.0, 1.0, n),)
        b = np.array([1.0, -2.0, 0.5])
        jasm = jcompile.compile_vform(jvform.parse_vf(
            CONVDIFF3, jkvs, args={'b': b}))(
                jkvs, geo=jgeometry.twisted_box(), b=b)
        jtabs = jasm._term_tables_for(jasm.combos)
        plan = jasm._fold_plan
        assert plan == asm._fold_plan
        tabs = asm._device_operands()['term_tables']
    else:
        _, _, jasm = _jax_stiffness(p, n)
        jtabs = jasm.tables.term_tables(jasm.terms)
        plan = jasm._fold()[0]
        assert plan == asm._fold()
        tabs = asm._compact_operands()['term_tables']
    prepped = [[jps.prepare_table(T) for T in t] for t in jtabs]
    ref = jps.stage_table_dedup_idx(prepped, tuple(plan))

    def groups(terms):
        return tuple(tuple(cuda_sumfac._dedup([tabs[t][k] for t in terms])[1])
                     for k in range(3))
    assert groups([t for t, _m in plan]) == ref
    asm.run_device()
    for mirrored, call in zip((False, True), tail_on):
        group = groups([t for t, m in plan if m == mirrored])
        assert tuple(call[3]) == group[1] and tuple(call[4]) == group[2]


def test_gate(monkeypatch):
    rng = np.random.RandomState(1)

    def chain(d, Q=5, M=4):
        return ([torch.as_tensor(rng.rand(M, Q)) for _ in range(d)],
                torch.as_tensor(rng.rand(*(d * (Q,)))))
    t3, F3 = zip(*[chain(3) for _ in range(3)])
    t2, F2 = zip(*[chain(2) for _ in range(3)])
    assert not cuda_sumfac.tail_supported(t3, F3)         # switch off
    monkeypatch.setattr(cuda_sumfac, 'TAIL_FUSED', True)
    assert cuda_sumfac.tail_supported(t3, F3)
    assert not cuda_sumfac.tail_supported(t2, F2)         # 2D refused
    odd = [list(t) for t in t3]
    odd[1][2] = torch.as_tensor(rng.rand(6, 5))           # other M3
    assert not cuda_sumfac.tail_supported(odd, F3)
    # a 2D chain through chain_folded keeps the K2 + K3 route
    li = sumfac.last_table_groups(t2)
    ref = sum(sumfac.contract_chain(t, F) for t, F in zip(t2, F2))
    assert torch.allclose(cuda_sumfac.chain_folded(t2, F2, li), ref,
                          rtol=1e-14, atol=0)
