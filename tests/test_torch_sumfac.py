"""Sum-factorization assembly of the PyTorch port (kernels K2 and K3 by
their plain versions) held against the JAX package's exact f64 path and
the golden stiffness fixtures."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pyiga_tpu.bspline as jbspline
import pyiga_tpu.geometry as jgeometry
from pyiga_tpu import assemblers as jassemblers
from pyiga_tpu.mlmatrix import transpose_idx_for_bidx
from pyiga_tpu.ops import banded as jbanded
from pyiga_tpu.ops import sumfac as jsumfac
from pyiga_tpu.utils import read_sparse_matrix

from pyiga_tpu_torch import bspline, convert, geometry
from pyiga_tpu_torch.assemblers import StiffnessAssembler
from pyiga_tpu_torch.ops import cuda_sumfac, sumfac
from pyiga_tpu_torch.ops.banded import flat_banded_to_csr

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), 'fixtures')


def _tree(gi):
    return {k: [jnp.asarray(a) for a in v] if isinstance(v, list)
            else jnp.asarray(v) for k, v in gi.items()}


def _jax_asm(name, p, n):
    jgeo = getattr(jgeometry, name)()
    jkvs = jgeo.sdim * (jbspline.make_knots(p, 0.0, 1.0, n),)
    return jassemblers.StiffnessAssembler(jkvs, jgeo)


def _port_asm(name, p, n):
    geo = getattr(geometry, name)()
    return StiffnessAssembler(geo.sdim * (bspline.make_knots(p, 0.0, 1.0, n),),
                              geo, device='cpu')


@pytest.mark.parametrize('name,p,n', [('twisted_box', 3, 6),
                                      ('quarter_annulus', 3, 10),
                                      ('twisted_box', 2, 7)])
def test_flat_banded_assembly_vs_jax_exact(name, p, n):
    """The port's folded chain + relayout equals JAX's exact folded chains
    over banded tables + banded_reorder + flat_banded_data."""
    jasm = _jax_asm(name, p, n)
    bws = jbanded.band_info(jasm.structure)
    ns = tuple(b[0] for b in jasm.structure.bs)
    bsz = tuple(2 * b + 1 for b in bws)
    btabs = jasm.tables.banded_term_tables(jasm.terms, bws)
    plan, _ = jasm._fold()
    tperms = [jnp.asarray(jsumfac.banded_transpose_perm(m, bw))
              for m, bw in zip(ns, bws)]
    data = jsumfac.assemble_terms_folded(
        [[jnp.asarray(T) for T in tabs] for tabs in btabs],
        jassemblers.stiffness_fields(_tree(jasm._geo_inputs)), tuple(plan),
        tperms, mode='exact', last_idx=jsumfac.last_table_groups(btabs))
    Db = np.asarray(jsumfac.banded_reorder(data, bsz, ns))
    flat = jbanded.flat_banded_data(Db, bws, ns)
    C, F = int(np.prod(bsz)), int(np.prod(ns))
    ref = flat.reshape(C, -1)[:, :F]

    op = _port_asm(name, p, n).assemble_banded()
    assert op.D.dtype == torch.float64 and op.D.shape == (C, F)
    D = op.D.numpy()
    assert np.abs(D - ref).max() / np.abs(ref).max() < 1e-13
    # convert carries the JAX banded layout into the same flat tensor
    assert torch.equal(convert.flat_banded(Db, bws, ns, device='cpu'),
                       torch.as_tensor(ref))
    # the port's plain folded chain over the same banded tables, with the
    # banded transpose permutations, reorders to the same (b..., n...) data
    asm = _port_asm(name, p, n)
    tabs = [[torch.as_tensor(T) for T in t]
            for t in asm.tables.banded_term_tables(asm.terms, bws)]
    tp = [torch.as_tensor(sumfac.banded_transpose_perm(m, bw))
          for m, bw in zip(ns, bws)]
    plain = sumfac.assemble_terms_folded(
        tabs, cuda_sumfac.stiffness_fields(asm.geo_inputs()), asm._fold(), tp)
    got = sumfac.banded_reorder(plain, bsz, ns).numpy()
    assert np.abs(got - Db).max() / np.abs(Db).max() < 1e-13


@pytest.mark.parametrize('fixture,name,p,n', [
    ('poisson_neu_d3_p2_n10_stiff.mtx.gz', 'twisted_box', 2, 10),
    ('poisson_neu_d2_p3_n15_stiff.mtx.gz', 'bspline_quarter_annulus', 3, 15),
])
def test_golden_stiffness(fixture, name, p, n):
    op = _port_asm(name, p, n).assemble_banded()
    A = flat_banded_to_csr(op.D, op.bws, op.ns)
    A_ref = read_sparse_matrix(os.path.join(FIXTURES, fixture))
    assert A.shape == A_ref.shape
    assert abs(A - A_ref).max() < 1e-14


@pytest.mark.parametrize('name,p,n', [('twisted_box', 3, 5),
                                      ('quarter_annulus', 2, 8)])
def test_compact_folded_chain_vs_jax(name, p, n):
    """The plain tensordot chain with compact pair tables and transpose
    permutations equals JAX's exact compact assembly."""
    jasm = _jax_asm(name, p, n)
    ref = jasm.assemble(mode='exact').data
    asm = _port_asm(name, p, n)
    tabs = [[torch.as_tensor(T) for T in t]
            for t in asm.tables.term_tables(asm.terms)]
    fields = cuda_sumfac.stiffness_fields(asm.geo_inputs())
    tperms = [torch.as_tensor(transpose_idx_for_bidx(bx))
              for bx in asm.structure.bidx]
    got = sumfac.assemble_terms_folded(tabs, fields, asm._fold(), tperms)
    assert np.abs(got.numpy() - ref).max() / np.abs(ref).max() < 1e-13
    chain = sumfac.contract_chain(tabs[0], fields[0])
    jchain = jsumfac.contract_chain([jnp.asarray(T.numpy()) for T in tabs[0]],
                                    jnp.asarray(fields[0].numpy()))
    assert np.abs(chain.numpy() - np.asarray(jchain)).max() \
        <= 1e-14 * np.abs(np.asarray(jchain)).max()


@pytest.mark.parametrize('d', [2, 3])
def test_chain_folded_plain(d):
    """K2 stages + the K3 fold with deduplicated last tables equal the sum
    of plain tensordot chains."""
    rng = np.random.RandomState(d)
    Q, M, nterms = 7, 5, 4
    tables = [[torch.as_tensor(rng.rand(M + k, Q)) for k in range(d)]
              for _ in range(nterms)]
    tables[2][-1] = tables[0][-1]        # shared last table
    fields = [torch.as_tensor(rng.rand(*(d * (Q,)))) for _ in range(nterms)]
    last_idx = sumfac.last_table_groups(tables)
    assert last_idx == (0, 1, 0, 2)
    got = cuda_sumfac.chain_folded(tables, fields, last_idx)
    ref = sum(sumfac.contract_chain(t, F) for t, F in zip(tables, fields))
    assert got.shape == tuple(M + k for k in range(d))
    assert torch.allclose(got, ref, rtol=1e-14, atol=0)
    X = torch.as_tensor(rng.rand(Q, 11))
    assert torch.allclose(cuda_sumfac.stage(X, tables[0][0]),
                          X.T @ tables[0][0].T, rtol=1e-14, atol=0)
