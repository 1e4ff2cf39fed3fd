"""API parity guard: the public names of ``pyiga_tpu`` that
``pyiga_tpu_torch`` lacks, by an AST diff of the two packages' sources,
equal an explicit list of what is not ported on purpose or not yet.  A
ported name that goes missing fails here, and a slice that ports more
shortens the list.

A public name is a module-level function, class or assignment whose name
does not start with an underscore, or a method, property or class-level
assignment of a public class (``__getitem__`` and ``__str__`` count,
other dunders do not); each module is a name too.  The repository's
``__graft_entry__.py`` counts as a module of the JAX package."""

import ast
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DUNDERS = ('__getitem__', '__str__')


def _class_names(node):
    out = set()
    for m in node.body:
        if isinstance(m, ast.FunctionDef):
            names = [m.name]
        elif isinstance(m, ast.Assign):
            names = [t.id for t in m.targets if isinstance(t, ast.Name)]
        else:
            names = []
        out.update(n for n in names
                   if not n.startswith('_') or n in DUNDERS)
    return out


def _module_names(path, mod):
    out = {('mod', mod)}
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names = [node.name]
        elif isinstance(node, ast.Assign):
            names = [t.id for t in node.targets if isinstance(t, ast.Name)]
        else:
            names = []
        for name in names:
            if name.startswith('_'):
                continue
            out.add((mod, name))
            if isinstance(node, ast.ClassDef):
                out.update((mod, name + '.' + m) for m in _class_names(node))
    return out


def public_names(pkg):
    root = os.path.join(REPO, pkg)
    out = set()
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith('.py'):
                path = os.path.join(dirpath, f)
                mod = os.path.relpath(path, root)[:-3].replace(os.sep, '.')
                out |= _module_names(path, mod)
    return out


# modules not ported as a whole: item 11's multi-device layer and the
# design stance (two-float pairs, the Pallas modules)
WHOLE_MODULES = ('parallel.__init__', 'parallel.flagship', 'ops.twofloat',
                 'ops.pallas_sumfac', 'ops.mg_pallas')

# item 11: the host cutoffs of config and the multi-device dry run
ITEM_11 = {('config', n) for n in ('host_assembly_cutoff',
                                   'host_solve_cutoff',
                                   'set_host_assembly_cutoff',
                                   'set_host_solve_cutoff')} | {
    ('__graft_entry__', 'dryrun_multichip')}

# the design stance: two-float pairs, Ozaki, the Pallas field functions,
# the TPU-only config names, the VMEM-fitting banded variant
DROPPED = {('assemblers', n) for n in (
    'BaseGaussAssembler.pair_field_fn', 'BaseGaussAssembler.pallas_field_fn',
    'MassAssembler.pair_field_fn', 'MassAssembler.pallas_field_fn',
    'StiffnessAssembler.pair_field_fn', 'StiffnessAssembler.pallas_field_fn',
    'mass_fields_df_pair', 'stiffness_fields_df_pair')} | {
    ('compile', 'PairAsmContext')} | {
    ('config', n) for n in (
        'compile_cache_dir', 'default_device', 'get_backend', 'set_backend',
        'pallas_interpret_mode', 'set_pallas_interpret', 'use_x64')} | {
    ('ops.banded', n) for n in (
        'BandedOperatorPair', 'BandedOperatorPair.matvec',
        'BandedOperatorPair.set_data_f64', 'FlatBandedOperatorPair',
        'FlatBandedOperatorPair.matvec', 'banded_matvec_pair',
        'banded_matvec_pair_static', 'flat_banded_pad_blocked',
        'flat_banded_pair_from_padded_chain')} | {
    ('ops.geom', n) for n in (
        'det_and_inv_df', 'det_and_inv_df_pairs', 'det_df_pairs',
        'geo_jac_stage12_df', 'geo_jacobian_field_df', 'tp_apply_df')} | {
    ('ops.sumfac', n) for n in (
        'assemble_terms_folded_pair', 'contract_chain_ozaki',
        'contract_chain_ozaki_pair', 'run_matrix_assembly_pair')}


def _missing():
    jax_names = public_names('pyiga_tpu')
    jax_names |= _module_names(os.path.join(REPO, '__graft_entry__.py'),
                               '__graft_entry__')
    return jax_names - public_names('pyiga_tpu_torch')


def test_missing_names_are_the_listed_ones():
    missing = _missing()
    whole = {('mod', m) for m in WHOLE_MODULES}
    assert whole <= missing, 'now ported: %s' % sorted(whole - missing)
    missing = {n for n in missing - whole if n[0] not in WHOLE_MODULES}
    expected = ITEM_11 | DROPPED
    assert not missing - expected, 'ported names lost or new gaps: %s' % \
        sorted(missing - expected)
    assert not expected - missing, 'listed as missing but present: %s' % \
        sorted(expected - missing)


def test_item_10_part_1_is_complete():
    """No name of item 10's first part is missing."""
    part1_modules = ('bspline', 'geometry', 'utils', 'mlmatrix',
                     'operators', 'solvers', 'stilde', 'spline',
                     'assemblers', 'ops.sumfac', 'ops.geom')
    lost = sorted(n for n in _missing() - DROPPED if n[0] in part1_modules
                  or n in (('mod', 'stilde'), ('mod', 'spline')))
    assert not lost, lost


def test_item_10_is_complete():
    """No name of item 10's second part (the tensor-approximation pillar,
    the command line, the entry twin) or of item 11's single-process
    layers (profiling, plotting) is missing, the multi-device dry run
    aside."""
    modules = ('tensor', '_cli', '__graft_entry__', 'profiling', 'vis')
    lost = sorted(n for n in _missing() - ITEM_11
                  if n[0] in modules or n in {('mod', m) for m in modules})
    assert not lost, lost
