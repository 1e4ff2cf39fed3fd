"""Compare variants of K5's mapping of points to threads, in its forward
(``vform_fields_kernel``) and its adjoint (``vform_adjoint_kernel`` and
the parameter sum), and an earlier generator, on one GPU.

    python3 scripts/torch_vform_adjoint_variants.py [NAME,NAME,...]
                                                    [--parent PATH]

A variant rewrites lines of ``vform_shape`` (the rule both generated
sources carry) in each form's generated sources: ``cols`` sets the rows
threshold to 0 (every last axis mapped to threads), ``adj_mb264`` /
``adj_mb66`` the adjoint's blocks below which RB halves (two an SM, the
forward's; half an SM), ``rows32`` / ``rows64`` / ``rows96`` the
threads and rows of a block in the rows mapping, ``cols_t128`` caps the columns mapping at 128
threads.  ``--parent PATH`` adds an
earlier ``pyiga_tpu_torch/ops/cuda_vform.py`` (e.g. ``git show
HEAD~1:pyiga_tpu_torch/ops/cuda_vform.py > build/old_cuda_vform.py``) as
the variant ``parent``: its own generator, its own ``launch``.  Every
source is compiled into the cache of ``_cuda.build_generated``: the
adjoints of the first variant and of the parent one at a time (nvcc's
seconds printed), the rest in parallel.

Cases at the phases' shapes (operands from the assemblers on the card):
the forward on convection-diffusion at 2D p=3 n=128 and 3D n=48, the
biharmonic and the Laplacian functional at 2D n=128, the Navier-Stokes
convection forms at (16, 32), ``v * ds``, ``inner(v, n) * ds`` and
``inner(grad(u), grad(v)) * ds`` on the 'left' face of the extruded
annulus at 3D n=48 (QL = 1) and the surface ``v * ds`` at n=128; the
adjoint on convection-diffusion, ``(1 + w^2) inner(grad(w), grad(v))``
and the biharmonic at 2D n=128 and on ``inner(grad(u), grad(v)) * ds`` on
the 'left' face.  Every variant's forward is held to ``combo_fields_
plain`` (1e-13 relative) and bitwise to the parent's output (to the first
variant's without ``--parent``); every adjoint to ``run_adjoint_plain``
(1e-13 of each gradient's largest entry) and bitwise on a repeat, its
source gradients compared bitwise with the parent's.  Times, two rounds,
the second in reverse order: the forward's C entry in a CUDA graph over
copies larger than the L2 (``chip_smoke.bare_times``); the adjoint's C
entry so (``kernel``, not for the parent), ``launch`` in a CUDA graph
(``device``) and by the host clock (``host``), and the parts of a
``launch``'s host time (:func:`host_parts`).  Prints ptxas's registers
and spills, the card's ``nvidia-smi`` name and power limit; writes
``chiprun_out/vform_adjoint_variants.json``.  Exits nonzero without a
CUDA device.  Imports neither jax nor pyiga_tpu.
"""

import argparse
import copy
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# name -> [(text of vform_shape, replacement)]
VARIANTS = {
    'shipped': [],
    'cols': [('#define K5_ROWS_QL 8', '#define K5_ROWS_QL 0')],
    'adj_mb264': [('#define K5_ADJ_MIN_BLOCKS 132',
                   '#define K5_ADJ_MIN_BLOCKS (2 * 132)')],
    'adj_mb66': [('#define K5_ADJ_MIN_BLOCKS 132',
                  '#define K5_ADJ_MIN_BLOCKS 66')],
    'rows32': [('s.threads = s.rb = 128;', 's.threads = s.rb = 32;')],
    'rows64': [('s.threads = s.rb = 128;', 's.threads = s.rb = 64;')],
    'rows96': [('s.threads = s.rb = 128;', 's.threads = s.rb = 96;')],
    'cols_t128': [('if (s.threads > 256) s.threads = 256;',
                   'if (s.threads > 128) s.threads = 128;')],
}


def load_parent(path):
    """An earlier ``cuda_vform.py`` as a module of the package (its
    relative imports resolve to this tree's)."""
    spec = importlib.util.spec_from_file_location(
        'pyiga_tpu_torch.ops._parent_cuda_vform', path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def variant(obj, name):
    """A copy of a forward :class:`Program` or an :class:`AdjointProgram`
    whose source has the variant's lines, its entry not yet built."""
    from pyiga_tpu_torch.ops import cuda_vform as cv
    text = obj.source
    for old, new in VARIANTS[name]:
        if old not in text:
            raise RuntimeError('%s: text to replace not found' % name)
        text = text.replace(old, new)
    v = copy.copy(obj)
    v._source, v._entry = text, None
    if isinstance(obj, cv.AdjointProgram):
        v._shape_fn, v._shapes = None, {}
    else:
        v._adjoint = None
    return v


def prebuild(items, serial=()):
    """Compile the generated sources `items` (``(name, source)``) into
    ``_cuda.build_generated``'s cache: the sources in `serial` first, one
    at a time (their seconds timed), then the rest, at most 8 nvcc
    processes at once; returns each source's ptxas lines (registers,
    spills) and the seconds of each serial build."""
    from pyiga_tpu_torch import _cuda
    gen_dir = _cuda.BUILD_DIR / 'gen'
    gen_dir.mkdir(parents=True, exist_ok=True)
    jobs, logs = [], {}
    for name, source in items:
        h = hashlib.sha256(' '.join(_cuda.NVCC_FLAGS).encode())
        h.update(source.encode())
        stem = '%s_%s' % (name, h.hexdigest()[:16])
        lib = gen_dir / ('lib%s.so' % stem)
        if lib.exists() or any(j[0] == lib for j in jobs):
            continue
        src = gen_dir / ('%s.cu' % stem)
        src.write_text(source)
        jobs.append((lib, src, source))
    seconds = {}
    for lib, src, source in [j for j in jobs if j[2] in serial]:
        t0 = time.perf_counter()
        out = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, '-shared',
                              '-o', str(lib) + '.tmp', str(src)],
                             capture_output=True, text=True)
        seconds[source] = time.perf_counter() - t0
        if out.returncode:
            raise RuntimeError('nvcc failed on %s:\n%s%s'
                               % (src, out.stdout, out.stderr))
        os.replace(str(lib) + '.tmp', lib)
        logs[source] = [ln.strip() for ln in (out.stdout + out.stderr)
                        .splitlines() if 'registers' in ln or 'spill' in ln]
    jobs = [j for j in jobs if j[2] not in serial]
    running = []
    for job in jobs + [None] * 8:
        if job is not None:
            lib, src, source = job
            running.append((job, subprocess.Popen(
                [_cuda._nvcc(), *_cuda.NVCC_FLAGS, '-shared', '-o',
                 str(lib) + '.tmp', str(src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
        while running and (len(running) >= 8 or job is None):
            (lib, src, source), proc = running.pop(0)
            out = proc.communicate()[0]
            if proc.returncode:
                raise RuntimeError('nvcc failed on %s:\n%s' % (src, out))
            os.replace(str(lib) + '.tmp', lib)
            logs[source] = [ln.strip() for ln in out.splitlines()
                            if 'registers' in ln or 'spill' in ln]
    return logs, seconds


def cases(dev):
    """The forward and adjoint cases: name -> (assembler, device inputs or
    None)."""
    import chip_smoke as cs
    from pyiga_tpu_torch import compile, geometry
    from pyiga_tpu_torch.assemble import instantiate_assembler
    fwd, adj = {}, {}
    conv = cs.convdiff_setup(128, dev)[2]
    fwd['convdiff 2D n=128'] = adj['convdiff 2D n=128'] = (conv, None)
    fwd['convdiff 3D n=48'] = (cs.convdiff_setup(48, dev, dim=3)[2], None)
    bih = instantiate_assembler(cs.BIHARMONIC, cs.kvs_of(2, 128), {
        'geo': geometry.quarter_annulus()}, None, device=dev)
    fwd['biharmonic 2D n=128'] = adj['biharmonic 2D n=128'] = (bih, None)
    fwd['laplacian functional n=128'] = (compile.compile_vform(
        cs.hessian_input_vf())(cs.kvs_of(2, 128),
                               geo=geometry.quarter_annulus(),
                               f=cs.laplacian_input(cs.kvs_of(2, 128)),
                               device=dev), None)
    w = geometry.BSplineFunc(cs.kvs_of(2, 128), np.random.RandomState(
        7).rand(131, 131))
    adj['(1 + w^2) 2D n=128'] = (instantiate_assembler(
        cs.NONLINEAR, cs.kvs_of(2, 128), {'geo': geometry.quarter_annulus(),
                                          'w': w}, None, device=dev), None)
    mod = cs.load_example('torch_navier_stokes')
    ns = mod.NavierStokes(n_el=cs.NS_N_EL, p=2, Re=20.0, device=dev)
    forms, _ = cs.ns_forms(ns, dev)
    fwd['NS nlconv (16, 32)'] = forms['nlconv']
    fwd['NS linconv (16, 32)'] = forms['linconv']
    face = cs.surface_asm('inner(grad(u), grad(v)) * ds', 3, 48, dev,
                          boundary='left')
    fwd['gradgrad ds left 3D n=48'] = adj['gradgrad ds left 3D n=48'] = (
        face, None)
    fwd['v ds left 3D n=48'] = (cs.surface_asm('v * ds', 3, 48, dev,
                                               boundary='left'), None)
    fwd['normal left 3D n=48'] = (cs.surface_asm(
        'inner(v, n) * ds', 3, 48, dev, boundary='left', bfuns=[('v', 3)]),
        None)
    fwd['surface v ds n=128'] = (cs.surface_vf(dev), None)
    return fwd, adj


def program(asm):
    plan = asm._fold_plan or [(t, False) for t in range(len(asm.combos))]
    return [asm.combos[t] for t, _m in plan]


def fwd_times(prog, arrays, n_out, dev):
    """The forward's C entry in a CUDA graph (``bare_times``)."""
    import chip_smoke
    d, ns = prog.dim, len(prog.sources)
    grid = tuple(w.shape[0] for w in arrays['weights'])
    out = torch.empty((n_out,) + grid, dtype=torch.float64, device=dev)
    operands = (list(arrays['weights']) + [arrays[k] for k in prog.sources]
                + [arrays['params']] * bool(prog.params) + [out])

    def args_of(ts):
        arr = dict(zip(prog.sources, ts[d:d + ns]), weights=ts[:d],
                   params=ts[-2])
        return prog.arguments(arr, ts[-1], 0)[:-1]
    return chip_smoke.bare_times('vform_fields', prog.entry(), operands,
                                 args_of, dev)['device_ms']


def run_fwd(prog, arrays, n_out, dev):
    grid = tuple(w.shape[0] for w in arrays['weights'])
    out = torch.empty((n_out,) + grid, dtype=torch.float64, device=dev)
    err = prog.entry()(*prog.arguments(
        arrays, out, torch.cuda.current_stream(dev).cuda_stream))
    torch.cuda.synchronize(dev)
    if err:
        raise RuntimeError('vform_fields launch failed (%d)' % err)
    return out


def host_parts(adj, arrays, g, dev):
    """Where a ``launch`` spends its host time (ms a call by the host
    clock, ``chip_smoke.host_ms``): the whole call, its allocations
    (``outputs``), its checks and argument list (``arguments``), the
    bare ctypes call of the C entry (its one or two kernel launches), one
    ``torch.empty`` of the first source's shape and an empty kernel's
    launch through ctypes."""
    import chip_smoke
    stream = torch.cuda.current_stream(dev).cuda_stream
    outs = adj.outputs(arrays)
    argv = adj.arguments(arrays, g, outs, stream)
    fn = adj.entry()
    shape = arrays[adj.forward.sources[0]].shape
    parts = {
        'launch': lambda: adj.launch(arrays, g),
        'outputs': lambda: adj.outputs(arrays),
        'arguments': lambda: adj.arguments(arrays, g, outs, stream),
        'ctypes_call': lambda: fn(*argv),
        'torch_empty': lambda: torch.empty(shape, dtype=torch.float64,
                                           device=dev)}
    out = {k: chip_smoke.host_ms(f, dev, reps=200) for k, f in parts.items()}
    out['empty_kernel'] = chip_smoke.empty_launch_ms(dev)
    print('  host parts %s' % ', '.join('%s %.4f' % kv for kv in out.items()),
          flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('names', nargs='?', default=','.join(VARIANTS))
    ap.add_argument('--parent', default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('torch_vform_adjoint_variants: no CUDA device available',
              file=sys.stderr)
        return 2
    import chip_smoke
    from pyiga_tpu_torch.ops import cuda_vform as cv
    names = args.names.split(',')
    card = chip_smoke.nvidia_smi()
    print(card, flush=True)
    dev = torch.device('cuda', 0)
    parent = load_parent(args.parent) if args.parent else None
    fwd_cases, adj_cases = cases(dev)

    # every program in every variant, and the parent's
    progs, arrays = {}, {}
    for case, (asm, inputs) in list(fwd_cases.items()) + list(
            adj_cases.items()):
        arrays[case] = asm.device_arrays(inputs)
        p = asm._program(program(asm))
        for name in names:
            progs[case, name] = variant(p, name)
            if case in adj_cases:
                progs[case, name, 'adj'] = variant(p.adjoint(), name)
        if parent is not None:
            pp = parent.generate(asm, program(asm))
            progs[case, 'parent'] = pp
            if case in adj_cases:
                progs[case, 'parent', 'adj'] = pp.adjoint()
    if parent is not None:
        names = names + ['parent']
    items = [('vform_adjoint' if len(k) == 3 else 'vform_fields', v.source)
             for k, v in progs.items()]
    # the adjoints of the first variant and of the parent built one at a
    # time: the seconds a first backward waits for nvcc
    serial = {v.source for k, v in progs.items()
              if len(k) == 3 and k[1] in (names[0], 'parent')}
    ptxas, seconds = prebuild(items, serial)
    rec = {'card': card, 'variants': {n: VARIANTS.get(n, 'parent')
                                      for n in names},
           'ptxas': {}, 'fwd': {}, 'adj': {}, 'nvcc_s': {}}
    for key, v in progs.items():
        if v.source in seconds:
            rec['nvcc_s'][' '.join(key)] = seconds[v.source]
            print('  nvcc %s: %.1f s' % (' '.join(key), seconds[v.source]),
                  flush=True)
        if key[1] in (names[0], 'parent'):
            rec['ptxas'][' '.join(key)] = ptxas.get(v.source, ['(cached)'])
            print('  ptxas %s: %s' % (' '.join(key), ' | '.join(
                ptxas.get(v.source, ['(cached)']))), flush=True)

    # checks: the forward against its plain version and bitwise against
    # the parent's (the first variant's) output; the adjoint against its
    # plain version, bitwise on a repeat, its source gradients bitwise
    # against the parent's
    rng = np.random.RandomState(0)
    gouts = {}
    ref_name = 'parent' if parent is not None else names[0]
    for case, (asm, _inputs) in fwd_cases.items():
        combos = program(asm)
        ref = torch.stack(cv.combo_fields_plain(asm, arrays[case], combos))
        first = run_fwd(progs[case, ref_name], arrays[case], len(combos),
                        dev)
        for name in names:
            got = run_fwd(progs[case, name], arrays[case], len(combos), dev)
            rel = float((got - ref).abs().max() / ref.abs().max())
            same = torch.equal(got, first)
            if rel > 1e-13 or not same:
                raise RuntimeError('%s fwd %s: rel %.3e, bitwise %s %s'
                                   % (name, case, rel, ref_name, same))
            rec['fwd'].setdefault(case, {})[name] = {
                'rel': rel, 'bitwise_equal_to_' + ref_name: same,
                'grid': list(got.shape[1:])}
    for case in adj_cases:
        p = progs[case, names[0]]
        grid = tuple(w.shape[0] for w in arrays[case]['weights'])
        g = gouts[case] = torch.as_tensor(
            rng.rand(len(p.outputs), *grid) - 0.5, dtype=torch.float64,
            device=dev)
        rg, rp = cv.run_adjoint_plain(p, arrays[case], g)
        refs = [rg[k] for k in p.sources] + ([rp] if rp is not None else [])
        base = None
        for name in [ref_name] + [n for n in names if n != ref_name]:
            a = progs[case, name, 'adj']
            gr, gp = a.launch(arrays[case], g)
            again = a.launch(arrays[case], g)
            got = [gr[k] for k in p.sources] + ([gp] if gp is not None
                                                else [])
            rep = [again[0][k] for k in p.sources] + (
                [again[1]] if gp is not None else [])
            rel = max(float((x - y).abs().max() / y.abs().max().clamp_min(
                1e-300)) for x, y in zip(got, refs))
            if rel > 1e-13 or not all(torch.equal(x, y)
                                      for x, y in zip(got, rep)):
                raise RuntimeError('%s adj %s: rel %.3e or not bitwise on a '
                                   'repeat' % (name, case, rel))
            r = rec['adj'].setdefault(case, {})[name] = {'rel': rel}
            if base is None:
                base = got
                continue
            r['sources_bitwise_equal_to_' + ref_name] = all(
                torch.equal(x, y) for x, y in zip(got[:len(p.sources)],
                                                  base))
            if gp is not None:
                r['params_rel_to_' + ref_name] = float(
                    (got[-1] - base[-1]).abs().max()
                    / base[-1].abs().max().clamp_min(1e-300))
    print('every variant agrees (forward <= 1e-13 of its plain version and '
          'bitwise equal to %s; adjoint <= 1e-13, bitwise on a repeat)'
          % ref_name, flush=True)

    rec['host_parts'] = {case: host_parts(progs[case, names[0], 'adj'],
                                          arrays[case], gouts[case], dev)
                         for case in adj_cases}
    for order in (names, names[::-1]):
        for name in order:
            for case, (asm, _inputs) in fwd_cases.items():
                t = fwd_times(progs[case, name], arrays[case],
                              len(program(asm)), dev)
                rec['fwd'][case][name].setdefault('device_ms', []).append(t)
            for case in adj_cases:
                a, g = progs[case, name, 'adj'], gouts[case]
                r = rec['adj'][case][name]

                def call(i=0, a=a, g=g, arr=arrays[case]):
                    return a.launch(arr, g)
                r.setdefault('device_ms', []).append(
                    chip_smoke.graph_ms(call, dev))
                r.setdefault('host_ms', []).append(
                    chip_smoke.host_ms(call, dev))
                if name != 'parent':
                    r.setdefault('kernel_ms', []).append(
                        chip_smoke.adjoint_bare_times(
                            a, arrays[case], g, dev)['device_ms'])
    for way in ('fwd', 'adj'):
        for case, r in rec[way].items():
            for name, v in r.items():
                print('  %s %-28s %-9s %s' % (way, case, name, '  '.join(
                    '%s %s' % (k, '/'.join('%.4f' % t for t in v[k]))
                    for k in ('device_ms', 'kernel_ms', 'host_ms')
                    if k in v)), flush=True)
    print(card)
    os.makedirs(os.path.join(REPO, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(REPO, 'chiprun_out',
                           'vform_adjoint_variants.json'), 'w') as f:
        json.dump(rec, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
