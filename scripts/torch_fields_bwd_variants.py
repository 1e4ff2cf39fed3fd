"""Compare mapping variants of K1's backward (``geo_fields_bwd_kernel``,
its three kinds) and of K1's forward on a one-point last axis on one GPU.

    python3 scripts/torch_fields_bwd_variants.py [NAME,NAME,...]
                                                 [--parent PATH]

Builds one library per variant of ``pyiga_tpu_torch/csrc/fields.cu`` (its
templates, ``fields.cuh``, inlined), all
``nvcc`` processes at once, under ``build/fields_bwd_variants/``.  A
variant rewrites lines of the source: the backward's threads a block and
a kind's ``BwdTune`` (its blocks an SM for ``__launch_bounds__``, so its
registers; the points a lane walks before a row's team of lanes widens;
the points whose gout is in flight), K1's rows threshold (``cols``: 0,
every last axis mapped to threads, the forward's mapping before its rows
branch), or cuts a part out (``cut_*``: timed, not checked).
``--parent PATH`` adds an earlier ``fields.cu`` with the same C entries
as the variant ``parent``.
Shapes: the 3D p=3 n=48 twisted box (stiffness, ``mass`` and ``jac``),
the 2D p=3 n=128 NURBS quarter annulus (``jac``), the surface ``v * ds``
at n=128 (G = 3), the 'left' (QL = 1) and 'bottom' faces of the extruded
annulus at 3D n=48; operands from the port's plain path on the CPU, moved
to the card.  Every variant's backward is held against
``_fields_vjp_plain`` (1e-13 relative, bitwise on a repeat), every
forward against its plain version (1e-13) and bitwise against the first
variant's output.  Times: the device time of one launch
(``chip_smoke.bare_times``: a CUDA graph over copies of the operands
larger than the L2) in two rounds, the second in reverse order.  Prints
ptxas's registers and spills of the instances at these shapes, the
card's ``nvidia-smi`` name and power limit; writes
``chiprun_out/fields_bwd_variants.json``.  Exits nonzero without a CUDA
device.  Imports neither jax nor pyiga_tpu.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# the shipped lines of BwdTune in csrc/fields.cuh: for the stiffness, mass
# and jac kinds the blocks an SM (registers), a lane's points before its
# row's team widens, the points whose gout is in flight
TUNE = 'static constexpr int %s = KIND == kStiffness ? %d : KIND == kMass ? %d : %d;'
SHIPPED = {'minb': (3, 4, 1), 'pts': (12, 24, 12), 'pf': (2, 4, 1)}


def tune(field, *values):
    """The substitution of BwdTune's line `field` by `values`."""
    return (TUNE % ((field,) + SHIPPED[field]), TUNE % ((field,) + values))


# the mass kind's VJP cut to gJ = g jh (no adj J, no det J): what the
# rest of the kernel costs
MASS_VJP = ('            const double f = copysign(gw, det) * go[0];\n'
            '#pragma unroll\n'
            '            for (int c = 0; c < D; ++c)\n'
            '#pragma unroll\n'
            '                for (int k = 0; k < D; ++k) gJ[c][k] = f * adj[k][c];\n')
# name -> [(text of csrc/fields.cu with csrc/fields.cuh inlined,
# replacement)]; a name starting 'cut' computes garbage and is timed, not
# checked
VARIANTS = {
    'shipped': [],
    'pm12': [tune('pts', 12, 12, 12)],
    'pm48': [tune('pts', 12, 48, 12)],
    'pf_m2': [tune('pf', 2, 2, 1)],
    'pf_m6': [tune('pf', 2, 6, 1)],
    'pf_s4': [tune('pf', 4, 4, 1)],
    'pf_j2': [tune('pf', 2, 4, 2)],
    't256': [('constexpr int kBwdThreads = 128;',
              'constexpr int kBwdThreads = 256;'), tune('minb', 1, 2, 1)],
    'cut_mass_vjp': [(MASS_VJP, MASS_VJP.replace(
        'copysign(gw, det) * go[0]', 'gw * go[0]').replace('adj[k][c]',
                                                           'J[c][k]'))],
    'cols': [('constexpr int kRowsQL = 8;', 'constexpr int kRowsQL = 0;')],
}
KIND_CODE = {'stiffness': 0, 'mass': 1, 'jac': 2}


def build(names, parent):
    """One library per variant, all nvcc processes started together;
    returns the loaded libraries and their ptxas lines."""
    import chip_smoke
    from pyiga_tpu_torch import _cuda
    src_dir = os.path.join(REPO, 'pyiga_tpu_torch', 'csrc')
    with open(os.path.join(src_dir, 'fields.cuh')) as f:
        header = f.read()
    procs = {}
    for name in names:
        d = os.path.join(REPO, 'build', 'fields_bwd_variants', name)
        os.makedirs(d, exist_ok=True)
        with open(parent if name == 'parent'
                  else os.path.join(src_dir, 'fields.cu')) as f:
            # K1's templates inline, where a variant's lines are
            text = f.read().replace('#include "fields.cuh"', header)
        for old, new in VARIANTS.get(name, []):
            if old not in text:
                raise RuntimeError('%s: text to replace not found' % name)
            text = text.replace(old, new)
        src = os.path.join(d, 'fields.cu')
        with open(src, 'w') as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, '-I', src_dir, '-shared',
             '-o', os.path.join(d, 'lib.so'), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, ptxas = {}, {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError('nvcc failed on %s:\n%s' % (name, out))
        ptxas[name] = chip_smoke.fields_ptxas(out)
        lib = ctypes.CDLL(os.path.join(REPO, 'build', 'fields_bwd_variants',
                                       name, 'lib.so'))
        for fn in ('pyiga_fields_bwd_f64', 'pyiga_geo_jac_fields_f64',
                   'pyiga_stiff_fields_f64', 'pyiga_mass_fields_f64'):
            getattr(lib, fn).argtypes = list(_cuda._SIGNATURES[fn])
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs, ptxas


def operands(dev):
    """K1's operands ``(Y, T, w12, wL, nurbs)`` at the probe's shapes,
    from the plain path on the CPU."""
    import chip_smoke
    from pyiga_tpu_torch import geometry
    from pyiga_tpu_torch.assemblers import StiffnessAssembler
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    cpu = torch.device('cpu')
    out = {}
    asm = chip_smoke.main_path_setup(3, 48, cpu)
    (Y, T, w12, wL, nurbs), _ = cs._spline_stages(asm.geo_inputs())
    out['3D n=48'] = (Y, T, w12, wL, nurbs)
    a2 = StiffnessAssembler(chip_smoke.kvs_of(2, 128),
                            geometry.quarter_annulus(), device=cpu)
    (Y, T, w12, wL, nurbs), _ = cs._spline_stages(a2.geo_inputs())
    out['annulus n=128'] = (Y, T, None, None, nurbs)
    for name, asm in (
            ('surface n=128', chip_smoke.surface_vf(cpu)),
            ('face left n=48', chip_smoke.surface_asm('v * ds', 3, 48, cpu,
                                                      boundary='left')),
            ('face bottom n=48', chip_smoke.surface_asm(
                'v * ds', 3, 48, cpu, boundary='bottom'))):
        ops = asm._device_operands()
        d = len(ops['geo_tables'])
        Y, _ = cs.geo_stage12(ops['geo_tables'], ops['geo_coeffs'], d)
        T = ops['geo_tables'][d - 1][:2].contiguous()
        out[name] = (Y, T, None, None, asm._geo_is_nurbs)
    return {k: tuple(t.to(dev) if torch.is_tensor(t) else t for t in v)
            for k, v in out.items()}


# (shape, kind) of the backward and of the forward
BWD_CASES = [('3D n=48', 'stiffness'), ('3D n=48', 'mass'),
             ('3D n=48', 'jac'), ('annulus n=128', 'jac'),
             ('surface n=128', 'jac'), ('face left n=48', 'jac')]
FWD_CASES = [('3D n=48', 'stiffness'), ('3D n=48', 'mass'),
             ('3D n=48', 'jac'), ('annulus n=128', 'jac'),
             ('surface n=128', 'jac'), ('face left n=48', 'jac'),
             ('face bottom n=48', 'jac')]


def out_shape(kind, Y, QL, nurbs):
    d, C, Q12, _nL = Y.shape
    G = C - int(nurbs)
    return {'stiffness': (d * (d + 1) // 2, Q12, QL), 'mass': (Q12, QL),
            'jac': (G + G * d, Q12, QL)}[kind]


def bwd_call(lib, kind, ops):
    """``(fn, operands, args_of)`` of a backward launch on `ops`."""
    Y, T, w12, wL, nurbs, g = ops
    d, C, Q12, nL = Y.shape
    return (lib.pyiga_fields_bwd_f64, [Y, T, w12, wL, g, torch.empty_like(Y)],
            lambda ts: (KIND_CODE[kind],) + tuple(t.data_ptr() for t in ts)
            + (d, C - int(nurbs), int(nurbs), Q12, T.shape[1], nL))


def fwd_call(lib, kind, ops):
    Y, T, w12, wL, nurbs = ops[:5]
    d, C, Q12, nL = Y.shape
    QL = T.shape[1]
    out = torch.empty(out_shape(kind, Y, QL, nurbs), dtype=torch.float64,
                      device=Y.device)
    if kind == 'jac':
        return (lib.pyiga_geo_jac_fields_f64, [Y, T, out],
                lambda ts: (ts[0].data_ptr(), ts[1].data_ptr(),
                            ts[2].data_ptr(), d, C - int(nurbs), int(nurbs),
                            Q12, QL, nL))
    fn = (lib.pyiga_stiff_fields_f64 if kind == 'stiffness'
          else lib.pyiga_mass_fields_f64)
    return (fn, [Y, T, w12, wL, out],
            lambda ts: tuple(t.data_ptr() for t in ts)
            + (d, int(nurbs), Q12, QL, nL))


def launch(call, dev):
    fn, ts, args_of = call
    err = fn(*args_of(ts), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError('launch failed (%d)' % err)
    return ts[-1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('names', nargs='?', default=','.join(VARIANTS))
    ap.add_argument('--parent', default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('torch_fields_bwd_variants: no CUDA device available',
              file=sys.stderr)
        return 2
    import chip_smoke
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    names = args.names.split(',')
    if args.parent:
        names.append('parent')
    card = chip_smoke.nvidia_smi()
    print(card, flush=True)
    dev = torch.device('cuda', 0)
    libs, ptxas = build(names, args.parent)
    shapes = operands(dev)
    rng = np.random.RandomState(0)
    bops, keys = {}, {}
    for shape, kind in BWD_CASES:
        Y, T, w12, wL, nurbs = shapes[shape]
        if w12 is None:
            w12 = wL = torch.empty(0, dtype=torch.float64, device=dev)
        g = torch.as_tensor(rng.rand(*out_shape(kind, Y, T.shape[1], nurbs))
                            - 0.5, dtype=torch.float64, device=dev)
        bops[shape, kind] = (Y, T, w12, wL, nurbs, g)
        keys['bwd', shape, kind] = chip_smoke.fields_instance(kind, Y, nurbs,
                                                              True)
    for shape, kind in FWD_CASES:
        Y, T, _w12, _wL, nurbs = shapes[shape]
        keys['fwd', shape, kind] = chip_smoke.fields_instance(
            kind, Y, nurbs, False, T.shape[1])
    rec = {'card': card, 'ptxas': {}, 'bwd': {}, 'fwd': {}}
    for (way, shape, kind), key in keys.items():
        for name in names:
            line = ptxas[name].get(key, 'not found')
            rec['ptxas']['%s %s %s %s' % (name, way, shape, kind)] = line
            print('  ptxas %-10s %s %-16s %-9s %s' % (name, way, shape, kind,
                                                     line), flush=True)

    # the backward against its plain formulas, the forward against its
    # plain version and the first variant's output, bitwise on a repeat
    first = {}
    for name in names:
        lib = libs[name]
        for (shape, kind), ops in bops.items():
            Y, T, w12, wL, nurbs, g = ops
            a = (None, None) if kind == 'jac' else (w12, wL)
            got = launch(bwd_call(lib, kind, ops), dev).clone()
            again = launch(bwd_call(lib, kind, ops), dev)
            ref = cs._fields_vjp_plain(kind, Y, T, *a, nurbs, g)
            rel = float((got - ref).abs().max() / ref.abs().max())
            if not name.startswith('cut') and (
                    rel > 1e-13 or not torch.equal(got, again)):
                raise RuntimeError('%s bwd %s %s: rel %.3e, repeat equal %s'
                                   % (name, shape, kind, rel,
                                      torch.equal(got, again)))
            rec['bwd'].setdefault('%s %s' % (shape, kind), {})[name] = {
                'rel': rel}
        for shape, kind in FWD_CASES:
            Y, T, w12, wL, nurbs = shapes[shape]
            got = launch(fwd_call(lib, kind, shapes[shape]), dev)
            ref = {'stiffness': lambda: cs.fields_plain(Y, T, w12, wL, nurbs),
                   'mass': lambda: cs.fields_mass_plain(Y, T, w12, wL,
                                                        nurbs),
                   'jac': lambda: cs.geo_jac_fields_plain(Y, T, nurbs)}[kind]()
            rel = float((got - ref).abs().max() / ref.abs().max())
            same = torch.equal(got, first.setdefault((shape, kind), got))
            if rel > 1e-13 or not same:
                raise RuntimeError('%s fwd %s %s: rel %.3e, equal to %s %s'
                                   % (name, shape, kind, rel, names[0], same))
            rec['fwd'].setdefault('%s %s' % (shape, kind), {})[name] = {
                'rel': rel, 'bitwise_equal_to_' + names[0]: same}
    print('every variant agrees (backward <= 1e-13 of its plain formulas, '
          'bitwise on a repeat; forward bitwise equal to %s)' % names[0],
          flush=True)

    for rnd, order in enumerate((names, names[::-1])):
        for name in order:
            lib = libs[name]
            for (shape, kind), ops in bops.items():
                fn, ts, args_of = bwd_call(lib, kind, ops)
                t = chip_smoke.bare_times('bwd', fn, ts, args_of,
                                          dev)['device_ms']
                rec['bwd']['%s %s' % (shape, kind)][name].setdefault(
                    'device_ms', []).append(t)
            for shape, kind in FWD_CASES:
                fn, ts, args_of = fwd_call(lib, kind, shapes[shape])
                t = chip_smoke.bare_times('fwd', fn, ts, args_of,
                                          dev)['device_ms']
                rec['fwd']['%s %s' % (shape, kind)][name].setdefault(
                    'device_ms', []).append(t)
    for way in ('bwd', 'fwd'):
        for case, r in rec[way].items():
            print('  %s %-26s %s' % (way, case, '  '.join(
                '%s %s' % (n, '/'.join('%.4f' % t for t in v['device_ms']))
                for n, v in r.items())), flush=True)
    print(card)
    os.makedirs(os.path.join(REPO, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(REPO, 'chiprun_out', 'fields_bwd_variants.json'),
              'w') as f:
        json.dump(rec, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
