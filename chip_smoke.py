"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--seed S]

Builds the port's CUDA kernels from ``pyiga_tpu_torch/csrc``, holds each
kernel against its plain PyTorch version on the card at the shapes of the
3D p=3 n=48 main path (the stage K2 and the fold K3, both on the f64
tensor cores, and the geometry fields K1, also at ragged shapes and
launched twice for bitwise-equal output; K1's ``jac`` and ``mass`` kinds
likewise in phases 4c and 4g), checks the whole path on small inputs
against the
CPU run and a golden stiffness fixture, then drives the main path
(``StiffnessAssembler.assemble_banded`` -> ``RestrictedOperator`` ->
``fastdiag_precond_weighted`` -> ``cg_ir``) on the twisted box at 3D p=3
n=48 and on the NURBS quarter annulus at 2D p=3 n=128, counting every
kernel launch of the 3D run.

The generic VForm path has its own phases: K1's ``jac`` kind and the
generated coefficient-field kernel K5 (built from the form's generated
source, at the path's 2D n=128 shape and at 3D n=48) against their plain
versions, each also timed apart from its wrapper (4c), the 2D n=16
convection-diffusion solve on the card against the CPU run (4d), and the
convection-diffusion path of ``examples/convection_diffusion.py`` at the
bench's 2D p=3 n=128 size (``assemble.assemble`` / ``VFormAssembler.
run_device`` -> ``MLMatvecOperator`` -> ``fastdiag_precond`` -> ``gmres``),
cold and warm, counting its launches, one K5 launch per ``run_device``
(7).  Phases 8 / 8b also count K5's launches per local-MG build.

The hierarchical local-multigrid path (the bench's ``run_localmg``:
``HSpace`` refined toward the (1, 1) corner -> ``HDiscretization`` on
``unit_square`` with the on-demand ``bbox`` assemblers -> ``solvers.
solve_hmultigrid`` -> ``DeviceMGSolver``, one K6 launch per solve: every
V-cycle and the convergence test run inside it) has these phases: K6
against its plain version on the (24, 3), (48, 3) and (96, 3) hierarchies, one
V-cycle from a seeded iterate and the whole solve against the host loop
over the plain cycle, with each step of a cycle timed from a traced
launch (4e); the path at n0=6 on the card against the CPU (4f); the bench
shape (24, 3), cold and warm, held to 29 iterations and to the port's
host path in the same process, one K6 launch per solve (8); and (48, 3)
through ``solve_hmultigrid(hs, A, f)`` with its defaults (above the JAX
package's dense cutoff, where ``'auto'`` takes K6 up to
``tri_block_cutoff``), held to 27 (8b).

The wavefront smoother (``ops/relax.py``; above ``tri_block_cutoff``
``solve_hmultigrid``'s defaults take it): ``wavefront_gs`` (one launch
per ``DeviceIndexedGS.apply``) and K6's wavefront mode against their
plain versions at (24, 3) and (96, 3), forward, backward and symmetric,
a set with zero-diagonal rows (also laid out with the local x in global
memory, and with levels split), a structurally nonsymmetric set (write
after read), bitwise on a repeat, with ms per pass and per cycle, the
kernel's reciprocal quotient bitwise against the division over every
row of the passes, and a pass by ``torch.triangular_solve`` on a CUDA
CSR matrix as the library yardstick (4j); (96, 3) through
``solve_hmultigrid(hs, A, f)`` with its defaults, held to the host path's 25 in one K6 launch per solve, its
solver setup (schedules, coarse inverse formed on the card) printed
(8c); and ``local_mg_step(relax_backend='device')`` under
``iterative_solve`` at (24, 3), 29 cycles, one ``wavefront_gs`` launch
per smoothing application (8d).

The low-rank ACA assembly: ``bench.py``'s ``run_aca`` at 3D p=3 n=48
(``aca_3d_device`` over ``compact_slice`` on the card, timed warm),
held to the port's CPU pivot count and to ``run_device()`` at 1e-9
(13); ``mass_fast`` / ``stiffness_fast`` on the card against the
golden fixtures (13b).

The mass and time-stepping paths: K1's ``mass`` kind and K1' (the
stiffness fields of a host-evaluated Jacobian, also at ragged shapes and
timed apart from its wrapper) against their plain versions (4g);
``assemble.mass`` / ``assemble.stiffness`` on the card against the
golden fixtures and the small heat problem card vs CPU (4h);
the 3D p=3 n=48 mass path (``MassAssembler.assemble_banded`` and the
compact ``assemble``, ``M 1`` against ``assemble('v * dx')``) (9); the
heat equation ``M u' = f - K u`` on the NURBS quarter annulus at 2D p=3
n=128, assembled on the card and integrated by the host ``esdirk34`` and
``ros3p`` (10); and on the polar quarter annulus given as a
``UserFunction`` at n=60, integrated by ``DeviceRosenbrockScheme`` against
the host scheme's step sequence with no host fallback (10b).

The fused stage-2 + fold tail (K7, the JAX package's ``PYIGA_TAIL_FUSED``
switch) and the 3D Dirichlet Poisson path of ``examples/poisson_3d.py``
with non-zero data: K7's transposed stage and tail kernel (both on the
f64 tensor cores; phase 2 finds the DMMA instructions of K2, K3 and K7 in
the built library's SASS) against their plain versions at the n=48 flat-banded
shapes and at ragged shapes around the DMMA tiles, each launched twice
to show bitwise-equal results (4i); the headline
``assemble_banded()`` with the switch on, then off, in one process, the
fused operator solved to the headline's 25 iterations (11); the
Dirichlet path at 3D p=3 n=48 on the twisted box with the harmonic data
``g = x + 2y + 3z`` (``StiffnessAssembler.assemble`` through K7 ->
``compute_dirichlet_bcs`` -> the lifted right-hand side by a
``MatrixFreeOperator`` -> ``cg_ir`` to 1e-10 -> the L2 error by
``integrate``), cold and warm (12); and the same path at n=8, card against
CPU (12b).

Vector-valued forms and the Navier-Stokes path of
``examples/torch_navier_stokes.py``: K1's ``jac`` kind on the channel at
the path's Gauss grid, and the geometry fields against a CPU copy; K5 on
the NS forms at (16, 32) (the
convection forms with the velocity and its first derivatives formed on
the card and read in place, the vector Laplacian, the two-space
divergence block) and K2 and K3 on their chains, each against its plain
version to 1e-13 and bitwise on a repeat, K2 and K3 also on (p=2, p=1)
two-space tables at ragged sizes (4k); ``divdiv`` at 3D p=3 n=48 on the
twisted box (block (i, j) = block (j, i) transposed) and the 2D p=3
n=128 vector Laplacian (its diagonal blocks = ``assemble.stiffness``),
launches counted (14); ``examples/torch_stokes.py``'s ``main()`` at
(8, 12) (15); and the NS channel at (16, 32), ROWDAIND2 from the Stokes
state to t = 1.0 (tau0 5e-2, tol 1e-2), on the port's host scheme and
then through ``integrate()``'s default, the device scheme on the card,
held to the JAX package's CPU step sequence (``NS_TIMES_JAX``), the
host's step times to 1e-9 and states to 1e-10, no host scheme behind it
and a divergence below 1e-10; the device stepper's F and J and the host
methods on the card at a seeded state held to a CPU setup (1e-13 /
1e-12); with ms per step attempt, per F and per J evaluation and their
launches (16).

Surface integrals, second derivatives, multipatch and the hierarchical
entry points (``scripts/torch_item8_phases.py`` runs them alone): K1's
``jac`` kind on a surface geometry (three components on a 2D grid,
B-spline and NURBS, n=128) and on the boundary Gauss grids of all six
faces of the extruded quarter annulus at 3D n=48 (a grid axis of length
1), K5 on ``v * ds``, ``inner(v, n) * ds``, ``inner(grad(u), grad(v)) *
ds``, a surface ``v * ds``, the biharmonic form and the Laplacian
functional of a spline input, K2 and K3 on those forms' chains, each
against its plain version (1e-13, bitwise on a repeat), K5 on the
'left' face (its rows mapping) also bitwise against its columns
mapping (4l); ``v * ds``
and ``inner(v, n) * ds`` on all six faces at 3D p=3 n=48 (areas and
averaged normals), ``inner(grad(u), grad(v)) * ds`` on 'left', the
tangential form on 'front' against the 2D stiffness matrix and the
surface ``v * ds`` at n=128, each held to a CPU setup with its
``assemble()`` ms (17); the biharmonic matrix at 2D n=128
(``run_device`` ms, launches), the Laplacian functional's error against
``8 y`` and a ``UserFunction`` geometry at n=60, held to CPU setups
(18); ``examples/torch_multipatch_poisson.py``'s ``main(p=3, n=128)``
(51,221 dofs; automatic matching against hand-joined patches, the
global matrix against a CPU setup) and ``assemble`` / ``project_L2``
over the (48, 3) HB space (19); phases 17-19 count their launches from
zero.

The differentiable assembly (``pyiga_tpu_torch.diff``;
``scripts/torch_diff_phases.py`` runs it alone): each backward kernel
against its plain version at the forward's phase shapes, 1e-13 relative
and bitwise on a repeat (20a: K1's backward of the stiffness, mass and
``jac`` kinds on the 3D p=3 n=48 twisted box and of the ``jac`` kind on
the 2D n=128 NURBS quarter annulus, a surface and the 'left' face's
boundary grid (QL = 1) of the extruded annulus at n=48, each with the
device time of a bare launch and ptxas's registers and spills; K2's and
K3's backward at the headline's compact chain; the generated K5 adjoint on
convection-diffusion, ``(1 + w*w) * inner(grad(w), grad(v)) * dx`` and
the biharmonic at 2D n=128 and on ``inner(grad(u), grad(v)) * ds`` on
the 'left' face at 3D n=48 (QL = 1), each timed through ``launch`` by
CUDA events and by the host clock, as a CUDA graph of ``launch`` and
as one of its bare C entry); then, counting launches from zero, the
gradient of ``sum(w * A)`` through ``assembly_coeff_fn`` for the 3D
n=48 stiffness (``fn(coeffs0)`` bitwise ``run_device()``) and mass and
the 2D n=128 convection-diffusion form, held to autograd through the
plain versions on the card (1e-12) and to central differences (1e-6),
with forward and backward ms (20b); a compliance through
``implicit_cg_solve`` at 3D n=48, its forward and adjoint CG counts and
its directional derivative against a central difference (20c);
``assembly_input_fn`` for a spline input (with its gradient) and a
parameter at 2D n=128 (20d); and both example ports, card against CPU
(20e).

The windowed assembly route (``scripts/torch_windowed_phases.py`` runs
it alone): K8 (``windowed_stage``) and K8f (``windowed_fold``) against
their plain versions, 1e-14 relative and bitwise on a repeat, at the 3D
p=3 n=48 twisted box's stage 1 and stage 2, the fold of its 6 plan
terms, the 2D p=3 n=128 stage 1 and fold, and ragged shapes (p = 1 to
4, one window, runs of dofs and r tiles cut short, folds of 1, 16 and
18 terms, tile counts that are no multiple of the CTAs, odd and even R,
X off its 16-byte alignment: every copy and store path of the kernel,
each launch's plan held to ``windowed_plan``), each beside its bound,
its plain version and two yardsticks:
K2 / K3 over the banded pair tables (the same output with the band's
zeros in the contraction) and one einsum over windows gathered outside
its timing (4m); then ``run_windowed_assembly`` on the 3D n=48
stiffness and mass and the 2D n=128 stiffness, launches counted from
zero (no K3), held to ``run_device()`` through the compact take (1e-14),
laid into the flat layout and held to ``assemble_banded().D`` (1e-13),
solved by phase 5 / 6's ``cg_ir`` ([7, 9, 9], 17), ``BandedOperator``
on its regular layout bitwise against ``FlatBandedOperator``, and timed
warm beside ``assemble_banded()`` (21).  Any failed check raises
(nonzero exit).

The headline's sibling lines (``scripts/torch_lines_phases.py`` runs them
alone): the float32 instances of K1 (stiffness and ``mass``), K2 and K3
against their plain versions at the 3D n=48 f32 line's shapes and at
ragged shapes (K2 and K3 also through every staging path of their
kernel, and K2 past 2^31 output elements on sampled rows), 1e-5
relative, bitwise on a repeat and bitwise unchanged with torch's global
TF32 on, each beside ``torch.matmul`` in float32 (4n); the 3D p=3 n=96 twisted box in float64 (970,299 dofs):
``assemble_banded()`` with its peak device bytes, ``cg_ir`` held to the
JAX package's CPU counts (``POISSON_COUNTS_JAX``,
``scripts/jax_poisson_counts.py``), 16 banded fibers and two on the
band's padding held to a host float64 chain (1e-13), and the windowed
route laid into the flat layout and held to ``assemble_banded().D``
(1e-14) (22); and the f32 line at n=48 under ``set_dtype(float32)``:
``assemble_banded()`` + ``cg`` with the float32 weighted fastdiag, its
count beside the JAX package's for the same operator, its solution held
to the float64 one (1e-5 in the 2-norm), the f32 mass operator, no
float64 kernel launched (22b).

The f32 line beyond Poisson (``scripts/torch_lines_phases.py --only
4o,22c`` runs it alone): the float32 instances of K1's ``jac`` kind (3D
n=48, 2D n=128 NURBS, a surface, a one-point boundary axis, ragged
shapes), K1' (2D n=128 polar ``UserFunction``, 3D n=48, ragged), K5
(convection-diffusion 2D n=128, the 3D n=48 stiffness form, ``v * ds``
on a face) and K8 / K8f (phase 4m's shapes and every copy and store
path, the plan for 4-byte elements held to ``windowed_plan``) against
their plain versions, 2e-6 relative, bitwise on a repeat and with
torch's global TF32 on, and no float64 instruction in the SASS of any
float32 instance, the generated float32 K5 libraries included (4o);
then under ``set_dtype(float32)``, launches counted from zero and no
float64 kernel allowed: the 2D n=128 convection-diffusion VForm
(``run_device`` / ``assemble`` ms, 1e-6 of phase 7's float64 matrix,
its GMRES count held to the JAX package's on the port's float32 matrix,
``CONVDIFF_COUNTS_JAX``), the 3D n=48 VForm stiffness against the
float32 ``StiffnessAssembler`` and ``aca_3d_device`` (float32 slices,
float64 crosses, 1e-5 of float64), the windowed route at phase 21's
shapes (2e-6 of the float32 ``assemble_banded()``, the peak bytes, cg
on its ``BandedOperator`` held to the JAX count), the polar
``UserFunction`` stiffness (K1', 1e-6) and the (24, 3) HB assembly
(1e-6) (22c).

The host API and the device Krylov entry points (23): ``cg_jit`` on the
main path's restricted K4 operator with the float64 weighted fastdiag at
3D n=48, from zero and from a start drawn with ``--seed`` (default 0),
each count held to the JAX package's ``cg_jit`` on the CPU on the same
operator (``CG_JIT_COUNTS_JAX``) and its residual to 1e-8 of the initial
one; ``cg_ir_traceable``'s program against ``cg_ir`` (the same counts, x
to 1e-12); ``gmres_jit`` on phase 7's operator at 2D n=128 from both
starts (``GMRES_JIT_COUNTS_JAX``); ``assemblers.stiffness_fields`` and
``ops.sumfac.run_matrix_assembly`` bitwise against ``run_device()`` and
``run_banded_assembly`` against ``assemble_banded()`` at 3D n=48; the
five example twins (``examples/torch_{poisson_3d,convection_diffusion,
adaptive_poisson,geometry_tour,subspace_correction_mg}.py``) at their
default sizes, what each prints held to the JAX example's
(``EXAMPLE_COUNTS_JAX``, ``TOUR_VALUES_JAX`` to 1e-12); and the host
``NurbsFunc.grid_hessian`` against ``geometry_hessian`` on the card on
the 2D n=128 Gauss grid (1e-12).  Each kernel's entry in the JSON line
also carries its launches in phase 23 (``launches_phase23``).

The entry twin, profiling and the command line (24;
``scripts/torch_entry_phase.py`` runs it alone): ``pyiga_tpu_torch.
__graft_entry__.entry()`` on the card against ``entry(device='cpu')``
(the plain versions; data and x to 1e-12); ``_single_chip_step`` at the
headline's 3D p=3 n=48 on the twisted box with 8 CG steps (K1, K2 stages
and one K3 fold, ``ml_matvec``), its data held to ``run_device()``
(1e-13 of the largest entry: the folded route sums mirrored terms in
another order), x to a float64 host CG on the same data (1e-10), its ms
(CUDA events, warm median of 5) and its K1 / K2 / K3 launches
(``launches_phase24``); ``profiling.timed`` around the step, at least
its CUDA-event time, and a ``profiling.trace`` of one step
(``chiprun_out/entry_trace/``) holding device events named for
``geo_fields_kernel``, ``stage_kernel`` and ``fold_kernel`` on a stream
torch's own kernels of the step ran on; ``str2asm_main([...,
'--source'])`` for a convection-diffusion form: its six plan terms and
the generated source's C entry ``pyiga_vform_fields``.

The multi-device layer (25; ``scripts/torch_parallel_phase.py`` runs it
alone): (a) at world size 1 over NCCL in this process, the sharded
flagship (``parallel.flagship.sharded_flagship_pipeline``: each slab's
banded chains, K4 f64 / f32 on the slab, the weighted fastdiag,
``cg_ir``) at 3D p=3 n=48 held to phase 5's counts ([7, 9, 9]) and
solution (1e-12), ``sharded_stiffness_step`` with 8 CG steps held to
``run_device()`` (1e-14 of its largest entry) and ``_single_chip_step``
(1e-12); (b) the same on two rank processes sharing the card over gloo,
each rank's counts (a)'s and its solution within 1e-10 of (a)'s, its
K1, K2, K3, K4 f64 and f32 launched, its assembly and
``cg_ir`` ms by CUDA events, the halo bytes of a matvec and the share of
a solve in collectives; (c) ``dryrun_multichip(4, backend='gloo')`` and
``sharded_multipatch_data`` on ``tests/test_parallel.py``'s three patches
against the per-patch assembly (1e-12); (d) ``vmap(grad)`` of
``test_grad_composes_with_sharding``'s mass objective with a batch of 4
over the two ranks against the loop of ``grad`` (1e-12), K1-bwd
``mass``, K2-bwd and K3-bwd launched; (e) NCCL across cards where
there are two or more, else one line that it was not run.  Each kernel's
entry in the JSON line also carries its launches in phase 25
(``launches_phase25``: (a)'s sharded flagship and sharded step, each
counted around its own call, and (d)'s on rank 0).

Forward mode and second derivatives (26; ``scripts/torch_diff_fwd_phase.py``
runs it alone): (a) K1-jvp and K1-hvp of every kind against their plain
versions on the 3D p=3 n=48 twisted box, the 2D n=128 NURBS quarter
annulus and the 'left' face of the extruded annulus (QL = 1), and the
generated K5 tangent and second-order programs of phase 20a's four forms
(every source and the parameters with a tangent), float64 (1e-13) and
float32 (:data:`DIFF_F32_TOL`), bitwise on a repeat; (b), (c)
``torch.func.jvp``, a ``forward_ad`` dual, the gradient and the HVP by
forward over reverse and by ``create_graph`` through
``assembly_coeff_fn`` of the 3D n=48 stiffness and mass assemblers and
the 2D n=128 convection-diffusion form, and ``assembly_input_fn`` of the
``(1 + w²)`` form at 2D n=128, each against the same through the plain
versions on the card (1e-12), ``<w, jvp>`` against ``<grad, v>`` (1e-12)
and a central difference (1e-6), the two HVPs against each other, with
their ms by CUDA events and launches; the same in float32 (2e-5); a
``torch.func.hessian`` of a 2D p=2 n=4 mass objective; (d)
``examples/torch_nonlinear_poisson.py`` by ``torch.func.jacfwd`` on the
card against the CPU run and the JAX example's norms.  It fails unless
each of the sixteen kernels (eight, and their float32 instances)
launched and no float32 run launched a float64 one of them.

Every kernel's entry in the JSON line has its time, its plain version's,
the time of one PyTorch call computing the same function where one
exists (``library_ms``; used nowhere in the port) and ``bound_ms``: the
larger of its bytes over 3.35 TB/s and its operations over the
datasheet's peak (67 TFLOP/s for f64 on the tensor cores where the
function is a matrix product, 34 TFLOP/s for f64 FMA otherwise, 67 for
f32), both counted from this run's inputs.  A kernel's ``ms`` is its
wrapper's call as the path makes it; for K1 ``jac``, K1-bwd, K5 and
K1' the record (and the JSON line) also holds ``launch_ms`` (the bare C
entry called back to back by ctypes) and ``device_ms`` (one launch's device
time, from a CUDA graph of 20 captured launches replayed between CUDA
events, the launches cycling through copies of their operands that
together hold at least twice the 50 MB L2, so that none is read from it).

Output: phase lines, then a JSON line ``{"kernels": [...]}``, the card's
``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {...}}``.  The full record also goes to
``chiprun_out/chip_smoke.json``.  Without a CUDA device it exits nonzero
and prints no result.  Imports neither jax nor pyiga_tpu.
"""

import json
import math
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# kernel -> (route, source, TPU kernel it replaces), for the JSON record
KERNELS = {
    'fields': ('cuda', 'pyiga_tpu_torch/csrc/fields.cu',
               'pyiga_tpu/ops/pallas_sumfac.py:1087'),
    # the same pallas_call with kind='jac'
    'geo_jac_fields': ('cuda', 'pyiga_tpu_torch/csrc/fields.cu',
                       'pyiga_tpu/ops/pallas_sumfac.py:1087'),
    'stage': ('cuda', 'pyiga_tpu_torch/csrc/sumfac.cu',
              'pyiga_tpu/ops/pallas_sumfac.py:353'),
    'fold': ('cuda', 'pyiga_tpu_torch/csrc/sumfac.cu',
             'pyiga_tpu/ops/pallas_sumfac.py:781'),
    'flat_banded_f64': ('cuda', 'pyiga_tpu_torch/csrc/banded.cu',
                        'pyiga_tpu/ops/banded.py:541'),
    'flat_banded_f32': ('cuda', 'pyiga_tpu_torch/csrc/banded.cu',
                        'pyiga_tpu/ops/banded.py:515'),
    # CUDA C generated per form by this module, built at run time
    'vform_fields': ('cuda', 'pyiga_tpu_torch/ops/cuda_vform.py',
                     'pyiga_tpu/compile.py:974'),
    'vcycle': ('cuda', 'pyiga_tpu_torch/csrc/mg.cu',
               'pyiga_tpu/ops/mg_pallas.py:493'),
    # the K1 call site with kind='mass' (through mass_fields_pallas)
    'mass_fields': ('cuda', 'pyiga_tpu_torch/csrc/fields.cu',
                    'pyiga_tpu/ops/pallas_sumfac.py:1087'),
    # K1': stiffness_fields_pallas's host-Jacobian branch
    'host_jac_fields': ('cuda', 'pyiga_tpu_torch/csrc/fields.cu',
                        'pyiga_tpu/ops/pallas_sumfac.py:1163'),
    # K7: the transposed stage and the fused stage-2 + fold tail
    'stage_T': ('cuda', 'pyiga_tpu_torch/csrc/sumfac.cu',
                'pyiga_tpu/ops/pallas_sumfac.py:436'),
    'tail_fused': ('cuda', 'pyiga_tpu_torch/csrc/sumfac.cu',
                   'pyiga_tpu/ops/pallas_sumfac.py:563'),
    # no Pallas site: the JAX package runs these as XLA loops
    'wavefront_gs': ('cuda', 'pyiga_tpu_torch/csrc/mg.cu',
                     'pyiga_tpu/ops/relax.py:111 _smooth_fn (XLA)'),
    'vcycle_wavefront': ('cuda', 'pyiga_tpu_torch/csrc/mg.cu',
                         'pyiga_tpu/ops/mg.py:55 _smooth in _solve_fn :477 '
                         '(XLA)'),
    # the windowed route's stage and folded final stage (K8, K8f)
    'windowed_stage': ('cuda', 'pyiga_tpu_torch/csrc/windowed.cu',
                       'no Pallas site: pyiga_tpu/ops/sumfac.py:395 '
                       '`_windowed_stage` (XLA)'),
    'windowed_fold': ('cuda', 'pyiga_tpu_torch/csrc/windowed.cu',
                      'no Pallas site: pyiga_tpu/ops/sumfac.py:395 '
                      '`_windowed_stage` in :433 `assemble_terms_windowed` '
                      '(XLA)'),
    # the float32 instances of K1, K2 and K3 (the f32 line); the JAX
    # package's f32 line runs these functions in XLA
    'fields_f32': ('cuda', 'pyiga_tpu_torch/csrc/fields_f32.cu',
                   'pyiga_tpu/ops/pallas_sumfac.py:1087 (float32: '
                   'pyiga_tpu/assemblers.py:59 `stiffness_fields`, XLA)'),
    'mass_fields_f32': ('cuda', 'pyiga_tpu_torch/csrc/fields_f32.cu',
                        'pyiga_tpu/ops/pallas_sumfac.py:1087 (float32: '
                        'pyiga_tpu/assemblers.py:53 `mass_fields`, XLA)'),
    'stage_f32': ('cuda', 'pyiga_tpu_torch/csrc/sumfac_f32.cu',
                  'pyiga_tpu/ops/pallas_sumfac.py:353 (float32: '
                  'pyiga_tpu/ops/sumfac.py:55 `contract_chain`, XLA)'),
    'fold_f32': ('cuda', 'pyiga_tpu_torch/csrc/sumfac_f32.cu',
                 'pyiga_tpu/ops/pallas_sumfac.py:781 (float32: '
                 'pyiga_tpu/ops/sumfac.py:291 `_contract_last`, XLA)'),
    # the float32 instances of K1's jac kind, K1', K5, K8 and K8f (the f32
    # line beyond Poisson); the JAX package's f32 line evaluates these
    # functions in XLA on float32 operands (pyiga_tpu/compile.py:1250-1262)
    'geo_jac_fields_f32': ('cuda', 'pyiga_tpu_torch/csrc/fields_f32.cu',
                           'pyiga_tpu/ops/pallas_sumfac.py:1087 (float32: '
                           'pyiga_tpu/ops/geom.py:69 `geo_jacobian_field`, '
                           'XLA)'),
    'host_jac_fields_f32': ('cuda', 'pyiga_tpu_torch/csrc/fields.cu',
                            'pyiga_tpu/ops/pallas_sumfac.py:1163 (float32: '
                            'pyiga_tpu/assemblers.py:59 `stiffness_fields`,'
                            ' XLA)'),
    'vform_fields_f32': ('cuda', 'pyiga_tpu_torch/ops/cuda_vform.py',
                         'pyiga_tpu/compile.py:974 (float32: '
                         'pyiga_tpu/compile.py:717 `_eval_combo_fields`, '
                         'XLA)'),
    'windowed_stage_f32': ('cuda', 'pyiga_tpu_torch/csrc/windowed.cu',
                           'no Pallas site: pyiga_tpu/ops/sumfac.py:395 '
                           '`_windowed_stage` (XLA, float32)'),
    'windowed_fold_f32': ('cuda', 'pyiga_tpu_torch/csrc/windowed.cu',
                          'no Pallas site: pyiga_tpu/ops/sumfac.py:395 '
                          '`_windowed_stage` in :433 '
                          '`assemble_terms_windowed` (XLA, float32)'),
}
# the kernels each main path runs
POISSON_KERNELS = ('fields', 'stage', 'fold', 'flat_banded_f64',
                   'flat_banded_f32')
VFORM_KERNELS = ('geo_jac_fields', 'vform_fields', 'stage', 'fold')
LOCALMG_KERNELS = ('vcycle', 'geo_jac_fields', 'vform_fields', 'stage',
                   'fold')
WAVE_LOCALMG_KERNELS = ('vcycle_wavefront',) + LOCALMG_KERNELS[1:]
ACA_KERNELS = ('geo_jac_fields', 'vform_fields', 'stage')
MASS_KERNELS = ('mass_fields', 'stage', 'fold', 'flat_banded_f64')
HEAT_KERNELS = ('mass_fields', 'fields', 'stage', 'fold')
USERGEO_KERNELS = ('host_jac_fields', 'stage', 'fold')
# the headline with the fused tail (phase 11) and the Dirichlet path (12)
TAILFUSED_KERNELS = ('fields', 'stage', 'stage_T', 'tail_fused',
                     'flat_banded_f64', 'flat_banded_f32')
DIRICHLET_KERNELS = ('fields', 'stage', 'stage_T', 'tail_fused')
# the windowed route (phases 4m and 21)
WINDOWED_KERNELS = ('windowed_stage', 'windowed_fold')
# phase 10's end times and first steps: esdirk34 factors 4 sparse LUs of
# the 16,641 free dofs per step attempt (~2.5 s each on the host), so t =
# 0.1 would take minutes; to t = 3e-4 from tau0 = 1e-3 it rejected 5
# attempts before 2 accepted ones (63.7 s); from tau0 = 2e-4 it rejects 1
# and accepts 2 (3 attempts, ~30 s)
HEAT_T_END = {'esdirk34': 3e-4, 'ros3p': 0.1}
HEAT_TAU0 = {'esdirk34': 2e-4, 'ros3p': 1e-3}
# (n0, levels) -> the iteration count of the JAX package's host path
LOCALMG_ITERS = {(24, 3): 29, (48, 3): 27, (96, 3): 25}
# the same under set_dtype(float32): the JAX package's solve_hmultigrid on
# the CPU (float64) of its own float32-assembled matrix, and of the port's
# (scripts/jax_poisson_counts.py localmg_f32 96); phase 8c-f32
LOCALMG_ITERS_F32 = {(96, 3): 25}
# the local-MG path's kernels under float32: the float32 assembly, K6 in
# float64 (as the JAX package solves)
WAVE_LOCALMG_F32_KERNELS = ('vcycle_wavefront', 'geo_jac_fields_f32',
                            'vform_fields_f32', 'stage_f32', 'fold_f32')
# the JAX package's Krylov counts on the CPU (scripts/jax_poisson_counts.py):
# cg_ir's (outer, inner_iters) for the 3D p=3 twisted box at n=96 in f64,
# and cg_jit's count for the port's float32 operator at n=48 with JAX's
# float32 weighted fastdiag
POISSON_COUNTS_JAX = {('float64', 96): (4, [7, 10, 11, 11]),
                      ('float32', 48): 24,
                      # cg_jit on the port's float32 windowed operator
                      # (``f32win``)
                      ('float32 windowed', 48): 24}
# gmres_jit's count for phase 7's solve on the port's float32
# convection-diffusion matrix at 2D n=128 (``convdiff``)
CONVDIFF_COUNTS_JAX = {('float32', 128): 41}
# the hierarchies whose largest smoothing set exceeds tri_block_cutoff,
# where solve_hmultigrid's defaults take the wavefront smoother
WAVEFRONT_SIZES = {(96, 3)}
# n -> the outer pivots of aca_3d_device for the 3D p=3 stiffness on the
# twisted box: the port's on the CPU (ties broken by the lowest index,
# lowrank.TIE_TOL), which the card must reproduce, and the JAX package's
# on the CPU ('exact' slices, strict argmax: rounding breaks the ties)
ACA_PIVOTS = {48: 32}
ACA_PIVOTS_JAX = {48: 29}
# the Navier-Stokes path (phase 16): examples/torch_navier_stokes.py at
# the bench's size; ROWDAIND2 from the Stokes state, tau0 5e-2, tol 1e-2,
# t_end 1.0 gives these accepted step times in the JAX package's host
# scheme on the CPU (scripts/ns_jax_steps.py), which the card's device
# scheme must reproduce
NS_KERNELS = ('geo_jac_fields', 'vform_fields', 'stage', 'fold')
NS_N_EL = (16, 32)
NS_TIMES_JAX = (0.0, 0.05, 0.3, 1.55)
NS_STEPS_JAX = len(NS_TIMES_JAX) - 1

CONVDIFF = '(inner(grad(u), grad(v)) + dot(b, grad(u)) * v + u * v) * dx'
CONV_B = np.array([3.0, -2.0])
CONV_B_3D = np.array([3.0, -2.0, 1.0])

# datasheet peaks of the H100 SXM (at its 700 W limit), per millisecond
HBM_BYTES_PER_MS = 3.35e12 / 1e3
F64_TENSOR_PER_MS = 67e12 / 1e3     # f64 on the tensor cores (DMMA)
F64_FMA_PER_MS = 34e12 / 1e3        # f64 outside the tensor cores
F32_PER_MS = 67e12 / 1e3            # f32 outside the tensor cores


def bound(nbytes, flops, peak_per_ms):
    """The least time the card could take for a function that moves
    `nbytes` (each input read once, each output written once) and does
    `flops` operations at `peak_per_ms`."""
    t_bytes = nbytes / HBM_BYTES_PER_MS
    t_ops = flops / peak_per_ms
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by='bytes' if t_bytes >= t_ops else 'operations',
                bound_bytes=int(nbytes), bound_flops=int(flops))


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def harmonic(x, y, z):
    """The Dirichlet data of phase 12: harmonic, so the discrete solution
    is the interpolant of g o geo on the twisted box."""
    return x + 2 * y + 3 * z


class SquaredError:
    """``(u_h - g)^2`` on a tensor grid (``g`` alone for ``uh=None``), `g`
    taken at the mapped points: the integrand of the L2 error."""

    def __init__(self, uh, geo, g):
        self.uh, self.geo, self.g = uh, geo, g

    def grid_eval(self, grid):
        X = self.geo.grid_eval(grid)
        ref = self.g(*np.moveaxis(X, -1, 0))
        return (ref if self.uh is None else self.uh.grid_eval(grid) - ref) ** 2


def log(*args):
    print(*args, flush=True)


def sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def time_ms(fn, device, reps=10, warmup=2):
    """Mean milliseconds of `fn()` over `reps` calls after `warmup`, by
    CUDA events (host clock around a synchronize on the CPU)."""
    for _ in range(warmup):
        fn()
    if device.type != 'cuda':
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t0) / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sync(device)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare(name, got, ref, rtol):
    """Max abs error and its ratio to max |ref|; raises above `rtol`."""
    err = float((got.double() - ref.double()).abs().max())
    scale = float(ref.double().abs().max())
    rel = err / scale if scale > 0 else err
    ok = bool(torch.isfinite(got).all()) and rel <= rtol
    log('  %-16s max_abs_err %.3e  rel %.3e  (tol %.0e)  %s'
        % (name, err, rel, rtol, 'ok' if ok else 'FAIL'))
    if not ok:
        raise RuntimeError('%s disagrees with its plain version' % name)
    return err, rel


def nvidia_smi():
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired) as e:
        return 'nvidia-smi unavailable (%s)' % e


def sass_dmma(lib_path, kernels=('stage_kernel', 'fold_kernel',
                                 'stage_T_kernel', 'tail_kernel',
                                 'stage_bwd_kernel')):
    """DMMA (f64 tensor-core) instructions per kernel in the SASS of the
    built library, by ``cuobjdump --dump-sass`` from the toolkit that
    built it; raises if one of `kernels` has none."""
    from pyiga_tpu_torch import _cuda
    tool = os.path.join(os.path.dirname(_cuda._nvcc()), 'cuobjdump')
    sass = subprocess.run([tool, '--dump-sass', lib_path], check=True,
                          capture_output=True, text=True,
                          timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if 'Function :' in line:
            fn = line.split('Function :')[1].strip()
            counts[fn] = 0
        elif fn is not None and 'DMMA' in line:
            counts[fn] += 1
    found = {k: sum(c for f, c in counts.items() if k in f) for k in kernels}
    log('  SASS DMMA instructions: %s' % found)
    missing = [k for k, c in found.items() if c == 0]
    if missing:
        raise RuntimeError('no DMMA instruction in the SASS of %s' % missing)
    return found


def main_path_setup(dim, n, device):
    """The main path's assembler with its host tables built (numpy
    setup that bench.py also keeps out of the timed assembly)."""
    from pyiga_tpu_torch import bspline, geometry
    from pyiga_tpu_torch.assemblers import StiffnessAssembler
    from pyiga_tpu_torch.ops.banded import band_info
    kvs = dim * (bspline.make_knots(3, 0.0, 1.0, n),)
    geo = geometry.twisted_box() if dim == 3 else geometry.quarter_annulus()
    asm = StiffnessAssembler(kvs, geo, device=device)
    asm.tables.banded_term_tables(asm.terms, band_info(asm.structure))
    return asm


# ragged shapes around the DMMA tiles (16-row m tiles, 8-column n tiles,
# 4- and 16-deep k slices, the 64 x 128 block tile of K2 and K7a, K3's
# 192 x 64, K7b's 32-row slab, 192-deep Y2 chunk and 384-column chunk):
# K < 4 (the twisted box's geometry stages), K not a multiple of 16, odd
# and even M and R, R below one tile, the 2D n=128 shapes (K = 512).
# K2 and K7a (K, R, M)
STAGE_RAGGED = ((2, 24, 192), (4, 1152, 192), (7, 45, 13), (33, 300, 70),
                (200, 1001, 5), (512, 512, 917), (192, 130, 357))
STAGE_T_RAGGED = ((7, 45, 13), (33, 300, 70), (200, 1001, 5),
                  (192, 130, 357))
# K3 (K, R, M, terms, tables), term t on table t % tables: one term, one
# group of all terms, groups of one, 16 terms and 17 (the wrapper's split)
FOLD_RAGGED = ((3, 100, 11, 2, 1), (7, 45, 13, 1, 1), (33, 300, 70, 3, 2),
               (512, 917, 917, 3, 2), (20, 129, 64, 16, 5),
               (20, 129, 64, 17, 4), (192, 200, 357, 6, 1),
               (9, 64, 130, 5, 5))
# K7b (M1, K2, K3, M2, M3, terms, stage-2 tables, final tables)
TAIL_RAGGED = ((5, 7, 9, 13, 11, 3, 2, 1), (3, 33, 200, 17, 600, 3, 2, 1),
               (4, 18, 30, 35, 45, 1, 1, 1), (3, 13, 21, 40, 70, 16, 3, 2),
               (2, 192, 384, 33, 385, 2, 1, 2))


# K1 (d, nurbs, Q12, QL, nL): D = 2 and 3, NURBS and not, nL = 1..5 (5
# takes the runtime-length loop), odd QL, QL above one block of threads,
# Q12 not a multiple of the 16-row tile, and grids above and below two
# blocks an SM (where the row tile shrinks)
FIELDS_RAGGED = ((2, False, 37, 13, 1), (2, True, 515, 7, 2),
                 (3, False, 1003, 45, 3), (3, True, 4099, 33, 4),
                 (2, False, 261, 301, 5), (3, True, 77, 19, 5),
                 (3, False, 10001, 9, 2), (2, True, 8191, 257, 3))


def check_fields_ragged(kind, device, seed=8, dtype=torch.float64,
                        tol=1e-13):
    """K1's `kind` ('stiffness', 'mass' or 'jac') against its plain
    version at :data:`FIELDS_RAGGED` on seeded inputs shaped like a
    geometry's (positive value tables, centred derivative tables, each
    component's partials dominant along its own axis, NURBS weights near
    1), so that every Jacobian is well conditioned: `tol` (1e-13 in
    float64) relative to the largest output, each launched twice for
    bitwise-equal output; `dtype` float32 runs K1's float32 instance."""
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    fn, plain = {'stiffness': (cs.fields, cs.fields_plain),
                 'mass': (cs.fields_mass, cs.fields_mass_plain),
                 'jac': (cs.geo_jac_fields, cs.geo_jac_fields_plain)}[kind]
    rng = np.random.RandomState(seed)
    out = {}
    for d, nurbs, Q12, QL, nL in FIELDS_RAGGED:
        C = d + int(nurbs)
        Y = 0.3 * rng.rand(d, C, Q12, nL)
        for t in range(d - 1):
            Y[t, t] += 2.0
        Y[d - 1, :d] += 1.0
        Y[d - 1, d - 1] += 3.0 * np.arange(nL)
        if nurbs:
            Y[:, C - 1] *= 0.2
            Y[d - 1, C - 1] += 1.0
        T = np.stack([rng.rand(QL, nL) + 0.5,
                      np.arange(nL) - (nL - 1) / 2.0
                      + 0.3 * rng.rand(QL, nL)])

        def dev(a):
            return torch.as_tensor(a, dtype=dtype, device=device)
        args = (dev(Y), dev(T))
        if kind != 'jac':
            args += (dev(rng.rand(Q12) + 0.5), dev(rng.rand(QL) + 0.5))
        args += (nurbs,)
        got, ref = fn(*args), plain(*args)
        sync(device)
        key = '%dD%s Q12=%d QL=%d nL=%d' % (d, ' NURBS' if nurbs else '',
                                            Q12, QL, nL)
        out[key] = compare('%s %s' % (kind, key), got, ref, tol)
        check_repeat('%s %s' % (kind, key), lambda: fn(*args), got)
    return out


def check_stage_ragged(name, rand, tol):
    """K2 against its plain version at :data:`STAGE_RAGGED` on operands
    from `rand` (their dtype picks the kernel), `tol` relative, each
    launched twice for bitwise-equal output."""
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    out = {}
    for Kr, Rr, Mr in STAGE_RAGGED:
        X, Tt = rand(Kr, Rr), rand(Mr, Kr)
        got, ref = cs.stage(X, Tt), cs.stage_plain(X, Tt)
        sync(got.device)
        key = '%dx%dx%d' % (Kr, Rr, Mr)
        out[key] = compare('%s %s' % (name, key), got, ref, tol)
        check_repeat('%s %s' % (name, key), lambda: cs.stage(X, Tt), got)
    return out


def check_fold_ragged(name, rand, tol):
    """K3 against its plain version at :data:`FOLD_RAGGED`, as
    :func:`check_stage_ragged`."""
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    out = {}
    for Kr, Rr, Mr, nt, ntab in FOLD_RAGGED:
        xs = [rand(Kr, Rr) for _ in range(nt)]
        tabs = [rand(Mr, Kr) for _ in range(ntab)]
        ti = [t % ntab for t in range(nt)]
        got, ref = cs.fold(xs, tabs, ti), cs.fold_plain(xs, tabs, ti)
        sync(got.device)
        key = '%dx%dx%d,%d terms,%d tables' % (Kr, Rr, Mr, nt, ntab)
        out[key] = compare('%s %s' % (name, key), got, ref, tol)
        check_repeat('%s %s' % (name, key), lambda: cs.fold(xs, tabs, ti),
                     got)
        del xs, tabs, got, ref
    return out


def check_repeat(name, fn, got):
    """A second launch on the same inputs gives bitwise-equal output (no
    atomics, a fixed summation order)."""
    again = fn()
    sync(again.device)
    if not torch.equal(again, got):
        raise RuntimeError('%s: two launches on the same inputs differ'
                           % name)
    return True


def check_kernels(device, n=48, seed=0):
    """Phase 4: each kernel against its plain version on `device`, at the
    shapes of the 3D p=3 main path (n=48 by default).  K2 and K3 (on the
    f64 tensor cores) also at the ragged shapes above, both to 1e-13
    relative to the largest entry and each launched twice (bitwise-equal);
    K3's plain version sums term by term, the kernel per distinct table.
    Yardsticks: one ``torch.matmul`` for K2, one over the terms' operands
    concatenated along K for K3."""
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    from pyiga_tpu_torch.ops import banded as bd

    rng = np.random.RandomState(seed)
    f64 = torch.float64

    def rand(*shape):
        return torch.as_tensor(rng.rand(*shape), dtype=f64, device=device)

    asm = main_path_setup(3, n, device)
    out = {}

    # K1 on the real geometry partials of the twisted box
    gi = asm.geo_inputs()
    tables = gi['geo_tables_bsp']
    Y, _ = cs.geo_stage12(tables, gi['geo_coeffs'], 3)
    w12 = (gi['weights'][0][:, None] * gi['weights'][1]).reshape(-1)
    T = tables[2][:2].contiguous()
    wL = gi['weights'][2]
    args = (Y, T, w12, wL, False)
    got, ref = cs.fields(*args), cs.fields_plain(*args)
    sync(device)
    err, rel = compare('fields', got, ref, 1e-13)
    check_repeat('fields', lambda: cs.fields(*args), got)
    # per point: the last-axis contraction (C x d dots of nL) + det/inverse
    d, C, _, nL = Y.shape
    out['fields'] = dict(max_abs_err=err, rel=rel,
                         shape=list(got.shape),
                         ms=time_ms(lambda: cs.fields(*args), device),
                         plain_ms=time_ms(lambda: cs.fields_plain(*args),
                                          device, reps=3),
                         library_ms=None,
                         **bound(nbytes(Y, T, w12, wL, got),
                                 got[0].numel() * (2 * C * d * nL + 100),
                                 F64_FMA_PER_MS))
    out['fields']['repeat_equal'] = True
    out['fields']['ragged'] = check_fields_ragged('stiffness', device)
    del Y, got, ref, args

    # K2 at both chain-stage shapes, real banded tables
    bws = bd.band_info(asm.structure)
    btabs = asm.tables.banded_term_tables(asm.terms, bws)
    stage_tabs = [torch.as_tensor(btabs[0][k], dtype=f64, device=device)
                  for k in (0, 1)]
    K, M = stage_tabs[0].shape[1], stage_tabs[0].shape[0]
    stage_ms, stage_plain_ms, stage_err, stage_rel = [], [], 0.0, 0.0
    stage_lib_ms, stage_bytes, stage_flops = [], 0, 0
    for R, Tt in ((K * K, stage_tabs[0]), (K * M, stage_tabs[1])):
        X = rand(K, R)
        got, ref = cs.stage(X, Tt), cs.stage_plain(X, Tt)
        sync(device)
        e, r = compare('stage R=%d' % R, got, ref, 1e-13)
        check_repeat('stage R=%d' % R, lambda: cs.stage(X, Tt), got)
        stage_err, stage_rel = max(stage_err, e), max(stage_rel, r)
        stage_ms.append(time_ms(lambda: cs.stage(X, Tt), device))
        stage_plain_ms.append(time_ms(lambda: cs.stage_plain(X, Tt), device))
        # yardstick: one torch.matmul of the same operands
        stage_lib_ms.append(time_ms(lambda: torch.matmul(X.t(), Tt.t()),
                                    device))
        stage_bytes += nbytes(X, Tt, got)
        stage_flops += 2 * K * R * M
        del X, got, ref
    out['stage'] = dict(max_abs_err=stage_err, rel=stage_rel,
                        shapes=[[K, K * K, M], [K, K * M, M]],
                        repeat_equal=True,
                        ms=sum(stage_ms), plain_ms=sum(stage_plain_ms),
                        library_ms=sum(stage_lib_ms),
                        ms_each=stage_ms, plain_ms_each=stage_plain_ms,
                        library_ms_each=stage_lib_ms,
                        **bound(stage_bytes, stage_flops,
                                F64_TENSOR_PER_MS))
    out['stage']['ragged'] = check_stage_ragged('stage', rand, 1e-13)

    # K3: the fold plan's terms over their deduplicated last tables,
    # R = M * M
    from pyiga_tpu_torch.ops.sumfac import last_table_groups
    plan = asm._fold()
    idx = list(last_table_groups([btabs[t] for t, _m in plan]))
    fold_tabs = [None] * (max(idx) + 1)
    for (t, _m), i in zip(plan, idx):
        fold_tabs[i] = torch.as_tensor(btabs[t][2], dtype=f64, device=device)
    xs = [rand(K, M * M) for _ in plan]
    got, ref = cs.fold(xs, fold_tabs, idx), cs.fold_plain(xs, fold_tabs, idx)
    sync(device)
    err, rel = compare('fold', got, ref, 1e-13)
    check_repeat('fold', lambda: cs.fold(xs, fold_tabs, idx), got)
    # yardstick: one torch.matmul over the terms' operands concatenated
    # along K (the concatenation is made outside the timed call)
    xcat = torch.cat(xs, dim=0).t()
    tcat = torch.cat([fold_tabs[i] for i in idx], dim=1).t()
    lib_ms = time_ms(lambda: torch.matmul(xcat, tcat), device)
    del xcat, tcat
    # the bound counts one product per distinct table: the terms that
    # share one are summed before it (what the kernel does, and the least
    # work for the function)
    out['fold'] = dict(max_abs_err=err, rel=rel,
                       shape=[len(xs), K, M * M, M], tables=len(fold_tabs),
                       repeat_equal=True,
                       ms=time_ms(lambda: cs.fold(xs, fold_tabs, idx),
                                  device),
                       plain_ms=time_ms(lambda: cs.fold_plain(
                           xs, fold_tabs, idx), device),
                       library_ms=lib_ms,
                       **bound(nbytes(*xs, *fold_tabs, got),
                               2 * K * M * M * M * len(set(idx)),
                               F64_TENSOR_PER_MS))
    del xs, got, ref
    out['fold']['ragged'] = check_fold_ragged('fold', rand, 1e-13)

    # K4 in f64 and f32 on the n=48 flat layout
    ns = tuple(b[0] for b in asm.structure.bs)
    lay = bd.flat_banded_layout(bws, ns)
    C, F, lead = lay['C'], lay['F'], lay['lead']
    offs = torch.as_tensor(lay['offs'], device=device)
    D = rand(C, F)
    xp = torch.zeros(F + 2 * lead, dtype=f64, device=device)
    xp[lead:lead + F] = rand(F)
    # the same operator as a CSR matrix: entry (i, i + offs[c]) = D[c, i]
    # where the column lies in [0, F) (x is zero outside)
    ii = torch.arange(F, device=device)
    cols = ii[None, :] + offs[:, None]
    valid = (cols >= 0) & (cols < F)
    coo = torch.sparse_coo_tensor(
        torch.stack([ii.expand(C, F)[valid], cols[valid]]), D[valid],
        (F, F)).coalesce()
    del ii, cols, valid
    for dtype, name, tol in ((f64, 'flat_banded_f64', 1e-13),
                             (torch.float32, 'flat_banded_f32', 1e-5)):
        Dd, xd = D.to(dtype), xp.to(dtype)
        got = bd.flat_banded_matvec(Dd, xd, offs, lead)
        ref = bd.flat_banded_matvec_plain(Dd, xd, offs, lead)
        sync(device)
        err, rel = compare(name, got, ref, tol)
        # the library yardstick: a CUDA CSR tensor times x (cuSPARSE SpMV)
        Acsr = coo.to(dtype).to_sparse_csr()
        xv = xd[lead:lead + F].clone()
        compare(name + ' CSR yardstick', Acsr @ xv, ref, tol)
        # D, the offsets and x read once, y written once
        out[name] = dict(
            max_abs_err=err, rel=rel, shape=[C, F],
            ms=time_ms(lambda: bd.flat_banded_matvec(Dd, xd, offs, lead),
                       device, reps=50),
            plain_ms=time_ms(lambda: bd.flat_banded_matvec_plain(
                Dd, xd, offs, lead), device),
            library_ms=time_ms(lambda: Acsr @ xv, device, reps=50),
            library_nnz=int(Acsr.values().numel()),
            **bound(nbytes(Dd, offs, xd[lead:lead + F], got), 2 * C * F,
                    F64_FMA_PER_MS if dtype == f64 else F32_PER_MS))
        del Dd, xd, got, ref, Acsr, xv
    del coo
    for name, r in out.items():
        log('  %-16s kernel %.4f ms   plain %.4f ms   library %s   bound '
            '%.4f ms (%s)' % (name, r['ms'], r['plain_ms'],
                              'none' if r['library_ms'] is None
                              else '%.4f ms' % r['library_ms'],
                              r['bound_ms'], r['bound_by']))
    return out


def solve_case(asm, op_hi, device):
    """Dirichlet solve of the main path on an assembled operator."""
    from pyiga_tpu_torch import solvers
    from pyiga_tpu_torch.ops.fastdiag import (fastdiag_precond_weighted,
                                              interior_dofs)
    from pyiga_tpu_torch.ops.matfree import RestrictedOperator

    free = interior_dofs(asm.kvs)
    t0 = time.perf_counter()
    A_hi = RestrictedOperator(op_hi, free)
    A_lo = RestrictedOperator(op_hi.to(torch.float32), free)
    P = fastdiag_precond_weighted(asm, dirichlet=True, dtype=torch.float32)
    b = torch.as_tensor(np.random.RandomState(0).rand(len(free)),
                        dtype=torch.float64, device=device)
    sync(device)
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, info = solvers.cg_ir(A_hi, A_lo, b, tol=1e-8, precond_lo=P,
                            inner_tol=3e-3)
    sync(device)
    t_solve = time.perf_counter() - t0
    res = float(torch.linalg.vector_norm(b - A_hi(x))
                / torch.linalg.vector_norm(b))
    return x, info, res, t_setup, t_solve


def run_main_path(dim, n, device):
    """Phases 5/6: assemble + solve, timed after synchronizes."""
    t0 = time.perf_counter()
    asm = main_path_setup(dim, n, device)
    t_host = time.perf_counter() - t0
    sync(device)
    t0 = time.perf_counter()
    op_hi = asm.assemble_banded()
    sync(device)
    t_asm = time.perf_counter() - t0
    x, info, res, t_setup, t_solve = solve_case(asm, op_hi, device)
    ndofs = op_hi.shape[0]
    n_free = int(np.prod([kv.numdofs - 2 for kv in asm.kvs]))
    if x.shape != (n_free,) or not bool(torch.isfinite(x).all()):
        raise RuntimeError('solution has shape %s or is not finite'
                           % (tuple(x.shape),))
    rec = dict(dim=dim, n=n, p=3, ndofs=ndofs, n_free=int(x.shape[0]),
               t_host_setup_ms=1e3 * t_host, t_assembly_ms=1e3 * t_asm,
               t_precond_setup_ms=1e3 * t_setup, t_solve_ms=1e3 * t_solve,
               dof_per_s=ndofs / (t_asm + t_solve), outer=info['outer'],
               inner_iters=info['inner_iters'],
               iters=sum(info['inner_iters']), residual=res,
               residual_cg_ir=info['residual'])
    log('  %dD p=3 n=%d: %d dofs (%d free); host setup %.1f ms'
        % (dim, n, ndofs, rec['n_free'], rec['t_host_setup_ms']))
    log('  assembly %.2f ms  solve %.2f ms  (precond setup %.1f ms)  '
        '%.0f dof/s' % (rec['t_assembly_ms'], rec['t_solve_ms'],
                        rec['t_precond_setup_ms'], rec['dof_per_s']))
    log('  outer %d  inner_iters %s  sum %d  rel residual %.3e'
        % (rec['outer'], rec['inner_iters'], rec['iters'], res))
    if not res <= 1e-8:
        raise RuntimeError('relative residual %.3e above 1e-8' % res)
    return rec


def check_small(device):
    """The whole path on small inputs: the card against the CPU run of the
    plain versions (3D p=3 n=8), and the card's 3D p=2 n=10 stiffness
    against the golden fixture."""
    import scipy.sparse
    from pyiga_tpu_torch import bspline, geometry
    from pyiga_tpu_torch.assemblers import StiffnessAssembler
    from pyiga_tpu_torch.ops.banded import flat_banded_to_csr

    cpu = torch.device('cpu')
    outs = {}
    for dev in (device, cpu):
        asm = main_path_setup(3, 8, dev)
        op = asm.assemble_banded()
        x, info, res, _, _ = solve_case(asm, op, dev)
        outs[dev.type] = (op.D.cpu(), x.cpu(), info, res)
    (Dg, xg, ig, rg), (Dc, xc, ic, rc) = outs[device.type], outs['cpu']
    err_D = float((Dg - Dc).abs().max() / Dc.abs().max())
    err_x = float((xg - xc).abs().max() / xc.abs().max())
    log('  3D n=8 card vs CPU: D rel %.3e  x rel %.3e  iters %s vs %s  '
        'res %.2e / %.2e' % (err_D, err_x, ig['inner_iters'],
                             ic['inner_iters'], rg, rc))
    if not (err_D <= 1e-12 and err_x <= 1e-9 and rg <= 1e-8):
        raise RuntimeError('card run disagrees with the CPU run at n=8')

    kv = bspline.make_knots(2, 0.0, 1.0, 10)
    op = StiffnessAssembler(3 * (kv,), geometry.twisted_box(),
                            device=device).assemble_banded()
    A = flat_banded_to_csr(op.D, op.bws, op.ns)
    data = np.loadtxt(os.path.join(REPO, 'tests', 'fixtures',
                                   'poisson_neu_d3_p2_n10_stiff.mtx.gz'),
                      skiprows=1, ndmin=2)
    ij = data[:, :2].astype(np.intp) - 1
    A_ref = scipy.sparse.coo_matrix((data[:, 2], (ij[:, 0], ij[:, 1])),
                                    shape=A.shape).tocsr()
    err_fix = float(abs(A - A_ref).max())
    log('  3D p=2 n=10 stiffness vs golden fixture: max abs err %.3e'
        % err_fix)
    if not err_fix <= 1e-14:
        raise RuntimeError('card assembly misses the golden fixture')
    return dict(n8_D_rel=err_D, n8_x_rel=err_x, n8_iters_card=ig,
                n8_iters_cpu=ic, fixture_max_abs_err=err_fix)


def convdiff_setup(n, device, dim=2):
    """The convection-diffusion assemblers of the VForm path (matrix and
    right-hand side) on the exact-NURBS quarter annulus, 2D p=3 (3D: the
    twisted box, ``b = CONV_B_3D``)."""
    from pyiga_tpu_torch import bspline, geometry
    from pyiga_tpu_torch.assemble import instantiate_assembler
    kvs = dim * (bspline.make_knots(3, 0.0, 1.0, n),)
    geo = geometry.quarter_annulus() if dim == 2 else geometry.twisted_box()
    asm = instantiate_assembler(CONVDIFF, kvs, {
        'geo': geo, 'b': CONV_B if dim == 2 else CONV_B_3D}, None,
        device=device)
    asm_f = instantiate_assembler('v * dx', kvs, {'geo': geo}, None,
                                  device=device)
    return kvs, geo, asm, asm_f


# an empty kernel: its event time through ctypes is the floor under any
# kernel timed through its wrapper
EMPTY_SRC = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int launch_empty(void* stream) {
    empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}
"""


def empty_launch_ms(device):
    """Event time of one empty launch, by ctypes, 200 back to back."""
    import ctypes
    from pyiga_tpu_torch import _cuda
    lib = _cuda.build_generated('empty_kernel', EMPTY_SRC)
    lib.launch_empty.argtypes = [ctypes.c_void_p]
    stream = torch.cuda.current_stream(device).cuda_stream
    return time_ms(lambda: lib.launch_empty(stream), device, reps=200)


def graph_ms(launch, device, n=20, reps=10):
    """Device time of one bare launch: `launch(0)` (which launches on
    PyTorch's current stream) once to load the kernel, then `launch(i)`
    for i < `n` captured in a CUDA graph, the graph replayed `reps` times
    between two CUDA events; returns milliseconds a launch."""
    launch(0)
    sync(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            launch(i)
    graph.replay()
    sync(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * n)


# the H100's L2 cache: a bare launch's device time is taken over enough
# copies of its operands that a launch finds none of them there
L2_BYTES = 50 * 2 ** 20


def _tensors_of(a):
    """The tensors in a nest of dicts, lists and tuples."""
    if isinstance(a, torch.Tensor):
        return [a]
    if isinstance(a, dict):
        a = list(a.values())
    if isinstance(a, (list, tuple)):
        return [t for v in a for t in _tensors_of(v)]
    return []


def _clone_nest(a):
    if isinstance(a, torch.Tensor):
        return a.clone()
    if isinstance(a, dict):
        return {k: _clone_nest(v) for k, v in a.items()}
    if isinstance(a, (list, tuple)):
        return type(a)(_clone_nest(v) for v in a)
    return a


def cold_copies(args):
    """`args` (a nest of tensors) and copies of it, together at least
    twice the L2 (eight at most)."""
    per = nbytes(*_tensors_of(args))
    k = min(8, max(1, -(-2 * L2_BYTES // per)))
    return [args] + [_clone_nest(args) for _ in range(k - 1)]


def cold_graph_ms(launch, args, device):
    """:func:`graph_ms` of ``launch(*args)`` with the launches cycling
    through :func:`cold_copies` of `args`, and the launches' outputs
    kept until the graph is gone (up to four times the L2: a larger
    output passes through it anyway), so that neither a launch's reads
    nor its writes find the previous launch's lines in the L2.  Returns
    ``(ms, copies)``."""
    copies = cold_copies(args)
    k = len(copies)
    outs = []

    def call(i):
        out = launch(*copies[i % k])
        if nbytes(*_tensors_of(outs + [out])) <= 4 * L2_BYTES:
            outs.append(out)
    ms = graph_ms(call, device)
    del outs, copies
    return ms, k


def bare_times(name, fn, operands, args_of, device):
    """A kernel's C entry apart from its Python wrapper: ``launch_ms``,
    the event time of back-to-back ctypes calls ``fn(*args, stream)`` with
    ``args = args_of(operands)`` prebuilt, and ``device_ms``, the device
    time of one launch (:func:`graph_ms`), the launches cycling through
    ``copies`` copies of `operands` (the tensors a launch reads and
    writes) that together hold at least twice the L2."""
    # the copies stay referenced until the graph is gone: capturing it
    # empties PyTorch's cache, which would unmap a freed copy
    copies = cold_copies(operands)
    k = len(copies)
    argsets = [args_of(ts) for ts in copies]

    def call(i):
        err = fn(*argsets[i % k], torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError('%s: bare launch failed (%d)' % (name, err))
    stream = torch.cuda.current_stream(device).cuda_stream
    launch_ms = time_ms(lambda: fn(*argsets[0], stream), device, reps=50)
    call(0)
    device_ms = graph_ms(call, device)
    del argsets, copies
    return dict(launch_ms=launch_ms, device_ms=device_ms, copies=k)


# K5's rows threshold (``K5_ROWS_QL`` of its generated sources)
K5_ROWS_QL = 8


def check_cols_mapping(prog, arrays, got, device, name):
    """K5's fields `got` on a grid whose last axis has fewer than
    :data:`K5_ROWS_QL` points (the rows mapping) bitwise against the same
    program built with the threshold at 0, so that every last axis maps
    to threads: the kernel's mapping before its rows branch, with the
    same point code.  Raises unless equal."""
    import copy
    text = prog.source.replace('#define K5_ROWS_QL %d' % K5_ROWS_QL,
                               '#define K5_ROWS_QL 0')
    if text == prog.source:
        raise RuntimeError('vform_fields %s: no rows threshold in the '
                           'source' % name)
    cols = copy.copy(prog)
    cols._source, cols._entry, cols._adjoint = text, None, None
    out = torch.empty_like(got)
    err = cols.entry()(*cols.arguments(
        arrays, out, torch.cuda.current_stream(device).cuda_stream))
    sync(device)
    if err != 0 or not torch.equal(out, got):
        raise RuntimeError('vform_fields %s: the rows mapping differs from '
                           'the columns mapping' % name)
    log('  vform_fields %-14s bitwise equal to the columns mapping' % name)
    return True


def vform_case(asm, device, inputs=None, tol=1e-12, name=None):
    """K5 on the plan's combos of a VForm assembler (its input fields
    replaced by the device tensors `inputs`, as a stepper passes them), in
    the compute dtype (under float32 the program's float32 instance, also
    bitwise unchanged with torch's global TF32 on): the kernel against
    its plain version (`tol` relative to the largest field), a second
    launch bitwise equal; ``ms`` through ``combo_fields`` (the path's
    call), ``launch_ms`` and ``device_ms`` of its bare C entry, the plain
    version's time and the bound."""
    from pyiga_tpu_torch import _cuda
    from pyiga_tpu_torch.ops import cuda_vform as cv
    plan = asm._fold_plan or [(t, False) for t in range(len(asm.combos))]
    combos = [asm.combos[t] for t, _m in plan]
    arrays = asm.device_arrays(inputs)
    dtype = arrays['weights'][0].dtype
    got = torch.stack(cv.combo_fields(asm, arrays, combos))
    ref = torch.stack(cv.combo_fields_plain(asm, arrays, combos))
    sync(device)
    name = name or '%dD n=%d' % (asm.dim, asm.kvs0[0].numspans)
    err, rel = compare('vform_fields ' + name, got, ref, tol)
    check_repeat('vform_fields ' + name,
                 lambda: torch.stack(cv.combo_fields(asm, arrays, combos)),
                 got)
    if dtype == torch.float32:
        with GlobalTF32():
            got_tf = torch.stack(cv.combo_fields(asm, arrays, combos))
            ref_tf = torch.stack(cv.combo_fields_plain(asm, arrays, combos))
            sync(device)
        if not (torch.equal(got_tf, got) and torch.equal(ref_tf, ref)):
            raise RuntimeError('vform_fields %s: global TF32 changed the '
                               'f32 results' % name)
        del got_tf, ref_tf
    prog = asm._program(combos, dtype)
    fn = prog.entry()
    lib = [k for k in _cuda.GEN_BUILDS if re.fullmatch(
        r'lib%s_[0-9a-f]{16}\.so' % prog.counter, os.path.basename(k))][-1]
    build = dict(_cuda.GEN_BUILDS[lib], path=lib)
    for line in build['log'].splitlines():
        if 'registers' in line or 'spill' in line:
            log('  ' + line.strip())
    cols_equal = None
    if got.shape[-1] < K5_ROWS_QL:
        cols_equal = check_cols_mapping(prog, arrays, got, device, name)
    d, ns = asm.dim, len(prog.sources)
    operands = (list(arrays['weights']) + [arrays[k] for k in prog.sources]
                + [arrays['params']] * bool(prog.params)
                + [torch.empty_like(got)])

    def args_of(ts):
        arr = dict(zip(prog.sources, ts[d:d + ns]), weights=ts[:d],
                   params=ts[-2])
        return prog.arguments(arr, ts[-1], 0)[:-1]
    rec = dict(max_abs_err=err, rel=rel, shape=list(got.shape),
               dtype=str(dtype), lib=lib,
               leaves=len(prog.leaves), sources=list(prog.sources),
               params=len(prog.params), instrs=len(prog.instrs),
               repeat_equal=True, cols_mapping_equal=cols_equal,
               ms=time_ms(lambda: cv.combo_fields(asm, arrays, combos),
                          device, reps=50),
               plain_ms=time_ms(lambda: cv.combo_fields_plain(
                   asm, arrays, combos), device, reps=3),
               library_ms=None, build=build)
    rec.update(bare_times(prog.counter, fn, operands, args_of, device))
    # the leaf rows the program reads (each once), the weight vectors and
    # the flat parameters, the fields written once; one operation per
    # SSA instruction and Gauss point
    N = got[0].numel()
    rows = {s for s in prog.leaf_src if s is not None}
    read = got.element_size() * (
        len(rows) * N + sum(w.numel() for w in arrays['weights'])
        + (arrays['params'].numel() if prog.params else 0))
    rec.update(bound(read + nbytes(got), len(prog.instrs) * N,
                     F32_PER_MS if dtype == torch.float32
                     else F64_FMA_PER_MS))
    log('  K5 %s: %d leaves from %s, %d params, %d SSA instrs, %d fields; '
        'nvcc %.2f s' % (name, len(prog.leaves), prog.sources,
                         len(prog.params), len(prog.instrs), len(combos),
                         build['seconds']))
    return rec


def check_vform_kernels(device):
    """Phase 4c: K1's jac kind against its plain version on the 2D
    annulus at n=128 and the 3D twisted box at n=48, and the generated K5
    against its plain version on the convection-diffusion form at 2D
    n=128 (the path's shape) and 3D n=48 on the twisted box (both
    1e-12 relative to the largest output, each launched twice for
    bitwise-equal output).  Each kernel's ``ms`` is its wrapper's call;
    ``launch_ms`` and ``device_ms`` (:func:`bare_times`) time its bare C
    entry."""
    from pyiga_tpu_torch import _cuda
    from pyiga_tpu_torch.ops import cuda_sumfac as cs

    t0 = time.perf_counter()
    _, _, asm, _ = convdiff_setup(128, device)
    t_setup = time.perf_counter() - t0
    ops = asm._device_operands()
    asm3 = main_path_setup(3, 48, device)
    gi3 = asm3.geo_inputs()
    cases = {}
    for name, tables, coeffs, nurbs in (
            ('2d_n128_nurbs', ops['geo_tables'], ops['geo_coeffs'],
             asm._geo_is_nurbs),
            ('3d_n48_bspline', gi3['geo_tables_bsp'], gi3['geo_coeffs'],
             False)):
        d = len(tables)
        Y, _ = cs.geo_stage12(tables, coeffs, d)
        T = tables[d - 1][:2].contiguous()
        got = cs.geo_jac_fields(Y, T, nurbs)
        ref = cs.geo_jac_fields_plain(Y, T, nurbs)
        sync(device)
        err, rel = compare('geo_jac ' + name[:9], got, ref, 1e-13)
        check_repeat('geo_jac ' + name[:9],
                     lambda: cs.geo_jac_fields(Y, T, nurbs), got)
        # per point: C x (d + 1) dots of nL, the NURBS quotient
        C, Q12, nL = Y.shape[1], Y.shape[2], Y.shape[3]
        cases[name] = dict(
            max_abs_err=err, rel=rel, shape=list(got.shape),
            ms=time_ms(lambda: cs.geo_jac_fields(Y, T, nurbs), device,
                       reps=50),
            plain_ms=time_ms(lambda: cs.geo_jac_fields_plain(Y, T, nurbs),
                             device, reps=3),
            library_ms=None,
            **bound(nbytes(Y, T, got),
                    got[0].numel() * (2 * C * (d + 1) * nL + 30),
                    F64_FMA_PER_MS))
        cases[name].update(bare_times(
            'geo_jac_fields', _cuda.library().pyiga_geo_jac_fields_f64,
            [Y, T, torch.empty_like(got)],
            lambda ts: (ts[0].data_ptr(), ts[1].data_ptr(), ts[2].data_ptr(),
                        d, C - int(nurbs), int(nurbs), Q12, T.shape[1], nL),
            device))
        del Y, got, ref
    out = {'geo_jac_fields': dict(cases['2d_n128_nurbs'], cases=cases,
                                  repeat_equal=True,
                                  ragged=check_fields_ragged('jac', device),
                                  empty_launch_ms=empty_launch_ms(device))}
    log('  empty launch (the floor of a wrapper-timed kernel): %.4f ms'
        % out['geo_jac_fields']['empty_launch_ms'])

    # K5 on the plan's combos of the n=128 path, then at 3D n=48
    k5 = {'2d_n128_convdiff': vform_case(asm, device)}
    k5['2d_n128_convdiff']['host_setup_first_ms'] = 1e3 * t_setup
    del asm3, gi3
    k5['3d_n48_convdiff'] = vform_case(convdiff_setup(
        48, device, dim=3)[2], device)
    out['vform_fields'] = dict(k5['2d_n128_convdiff'], cases=k5)
    for name, r in list(cases.items()) + list(k5.items()):
        log('  %-18s wrapper %.4f ms   bare launch %.4f ms   device %.4f ms'
            '   plain %.4f ms   bound %.4f ms (%s)'
            % (name, r['ms'], r['launch_ms'], r['device_ms'], r['plain_ms'],
               r['bound_ms'], r['bound_by']))
    return out


def solve_convdiff(asm, data, f, device):
    """Dirichlet restriction of the assembled convection-diffusion matrix
    and its GMRES(30) solve to 1e-10, fastdiag right preconditioner."""
    from pyiga_tpu_torch import solvers
    from pyiga_tpu_torch.ops import fastdiag, matfree
    from pyiga_tpu_torch.ops.mlmatvec import MLMatvecOperator

    free = fastdiag.interior_dofs(asm.kvs0)
    t0 = time.perf_counter()
    A = matfree.RestrictedOperator(MLMatvecOperator(data, asm.structure),
                                   free)
    P = fastdiag.fastdiag_precond(asm.kvs0, dirichlet=True, device=device)
    b = torch.as_tensor(np.asarray(f).ravel()[free], dtype=torch.float64,
                        device=device)
    sync(device)
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, iters = solvers.gmres(A, b, tol=1e-10, restart=30, precond=P)
    sync(device)
    t_solve = time.perf_counter() - t0
    res = float(torch.linalg.vector_norm(b - A(x))
                / torch.linalg.vector_norm(b))
    if x.shape != (len(free),) or not bool(torch.isfinite(x).all()):
        raise RuntimeError('GMRES solution has shape %s or is not finite'
                           % (tuple(x.shape),))
    return x, iters, res, t_setup, t_solve


def check_vform_small(device):
    """Phase 4d: the VForm path (assembly and GMRES) at 2D n=16 on the
    card against the CPU run of the plain versions."""
    cpu = torch.device('cpu')
    outs = {}
    for dev in (device, cpu):
        _, _, asm, asm_f = convdiff_setup(16, dev)
        data = asm.run_device()[(None, None)]
        x, iters, res, _, _ = solve_convdiff(asm, data,
                                             asm_f.assemble_vector(), dev)
        outs[dev.type] = (data.cpu(), x.cpu(), iters, res)
    (Dg, xg, ig, rg), (Dc, xc, ic, rc) = outs[device.type], outs['cpu']
    err_D = float((Dg - Dc).abs().max() / Dc.abs().max())
    err_x = float((xg - xc).abs().max() / xc.abs().max())
    log('  2D n=16 card vs CPU: A data rel %.3e  x rel %.3e  GMRES iters '
        '%s vs %s  res %.2e / %.2e' % (err_D, err_x, ig, ic, rg, rc))
    if ig != ic:
        log('  iteration counts differ by %d: the card sums the compact '
            'matvec by atomic scatter-adds, in another order than the CPU,'
            ' which moves the Givens residual estimate across tol'
            % abs(ig - ic))
    if not (err_D <= 1e-12 and err_x <= 1e-9 and abs(ig - ic) <= 1
            and rg <= 1e-9):
        raise RuntimeError('card VForm path disagrees with the CPU run')
    return dict(n16_data_rel=err_D, n16_x_rel=err_x, n16_iters_card=ig,
                n16_iters_cpu=ic, n16_res_card=rg, n16_res_cpu=rc)


def run_convdiff(device, n=128):
    """Phase 7: the convection-diffusion VForm path at 2D p=3 n=128,
    timed after synchronizes: assembler setup, ``run_device()`` (best of
    3 after a warm call, as bench.py times it), ``assemble_vector()``,
    the whole ``assemble.assemble`` call with its CSR expansion, and the
    GMRES solve."""
    from pyiga_tpu_torch import _cuda, assemble
    t0 = time.perf_counter()
    kvs, geo, asm, asm_f = convdiff_setup(n, device)
    t_host = 1e3 * (time.perf_counter() - t0)
    t_A = best_ms(asm.run_device, device)
    k5 = _cuda.LAUNCHES['vform_fields']
    asm.run_device()
    k5 = _cuda.LAUNCHES['vform_fields'] - k5
    t_f = best_ms(asm_f.assemble_vector, device)
    t0 = time.perf_counter()
    A = assemble.assemble(CONVDIFF, kvs, geo=geo, b=CONV_B, device=device)
    t_whole = 1e3 * (time.perf_counter() - t0)
    data = asm.run_device()[(None, None)]
    f = asm_f.assemble_vector()
    x, iters, res, t_setup, t_solve = solve_convdiff(asm, data, f, device)
    ndofs = A.shape[0]
    rec = dict(n=n, p=3, ndofs=ndofs, n_free=int(x.shape[0]),
               nnz=int(A.nnz), combos=len(asm.combos),
               fold_plan=asm._fold_plan, t_host_setup_ms=t_host,
               t_run_device_ms=t_A, t_assemble_vector_ms=t_f,
               t_assemble_csr_ms=t_whole, t_precond_setup_ms=1e3 * t_setup,
               t_solve_ms=1e3 * t_solve, iters=iters, residual=res,
               k5_launches_per_run_device=k5)
    log('  2D p=3 n=%d: %d dofs (%d free), %d combos; host setup %.1f ms'
        % (n, ndofs, rec['n_free'], rec['combos'], t_host))
    log('  run_device %.2f ms  assemble_vector %.2f ms  assemble()+CSR '
        '%.1f ms' % (t_A, t_f, t_whole))
    log('  K5 launches per run_device: %d' % k5)
    if k5 != 1:
        raise RuntimeError('run_device launched K5 %d times' % k5)
    log('  GMRES %d iterations in %.2f ms (precond setup %.1f ms)  true '
        'rel residual %.3e' % (iters, rec['t_solve_ms'],
                               rec['t_precond_setup_ms'], res))
    if not res <= 1e-9:
        raise RuntimeError('relative residual %.3e above 1e-9' % res)
    return rec


def localmg_space(n0, num_levels=3):
    """The bench's hierarchy (``bench.py`` ``run_localmg``): 2D p=3,
    disparity 1, Dirichlet on all four sides, refined toward the (1, 1)
    corner."""
    from pyiga_tpu_torch import bspline
    from pyiga_tpu_torch.hierarchical import HSpace
    hs = HSpace(2 * (bspline.make_knots(3, 0.0, 1.0, n0),), disparity=1,
                bdspecs=[(0, 0), (0, 1), (1, 0), (1, 1)])
    for lv in range(num_levels - 1):
        thr = 1.0 - 2.0 ** (-lv - 1)
        hs.refine_region(lv, lambda *X: min(X) > thr)
    return hs


def localmg_discretization(hs, device):
    from pyiga_tpu_torch import geometry, vform
    from pyiga_tpu_torch.hierarchical import HDiscretization
    return HDiscretization(hs, vform.stiffness_vf(dim=2),
                           {'geo': geometry.unit_square(),
                            'f': lambda *x: 1.0}, device=device)


def localmg_solver(hs, A, device, impl):
    """The device solver of ``solve_hmultigrid``'s defaults ('cell_supp',
    'gs', 2 steps) with `impl` forced."""
    from pyiga_tpu_torch import solvers
    from pyiga_tpu_torch.ops.mg import DeviceMGSolver
    Ps = hs.virtual_hierarchy_prolongators()
    return DeviceMGSolver(solvers.galerkin_hierarchy(A, Ps), Ps,
                          hs.indices_to_smooth('cell_supp'),
                          ('forward', 'backward'), 2,
                          active_dofs=hs.non_dirichlet_dofs(),
                          smoother_impl=impl, device=device)


def vcycle_bound(ops, x, f):
    """K6's bound for one cycle: every operand of the hierarchy, x and f
    read once, x written once, each triangular inverse T over its occupied
    entries only (from each row's first to its last nonzero); the
    operations counted are T's occupied entries once per listed sweep and
    the coarse inverse once (a lower bound: the ELL products are left
    out)."""
    tensors, seen = [ops.ind0, ops.mask, x, f, x], set()
    nbytes_dense = 8 * ops.Cinv.m ** 2
    flops = 2 * ops.Cinv.m ** 2
    for lev in ops.levels:
        for key, val in lev.items():
            if key == 'wave':
                wb = wavefront_bound(val, None, ops.steps, vectors=False)
                nbytes_dense += wb['bound_bytes']
                flops += wb['bound_flops']
                continue
            for t in (val if isinstance(val, (list, tuple)) else [val]):
                if id(t) in seen:
                    continue
                seen.add(id(t))
                if key in ('pre', 'post'):
                    nbytes_dense += 8 * t.entries
                else:
                    tensors.append(t)
        for T in lev.get('pre', []) + lev.get('post', []):
            flops += 2 * ops.steps * T.entries
    return bound(nbytes(*tensors) + nbytes_dense, flops, F64_FMA_PER_MS)


def localmg_problem(n0, L, device):
    """Hierarchy, matrix and right-hand side of the local-MG path."""
    hs = localmg_space(n0, L)
    hd = localmg_discretization(hs, device)
    return hs, hd.assemble_matrix(), hd.assemble_rhs()


def check_vcycle_kernel(device):
    """Phase 4e: K6 against its plain version on the operands of the
    (24, 3), (48, 3) and (96, 3) hierarchies (the last past
    ``tri_block_cutoff``, where ``'auto'`` takes K6's wavefront mode: the
    dense mode there is that mode's yardstick, after a host setup of half a
    minute for its four 9,316-row triangular inverses): one V-cycle from a
    seeded iterate and
    right-hand side (1e-13 relative to the largest entry, a second launch
    bitwise equal), and the whole solve from zero for the path's
    right-hand side against the host loop over the plain cycle (the same
    cycle count, x and the per-cycle res2 to 1e-12 relative).  Times: one
    cycle by its own launch, the solve's launch divided by its cycles, and
    from a traced solve the time of each step of its second cycle (block
    0's ``%globaltimer`` after each grid barrier)."""
    from pyiga_tpu_torch.ops import cuda_mg
    cpu = torch.device('cpu')
    cases = {}
    for n0, L in LOCALMG_ITERS:
        hs, A, fh = localmg_problem(n0, L, cpu)
        t0 = time.perf_counter()
        s = localmg_solver(hs, A, device, 'fused')
        sync(device)
        t_setup = time.perf_counter() - t0
        ops = s.ops
        name = '(%d,%d)' % (n0, L)
        rng = np.random.RandomState(n0)
        x = torch.as_tensor(rng.rand(A.shape[0]), dtype=torch.float64,
                            device=device)
        f = torch.as_tensor(rng.rand(A.shape[0]), dtype=torch.float64,
                            device=device)
        got, ref = cuda_mg.vcycle(ops, x, f), cuda_mg.vcycle_plain(ops, x, f)
        sync(device)
        err, rel = compare('vcycle ' + name, got[0], ref[0], 1e-13)
        _, rel2 = compare('res2 ' + name, got[1].reshape(1),
                          ref[1].reshape(1), 1e-13)
        check_repeat('vcycle ' + name, lambda: cuda_mg.vcycle(ops, x, f)[0],
                     got[0])
        fp = torch.as_tensor(fh, dtype=torch.float64, device=device)
        res0 = np.float64(torch.linalg.vector_norm(fp * ops.mask).item())
        xs, its, _, hists = cuda_mg.vcycle_solve_plain(ops, fp, res0, 1e-8,
                                                       100)
        xg, itg, _, histg = cuda_mg.vcycle_solve(ops, fp, res0, 1e-8, 100)
        if itg != its:
            raise RuntimeError('K6 solve %s took %d cycles, the plain loop %d'
                               % (name, itg, its))
        _, rel_x = compare('solve x ' + name, xg, xs, 1e-12)
        _, rel_h = compare('solve res2 ' + name, histg, hists, 1e-12)
        xz = torch.zeros_like(fp)
        solve_ms = time_ms(lambda: cuda_mg.launch_solve(
            ops, xz.zero_(), fp, res0, 1e-8, 100), device, reps=10)
        # a traced solve: the steps of its second cycle
        first, names = cuda_mg.phase_names(ops, first=True), \
            cuda_mg.phase_names(ops)
        trace = torch.zeros(len(first) + len(names) + 1, dtype=torch.int64,
                            device=device)
        traced_ms = time_ms(lambda: cuda_mg.launch_solve(
            ops, xz.zero_(), fp, res0, 1e-8, 100, trace=trace), device,
            reps=10)
        ts = trace.cpu().numpy()[len(first):]
        steps_us = [(nm, 1e-3 * float(t1 - t0_))
                    for nm, t0_, t1 in zip(names, ts[:-1], ts[1:])]
        blocks, smem = cuda_mg._launch_shape(ops, device)
        m = [int(lev['S'].shape[0]) for lev in ops.levels[1:]]
        key = '%d_%d' % (n0, L)
        cases[key] = dict(
            max_abs_err=err, rel=rel, res2_rel=rel2, solve_x_rel=rel_x,
            solve_res2_rel=rel_h, repeat_equal=True, cycles=itg,
            blocks=blocks, smem_bytes=smem, n=ops.n, m=m,
            m0=int(ops.ind0.shape[0]), solver_setup_ms=1e3 * t_setup,
            cycle_ms=time_ms(lambda: cuda_mg.vcycle(ops, x, f), device,
                             reps=20),
            solve_ms=solve_ms, ms=solve_ms / itg, traced_solve_ms=traced_ms,
            cycle2_steps_us=steps_us,
            plain_ms=time_ms(lambda: cuda_mg.vcycle_plain(ops, x, f), device,
                             reps=5),
            library_ms=None, **vcycle_bound(ops, x, f))
        r = cases[key]
        log('  %s: n %s  m %s  m0 %d  %d blocks, %d B shared  solver setup '
            '%.0f ms' % (name, ops.n, m, r['m0'], blocks, smem,
                         1e3 * t_setup))
        log('  vcycle %s one cycle %.4f ms   solve %.4f ms / %d cycles = '
            '%.4f ms a cycle (traced %.4f ms)   plain %.4f ms a cycle   '
            'bound %.4f ms' % (name, r['cycle_ms'], solve_ms, itg, r['ms'],
                               traced_ms, r['plain_ms'], r['bound_ms']))
        log('  cycle 2 steps (us): %s'
            % ', '.join('%s %.2f' % st for st in steps_us))
        del s, ops, x, f, fp, got, ref
    return {'vcycle': dict(cases['24_3'], cases=cases)}


def check_localmg_small(device):
    """Phase 4f: the local-MG path at n0=6, L=3 ('gs'): assembly and the
    device solve on the card against the CPU run of the plain versions
    and the host path; equal iteration counts, x to 1e-12.  Then K6's
    solve with 0 and 1 smoothing steps against its plain loop."""
    from pyiga_tpu_torch import solvers
    cpu = torch.device('cpu')
    hs = localmg_space(6)
    outs = {}
    for dev in (device, cpu):
        hd = localmg_discretization(hs, dev)
        A, f = hd.assemble_matrix(), hd.assemble_rhs()
        x, it = solvers.solve_hmultigrid(hs, A, f, tol=1e-8,
                                         relax_backend='device', device=dev)
        outs[dev.type] = (A, f, x, it)
    (Ag, fg, xg, ig), (Ac, fc, xc, ic) = outs[device.type], outs['cpu']
    xh, ih = solvers.solve_hmultigrid(hs, Ac, fc, tol=1e-8,
                                      relax_backend='host')
    err_A = float(abs(Ag - Ac).max() / abs(Ac).max())
    err_f = float(np.abs(fg - fc).max() / np.abs(fc).max())
    err_x = float(np.abs(xg - xc).max() / np.abs(xc).max())
    err_xh = float(np.abs(xg - xh).max() / np.abs(xh).max())
    log('  n0=6 L=3 (%d dofs) card vs CPU: A rel %.3e  f rel %.3e  x rel '
        '%.3e (host path %.3e)  iterations %s / %s / host %s'
        % (hs.numdofs, err_A, err_f, err_x, err_xh, ig, ic, ih))
    if not (ig == ic == ih and err_A <= 1e-13 and err_f <= 1e-13
            and err_x <= 1e-12 and err_xh <= 1e-12):
        raise RuntimeError('card local-MG path disagrees with the CPU run')
    # K6's solve with 0 and 1 smoothing steps (with none, the kernel adds a
    # barrier between the residual sum and the next cycle's first write to
    # r) against the plain loop on the same operands, at most 20 cycles
    from pyiga_tpu_torch.ops import cuda_mg
    steps_rel = {}
    for steps in (0, 1):
        ops = solvers._device_mg_solver(hs, Ag, 'cell_supp', 'gs', steps,
                                        device).ops
        ft = torch.as_tensor(fg, dtype=torch.float64, device=device)
        res0 = np.float64(torch.linalg.vector_norm(ft * ops.mask).item())
        xk, itk, _, hk = cuda_mg.vcycle_solve(ops, ft, res0, 1e-8, 20)
        xp, itp, _, hp = cuda_mg.vcycle_solve_plain(ops, ft, res0, 1e-8, 20)
        if itk != itp:
            raise RuntimeError('K6 with %d smoothing steps took %d cycles, '
                               'the plain loop %d' % (steps, itk, itp))
        _, rel = compare('solve x steps=%d' % steps, xk, xp, 1e-12)
        compare('solve res2 steps=%d' % steps, hk, hp, 1e-12)
        steps_rel[steps] = dict(cycles=itk, x_rel=rel)
    return dict(n6_dofs=hs.numdofs, n6_A_rel=err_A, n6_f_rel=err_f,
                n6_x_rel=err_x, n6_x_host_rel=err_xh, n6_iters_card=ig,
                n6_iters_cpu=ic, n6_iters_host=ih, n6_smooth_steps=steps_rel)


def run_localmg(device, n0, L=3, impl=None, iters_jax=None, kernels=None):
    """Phases 8/8b/8c: the local-MG path the way ``bench.py``
    ``run_localmg`` times it: assembly (``assemble_matrix`` +
    ``assemble_rhs``) is the min of 3 after 2 warm-up builds; the solve
    the min of 2 at tol 1e-8 after a warm-up at tol 1e-2, through
    ``solve_hmultigrid`` (`impl` None) or a ``DeviceMGSolver`` with
    ``smoother_impl=impl``.  Holds the count to the port's host path in
    this process and to the JAX package's (`iters_jax`, default
    :data:`LOCALMG_ITERS`), and the launches to `kernels` (default the
    float64 path's)."""
    from pyiga_tpu_torch import _cuda, solvers
    if iters_jax is None:
        iters_jax = LOCALMG_ITERS[(n0, L)]
    t0 = time.perf_counter()
    hs = localmg_space(n0, L)
    t_space = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(device)
    _cuda.reset_launches()

    def build():
        hd = localmg_discretization(hs, device)
        t0 = time.perf_counter()
        A = hd.assemble_matrix()
        t1 = time.perf_counter()
        f = hd.assemble_rhs()
        return A, f, t1 - t0, time.perf_counter() - t1

    t0 = time.perf_counter()
    build()
    t_first = time.perf_counter() - t0
    build()
    best = None
    k5 = _cuda.LAUNCHES['vform_fields']
    for _ in range(3):
        A, f, t_A, t_f = build()
        if best is None or t_A + t_f < sum(best):
            best = (t_A, t_f)
    k5 = (_cuda.LAUNCHES['vform_fields'] - k5) / 3
    t0 = time.perf_counter()
    if impl is None:        # solve_hmultigrid's defaults: the card, 'auto'
        def solve(tol):
            return solvers.solve_hmultigrid(hs, A, f, tol=tol)
    else:
        solver = localmg_solver(hs, A, device, impl)

        def solve(tol):
            return solver.solve(f, tol=tol)
    solve(1e-2)     # on the solve_hmultigrid path this builds the solver
    sync(device)
    t_warm = time.perf_counter() - t0
    t_slv = np.inf
    for _ in range(2):
        t0 = time.perf_counter()
        x, iters = solve(1e-8)
        t_slv = min(t_slv, time.perf_counter() - t0)
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device)
    route = impl
    setup = {}
    if impl is None:
        solver = solvers._device_mg_solver(hs, A, 'cell_supp', 'gs', 2,
                                           device)
        route = solver.smoother_impl
        setup['first'] = solver.setup_ms
        if route == 'wavefront':
            # the same setup again, the process warm (cuSOLVER loaded)
            setup['again'] = localmg_solver(hs, A, device,
                                            route).setup_ms
            torch.cuda.empty_cache()
    want = 'wavefront' if (n0, L) in WAVEFRONT_SIZES else 'fused'
    if impl is None and route != want:
        raise RuntimeError('solve_hmultigrid took the %r route at (%d,%d), '
                           'expected %r' % (route, n0, L, want))
    k6 = 'vcycle_wavefront' if route == 'wavefront' else 'vcycle'

    t0 = time.perf_counter()
    xh, it_host = solvers.solve_hmultigrid(hs, A, f, tol=1e-8,
                                           relax_backend='host')
    t_host = time.perf_counter() - t0
    free = hs.non_dirichlet_dofs()
    res = float(np.linalg.norm((f - A @ x)[free]) / np.linalg.norm(f[free]))
    x_rel = float(np.abs(x - xh).max() / np.abs(xh).max())
    rec = dict(n0=n0, levels=L, p=3, impl=impl or 'auto', route=route,
               setup_ms=setup, smoothing_sets=[
                   len(s) for s in hs.indices_to_smooth('cell_supp')],
               ms_per_cycle=1e3 * t_slv / iters, ndofs=hs.numdofs,
               nnz=int(A.nnz), numactive=list(hs.numactive),
               t_space_ms=1e3 * t_space, t_first_build_ms=1e3 * t_first,
               t_assemble_matrix_ms=1e3 * best[0],
               t_assemble_rhs_ms=1e3 * best[1],
               t_assembly_ms=1e3 * sum(best),
               t_solver_setup_and_warm_solve_ms=1e3 * t_warm,
               t_solve_ms=1e3 * t_slv, iters=iters, iters_host=it_host,
               t_host_solve_ms=1e3 * t_host, residual=res, x_rel_host=x_rel,
               dof_per_s=hs.numdofs / (sum(best) + t_slv),
               peak_device_bytes=int(peak), launches=launches,
               k5_launches_per_build=k5)
    log('  (%d,%d) %s: %d dofs, nnz %d; first build %.0f ms; K5 launches '
        'per build %g' % (n0, L, rec['impl'], hs.numdofs, A.nnz,
                          1e3 * t_first, k5))
    log('  assembly %.2f ms (matrix %.2f + rhs %.2f)  solver setup + warm '
        'solve %.1f ms  solve %.2f ms  %.0f dof/s'
        % (rec['t_assembly_ms'], rec['t_assemble_matrix_ms'],
           rec['t_assemble_rhs_ms'], rec['t_solver_setup_and_warm_solve_ms'],
           rec['t_solve_ms'], rec['dof_per_s']))
    log('  iterations %s (host path %s in %.1f ms, JAX %d)  rel residual '
        '%.3e  x vs host %.3e  peak %.1f MB'
        % (iters, it_host, 1e3 * t_host, iters_jax, res, x_rel,
           peak / 2 ** 20))
    log('  route %s, smoothing sets %s, %.4f ms a cycle; solver setup '
        '(ms) %s' % (route, rec['smoothing_sets'], rec['ms_per_cycle'],
                     setup))
    log('  launches: %s' % launches)
    if x.shape != (hs.numdofs,) or not np.isfinite(x).all():
        raise RuntimeError('local-MG solution has shape %s or is not finite'
                           % (x.shape,))
    if not (iters == it_host == iters_jax):
        raise RuntimeError('local-MG iterations %s, host path %s, expected %d'
                           % (iters, it_host, iters_jax))
    if not (res <= 1e-8 and x_rel <= 1e-10):
        raise RuntimeError('local-MG residual %.3e or x vs host %.3e too '
                           'large' % (res, x_rel))
    if kernels is None:
        kernels = WAVE_LOCALMG_KERNELS if route == 'wavefront' else \
            LOCALMG_KERNELS
    missing = [k for k in kernels if launches[k] <= 0]
    if missing:
        raise RuntimeError('local-MG path never launched %s' % missing)
    # the warm-up solve and the two timed ones: one K6 launch each
    if launches[k6] != 3:
        raise RuntimeError('K6 (%s) launched %d times for 3 solves'
                           % (k6, launches[k6]))
    return rec


def wavefront_bound(sweeps, group, iterations, vectors=True):
    """The wavefront kernel's bound: each distinct pass of group `group`
    (every group for None) read once (its stored nonzero entries, 4 + 8
    bytes each; its rows' local and global index and diagonal; its level
    table) and, with `vectors`, the touched entries of x read, the set's
    written and its b read; the operations counted are 2 a stored entry
    and one division a row, per pass applied (`iterations` times each
    pass of the group)."""
    groups = range(len(sweeps.groups)) if group is None else [group]
    seen, nb, flops = set(), 0, 0
    for g in groups:
        for c in sweeps.compact[g]:
            rows = int(c['lvl'][:, 3].sum())
            flops += iterations * (2 * c['entries'] + rows)
            if id(c) not in seen:
                seen.add(id(c))
                nb += 12 * c['entries'] + 16 * rows + 16 * c['nlev']
    if vectors:
        nb += 8 * (sweeps.nloc + 2 * sweeps.m)
    return bound(nb, flops, F64_FMA_PER_MS)


def localmg_levels(n0, L, device):
    """The Galerkin hierarchy, smoothing sets and right-hand side of the
    local-MG path (assembled on `device`)."""
    from pyiga_tpu_torch import solvers
    hs, A, f = localmg_problem(n0, L, device)
    Ps = hs.virtual_hierarchy_prolongators()
    return hs, A, f, solvers.galerkin_hierarchy(A, Ps), \
        hs.indices_to_smooth('cell_supp')


def pass_numerators(sweeps, group, x, b):
    """The numerators ``b_i - sum_j a_ij x_j`` and diagonals of every live
    row of the passes of group `group` of `sweeps`, as the plain version
    computes them level by level from `x` (on x's device)."""
    xe = torch.cat([x, x.new_zeros(1)])
    be = torch.cat([b, b.new_zeros(1)])
    nums, diags = [], []
    for rows, cols, vals, diag in sweeps.plain[group]:
        for l in range(rows.shape[0]):
            r = rows[l]
            num = be[r] - (vals[l] * xe[cols[l]]).sum(dim=-1)
            xe[r] = num / diag[l]
            live = r != sweeps.n
            nums.append(num[live])
            diags.append(diag[l][live])
    return torch.cat(nums), torch.cat(diags)


def check_quotient(sweeps, x, b, rng, reps=16):
    """The kernel's reciprocal quotient (``cuda_mg.wavefront_quotient``)
    against the division on the card: the numerators and diagonals of
    every row of the sweeps' passes, and `reps` random numerators (signs
    and six decades) for each diagonal.  Returns the count of rows that
    differ (bitwise) and how many were compared; the reciprocal is the
    host pack's, 1 / d rounded once."""
    from pyiga_tpu_torch.ops import cuda_mg
    num, d = pass_numerators(sweeps, 0, x, b)
    dh = d.cpu().numpy()
    r = torch.as_tensor(1.0 / dh, device=d.device)
    if not torch.equal(r, 1.0 / d):
        raise RuntimeError('1 / d on the card differs from the host')
    nr = rng.uniform(-1, 1, (reps, len(dh))) \
        * 10.0 ** rng.uniform(-3, 3, (reps, len(dh)))
    num = torch.cat([num, torch.as_tensor(nr.reshape(-1), device=d.device)])
    d, r = d.repeat(reps + 1), r.repeat(reps + 1)
    got = cuda_mg.wavefront_quotient(num, d, r)
    return int((got != num / d).sum()), int(num.numel())


def trisolve_yardstick(A, S, reverse, x, b, got, device):
    """The library call for one Gauss-Seidel pass over the set `S` (in
    order, or reversed): ``torch.triangular_solve(r, L, upper=False)``
    with ``L = (D + L)_SS`` in the sweep order as a CSR tensor on the card
    and ``r = b_S - (the rest) x`` formed on the host outside the timing
    (PyTorch's call runs cuSPARSE's analysis with each solve).  Checks the
    solution against `got` (the kernel's pass from `x`) and returns the
    relative difference and ms a call."""
    import scipy.sparse
    A = scipy.sparse.csr_matrix(A)
    S = np.asarray(S)
    order = (S[::-1] if reverse else S).copy()
    rest = np.setdiff1d(np.arange(A.shape[0]), S)
    M = A[order][:, order]
    L = scipy.sparse.tril(M).tocsr()
    xh, bh = x.cpu().numpy(), b.cpu().numpy()
    rhs = bh[order] - scipy.sparse.triu(M, 1) @ xh[order] \
        - A[order][:, rest] @ xh[rest]
    Lt = torch.sparse_csr_tensor(
        torch.as_tensor(L.indptr, dtype=torch.int32, device=device),
        torch.as_tensor(L.indices, dtype=torch.int32, device=device),
        torch.as_tensor(L.data, device=device), size=L.shape)
    R = torch.as_tensor(rhs[:, None], device=device)
    sol = torch.triangular_solve(R, Lt, upper=False).solution[:, 0]
    ref = got[torch.as_tensor(order, device=device)]
    rel = float((sol - ref).abs().max() / ref.abs().max())
    if not rel <= 1e-12:
        raise RuntimeError('triangular_solve yardstick differs from the '
                           'pass by %.3e' % rel)
    return rel, time_ms(lambda: torch.triangular_solve(R, Lt, upper=False),
                        device, reps=10)


def check_wavefront_kernels(device, sizes=((24, 3), (96, 3))):
    """Phase 4j: both wavefront kernels against their plain versions.
    ``wavefront_gs`` (one launch per ``DeviceIndexedGS.apply``) on the
    smoothing sets of levels 1 and 2 of the (24, 3) and (96, 3)
    hierarchies, forward, backward and symmetric, 2 iterations from a
    seeded x and b (1e-13 relative; a second launch bitwise equal), and on
    a set with two zero-diagonal rows, also laid out for less shared
    memory (the local x in global memory; then also levels split), and a
    structurally nonsymmetric set (write after read); its time per pass
    with the level count and rows per level; the kernel's reciprocal
    quotient against the division over every row's numerator of each
    pass (and random ones), bitwise; the library yardstick, one
    ``torch.triangular_solve`` of a pass on a CUDA CSR matrix, checked
    against the kernel's pass.  K6's wavefront mode on the same
    hierarchies: one cycle from a seeded iterate against the plain cycle
    (1e-13, bitwise on a repeat), at (24, 3) the whole solve against the
    host loop over the plain cycle (the same count, x and res2 to 1e-12),
    its ms a cycle, and the steps of a traced cycle."""
    from pyiga_tpu_torch.ops import cuda_mg
    from pyiga_tpu_torch.ops.relax import DeviceIndexedGS
    gs_cases, k6_cases = {}, {}
    for n0, L in sizes:
        t0 = time.perf_counter()
        hs, A, fh, As, lv_inds = localmg_levels(n0, L, device)
        log('  (%d,%d): %d dofs, smoothing sets %s, hierarchy %.1f s'
            % (n0, L, hs.numdofs, [len(s) for s in lv_inds],
               time.perf_counter() - t0))
        rng = np.random.RandomState(n0)
        for lv in range(1, L):
            n = As[lv].shape[0]
            x = torch.as_tensor(rng.rand(n), dtype=torch.float64,
                                device=device)
            b = torch.as_tensor(rng.rand(n), dtype=torch.float64,
                                device=device)
            for sweep in ('forward', 'backward', 'symmetric'):
                t0 = time.perf_counter()
                gs = DeviceIndexedGS(As[lv], lv_inds[lv], sweep=sweep,
                                     iterations=2, device=device)
                t_setup = time.perf_counter() - t0
                sw = gs.sweeps
                name = 'wavefront_gs (%d,%d) L%d %s' % (n0, L, lv, sweep)
                got = cuda_mg.wavefront_gs(sw, 0, 2, x.clone(), b)
                ref = cuda_mg.wavefront_gs_plain(sw, 0, 2, x.clone(), b)
                sync(device)
                err, rel = compare(name, got, ref, 1e-13)
                check_repeat(name, lambda: cuda_mg.wavefront_gs(
                    sw, 0, 2, x.clone(), b), got)
                npass = sw.groups[0]
                xw = x.clone()
                ms_pass = time_ms(lambda: cuda_mg.wavefront_gs(
                    sw, 0, 1, xw, b), device, reps=20) / npass
                ms_launch = time_ms(lambda: cuda_mg.wavefront_gs(
                    sw, 0, 2, xw, b), device, reps=20)
                plain_ms = time_ms(lambda: cuda_mg.wavefront_gs_plain(
                    sw, 0, 2, xw.clone(), b), device, reps=2, warmup=1)
                quot_bad, quot_n = check_quotient(sw, x, b, rng)
                if quot_bad:
                    raise RuntimeError('%s: the reciprocal quotient differs '
                                       'from the division in %d of %d rows'
                                       % (name, quot_bad, quot_n))
                tri_rel = lib_pass = library_ms = None
                if sweep != 'symmetric':
                    one = cuda_mg.wavefront_gs(sw, 0, 1, x.clone(), b)
                    tri_rel, lib_pass = trisolve_yardstick(
                        As[lv], lv_inds[lv], sweep == 'backward', x, b, one,
                        device)
                    library_ms = 2 * lib_pass   # the launch: 2 passes
                levels = [c['nlev'] for c in sw.compact[0]]
                rows_max = [c['pmax'] for c in sw.compact[0]]
                # a row's stale (padded) and fresh widths
                widths = [int((c['lvl'][:, 4] + c['lvl'][:, 7]).max())
                          if c['nlev'] else 0 for c in sw.compact[0]]
                key = '%d_%d_L%d_%s' % (n0, L, lv, sweep)
                gs_cases[key] = dict(
                    max_abs_err=err, rel=rel, repeat_equal=True,
                    ms_per_pass=ms_pass, ms=ms_launch, plain_ms=plain_ms,
                    levels=levels, rows_per_level_max=rows_max,
                    width_max=widths, m=sw.m, nloc=sw.nloc,
                    smem_bytes=sw.smem_bytes, xs_shared=sw.xs_shared,
                    war=[c['war'] for c in sw.compact[0]],
                    fresh=[c['fresh'] for c in sw.compact[0]],
                    entries=[c['entries'] for c in sw.compact[0]],
                    quotient_rows=quot_n, quotient_differ=quot_bad,
                    setup_ms=1e3 * t_setup, library_ms=library_ms,
                    library_ms_per_pass=lib_pass, library_rel=tri_rel,
                    **wavefront_bound(sw, 0, 2))
                r = gs_cases[key]
                log('  %s: m %d, local x %d, levels %s, rows/level <= %s, '
                    'width <= %s; %.4f ms a pass (%.3f us a level), launch '
                    '(2 iterations) %.4f ms, plain %.2f ms, bound %.5f ms, '
                    'triangular_solve %s ms a pass, setup %.0f ms; '
                    'quotient = division on %d rows'
                    % (name, sw.m, sw.nloc, levels, rows_max, widths,
                       ms_pass, 1e3 * ms_pass / max(np.mean(levels), 1),
                       ms_launch, plain_ms, r['bound_ms'],
                       'n/a' if lib_pass is None else '%.4f' % lib_pass,
                       1e3 * t_setup, quot_n))
        # a set whose rows include two zero diagonals (skipped rows)
        Az = As[L - 1].tolil()
        dead = np.asarray(lv_inds[L - 1])[[3, 17]]
        for i in dead:
            Az[i, i] = 0.0
        Az = Az.tocsr()
        gz = DeviceIndexedGS(Az, lv_inds[L - 1], sweep='symmetric',
                             iterations=2, device=device)
        n = Az.shape[0]
        x = torch.as_tensor(rng.rand(n), dtype=torch.float64, device=device)
        b = torch.as_tensor(rng.rand(n), dtype=torch.float64, device=device)
        got = cuda_mg.wavefront_gs(gz.sweeps, 0, 2, x.clone(), b)
        ref = cuda_mg.wavefront_gs_plain(gz.sweeps, 0, 2, x.clone(), b)
        compare('wavefront_gs zero diagonal (%d,%d)' % (n0, L), got, ref,
                1e-13)
        if not torch.equal(got[dead], x[dead]):
            raise RuntimeError('a zero-diagonal row changed')
        check_repeat('wavefront_gs zero diagonal', lambda: cuda_mg.
                     wavefront_gs(gz.sweeps, 0, 2, x.clone(), b), got)
        if (n0, L) == sizes[0]:
            # the layouts for a smaller shared memory: the local x in a
            # global scratch vector, then also the levels split in runs of
            # rows
            full = gz.sweeps
            for layout, frac in (('x global', 4), ('split', 3)):
                saved = cuda_mg.WF_SMEM_BYTES
                cuda_mg.WF_SMEM_BYTES = (full.smem_bytes - 8 * full.nloc) \
                    * frac // 4
                try:
                    gsm = DeviceIndexedGS(Az, lv_inds[L - 1],
                                          sweep='symmetric', iterations=2,
                                          device=device)
                finally:
                    cuda_mg.WF_SMEM_BYTES = saved
                nlev = [c['nlev'] for c in gsm.sweeps.compact[0]]
                split = nlev > [c['nlev'] for c in full.compact[0]]
                if gsm.sweeps.xs_shared or split != (layout == 'split'):
                    raise RuntimeError('the %s layout kept its local x in '
                                       'shared memory or split %s level'
                                       % (layout, 'no' if layout == 'split'
                                          else 'a'))
                got_s = cuda_mg.wavefront_gs(gsm.sweeps, 0, 2, x.clone(), b)
                compare('wavefront_gs %s layout (%d,%d)' % (layout, n0, L),
                        got_s, ref, 1e-13)
                check_repeat('wavefront_gs %s layout' % layout,
                             lambda: cuda_mg.wavefront_gs(
                                 gsm.sweeps, 0, 2, x.clone(), b), got_s)
                log('  %s layout: %d B shared, levels %s (from %s)'
                    % (layout, gsm.sweeps.smem_bytes, nlev,
                       [c['nlev'] for c in full.compact[0]]))
            # a structurally nonsymmetric matrix: rows of a level read
            # what others of it write (write after read), two zero
            # diagonals
            import scipy.sparse
            rs = np.random.RandomState(5)
            Aw = (scipy.sparse.random(400, 400, density=0.03,
                                      random_state=rs)
                  + 10 * scipy.sparse.eye(400)).tolil()
            Sw = rs.permutation(400)[:300]
            for i in Sw[:2]:
                Aw[i, i] = 0.0
            gw = DeviceIndexedGS(Aw.tocsr(), Sw, sweep='symmetric',
                                 iterations=2, device=device)
            if not any(c['war'] for c in gw.sweeps.compact[0]):
                raise RuntimeError('the nonsymmetric set has no write '
                                   'after read')
            xw = torch.as_tensor(rs.rand(400), device=device)
            bw = torch.as_tensor(rs.rand(400), device=device)
            got_w = cuda_mg.wavefront_gs(gw.sweeps, 0, 2, xw.clone(), bw)
            compare('wavefront_gs write after read', got_w,
                    cuda_mg.wavefront_gs_plain(gw.sweeps, 0, 2, xw.clone(),
                                               bw), 1e-13)
            check_repeat('wavefront_gs write after read', lambda: cuda_mg.
                         wavefront_gs(gw.sweeps, 0, 2, xw.clone(), bw),
                         got_w)

        # K6's wavefront mode
        t0 = time.perf_counter()
        s = localmg_solver(hs, A, device, 'wavefront')
        t_setup = time.perf_counter() - t0
        ops = s.ops
        name = '(%d,%d)' % (n0, L)
        x = torch.as_tensor(rng.rand(A.shape[0]), dtype=torch.float64,
                            device=device)
        f = torch.as_tensor(rng.rand(A.shape[0]), dtype=torch.float64,
                            device=device)
        got, ref = cuda_mg.vcycle(ops, x, f), cuda_mg.vcycle_plain(ops, x, f)
        sync(device)
        err, rel = compare('vcycle_wavefront ' + name, got[0], ref[0], 1e-13)
        _, rel2 = compare('res2 wavefront ' + name, got[1].reshape(1),
                          ref[1].reshape(1), 1e-13)
        check_repeat('vcycle_wavefront ' + name,
                     lambda: cuda_mg.vcycle(ops, x, f)[0], got[0])
        fp = torch.as_tensor(fh, dtype=torch.float64, device=device)
        res0 = np.float64(torch.linalg.vector_norm(fp * ops.mask).item())
        xg, itg, _, histg = cuda_mg.vcycle_solve(ops, fp, res0, 1e-8, 100)
        rec = dict(max_abs_err=err, rel=rel, res2_rel=rel2,
                   repeat_equal=True, cycles=itg, n=ops.n,
                   setup_ms=s.setup_ms, setup_total_ms=1e3 * t_setup)
        if (n0, L) == sizes[0]:
            xs, its, _, hists = cuda_mg.vcycle_solve_plain(ops, fp, res0,
                                                           1e-8, 100)
            if itg != its:
                raise RuntimeError('K6 wavefront solve %s took %d cycles, '
                                   'the plain loop %d' % (name, itg, its))
            _, rec['solve_x_rel'] = compare('solve x wavefront ' + name, xg,
                                            xs, 1e-12)
            _, rec['solve_res2_rel'] = compare(
                'solve res2 wavefront ' + name, histg, hists, 1e-12)
        if itg != LOCALMG_ITERS[(n0, L)]:
            raise RuntimeError('K6 wavefront solve %s took %d cycles, '
                               'expected %d' % (name, itg,
                                                LOCALMG_ITERS[(n0, L)]))
        xz = torch.zeros_like(fp)
        solve_ms = time_ms(lambda: cuda_mg.launch_solve(
            ops, xz.zero_(), fp, res0, 1e-8, 100), device, reps=5)
        first, names = cuda_mg.phase_names(ops, first=True), \
            cuda_mg.phase_names(ops)
        trace = torch.zeros(len(first) + len(names) + 1, dtype=torch.int64,
                            device=device)
        cuda_mg.launch_solve(ops, xz.zero_(), fp, res0, 1e-8, 100,
                             trace=trace)
        ts = trace.cpu().numpy()[len(first):]
        steps_us = [(nm, 1e-3 * float(t1 - t0_))
                    for nm, t0_, t1 in zip(names, ts[:-1], ts[1:])]
        blocks, smem = cuda_mg._launch_shape(ops, device)
        rec.update(
            blocks=blocks, smem_bytes=smem, solve_ms=solve_ms,
            ms=solve_ms / itg, cycle2_steps_us=steps_us,
            cycle_ms=time_ms(lambda: cuda_mg.vcycle(ops, x, f), device,
                             reps=5),
            plain_ms=time_ms(lambda: cuda_mg.vcycle_plain(ops, x, f),
                             device, reps=1, warmup=1),
            library_ms=None, **vcycle_bound(ops, x, f))
        rec['library_ms_per_pass'] = {
            k: v['library_ms_per_pass'] for k, v in gs_cases.items()
            if k.startswith('%d_%d_' % (n0, L))
            and v['library_ms_per_pass'] is not None}
        k6_cases['%d_%d' % (n0, L)] = rec
        log('  vcycle_wavefront %s: %d blocks, %d B shared; setup %s ms; '
            'one cycle %.4f ms, solve %.3f ms / %d cycles = %.4f ms a cycle,'
            ' plain %.1f ms a cycle, bound %.4f ms'
            % (name, blocks, smem, {k: round(v, 1) for k, v in
                                     s.setup_ms.items()}, rec['cycle_ms'],
               solve_ms, itg, rec['ms'], rec['plain_ms'], rec['bound_ms']))
        log('  cycle 2 steps (us): %s'
            % ', '.join('%s %.2f' % st for st in steps_us))
        del s, ops, gs, gz
        torch.cuda.empty_cache()
    # the entries of the JSON line: the paths' shapes ((24, 3) level 2
    # forward, as phase 8d applies it; K6 at (96, 3) as phase 8c runs it)
    (n0, L), (n1, L1) = sizes[0], sizes[-1]
    return {'wavefront_gs': dict(gs_cases['%d_%d_L%d_forward'
                                          % (n0, L, L - 1)], cases=gs_cases),
            'vcycle_wavefront': dict(k6_cases['%d_%d' % (n1, L1)],
                                     cases=k6_cases)}


def run_localmg_step_device(device, n0=24, L=3):
    """Phase 8d: ``local_mg_step(relax_backend='device')`` under
    ``iterative_solve`` at (24, 3): one ``DeviceIndexedGS`` per level and
    sweep direction, one ``wavefront_gs`` launch per smoothing
    application; the count must equal the host path's (29)."""
    from pyiga_tpu_torch import _cuda, solvers
    hs, A, f = localmg_problem(n0, L, device)
    Ps = hs.virtual_hierarchy_prolongators()
    lv_inds = hs.indices_to_smooth('cell_supp')
    active = hs.non_dirichlet_dofs()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    step = solvers.local_mg_step(hs, A, f, Ps, lv_inds, 'gs', 2,
                                 relax_backend='device', device=device)
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, it = solvers.iterative_solve(step, A, f, active_dofs=active)
    t_solve = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    step_h = solvers.local_mg_step(hs, A, f, Ps, lv_inds, 'gs', 2,
                                   relax_backend='host')
    xh, it_h = solvers.iterative_solve(step_h, A, f, active_dofs=active)
    x_rel = float(np.abs(x - xh).max() / np.abs(xh).max())
    log('  (%d,%d) local_mg_step device: %d cycles (host %d), setup %.0f '
        'ms, solve %.1f ms (%.2f ms a cycle), x vs host %.3e; launches %s'
        % (n0, L, it, it_h, 1e3 * t_setup, 1e3 * t_solve,
           1e3 * t_solve / it, x_rel, launches))
    if not (it == it_h == LOCALMG_ITERS[(n0, L)] and x_rel <= 1e-10):
        raise RuntimeError('local_mg_step device took %s cycles (host %s), '
                           'x vs host %.3e' % (it, it_h, x_rel))
    # per cycle a pre- and a post-smoothing application on each of the
    # L - 1 upper levels
    if launches['wavefront_gs'] != 2 * (L - 1) * it:
        raise RuntimeError('wavefront_gs launched %d times for %d cycles'
                           % (launches['wavefront_gs'], it))
    return dict(n0=n0, levels=L, iters=it, iters_host=it_h,
                t_setup_ms=1e3 * t_setup, t_solve_ms=1e3 * t_solve,
                x_rel_host=x_rel, launches=launches)


def run_aca(device, n=48, p=3):
    """Phase 13: ``bench.py`` ``run_aca(..., 3, 48)``: the 3D p=3
    stiffness of the twisted box by ``aca_3d_device(asm, tol=1e-10,
    verbose=0)`` on the card, timed warm as the bench times it (the host
    CSR excluded); pivots and ``entry_frac`` as ``bench.py:745-746``
    computes them; the result against ``run_device()``'s data (1e-9
    relative to its largest entry); the pivot count against the port's
    on the CPU (``ACA_PIVOTS``), the JAX package's printed beside it."""
    from pyiga_tpu_torch import _cuda, bspline, geometry, lowrank
    from pyiga_tpu_torch.compile import compile_vform
    from pyiga_tpu_torch.vform import stiffness_vf
    kvs = 3 * (bspline.make_knots(p, 0.0, 1.0, n),)
    t0 = time.perf_counter()
    asm = compile_vform(stiffness_vf(3))(kvs, geo=geometry.twisted_box(),
                                         device=device)
    t_setup = time.perf_counter() - t0
    S = asm.structure
    shape = tuple(len(bx) for bx in S.bidx)
    total = int(np.prod(shape))
    counts = []
    inflate = lowrank._aca_inflate

    def counting(cols, mats, count, shp):
        counts.append(int(count))
        return inflate(cols, mats, count, shp)
    lowrank._aca_inflate = counting
    torch.cuda.reset_peak_memory_stats(device)
    _cuda.reset_launches()
    try:
        t0 = time.perf_counter()
        X = lowrank.aca_3d_device(asm, tol=1e-10, verbose=0)
        t_cold = time.perf_counter() - t0
        launches = dict(_cuda.LAUNCHES)
        t0 = time.perf_counter()
        X = lowrank.aca_3d_device(asm, tol=1e-10, verbose=0)
        t_warm = time.perf_counter() - t0
    finally:
        lowrank._aca_inflate = inflate
    peak = torch.cuda.max_memory_allocated(device)
    pivots = counts[-1]
    frac = pivots * (S.bidx[0].shape[0] + total // S.bidx[0].shape[0]) \
        / total
    ref = asm.run_device()[(None, None)].cpu().numpy()
    scale = float(np.abs(ref).max())
    rel = float(np.abs(X - ref).max()) / scale
    ndofs = int(np.prod([kv.numdofs for kv in kvs]))
    rec = dict(n=n, p=p, ndofs=ndofs, shape=shape, entries=total,
               t_asm_setup_ms=1e3 * t_setup, t_cold_ms=1e3 * t_cold,
               t_aca_ms=1e3 * t_warm, pivots=pivots, pivots_cold=counts[0],
               pivots_port_cpu=ACA_PIVOTS[n], pivots_jax_cpu=ACA_PIVOTS_JAX[n],
               entry_frac=frac, rel_err=rel,
               peak_device_bytes=int(peak), launches=launches)
    log('  3D p=%d n=%d (%d dofs): compact tensor %s = %d entries; '
        'assembler setup %.0f ms; aca_3d_device cold %.1f ms, warm %.1f '
        'ms; %d pivots (the port on the CPU %d, JAX on the CPU %d), '
        'entry_frac %.4f; rel err vs run_device %.3e; peak %.1f MB'
        % (p, n, ndofs, shape, total, 1e3 * t_setup, 1e3 * t_cold,
           1e3 * t_warm, pivots, ACA_PIVOTS[n], ACA_PIVOTS_JAX[n], frac, rel,
           peak / 2 ** 20))
    log('  launches (cold call): %s' % launches)
    if X.shape != shape or not np.isfinite(X).all():
        raise RuntimeError('ACA result has shape %s or is not finite'
                           % (X.shape,))
    if not (pivots == counts[0] == ACA_PIVOTS[n] and rel <= 1e-9):
        raise RuntimeError('ACA took %d pivots (cold %d, the port on the '
                           'CPU %d), rel err %.3e'
                           % (pivots, counts[0], ACA_PIVOTS[n], rel))
    missing = [k for k in ACA_KERNELS if launches[k] <= 0]
    if missing:
        raise RuntimeError('ACA path never launched %s' % missing)
    return rec


def check_fast_fixtures(device):
    """Phase 13b: ``stiffness_fast`` / ``mass_fast`` on the card (2D: the
    host 2D ACA over slices computed on the card; 3D: ``aca_3d_device``)
    against the golden fixtures at 2D p=3 n=15 (quarter annulus) and 3D
    p=2 n=10 (twisted box), 1e-9 absolute."""
    from pyiga_tpu_torch import assemble, bspline, geometry
    out = {}
    for dim, p, n in ((2, 3, 15), (3, 2, 10)):
        kvs = dim * (bspline.make_knots(p, 0.0, 1.0, n),)
        geo = geometry.bspline_quarter_annulus() if dim == 2 else \
            geometry.twisted_box()
        for kind, fn in (('mass', assemble.mass_fast),
                         ('stiff', assemble.stiffness_fast)):
            t0 = time.perf_counter()
            M = fn(kvs, geo, verbose=0, device=device)
            t = time.perf_counter() - t0
            name = 'poisson_neu_d%d_p%d_n%d_%s' % (dim, p, n, kind)
            ref = read_fixture(name + '.mtx.gz')
            err = float(abs(M - ref).max())
            log('  %s_fast %s: max abs err %.3e (%.0f ms)'
                % (kind, name, err, 1e3 * t))
            if M.shape != ref.shape or not err <= 1e-9:
                raise RuntimeError('%s_fast off the fixture %s by %.3e'
                                   % (kind, name, err))
            out[name] = dict(max_abs_err=err, ms=1e3 * t)
    return out


def polar_annulus():
    """The quarter annulus in polar parametrization as a ``UserFunction``
    (map and analytic Jacobian, ``[..., i, j] = dF_i/dx_j``): a geometry
    the assemblers evaluate on the host."""
    from pyiga_tpu_torch import geometry
    h = 0.5 * np.pi

    def f(x, y):
        return ((1 + x) * np.cos(h * y), (1 + x) * np.sin(h * y))

    def jac(x, y):
        x, y = np.broadcast_arrays(x, y)
        c, s = np.cos(h * y), np.sin(h * y)
        return np.stack([np.stack([c, -h * (1 + x) * s], axis=-1),
                         np.stack([s, h * (1 + x) * c], axis=-1)], axis=-2)
    return geometry.UserFunction(f, [[0, 1], [0, 1]], jac=jac)


def check_mass_kernels(device, n3=48, n2=128):
    """Phase 4g: K1's mass kind against its plain version at the 3D n=48
    twisted-box shapes and the 2D n=128 NURBS quarter-annulus shapes, and
    K1' at the 2D n=128 shape of the polar annulus (its host Jacobian), at
    the 3D n=48 shape (the twisted box's Jacobian, made on the card by
    K1's jac kind) and at ragged shapes, all 1e-13 relative to the
    largest output and each launched twice for bitwise-equal output.
    K1''s ``launch_ms`` and ``device_ms`` time its bare C entry."""
    from pyiga_tpu_torch.assemblers import MassAssembler, StiffnessAssembler
    from pyiga_tpu_torch import _cuda, bspline, geometry
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    from pyiga_tpu_torch.ops import geom

    out = {'mass_fields': {}, 'host_jac_fields': {}}
    kv128 = bspline.make_knots(3, 0.0, 1.0, n2)
    kv48 = bspline.make_knots(3, 0.0, 1.0, n3)
    for name, asm in (
            ('3d_n48_bspline', MassAssembler(3 * (kv48,),
                                             geometry.twisted_box(),
                                             device=device)),
            ('2d_n128_nurbs', MassAssembler(2 * (kv128,),
                                            geometry.quarter_annulus(),
                                            device=device))):
        gi = asm.geo_inputs()
        args, grid = cs._spline_stages(gi)
        got, ref = cs.fields_mass(*args), cs.fields_mass_plain(*args)
        sync(device)
        err, rel = compare('mass ' + name[:10], got, ref, 1e-13)
        check_repeat('mass ' + name[:10], lambda: cs.fields_mass(*args), got)
        Y = args[0]
        d, C, _, nL = Y.shape
        out['mass_fields'][name] = dict(
            max_abs_err=err, rel=rel, shape=list(got.shape),
            out_bytes=got.numel() * 8,
            ms=time_ms(lambda: cs.fields_mass(*args), device),
            plain_ms=time_ms(lambda: cs.fields_mass_plain(*args), device,
                             reps=3),
            library_ms=None,
            **bound(nbytes(*args[:4], got),
                    got.numel() * (2 * C * d * nL + 20), F64_FMA_PER_MS))
        if name.startswith('3d'):
            # the twisted box's Jacobian at the 3D shape, for K1' below
            tables = gi['geo_tables_bsp']
            _, jac3 = cs.geometry_fields(tables, gi['geo_coeffs'], False)
            jac3 = jac3.reshape(3, 3, -1).contiguous()
            w3 = geom.gauss_weight_factors(gi['weights'])
        del asm, gi, args, got, ref

    t0 = time.perf_counter()
    asm = StiffnessAssembler(2 * (kv128,), polar_annulus(), device=device)
    t_host_jac = time.perf_counter() - t0
    gi = asm.geo_inputs()
    jac2, _ = cs._host_jacobian(gi)
    lib = _cuda.library()
    for name, jac, (w12, wL) in (
            ('2d_n128_user', jac2,
             geom.gauss_weight_factors(gi['weights'])),
            ('3d_n48_twisted', jac3, w3)):
        got = cs.host_jac_fields(jac, w12, wL)
        ref = cs.host_jac_fields_plain(jac, w12, wL)
        sync(device)
        err, rel = compare("K1' " + name[:11], got, ref, 1e-13)
        check_repeat("K1' " + name[:11],
                     lambda: cs.host_jac_fields(jac, w12, wL), got)
        d = jac.shape[0]
        out['host_jac_fields'][name] = dict(
            max_abs_err=err, rel=rel, shape=list(got.shape),
            repeat_equal=True, in_bytes=nbytes(jac, w12, wL),
            ms=time_ms(lambda: cs.host_jac_fields(jac, w12, wL), device,
                       reps=50),
            plain_ms=time_ms(lambda: cs.host_jac_fields_plain(jac, w12, wL),
                             device, reps=3),
            library_ms=None,
            # det, adjugate, the unique products: ~60 operations a point
            **bound(nbytes(jac, w12, wL, got), 60 * got.shape[1],
                    F64_FMA_PER_MS))
        out['host_jac_fields'][name].update(bare_times(
            'host_jac_fields', lib.pyiga_host_jac_fields_f64,
            [jac, w12, wL, torch.empty_like(got)],
            lambda ts: tuple(t.data_ptr() for t in ts)
            + (d, w12.numel(), wL.numel()), device))
        del got, ref
    out['host_jac_fields']['2d_n128_user']['host_jacobian_setup_ms'] = \
        1e3 * t_host_jac
    # headline cases: the shapes of the paths that launch each kernel
    # (phase 9's 3D mass path, phase 10b's user geometry at full width)
    res = {k: dict(v['3d_n48_bspline' if k == 'mass_fields'
                     else '2d_n128_user'], cases=v) for k, v in out.items()}
    res['mass_fields'].update(repeat_equal=True,
                              ragged=check_fields_ragged('mass', device))
    res['host_jac_fields']['ragged'] = check_host_jac_ragged(device)
    for k, r in res.items():
        for name, c in r['cases'].items():
            log('  %-16s %-15s kernel %.4f ms   plain %.4f ms   bound %.4f '
                'ms%s' % (k, name, c['ms'], c['plain_ms'], c['bound_ms'],
                          '   bare launch %.4f ms   device %.4f ms'
                          % (c['launch_ms'], c['device_ms'])
                          if 'device_ms' in c else ''))
    return res


# K1' (d, Q12, QL): QL not a multiple of a warp, above one block's 256
# columns, one row; Q12 above and below two blocks an SM
HOST_JAC_RAGGED = ((2, 37, 301), (3, 1003, 45), (2, 5000, 7), (3, 1, 129))


def check_host_jac_ragged(device, seed=9, dtype=torch.float64, tol=1e-13):
    """K1' against its plain version at :data:`HOST_JAC_RAGGED` on seeded
    well-conditioned Jacobians (identity plus 0.2 noise) and weights:
    `tol` (1e-13 in float64) relative to the largest output, each
    launched twice for bitwise-equal output; `dtype` float32 runs the
    float32 instance."""
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    rng = np.random.RandomState(seed)
    out = {}
    for d, Q12, QL in HOST_JAC_RAGGED:
        def dev(a):
            return torch.as_tensor(a, dtype=dtype, device=device)
        jac = dev(np.eye(d)[:, :, None] + 0.2 * rng.rand(d, d, Q12 * QL))
        w12, wL = dev(rng.rand(Q12) + 0.5), dev(rng.rand(QL) + 0.5)
        got = cs.host_jac_fields(jac, w12, wL)
        ref = cs.host_jac_fields_plain(jac, w12, wL)
        sync(device)
        key = '%dD Q12=%d QL=%d' % (d, Q12, QL)
        out[key] = compare("K1' " + key, got, ref, tol)
        check_repeat("K1' " + key, lambda: cs.host_jac_fields(jac, w12, wL),
                     got)
    return out


def read_fixture(name, shape=None):
    import scipy.sparse
    data = np.loadtxt(os.path.join(REPO, 'tests', 'fixtures', name),
                      skiprows=1, ndmin=2)
    ij = data[:, :2].astype(np.intp) - 1
    if shape is None:
        shape = (int(ij[:, 0].max()) + 1, int(ij[:, 1].max()) + 1)
    return scipy.sparse.coo_matrix((data[:, 2], (ij[:, 0], ij[:, 1])),
                                   shape=shape).tocsr()


def heat_system(M, K, kvs):
    """The restricted heat equation ``M_ff u' = f_f - K_ff u`` (u = 0 on
    the boundary, f = 1, so ``f = M 1``), scaled by ``n**2`` (n the spans
    per axis) so that M's entries are O(1): the DIRK stage Newton stops
    at an absolute residual of 1e-4.  Returns ``(M_ff, K_ff, f_f)``."""
    from pyiga_tpu_torch.ops.fastdiag import interior_dofs
    free = interior_dofs(kvs)
    s = float(kvs[0].numspans ** 2)
    Mf = (s * M)[free][:, free].tocsr()
    Kf = (s * K)[free][:, free].tocsr()
    f = s * (M @ np.ones(M.shape[0]))[free]
    return Mf, Kf, f


class CountingScheme:
    """A scheme proxy counting step attempts (accepted and rejected)."""

    def __init__(self, scheme):
        self.scheme, self.attempts = scheme, 0

    def step(self, *args, **kwargs):
        self.attempts += 1
        return self.scheme.step(*args, **kwargs)

    def truncated(self):
        return self.scheme.truncated()


def integrate_host(name, Mf, Kf, f, tol=1e-5, tau0=1e-3, t_end=0.1):
    """Adaptive integration of the heat system by the host scheme of
    `name`; returns ``(times, states, attempts, seconds)``."""
    from pyiga_tpu_torch import solvers
    coeffs = getattr(solvers, 'coeffs_' + name)()
    if name.startswith('ros') or name == 'rodasp':
        scheme, order = solvers._RosenbrockScheme(*coeffs[:4]), coeffs[4]
    else:
        scheme, order = solvers._DIRKScheme(coeffs[0]), coeffs[1]
    scheme = CountingScheme(scheme)
    x0 = np.zeros(Mf.shape[0])
    t0 = time.perf_counter()
    ts, xs = solvers._integrate_adaptive(
        scheme, order, Mf, lambda x: f - Kf @ x, lambda x: -Kf, x0, tau0,
        t_end, tol)
    return ts, xs, scheme.attempts, time.perf_counter() - t0


def check_mass_small(device):
    """Phase 4h: ``assemble.mass`` / ``assemble.stiffness`` on the card
    against the four golden fixtures (1e-14 abs), and the small heat
    problem (2D p=3 n=8 NURBS quarter annulus) assembled on the card and
    on the CPU, integrated by esdirk34 and ros3p: identical step times."""
    from pyiga_tpu_torch import assemble, bspline, geometry
    out = {}
    for kind, fix, geo, p, n, d in (
            ('mass', 'poisson_neu_d2_p3_n15_mass', 'bspline_quarter_annulus',
             3, 15, 2),
            ('stiffness', 'poisson_neu_d2_p3_n15_stiff',
             'bspline_quarter_annulus', 3, 15, 2),
            ('mass', 'poisson_neu_d3_p2_n10_mass', 'twisted_box', 2, 10, 3),
            ('stiffness', 'poisson_neu_d3_p2_n10_stiff', 'twisted_box', 2,
             10, 3)):
        kvs = d * (bspline.make_knots(p, 0.0, 1.0, n),)
        A = getattr(assemble, kind)(kvs, getattr(geometry, geo)(),
                                    device=device)
        err = float(abs(A - read_fixture(fix + '.mtx.gz', A.shape)).max())
        log('  %-30s card vs golden fixture: max abs err %.3e' % (fix, err))
        if not err <= 1e-14:
            raise RuntimeError('card assembly misses fixture %s' % fix)
        out[fix] = err

    kvs = 2 * (bspline.make_knots(3, 0.0, 1.0, 8),)
    systems = {}
    for dev in (device, torch.device('cpu')):
        geo = geometry.quarter_annulus()
        systems[dev.type] = heat_system(
            assemble.mass(kvs, geo, device=dev),
            assemble.stiffness(kvs, geo, device=dev), kvs)
    (Mg, Kg, fg), (Mc, Kc, fc) = systems[device.type], systems['cpu']
    err_M = float(abs(Mg - Mc).max() / abs(Mc).max())
    err_K = float(abs(Kg - Kc).max() / abs(Kc).max())
    out['heat_n8'] = dict(M_rel=err_M, K_rel=err_K)
    for name in ('esdirk34', 'ros3p'):
        tg, xg, ag, _ = integrate_host(name, Mg, Kg, fg)
        tc, xc, ac, _ = integrate_host(name, Mc, Kc, fc)
        dt = (float(np.abs(np.subtract(tg, tc)).max())
              if len(tg) == len(tc) else np.inf)
        dx = float(np.abs(xg[-1] - xc[-1]).max() / np.abs(xc[-1]).max())
        log('  heat n=8 %-8s card vs CPU: M rel %.3e  K rel %.3e  steps '
            '%d/%d (attempts %d/%d)  times max diff %.3e  x rel %.3e'
            % (name, err_M, err_K, len(tg) - 1, len(tc) - 1, ag, ac, dt, dx))
        if not (err_M <= 1e-13 and err_K <= 1e-13 and ag == ac
                and dt <= 1e-12 and dx <= 1e-10):
            raise RuntimeError('card heat problem disagrees with the CPU')
        out['heat_n8'][name] = dict(steps=len(tg) - 1, attempts=ag,
                                    times_max_diff=dt, x_rel=dx)
    return out


def run_mass_path(device, n=48):
    """Phase 9: the 3D mass path, p=3 twisted box: ``MassAssembler.
    assemble_banded()`` (K2 geometry stages, K1 mass, K2, K3; flat
    layout) cold and warm, then the compact ``assemble()`` on the same
    space; the layouts agree on a seeded matvec (1e-13 rel), and ``M 1``
    through K4 equals ``assemble('v * dx')`` (1e-12 rel)."""
    from pyiga_tpu_torch import _cuda, assemble, bspline, geometry
    from pyiga_tpu_torch.assemblers import MassAssembler
    from pyiga_tpu_torch.ops.banded import band_info
    from pyiga_tpu_torch.ops.mlmatvec import MLMatvecOperator

    kvs = 3 * (bspline.make_knots(3, 0.0, 1.0, n),)
    geo = geometry.twisted_box()
    t0 = time.perf_counter()
    asm = MassAssembler(kvs, geo, device=device)
    asm.tables.banded_term_tables(asm.terms, band_info(asm.structure))
    t_host = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(device)
    _cuda.reset_launches()
    times = []
    for _ in range(2):                      # cold, warm
        sync(device)
        t0 = time.perf_counter()
        op = asm.assemble_banded()
        sync(device)
        times.append(time.perf_counter() - t0)
    peak_banded = torch.cuda.max_memory_allocated(device)
    t0 = time.perf_counter()
    data = asm.run_device()
    sync(device)
    t_compact = time.perf_counter() - t0
    t0 = time.perf_counter()
    mlm = asm.assemble()
    t_compact_host = time.perf_counter() - t0
    ones = torch.ones(op.shape[0], dtype=torch.float64, device=device)
    m1 = op(ones)
    sync(device)
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device)
    missing = [k for k in MASS_KERNELS if launches[k] <= 0]
    if missing:
        raise RuntimeError('mass path never launched %s' % missing)

    x = torch.as_tensor(np.random.RandomState(9).rand(op.shape[0]),
                        dtype=torch.float64, device=device)
    y_b = op(x)
    y_c = MLMatvecOperator(data, asm.structure)(x)
    rel_layout = float((y_b - y_c).abs().max() / y_c.abs().max())
    v = torch.as_tensor(assemble.assemble('v * dx', kvs, geo=geo,
                                          device=device).ravel(),
                        dtype=torch.float64, device=device)
    rel_pu = float((m1 - v).abs().max() / v.abs().max())
    vol = float(m1.sum())
    rec = dict(n=n, p=3, ndofs=op.shape[0], D_bytes=op.D.numel() * 8,
               compact_bytes=data.numel() * 8, t_host_setup_ms=1e3 * t_host,
               t_banded_cold_ms=1e3 * times[0],
               t_banded_warm_ms=1e3 * times[1],
               t_compact_run_device_ms=1e3 * t_compact,
               t_compact_assemble_ms=1e3 * t_compact_host,
               layout_rel=rel_layout, m1_vs_vdx_rel=rel_pu, volume=vol,
               peak_banded_bytes=int(peak_banded), peak_bytes=int(peak),
               launches=launches, mlmatrix_nnz_blocks=list(mlm.data.shape))
    log('  3D p=3 n=%d: %d dofs, D %.0f MB, compact %.0f MB; host setup '
        '%.0f ms' % (n, rec['ndofs'], rec['D_bytes'] / 1e6,
                     rec['compact_bytes'] / 1e6, rec['t_host_setup_ms']))
    log('  assemble_banded cold %.2f ms  warm %.2f ms  run_device (compact) '
        '%.2f ms  assemble() with host copy %.1f ms'
        % (rec['t_banded_cold_ms'], rec['t_banded_warm_ms'],
           rec['t_compact_run_device_ms'], rec['t_compact_assemble_ms']))
    log('  banded vs compact matvec rel %.3e  M 1 vs v*dx rel %.3e  volume '
        '%.12f  peak %.0f MB (banded alone %.0f MB)'
        % (rel_layout, rel_pu, vol, peak / 2 ** 20, peak_banded / 2 ** 20))
    log('  launches: %s' % launches)
    if not (rel_layout <= 1e-13 and rel_pu <= 1e-12
            and bool(torch.isfinite(m1).all())):
        raise RuntimeError('mass layouts or partition of unity disagree')
    return rec


def run_heat_host(device, n=128):
    """Phase 10: the heat equation on the 2D p=3 NURBS quarter annulus,
    M and K assembled on the card through the compact path and held to
    the CPU assembly (1e-13), then integrated by the host esdirk34 (to
    t = 3e-4 from tau0 = 2e-4, see ``HEAT_T_END``) and ros3p (to t = 0.1
    from tau0 = 1e-3), both adaptive with tol 1e-5."""
    from pyiga_tpu_torch import _cuda, assemble, bspline, geometry
    kvs = 2 * (bspline.make_knots(3, 0.0, 1.0, n),)
    geo = geometry.quarter_annulus()
    _cuda.reset_launches()
    sync(device)
    t0 = time.perf_counter()
    M = assemble.mass(kvs, geo, device=device)
    K = assemble.stiffness(kvs, geo, device=device)
    sync(device)
    t_first = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    missing = [k for k in HEAT_KERNELS if launches[k] <= 0]
    if missing:
        raise RuntimeError('heat path never launched %s' % missing)
    t0 = time.perf_counter()
    M = assemble.mass(kvs, geo, device=device)
    K = assemble.stiffness(kvs, geo, device=device)
    t_warm = time.perf_counter() - t0
    from pyiga_tpu_torch.assemblers import MassAssembler, StiffnessAssembler
    t_dev = {}
    for name, cls in (('mass', MassAssembler),
                      ('stiffness', StiffnessAssembler)):
        asm = cls(kvs, geo, device=device)
        t_dev[name] = time_ms(asm.run_device, device, reps=5)
    Mc = assemble.mass(kvs, geo)
    Kc = assemble.stiffness(kvs, geo)
    err_M = float(abs(M - Mc).max() / abs(Mc).max())
    err_K = float(abs(K - Kc).max() / abs(Kc).max())
    Mf, Kf, f = heat_system(M, K, kvs)
    rec = dict(n=n, p=3, ndofs=M.shape[0], n_free=Mf.shape[0],
               t_assembly_first_ms=1e3 * t_first,
               t_assembly_csr_ms=1e3 * t_warm,
               t_run_device_ms=t_dev, M_rel_cpu=err_M, K_rel_cpu=err_K,
               launches=launches)
    log('  2D p=3 n=%d: %d dofs (%d free); M+K to CSR first %.0f ms, warm '
        '%.0f ms; run_device mass %.2f ms stiffness %.2f ms; vs CPU M %.3e '
        'K %.3e' % (n, rec['ndofs'], rec['n_free'], 1e3 * t_first,
                    1e3 * t_warm, t_dev['mass'], t_dev['stiffness'], err_M,
                    err_K))
    log('  launches: %s' % launches)
    if not (err_M <= 1e-13 and err_K <= 1e-13):
        raise RuntimeError('card heat matrices disagree with the CPU')
    import scipy.sparse.linalg
    t0 = time.perf_counter()
    scipy.sparse.linalg.splu((Mf + 1e-3 * Kf).tocsc(), permc_spec='COLAMD')
    rec['t_one_lu_s'] = time.perf_counter() - t0
    for name, t_end in HEAT_T_END.items():
        ts, xs, att, secs = integrate_host(name, Mf, Kf, f,
                                           tau0=HEAT_TAU0[name], t_end=t_end)
        acc = len(ts) - 1
        rec[name] = dict(t_end=t_end, tau0=HEAT_TAU0[name], accepted=acc,
                         rejected=att - acc,
                         seconds=secs, t_final=ts[-1],
                         x_max=float(np.abs(xs[-1]).max()))
        log('  %-8s to t_end %g: %d accepted, %d rejected, t %.6f, max u '
            '%.6f, host %.2f s (one LU %.3f s)'
            % (name, t_end, acc, att - acc, ts[-1], rec[name]['x_max'], secs,
               rec['t_one_lu_s']))
        if not (np.all(np.isfinite(xs[-1])) and ts[-1] >= t_end
                and 0 < rec[name]['x_max'] < 1):
            raise RuntimeError('heat integration by %s failed' % name)
    return rec


def run_heat_device(device, n=60, n_full=128):
    """Phase 10b: the heat equation on the polar quarter annulus given as
    a ``UserFunction`` (K through K1', M through the plain host-Jacobian
    mass), integrated by ``DeviceRosenbrockScheme`` (ros3p, tol 1e-5;
    and rodasp, tol 1e-7, whose sequence has a rejected step) against
    the host ``_RosenbrockScheme`` on the same matrices; then K and M at
    n=128 on the card held to the CPU (1e-13)."""
    from pyiga_tpu_torch import _cuda, assemble, bspline, solvers
    from pyiga_tpu_torch.ops.rosw import DeviceRosenbrockScheme
    kvs = 2 * (bspline.make_knots(3, 0.0, 1.0, n),)
    geo = polar_annulus()
    _cuda.reset_launches()
    sync(device)
    t0 = time.perf_counter()
    M = assemble.mass(kvs, geo, device=device)
    K = assemble.stiffness(kvs, geo, device=device)
    sync(device)
    t_asm = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    missing = [k for k in USERGEO_KERNELS if launches[k] <= 0]
    if missing:
        raise RuntimeError('user-geometry path never launched %s' % missing)
    Mf, Kf, f = heat_system(M, K, kvs)
    rec = dict(n=n, p=3, ndofs=M.shape[0], n_free=Mf.shape[0],
               t_assembly_ms=1e3 * t_asm, launches=launches)
    log('  2D p=3 n=%d polar UserFunction: %d dofs (%d free); M+K %.0f ms'
        % (n, rec['ndofs'], rec['n_free'], 1e3 * t_asm))
    log('  launches: %s' % launches)
    ops = {'K': torch.as_tensor(Kf.toarray(), device=device),
           'f': torch.as_tensor(f, device=device)}
    rec['host_fallbacks'] = 0
    for name, tol in (('ros3p', 1e-5), ('rodasp', 1e-7)):
        ts_h, xs_h, att_h, secs_h = integrate_host(name, Mf, Kf, f, tol=tol)
        A, G, b, bh, order = getattr(solvers, 'coeffs_' + name)()
        scheme = DeviceRosenbrockScheme(
            (A, G, b, bh), lambda x, o: o['f'] - o['K'] @ x,
            lambda x, o: -o['K'], Mf.toarray(), ops,
            host_scheme=solvers._RosenbrockScheme(A, G, b, bh),
            device=device)
        sync(device)
        t0 = time.perf_counter()
        ts, xs = scheme.integrate_adaptive(
            (Mf, lambda x: f - Kf @ x, lambda x: -Kf), np.zeros(len(f)),
            1e-3, 0.1, tol, order)
        secs = time.perf_counter() - t0
        rec['host_fallbacks'] += scheme.host_fallbacks
        same = len(ts) == len(ts_h) and scheme.n_attempts == att_h
        dt = (float(np.abs(np.subtract(ts, ts_h)).max()) if same
              else np.inf)
        dx = float(np.abs(xs[-1] - xs_h[-1]).max()
                   / np.abs(xs_h[-1]).max())
        acc = len(ts) - 1
        rec[name] = dict(tol=tol, accepted=acc, rejected=scheme.n_attempts
                         - acc, host_accepted=len(ts_h) - 1,
                         host_rejected=att_h - len(ts_h) + 1,
                         times_max_diff=dt, x_rel=dx, device_s=secs,
                         host_s=secs_h,
                         ms_per_attempt_device=1e3 * secs / scheme.n_attempts,
                         ms_per_attempt_host=1e3 * secs_h / att_h,
                         host_reads=scheme.n_host_reads)
        log('  %-6s tol %.0e: device %d accepted / %d rejected, host %d / %d'
            '; times max diff %.3e  x rel %.3e; %.2f ms per step attempt on '
            'the card, %.2f ms on the host'
            % (name, tol, acc, rec[name]['rejected'],
               rec[name]['host_accepted'], rec[name]['host_rejected'], dt, dx,
               rec[name]['ms_per_attempt_device'],
               rec[name]['ms_per_attempt_host']))
        # ros3p to 1e-12; rodasp's 25 attempts compound the stage
        # solves' 1e-11 residual into tau, so its times are held to 1e-10
        if not (same and dt <= (1e-12 if name == 'ros3p' else 1e-10)
                and dx <= 1e-9):
            raise RuntimeError('device Rosenbrock (%s) left the host step '
                               'sequence' % name)
    log('  host fallbacks: %d' % rec['host_fallbacks'])
    if rec['host_fallbacks'] != 0:
        raise RuntimeError('device Rosenbrock fell back to the host')

    kvs = 2 * (bspline.make_knots(3, 0.0, 1.0, n_full),)
    errs = {}
    for kind in ('mass', 'stiffness'):
        A = getattr(assemble, kind)(kvs, geo, device=device)
        Ac = getattr(assemble, kind)(kvs, geo)
        errs[kind] = float(abs(A - Ac).max() / abs(Ac).max())
    rec['n128_rel_cpu'] = errs
    log('  n=%d card vs CPU: M %.3e  K %.3e' % (n_full, errs['mass'],
                                                errs['stiffness']))
    if not max(errs.values()) <= 1e-13:
        raise RuntimeError('card user-geometry matrices disagree with CPU')
    return rec


def check_tail_kernels(device, n=48, seed=4):
    """Phase 4i: K7's transposed stage and tail kernel against their plain
    versions at the n=48 flat-banded shapes of ``assemble_banded`` (real
    banded tables, the direct terms' first tables halved, stage-2 and
    final tables shared by identity as the route shares them; seeded
    fields and stage-1 outputs) and at the ragged shapes above, 1e-13
    relative to the largest entry, each launched twice (bitwise-equal).
    Yardsticks: one ``torch.matmul`` for ``stage_T``, one
    ``torch.einsum`` over the stacked per-term operands for
    ``tail_fused``.  The tail's bound counts the final stage once per
    distinct final table: the terms that share one are summed before it
    (what the kernel does, and the least work for the function)."""
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    from pyiga_tpu_torch.ops.banded import band_info

    rng = np.random.RandomState(seed)
    f64 = torch.float64

    def rand(*shape):
        return torch.as_tensor(rng.rand(*shape), dtype=f64, device=device)

    asm = main_path_setup(3, n, device)
    plan = asm._fold()
    btabs = asm.tables.banded_term_tables(asm.terms, band_info(asm.structure))
    uploaded = {}

    def dev(a):
        if id(a) not in uploaded:
            uploaded[id(a)] = (a, torch.as_tensor(a, dtype=f64,
                                                  device=device))
        return uploaded[id(a)][1]
    tabs = [[dev(btabs[t][0] if m else 0.5 * btabs[t][0])]
            + [dev(T) for T in btabs[t][1:]] for t, m in plan]
    M, K = tabs[0][0].shape
    out = {}

    X = rand(K, K * K)
    T = tabs[0][0]
    got, ref = cs.stage_T(X, T), cs.stage_T_plain(X, T)
    sync(device)
    err, rel = compare('stage_T', got, ref, 1e-13)
    check_repeat('stage_T', lambda: cs.stage_T(X, T), got)
    out['stage_T'] = dict(
        max_abs_err=err, rel=rel, shape=[K, K * K, M], repeat_equal=True,
        ms=time_ms(lambda: cs.stage_T(X, T), device),
        plain_ms=time_ms(lambda: cs.stage_T_plain(X, T), device),
        library_ms=time_ms(lambda: torch.matmul(T, X), device),
        **bound(nbytes(X, T, got), 2 * K * K * K * M, F64_TENSOR_PER_MS))
    del X, got, ref
    out['stage_T']['ragged'] = {}
    for Kr, Rr, Mr in STAGE_T_RAGGED:
        X, T = rand(Kr, Rr), rand(Mr, Kr)
        got, ref = cs.stage_T(X, T), cs.stage_T_plain(X, T)
        sync(device)
        key = '%dx%dx%d' % (Kr, Rr, Mr)
        out['stage_T']['ragged'][key] = compare('stage_T ' + key, got, ref,
                                                1e-13)
        check_repeat('stage_T ' + key, lambda: cs.stage_T(X, T), got)

    x1T = [rand(M, K, K) for _ in plan]
    tc2, idx2 = cs._dedup([t[1] for t in tabs])
    tc3, idx3 = cs._dedup([t[2] for t in tabs])
    args = (x1T, tc2, tc3, idx2, idx3)
    got, ref = cs.tail_fused(*args), cs.tail_fused_plain(*args)
    sync(device)
    err, rel = compare('tail_fused', got, ref, 1e-13)
    check_repeat('tail_fused', lambda: cs.tail_fused(*args), got)
    M2, M3 = tc2[0].shape[0], tc3[0].shape[0]
    flops = (len(x1T) * 2 * M * K * K * M2
             + len(set(idx3)) * 2 * M * M2 * K * M3)
    rec = dict(max_abs_err=err, rel=rel, shape=[len(x1T), M, K, K, M2, M3],
               tables=[len(tc2), len(tc3)], repeat_equal=True,
               ms=time_ms(lambda: cs.tail_fused(*args), device, reps=5),
               plain_ms=time_ms(lambda: cs.tail_fused_plain(*args), device,
                                reps=5),
               **bound(nbytes(*x1T, *tc2, *tc3, got), flops,
                       F64_TENSOR_PER_MS))
    X6 = torch.stack(x1T)
    T2 = torch.stack([tc2[i] for i in idx2])
    T3 = torch.stack([tc3[i] for i in idx3])
    del got, ref
    rec['library_ms'] = time_ms(
        lambda: torch.einsum('tajk,tbj,tck->abc', X6, T2, T3), device,
        reps=3, warmup=1)
    out['tail_fused'] = rec
    del X6, T2, T3, x1T, args
    rec['ragged'] = {}
    for M1, K2, K3, M2, M3, nt, n2, n3 in TAIL_RAGGED:
        xs = [rand(M1, K2, K3) for _ in range(nt)]
        t2 = [rand(M2, K2) for _ in range(n2)]
        t3 = [rand(M3, K3) for _ in range(n3)]
        a = (xs, t2, t3, [t % n2 for t in range(nt)],
             [(t * 7 // 3) % n3 for t in range(nt)])
        got, ref = cs.tail_fused(*a), cs.tail_fused_plain(*a)
        sync(device)
        key = '%dx%dx%dx%dx%d,%d terms' % (M1, K2, K3, M2, M3, nt)
        rec['ragged'][key] = compare('tail ' + key, got, ref, 1e-13)
        check_repeat('tail ' + key, lambda: cs.tail_fused(*a), got)
    for name, r in out.items():
        log('  %-16s kernel %.4f ms   plain %.4f ms   library %.4f ms   '
            'bound %.4f ms (%s)' % (name, r['ms'], r['plain_ms'],
                                    r['library_ms'], r['bound_ms'],
                                    r['bound_by']))
    return out


def run_tail_fused_path(device, n=48):
    """Phase 11: the headline ``assemble_banded()`` with the fused tail
    (``cuda_sumfac.TAIL_FUSED``) on, then off, in one process: each route
    cold, then five warm calls of each in turns (fused, two-call,
    two-call, fused, ...; host clock after a synchronize, min and median
    reported): D agrees to 1e-13 relative, the fused run launches
    ``stage_T`` six times, ``tail_fused`` once and ``fold`` never, and
    ``cg_ir`` on the fused operator takes the headline's 25 inner
    iterations [7, 9, 9].  The switch is restored afterwards."""
    from pyiga_tpu_torch import _cuda
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    asm = main_path_setup(3, n, device)
    saved = cs.TAIL_FUSED
    ops, times, launches = {}, {'fused': [], 'two_call': []}, {}

    def run(on, count):
        cs.TAIL_FUSED = on
        key = 'fused' if on else 'two_call'
        if count:
            _cuda.reset_launches()
        sync(device)
        t0 = time.perf_counter()
        ops[key] = asm.assemble_banded()
        sync(device)
        times[key].append(1e3 * (time.perf_counter() - t0))
        if count:
            launches[key] = dict(_cuda.LAUNCHES)

    try:
        for on in (True, False):            # cold
            run(on, True)
        for rep in range(5):                # warm, in turns
            for on in ((True, False) if rep % 2 == 0 else (False, True)):
                run(on, False)
    finally:
        cs.TAIL_FUSED = saved
    Df, D2 = ops['fused'].D, ops['two_call'].D
    rel = float((Df - D2).abs().max() / D2.abs().max())
    lf = launches['fused']
    warm = {k: (min(v[1:]), float(np.median(v[1:]))) for k, v in times.items()}
    log('  assemble_banded fused cold %.2f ms warm min %.2f median %.2f ms; '
        'two-call cold %.2f ms warm min %.2f median %.2f ms; D rel %.3e'
        % (times['fused'][0], *warm['fused'], times['two_call'][0],
           *warm['two_call'], rel))
    log('  launches (fused): %s' % lf)
    if not rel <= 1e-13:
        raise RuntimeError('fused D differs from the two-call D: %.3e' % rel)
    if not (lf['stage_T'] == 6 and lf['tail_fused'] == 1
            and lf['fold'] == 0):
        raise RuntimeError('fused assembly launched stage_T %d, tail_fused '
                           '%d, fold %d (expected 6, 1, 0)'
                           % (lf['stage_T'], lf['tail_fused'], lf['fold']))
    _cuda.reset_launches()
    x, info, res, t_setup, t_solve = solve_case(asm, ops['fused'], device)
    solve_launches = dict(_cuda.LAUNCHES)
    log('  cg_ir on the fused operator: inner_iters %s  sum %d  rel residual '
        '%.3e  solve %.2f ms' % (info['inner_iters'], sum(info['inner_iters']),
                                 res, 1e3 * t_solve))
    if info['inner_iters'] != [7, 9, 9] or not res <= 1e-8:
        raise RuntimeError('fused operator solves in %s, residual %.3e'
                           % (info['inner_iters'], res))
    path = {k: lf[k] + solve_launches[k] for k in lf}
    missing = [k for k in TAILFUSED_KERNELS if path[k] <= 0]
    if missing:
        raise RuntimeError('fused headline never launched %s' % missing)
    return dict(n=n, D_rel=rel, t_fused_ms=times['fused'],
                t_two_call_ms=times['two_call'],
                t_warm_min_median_ms=warm, launches_fused=lf,
                launches_two_call=launches['two_call'],
                launches_path=path, inner_iters=info['inner_iters'],
                residual=res, t_solve_ms=1e3 * t_solve)


def dirichlet_path(n, device):
    """The 3D Dirichlet Poisson path (``examples/poisson_3d.py`` with the
    harmonic data `g`) at p=3 on the twisted box: ``StiffnessAssembler.
    assemble()`` (a host MLMatrix), ``compute_dirichlet_bcs``, the lifted
    right-hand side ``b = -(A_mf ext(g_b))_free`` by a full
    ``MatrixFreeOperator``, float64/float32 restricted operators, the
    weighted fastdiag in float32, ``cg_ir`` to 1e-10, then the completed
    solution's L2 error by ``integrate``.  Returns the record and the
    solution on the free dofs (host)."""
    from pyiga_tpu_torch import assemble, bspline, geometry, solvers
    from pyiga_tpu_torch.assemblers import StiffnessAssembler
    from pyiga_tpu_torch.ops.fastdiag import fastdiag_precond_weighted
    from pyiga_tpu_torch.ops.matfree import MatrixFreeOperator
    from pyiga_tpu_torch.ops.mlmatvec import make_ml_matvec

    t = {}
    kvs = 3 * (bspline.make_knots(3, 0.0, 1.0, n),)
    geo = geometry.twisted_box()
    t0 = time.perf_counter()
    asm = StiffnessAssembler(kvs, geo, device=device)
    t['host_setup'] = time.perf_counter() - t0
    sync(device)
    t0 = time.perf_counter()
    A = asm.assemble()
    t['assembly'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bd, vals = assemble.compute_dirichlet_bcs(kvs, geo, ('all', harmonic))
    t['dirichlet_bcs'] = time.perf_counter() - t0
    n_full = A.shape[0]
    free = np.setdiff1d(np.arange(n_full), bd)
    t0 = time.perf_counter()
    A_mf = MatrixFreeOperator(asm)
    ext = torch.zeros(n_full, dtype=torch.float64, device=device)
    ext[torch.as_tensor(bd, device=device)] = torch.as_tensor(vals,
                                                               device=device)
    free_t = torch.as_tensor(free, device=device)
    b = -A_mf(ext)[free_t]
    op_hi = MatrixFreeOperator(asm, free_dofs=free, dtype=torch.float64)
    op_lo = MatrixFreeOperator(asm, free_dofs=free, dtype=torch.float32)
    P = fastdiag_precond_weighted(asm, dirichlet=True, dtype=torch.float32)
    sync(device)
    t['solver_setup'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, info = solvers.cg_ir(op_hi, op_lo, b, tol=1e-10, precond_lo=P)
    sync(device)
    t['solve'] = time.perf_counter() - t0
    res = float(torch.linalg.vector_norm(b - op_hi(x))
                / torch.linalg.vector_norm(b))
    # the matrix-free operator against the assembled one (K7's output)
    xr = torch.as_tensor(np.random.RandomState(12).rand(n_full),
                         dtype=torch.float64, device=device)
    y_mf, y_asm = A_mf(xr), make_ml_matvec(A, device=device)(xr)
    mf_rel = float((y_mf - y_asm).abs().max() / y_asm.abs().max())
    u = np.zeros(n_full)
    u[free], u[bd] = x.cpu().numpy(), vals
    uh = geometry.BSplineFunc(kvs, u.reshape([kv.numdofs for kv in kvs]))
    t0 = time.perf_counter()
    err2 = assemble.integrate(kvs, SquaredError(uh, geo, harmonic), geo=geo)
    t['integrate'] = time.perf_counter() - t0
    norm2 = assemble.integrate(kvs, SquaredError(None, geo, harmonic),
                               geo=geo)
    rec = dict(n=n, p=3, ndofs=n_full, n_free=len(free),
               n_dirichlet=len(bd), outer=info['outer'],
               inner_iters=info['inner_iters'],
               iters=sum(info['inner_iters']), residual=res,
               residual_cg_ir=info['residual'],
               rel_l2_error=float(np.sqrt(err2 / norm2)),
               mf_vs_assembled_rel=mf_rel,
               **{'t_%s_ms' % k: 1e3 * v for k, v in t.items()})
    return rec, x.cpu()


def run_dirichlet_path(device, n=48):
    """Phase 12: the Dirichlet path at n=48 with the fused tail on, cold
    and warm; residual <= 1e-10 and relative L2 error <= 1e-7 (the
    discrete solution is the interpolant of the harmonic data, so the
    error is the solver's), the assembled (K7) and the matrix-free
    operators agree to 1e-12."""
    from pyiga_tpu_torch import _cuda
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    saved = cs.TAIL_FUSED
    cs.TAIL_FUSED = True
    try:
        torch.cuda.reset_peak_memory_stats(device)
        _cuda.reset_launches()
        cold, _ = dirichlet_path(n, device)
        cold['launches'] = dict(_cuda.LAUNCHES)
        cold['peak_device_bytes'] = int(torch.cuda.max_memory_allocated(
            device))
        warm, _ = dirichlet_path(n, device)
    finally:
        cs.TAIL_FUSED = saved
    for name, r in (('cold', cold), ('warm', warm)):
        log('  %s: %d dofs (%d free); assemble() %.1f ms  bcs %.1f ms  '
            'solver setup %.1f ms  solve %.1f ms  integrate %.1f ms'
            % (name, r['ndofs'], r['n_free'], r['t_assembly_ms'],
               r['t_dirichlet_bcs_ms'], r['t_solver_setup_ms'],
               r['t_solve_ms'], r['t_integrate_ms']))
        log('    outer %d  inner_iters %s  rel residual %.3e  rel L2 error '
            '%.3e  matrix-free vs assembled %.3e'
            % (r['outer'], r['inner_iters'], r['residual'],
               r['rel_l2_error'], r['mf_vs_assembled_rel']))
    log('  peak %.0f MB  launches: %s' % (cold['peak_device_bytes'] / 2 ** 20,
                                         cold['launches']))
    for r in (cold, warm):
        if not (r['residual'] <= 1e-10 and r['rel_l2_error'] <= 1e-7
                and r['mf_vs_assembled_rel'] <= 1e-12):
            raise RuntimeError('Dirichlet path: residual %.3e, L2 error '
                               '%.3e, operators %.3e'
                               % (r['residual'], r['rel_l2_error'],
                                  r['mf_vs_assembled_rel']))
    missing = [k for k in DIRICHLET_KERNELS if cold['launches'][k] <= 0]
    if missing:
        raise RuntimeError('Dirichlet path never launched %s' % missing)
    cold['warm'] = warm
    return cold


def check_dirichlet_small(device, n=8):
    """Phase 12b: the Dirichlet path at n=8 with the fused tail on, card
    against CPU: identical ``cg_ir`` counts, solutions to 1e-10."""
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    saved = cs.TAIL_FUSED
    cs.TAIL_FUSED = True
    try:
        rg, xg = dirichlet_path(n, device)
        rc, xc = dirichlet_path(n, torch.device('cpu'))
    finally:
        cs.TAIL_FUSED = saved
    err_x = float((xg - xc).abs().max() / xc.abs().max())
    log('  n=%d card vs CPU: inner_iters %s vs %s  x rel %.3e  L2 error '
        '%.3e / %.3e' % (n, rg['inner_iters'], rc['inner_iters'], err_x,
                         rg['rel_l2_error'], rc['rel_l2_error']))
    if rg['inner_iters'] != rc['inner_iters'] or not err_x <= 1e-10:
        raise RuntimeError('card Dirichlet path disagrees with the CPU run')
    return dict(dirichlet_n8_card=rg, dirichlet_n8_cpu=rc,
                dirichlet_n8_x_rel=err_x)


################################################################################
# Vector-valued forms and the Navier-Stokes path (phases 4k, 14, 15, 16)
################################################################################

def load_example(name):
    """A port-side example script (``examples/<name>.py``) as a module."""
    import importlib.util as ilu
    path = os.path.join(REPO, 'examples', name + '.py')
    spec = ilu.spec_from_file_location(name, path)
    mod = ilu.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ns_forms(ns, device):
    """The path's VForm assemblers with the device inputs a stepper gives
    them at the state `ns`'s Stokes solution plus a seeded perturbation:
    the two convection assemblers (``input:vel``, and ``ideriv:vel:1``
    for the nonlinear one, formed on the card), the vector Laplacian and
    the two-space divergence block."""
    from pyiga_tpu_torch import assemble
    F_fn, J_fn, ops = ns._traceable_ops()
    x0 = ns.initial_state()
    x = x0 + 0.01 * np.random.RandomState(0).rand(len(x0))
    u_p = torch.as_tensor(ns.LS.complete(x), device=device)
    vals, ders = ns.velocity_fields(u_p, ops)
    geo = {'geo': ns.geo}
    return {
        'nlconv': (ns.asm_nlconv.asm, {'input:vel': vals,
                                       'ideriv:vel:1': ders}),
        'linconv': (ns.asm_linconv.asm, {'input:vel': vals}),
        'veclap': (assemble.instantiate_assembler(
            'inner(grad(u), grad(v)) * dx', ns.kvs_u, geo,
            [('u', 2), ('v', 2)], device=device), None),
        'div_q': (assemble.instantiate_assembler(
            'div(u) * q * dx', (ns.kvs_u, ns.kvs_p), geo,
            [('u', 2, 0), ('q', 1, 1)], device=device), None),
    }, (F_fn, J_fn, ops, torch.as_tensor(x, device=device))


def chain_case(asm, inputs, device, name):
    """K2 and K3 on a form's chains as ``run_device`` runs them: per
    component block (per group, direct or mirrored, of a folded form) its
    terms' stages but the last (K2) and one fold (K3) over their last
    tables, each against its plain version (1e-13 relative, bitwise on a
    repeat); times summed over the blocks of one evaluation, with the
    plain versions' and one ``torch.matmul`` per call as the yardstick,
    and the bound of the same work."""
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    from pyiga_tpu_torch.ops import cuda_vform as cv
    ops = asm._device_operands()
    fields = cv.combo_fields(asm, asm.device_arrays(inputs), asm.combos)
    if asm._fold_plan is None:
        plans = asm._block_plans()
    else:
        plans = {m: [(t, mm) for t, mm in asm._fold_plan if mm == m]
                 for m in (False, True)}
    stages, folds = [], []
    for key, plan in sorted(plans.items(), key=str):
        if not plan:
            continue
        xs, tabs, slot = [], [], {}
        for t, _m in plan:
            X = fields[t]
            for T in ops['term_tables'][t][:-1]:
                stages.append((X.reshape(X.shape[0], -1), T))
                X = cs._run_stage(X, T)
            xs.append(X.reshape(X.shape[0], -1))
            i = ops['last_idx'][t]
            if i not in slot:
                slot[i] = len(tabs)
                tabs.append(ops['term_tables'][t][-1])
        folds.append((xs, tabs, [slot[ops['last_idx'][t]] for t, _m in plan]))
    sync(device)
    rec = {}
    err = rel = 0.0
    for X, T in stages:
        got, ref = cs.stage(X, T), cs.stage_plain(X, T)
        sync(device)
        e, r = compare('stage %s %dx%dx%d' % (name, X.shape[0], X.shape[1],
                                             T.shape[0]), got, ref, 1e-13)
        check_repeat('stage ' + name, lambda: cs.stage(X, T), got)
        err, rel = max(err, e), max(rel, r)
    K, R = stages[0][0].shape
    M = stages[0][1].shape[0]
    rec['stage'] = dict(
        max_abs_err=err, rel=rel, repeat_equal=True, launches=len(stages),
        shape=[K, R, M],
        ms=sum(time_ms(lambda: cs.stage(X, T), device, reps=50)
               for X, T in stages),
        plain_ms=sum(time_ms(lambda: cs.stage_plain(X, T), device, reps=50)
                     for X, T in stages),
        library_ms=sum(time_ms(lambda: torch.matmul(X.t(), T.t()), device,
                               reps=50) for X, T in stages),
        **bound(sum(nbytes(X, T) + 8 * X.shape[1] * T.shape[0]
                    for X, T in stages),
                sum(2 * X.numel() * T.shape[0] for X, T in stages),
                F64_TENSOR_PER_MS))
    err = rel = 0.0
    for xs, tabs, idx in folds:
        got, ref = cs.fold(xs, tabs, idx), cs.fold_plain(xs, tabs, idx)
        sync(device)
        e, r = compare('fold %s %d terms' % (name, len(xs)), got, ref, 1e-13)
        check_repeat('fold ' + name, lambda: cs.fold(xs, tabs, idx), got)
        err, rel = max(err, e), max(rel, r)
    xs, tabs, _ = folds[0]
    cat = [(torch.cat(xs, dim=0).t(), torch.cat([tabs[i] for i in idx],
                                                 dim=1).t())
           for xs, tabs, idx in folds]
    rec['fold'] = dict(
        max_abs_err=err, rel=rel, repeat_equal=True, launches=len(folds),
        shape=[xs[0].shape[0], xs[0].shape[1], tabs[0].shape[0]],
        terms=[len(f[0]) for f in folds],
        ms=sum(time_ms(lambda: cs.fold(*f), device, reps=50) for f in folds),
        plain_ms=sum(time_ms(lambda: cs.fold_plain(*f), device, reps=50)
                     for f in folds),
        library_ms=sum(time_ms(lambda: torch.matmul(a, b), device, reps=50)
                       for a, b in cat),
        **bound(sum(nbytes(*f[0], *f[1]) + 8 * f[0][0].shape[1]
                    * f[1][0].shape[0] for f in folds),
                sum(2 * f[0][0].numel() * f[1][0].shape[0] * len(f[1])
                    for f in folds), F64_TENSOR_PER_MS))
    return rec


# two-space (velocity p=2, pressure p=1) pair tables at sizes whose pair
# counts are no multiple of the DMMA tiles, and the tile edges' neighbours
NS_RAGGED = ((5, 8), (7, 13), (15, 31), (33, 70))


def check_two_space_ragged(device, seed=12):
    """K2 and K3 on the (p=2 trial, p=1 test) pair tables of the channel
    at :data:`NS_RAGGED` (``M != K``, odd counts), seeded fields, 1e-13
    relative and bitwise on a repeat."""
    from pyiga_tpu_torch import bspline
    from pyiga_tpu_torch.mlmatrix import MLStructure
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    from pyiga_tpu_torch.ops.sumfac import SpaceTables, quadrature_for
    rng = np.random.RandomState(seed)
    out = {}
    for n_el in NS_RAGGED:
        ku = tuple(bspline.make_knots(2, 0.0, 1.0, n) for n in n_el)
        kp = tuple(bspline.make_knots(1, 0.0, 1.0, n) for n in n_el)
        grid, _ = quadrature_for(ku, 3)
        S = MLStructure.from_kvs(ku, kp)
        st = SpaceTables(ku, kp, grid, S.bidx, 1)
        T = [[torch.as_tensor(st.pair_table(k, du, 0), device=device)
              for du in (0, 1)] for k in range(2)]
        Q0, Q1 = (len(g) for g in grid)
        X = torch.as_tensor(rng.rand(Q0, Q1), device=device)
        got = cs.stage(X, T[0][1])
        key = '%dx%d' % n_el
        out[key] = dict(M=[int(t.shape[0]) for t in T[0] + T[1]],
                        Q=[Q0, Q1])
        out[key]['stage'] = compare('stage 2-space ' + key, got,
                                    cs.stage_plain(X, T[0][1]), 1e-13)
        check_repeat('stage 2-space ' + key,
                     lambda: cs.stage(X, T[0][1]), got)
        xs = [torch.as_tensor(rng.rand(Q1, T[0][0].shape[0]), device=device)
              for _ in range(3)]
        idx = [0, 1, 0]
        got = cs.fold(xs, T[1], idx)
        out[key]['fold'] = compare('fold 2-space ' + key, got,
                                   cs.fold_plain(xs, T[1], idx), 1e-13)
        check_repeat('fold 2-space ' + key,
                     lambda: cs.fold(xs, T[1], idx), got)
    return out


def check_ns_geometry(asm, device):
    """K1's ``jac`` kind on the channel geometry at the Navier-Stokes
    path's Gauss grid (:func:`jac_case`); and the geometry fields (K2
    stages + K1) on the card against the same computation on CPU copies
    (the plain versions), 1e-13."""
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    rec = jac_case(asm, device, 'channel')
    ops = asm._device_operands()
    tables, coeffs, nurbs = (ops['geo_tables'], ops['geo_coeffs'],
                             asm._geo_is_nurbs)
    dev = cs.geometry_fields(tables, coeffs, nurbs)
    host = cs.geometry_fields([t.cpu() for t in tables], coeffs.cpu(), nurbs)
    rec['fields_vs_cpu'] = [compare('geometry fields %s' % k, a.cpu(), b,
                                    1e-13)
                            for k, a, b in zip(('val', 'jac'), dev, host)]
    return rec


def jac_bare_times(Y, T, got, nurbs, device):
    """:func:`bare_times` of K1's ``jac`` kind on the operands ``Y``,
    ``T`` and the output shape of `got` (the float32 entry for float32
    operands)."""
    from pyiga_tpu_torch import _cuda
    d, C, Q12, nL = Y.shape
    f32 = Y.dtype == torch.float32
    return bare_times(
        'geo_jac_fields' + '_f32' * f32,
        getattr(_cuda.library(), 'pyiga_geo_jac_fields_%s'
                % ('f32' if f32 else 'f64')),
        [Y, T, torch.empty_like(got)],
        lambda ts: (ts[0].data_ptr(), ts[1].data_ptr(), ts[2].data_ptr(), d,
                    C - int(nurbs), int(nurbs), Q12, T.shape[1], nL), device)


def check_ns_kernels(device):
    """Phase 4k: K1's ``jac`` kind and the geometry fields on the channel
    at the path's Gauss grid (:func:`check_ns_geometry`); K5 on the
    Navier-Stokes forms at the path's size (the convection forms with
    their velocity fields and first derivatives formed on the card and
    read in place, the vector Laplacian, the two-space divergence), 1e-13
    relative and bitwise on a repeat; K2 and K3 on the convection forms'
    and the two-space form's chains, and at ragged two-space shapes
    around the DMMA tiles."""
    mod = load_example('torch_navier_stokes')
    ns = mod.NavierStokes(n_el=NS_N_EL, p=2, Re=20.0, device=device)
    forms, _ = ns_forms(ns, device)
    out = {'vform_fields': {}, 'chains': {}}
    out['geo_jac_fields'] = g = check_ns_geometry(ns.asm_nlconv.asm, device)
    log('  K1 jac channel %s (nL=%d): %.4f ms (device %.4f, plain %.4f, '
        'bound %.4f); geometry fields vs CPU rel %s' % (
            g['shape'], g['nL'], g['ms'], g['device_ms'], g['plain_ms'],
            g['bound_ms'], ['%.3e' % r for _e, r in g['fields_vs_cpu']]))
    for name, (asm, inputs) in forms.items():
        out['vform_fields'][name] = vform_case(asm, device, inputs,
                                               tol=1e-13, name=name)
        out['chains'][name] = chain_case(asm, inputs, device, name)
    out['ragged'] = check_two_space_ragged(device)
    for name, r in out['vform_fields'].items():
        c = out['chains'][name]
        log('  %-8s K5 %.4f ms (device %.4f, bound %.4f)  K2 x%d %.4f ms '
            '(plain %.4f, matmul %.4f, bound %.4f)  K3 x%d %.4f ms (plain '
            '%.4f, matmul %.4f, bound %.4f)'
            % (name, r['ms'], r['device_ms'], r['bound_ms'],
               c['stage']['launches'], c['stage']['ms'],
               c['stage']['plain_ms'], c['stage']['library_ms'],
               c['stage']['bound_ms'], c['fold']['launches'],
               c['fold']['ms'], c['fold']['plain_ms'],
               c['fold']['library_ms'], c['fold']['bound_ms']))
    return out


def run_vector_assembly(device):
    """Phase 14: vector assembly at full width: ``divdiv`` at 3D p=3 n=48
    on the twisted box (every block (i, j) equal to block (j, i)
    transposed, 1e-13) and the 2D p=3 n=128 vector Laplacian on the NURBS
    quarter annulus (its diagonal blocks equal to ``assemble.stiffness``,
    1e-13), each ``run_device`` timed and its launches counted."""
    from pyiga_tpu_torch import _cuda, assemble, bspline, geometry, vform
    from pyiga_tpu_torch.compile import compile_vform
    from pyiga_tpu_torch.mlmatrix import transpose_idx_for_bidx
    rec = {}
    kvs = 3 * (bspline.make_knots(3, 0.0, 1.0, 48),)
    t0 = time.perf_counter()
    asm = compile_vform(vform.divdiv_vf(3))(kvs, geo=geometry.twisted_box(),
                                           device=device)
    t_setup = time.perf_counter() - t0
    asm.run_device()
    sync(device)
    _cuda.reset_launches()
    t0 = time.perf_counter()
    blocks = asm.run_device()
    sync(device)
    t_run = time.perf_counter() - t0
    launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    perms = [torch.as_tensor(transpose_idx_for_bidx(bx), device=device)
             for bx in asm.structure.bidx]
    sym = 0.0
    for (i, j), D in blocks.items():
        if i < j:
            T = blocks[(j, i)]
            for k, p in enumerate(perms):
                T = torch.index_select(T, k, p)
            sym = max(sym, float((D - T).abs().max() / D.abs().max()))
    rec['divdiv3d_n48'] = dict(
        blocks=len(blocks), combos=len(asm.combos),
        shape=list(blocks[(0, 0)].shape), t_setup_ms=1e3 * t_setup,
        t_run_device_ms=1e3 * t_run, launches=launches, transpose_rel=sym)
    log('  divdiv 3D p=3 n=48: %d blocks of %s, %d combos; setup %.0f ms, '
        'run_device %.1f ms; launches %s; (i,j) vs (j,i)^T rel %.3e'
        % (len(blocks), rec['divdiv3d_n48']['shape'], len(asm.combos),
           1e3 * t_setup, 1e3 * t_run, launches, sym))
    if len(blocks) != 9 or not sym <= 1e-13:
        raise RuntimeError('divdiv blocks are not transposes of each other')
    del asm, blocks, perms, D, T
    torch.cuda.empty_cache()

    kvs = 2 * (bspline.make_knots(3, 0.0, 1.0, 128),)
    geo = geometry.quarter_annulus()
    asm = assemble.instantiate_assembler(
        'inner(grad(u), grad(v)) * dx', kvs, {'geo': geo},
        [('u', 2), ('v', 2)], device=device)
    asm.run_device()
    sync(device)
    _cuda.reset_launches()
    t0 = time.perf_counter()
    blocks = asm.run_device()
    sync(device)
    t_run = time.perf_counter() - t0
    launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    S = assemble.stiffness(kvs, geo, device=device)
    errs = [float(abs(asm.structure.make_mlmatrix(
        data=blocks[(c, c)].cpu().numpy()).asmatrix() - S).max()
        / abs(S).max()) for c in range(2)]
    rec['veclap2d_n128'] = dict(blocks=sorted(map(list, blocks)),
                                t_run_device_ms=1e3 * t_run,
                                launches=launches, diag_rel=errs)
    log('  vector Laplacian 2D p=3 n=128: blocks %s, run_device %.2f ms; '
        'launches %s; diagonal blocks vs assemble.stiffness rel %s'
        % (sorted(blocks), 1e3 * t_run, launches,
           ['%.3e' % e for e in errs]))
    if sorted(blocks) != [(0, 0), (1, 1)] or not max(errs) <= 1e-13:
        raise RuntimeError('vector Laplacian blocks differ from the '
                           'scalar stiffness')
    return rec


def run_stokes(device):
    """Phase 15: ``examples/torch_stokes.py``'s ``main()`` at its defaults
    (8, 12) on the card (it asserts a divergence below 1e-10, the
    Poiseuille profile to 1e-6 and a linear pressure)."""
    sys.path.insert(0, os.path.join(REPO, 'examples'))
    try:
        stokes = load_example('torch_stokes')
    finally:
        sys.path.remove(os.path.join(REPO, 'examples'))
    t0 = time.perf_counter()
    vel, _pres = stokes.main(device=device)
    secs = time.perf_counter() - t0
    y = np.linspace(0, 1, 21)
    err = max(np.abs(vel.grid_eval((y, np.array([xp])))[:, 0, 0]
                     - 4 * y * (1 - y)).max() for xp in (0.5, 1.0, 1.7))
    log('  torch_stokes.main(): %.2f s, Poiseuille profile error %.3e'
        % (secs, err))
    return dict(n_el=[8, 12], seconds=secs, profile_error=err)


def check_ns_F_J(mod, ns, scheme, x0, device):
    """The device stepper's ``F_fn`` / ``J_fn`` on the card and the host
    methods ``F`` / ``J`` (assembled on the card) at a seeded state, each
    against the host methods of the same setup built on the CPU (plain
    versions, velocity fields evaluated on the host): F to 1e-13, J to
    1e-12, relative to the largest entry."""
    cpu = mod.NavierStokes(n_el=NS_N_EL, p=2, Re=20.0, device='cpu')
    x = x0 + 0.01 * np.random.RandomState(0).rand(len(x0))
    Fref, Jref = cpu.F(x), cpu.J(x).toarray()
    xt = torch.as_tensor(x, device=device)
    got = {'F_fn': (scheme._F_fn(xt, scheme._ops).cpu().numpy(), Fref),
           'J_fn': (scheme._J_fn(xt, scheme._ops).cpu().numpy(), Jref),
           'F': (ns.F(x), Fref), 'J': (ns.J(x).toarray(), Jref)}
    rec = {k: float(np.abs(a - b).max() / np.abs(b).max())
           for k, (a, b) in got.items()}
    log('  F / J at a seeded state vs the CPU setup: %s'
        % {k: '%.3e' % v for k, v in rec.items()})
    bad = [k for k, v in rec.items()
           if not v <= (1e-13 if k.startswith('F') else 1e-12)]
    if bad:
        raise RuntimeError('Navier-Stokes %s differ from the CPU setup'
                           % bad)
    return rec


def run_navier_stokes(device):
    """Phase 16: ``examples/torch_navier_stokes.py`` at the bench size
    (16, 32), ROWDAIND2 from the Stokes state, tau0 5e-2, tol 1e-2, to
    t_end 1.0: the port's host scheme, then ``integrate()``'s default on
    the card (the device scheme) with the launch counts set to 0 just
    before; the JAX package's step count and times, the host's step
    times to 1e-9 and states to 1e-10, no host scheme behind the device
    one, the divergence below 1e-10, F and J at a seeded state against a
    CPU setup (:func:`check_ns_F_J`).  Then the
    device run warm, ms per F and per J evaluation with their launches,
    and a run with each F and J evaluation timed (where a step attempt's
    time goes)."""
    from pyiga_tpu_torch import _cuda
    mod = load_example('torch_navier_stokes')
    t0 = time.perf_counter()
    ns = mod.NavierStokes(n_el=NS_N_EL, p=2, Re=20.0, device=device)
    t_setup = time.perf_counter() - t0
    x0 = ns.initial_state()
    n_free = len(x0)
    rec = dict(n_el=list(NS_N_EL), ndofs=ns.n_u + ns.n_p, n_free=n_free,
               t_setup_s=t_setup)
    log('  n_el %s: %d dofs (%d velocity, %d pressure), %d free; setup '
        '%.1f s' % (NS_N_EL, ns.n_u + ns.n_p, ns.n_u, ns.n_p, n_free,
                    t_setup))
    args = dict(x0=x0, tau=5e-2, t_end=1.0, tol=1e-2)

    J_host = ns.J
    n_J = [0]

    def counted_J(x):
        n_J[0] += 1
        return J_host(x)
    ns.J = counted_J
    t0 = time.perf_counter()
    th, sh = ns.integrate(backend='host', **args)
    t_host = time.perf_counter() - t0
    ns.J = J_host
    rec['host'] = dict(times=th, attempts=n_J[0], seconds=t_host,
                       ms_per_attempt=1e3 * t_host / n_J[0],
                       divergence=float(ns.divergence_norm(sh[-1])))

    sync(device)
    _cuda.reset_launches()
    t0 = time.perf_counter()
    td, sd = ns.integrate(**args)
    sync(device)
    t_dev = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    rec['launches'] = launches
    log('  launches: %s' % {k: v for k, v in launches.items() if v})
    missing = [k for k in NS_KERNELS if launches[k] <= 0]
    if missing:
        raise RuntimeError('Navier-Stokes path never launched %s' % missing)
    scheme = ns._dev_scheme[1]
    div = float(ns.divergence_norm(sd[-1]))
    dt_host = (max(abs(a - b) for a, b in zip(td, th))
               if len(td) == len(th) else np.inf)
    dt_jax = (max(abs(a - b) for a, b in zip(td, NS_TIMES_JAX))
              if len(td) == len(NS_TIMES_JAX) else np.inf)
    dx = max(np.linalg.norm(a - b) / np.linalg.norm(b)
             for a, b in zip(sd, sh)) if len(td) == len(th) else np.inf
    rec['device'] = dict(backend=ns.last_backend, times=td,
                         attempts=scheme.n_attempts, seconds_cold=t_dev,
                         host_fallbacks=scheme.host_fallbacks,
                         host_reads=scheme.n_host_reads, divergence=div,
                         times_vs_host=dt_host, times_vs_jax=dt_jax,
                         states_rel_vs_host=dx)
    log('  device scheme (%s): %d steps %s, %d attempts, %d host fallbacks, '
        '%.2f s cold; host scheme %d steps, %d attempts, %.2f s'
        % (ns.last_backend, len(td) - 1, ['%.4g' % t for t in td[1:]],
           scheme.n_attempts, scheme.host_fallbacks, t_dev, len(th) - 1,
           n_J[0], t_host))
    log('  JAX CPU steps %d; times vs host %.3e, vs JAX %.3e; states vs '
        'host rel %.3e; divergence %.3e'
        % (NS_STEPS_JAX, dt_host, dt_jax, dx, div))
    if ns.last_backend != 'device' or scheme.host_fallbacks != 0 \
            or scheme._host_scheme is not None:
        raise RuntimeError('the Navier-Stokes path left the device scheme')
    if len(td) - 1 != NS_STEPS_JAX or not (dt_host <= 1e-9
                                          and dt_jax <= 1e-9):
        raise RuntimeError('the device step sequence differs from the '
                           'host and JAX sequences')
    if not dx <= 1e-10:
        raise RuntimeError('device states differ from the host scheme\'s '
                           '(rel %.3e)' % dx)
    if not (div < 1e-10 and rec['host']['divergence'] < 1e-10):
        raise RuntimeError('divergence %.3e above 1e-10' % div)
    rec['F_J_vs_cpu'] = check_ns_F_J(mod, ns, scheme, x0, device)

    # warm: the same integration again on the built scheme (its cached
    # inverses dropped, so that each attempt forms its own as a new run's
    # would)
    scheme._P.clear()
    sync(device)
    t0 = time.perf_counter()
    ns.integrate(**args)
    sync(device)
    t_warm = time.perf_counter() - t0
    rec['device']['seconds_warm'] = t_warm
    rec['device']['ms_per_attempt'] = 1e3 * t_warm / scheme.n_attempts

    # one F and one J evaluation: launches and times
    F_fn, J_fn, ops = scheme._F_fn, scheme._J_fn, scheme._ops
    x = torch.as_tensor(x0, device=device)
    for name, fn in (('F', F_fn), ('J', J_fn)):
        fn(x, ops)
        sync(device)
        _cuda.reset_launches()
        fn(x, ops)
        sync(device)
        rec['%s_launches' % name] = {k: v for k, v in _cuda.LAUNCHES.items()
                                     if v}
        rec['%s_ms' % name] = time_ms(lambda: fn(x, ops), device, reps=20)
    n = n_free
    W = torch.eye(n, dtype=torch.float64, device=device) - 0.1 * J_fn(x, ops)
    rec['inv_ms'] = time_ms(lambda: torch.linalg.inv(W), device, reps=5)
    rec['matvec_ms'] = time_ms(lambda: W @ x, device, reps=50)

    # a run with each evaluation timed on the host clock after a sync
    spent = {'F': [0, 0.0], 'J': [0, 0.0]}

    def timed(name, fn):
        def call(x, o):
            sync(device)
            t = time.perf_counter()
            y = fn(x, o)
            sync(device)
            spent[name][0] += 1
            spent[name][1] += time.perf_counter() - t
            return y
        return call
    scheme._F_fn, scheme._J_fn = timed('F', F_fn), timed('J', J_fn)
    scheme._P.clear()
    sync(device)
    t0 = time.perf_counter()
    ns.integrate(**args)
    sync(device)
    t_traced = time.perf_counter() - t0
    scheme._F_fn, scheme._J_fn = F_fn, J_fn
    rec['breakdown'] = dict(
        seconds=t_traced, attempts=scheme.n_attempts,
        F_calls=spent['F'][0], F_s=spent['F'][1], J_calls=spent['J'][0],
        J_s=spent['J'][1],
        rest_s=t_traced - spent['F'][1] - spent['J'][1])
    b = rec['breakdown']
    log('  warm device run %.1f ms (%.2f ms per attempt); host %.2f ms per '
        'attempt' % (1e3 * t_warm, rec['device']['ms_per_attempt'],
                     rec['host']['ms_per_attempt']))
    log('  F %.3f ms (launches %s), J %.3f ms (launches %s); inverse of W '
        '(%d x %d) %.3f ms, a dense matvec %.4f ms'
        % (rec['F_ms'], rec['F_launches'], rec['J_ms'], rec['J_launches'],
           n, n, rec['inv_ms'], rec['matvec_ms']))
    log('  where a run goes: %.1f ms over %d attempts: %d F %.1f ms, %d J '
        '%.1f ms, rest (inverse, stage solves, host reads) %.1f ms'
        % (1e3 * t_traced, b['attempts'], b['F_calls'], 1e3 * b['F_s'],
           b['J_calls'], 1e3 * b['J_s'], 1e3 * b['rest_s']))
    return rec


################################################################################
# Surface integrals, second derivatives, multipatch (phases 4l, 17-19)
################################################################################

# the kernels the phases 17-19 paths run
ITEM8_KERNELS = ('geo_jac_fields', 'vform_fields', 'stage', 'fold')
FACES = ('left', 'right', 'bottom', 'top', 'front', 'back')
# v * ds over each face of tensor_product(line_segment(0, 1),
# quarter_annulus()) sums to the face's area, inner(v, n) * ds (packed) to
# the integral of the outward normal (pyiga_tpu's test_vform.py)
FACE_AREAS = {'left': np.pi / 2, 'right': np.pi, 'bottom': 1.0, 'top': 1.0,
              'front': 3 * np.pi / 4, 'back': 3 * np.pi / 4}
FACE_NORMALS = {'left': (-1.0, -1.0, 0.0), 'right': (2.0, 2.0, 0.0),
                'bottom': (0.0, -1.0, 0.0), 'top': (-1.0, 0.0, 0.0),
                'front': (0.0, 0.0, -3 * np.pi / 4),
                'back': (0.0, 0.0, 3 * np.pi / 4)}
# n = 16's bound on the relative error of the Laplacian functional
# (pyiga_tpu's test_input_field_hessian_assembly) over 16: O(h^2) predicts
# ~64x less at n = 128
LAPLACIAN_TOL = 2e-4 / 16


def geo3():
    """The 3D geometry of the surface phases: the quarter annulus extruded
    along a unit segment (NURBS)."""
    from pyiga_tpu_torch import geometry
    return geometry.tensor_product(geometry.line_segment(0.0, 1.0),
                                   geometry.quarter_annulus())


def kvs_of(dim, n, p=3):
    from pyiga_tpu_torch import bspline
    return dim * (bspline.make_knots(p, 0.0, 1.0, n),)


def jac_case(asm, device, name, tol=1e-13):
    """K1's ``jac`` kind on an assembler's geometry tables (its Gauss grid,
    a boundary grid's collapsed axis included) in the compute dtype
    against its plain version, `tol` relative and bitwise on a repeat
    (float32: :func:`f32_check`, also with torch's global TF32 on), with
    ``ms``, ``launch_ms`` / ``device_ms``, the plain version's time and
    the bound."""
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    ops = asm._device_operands()
    tables, coeffs, nurbs = (ops['geo_tables'], ops['geo_coeffs'],
                             asm._geo_is_nurbs)
    d = len(tables)
    Y, _ = cs.geo_stage12(tables, coeffs, d)
    T = tables[d - 1][:2].contiguous()
    f32 = Y.dtype == torch.float32
    if f32:
        got, err, rel, _ = f32_check(
            'geo_jac_f32 ' + name, cs.geo_jac_fields,
            cs.geo_jac_fields_plain, (Y, T, nurbs), device, tol=tol)
    else:
        got = cs.geo_jac_fields(Y, T, nurbs)
        ref = cs.geo_jac_fields_plain(Y, T, nurbs)
        sync(device)
        err, rel = compare('geo_jac ' + name, got, ref, tol)
        check_repeat('geo_jac ' + name,
                     lambda: cs.geo_jac_fields(Y, T, nurbs), got)
    from pyiga_tpu_torch import _cuda
    C, Q12, nL = Y.shape[1], Y.shape[2], Y.shape[3]
    rec = dict(
        max_abs_err=err, rel=rel, shape=list(got.shape), Y=list(Y.shape),
        nL=nL, QL=int(T.shape[1]), repeat_equal=True,
        ptxas=fields_ptxas(_cuda.BUILD_INFO['log']).get(
            fields_instance('jac', Y, nurbs, False, int(T.shape[1])),
            'not found'),
        ms=time_ms(lambda: cs.geo_jac_fields(Y, T, nurbs), device, reps=50),
        plain_ms=time_ms(lambda: cs.geo_jac_fields_plain(Y, T, nurbs),
                         device, reps=5),
        library_ms=None,
        **bound(nbytes(Y, T, got),
                got[0].numel() * (2 * C * (d + 1) * nL + 30),
                F32_PER_MS if f32 else F64_FMA_PER_MS))
    if f32:
        rec['tf32_on_unchanged'] = True
    rec.update(jac_bare_times(Y, T, got, nurbs, device))
    return rec


def surface_asm(form, dim, n, device, boundary=None, geo=None, bfuns=None,
                **args):
    """An assembler of `form` on a p=3 space of `n` elements per axis:
    over the face `boundary` of :func:`geo3` (3D), or over `geo`."""
    from pyiga_tpu_torch.assemble import instantiate_assembler
    args['geo'] = geo if geo is not None else geo3()
    return instantiate_assembler(form, kvs_of(dim, n), args, bfuns,
                                 boundary=boundary, device=device)


def surface_vf(device, n=128, geo=None):
    """``VForm(2, geo_dim=3)``'s ``v * ds`` on a surface (default: the
    'left' face of :func:`geo3`) at 2D p=3."""
    from pyiga_tpu_torch import compile, vform
    vf = vform.VForm(2, geo_dim=3, arity=1)
    vf.add(vf.basisfuns() * vform.ds)
    return compile.compile_vform(vf)(
        kvs_of(2, n), geo=geo if geo is not None else geo3().boundary('left'),
        device=device)


def hessian_input_vf():
    """The Laplacian functional of an input field ``f``:
    ``(H[0,0] + H[1,1]) * v * dx`` with ``H = hess(f)``."""
    from pyiga_tpu_torch import vform
    vf = vform.VForm(2, arity=1)
    v = vf.basisfuns()
    H = vform.hess(vf.input('f'))
    vf.add((H[0, 0] + H[1, 1]) * v * vform.dx)
    return vf


def laplacian_input(kvs):
    """The interpolant of ``x^2 y + y^3`` on the quarter annulus as a
    spline input (its physical Laplacian is ``8 y``)."""
    from pyiga_tpu_torch import approx, geometry
    coeffs = approx.interpolate(kvs, lambda x, y: x ** 2 * y + y ** 3,
                                geo=geometry.quarter_annulus())
    return geometry.BSplineFunc(kvs, coeffs)


def check_item8_kernels(device):
    """Phase 4l: the kernels at the shapes of surface integrals and second
    derivatives, each against its plain version (1e-13 relative, bitwise
    on a repeat): K1's ``jac`` kind on a surface geometry (three
    components on a 2D grid; B-spline: the twisted box's 'left' face,
    NURBS: :func:`geo3`'s, both at n=128) and on the boundary Gauss grids
    of all six faces of :func:`geo3` at n=48 (one grid axis of length 1);
    K5 on ``v * ds`` ('left' and 'front'), ``inner(v, n) * ds`` and
    ``inner(grad(u), grad(v)) * ds`` ('left', 3D n=48), the surface ``v
    * ds`` (n=128),
    the biharmonic ``inner(hess(u), hess(v)) * dx`` and the Laplacian
    functional of a spline input (2D n=128 NURBS quarter annulus), on the
    'left' face (a one-point last axis: K5's rows mapping) also bitwise
    against the columns mapping (:func:`check_cols_mapping`); K2 and K3
    on those forms' chains (the normal axis of a face a 1 x 1 table)."""
    from pyiga_tpu_torch import geometry
    out = {'geo_jac_fields': {}, 'vform_fields': {}, 'chains': {}}
    surf_bsp = surface_vf(device, geo=geometry.twisted_box().boundary('left'))
    surf = surface_vf(device)
    out['geo_jac_fields']['surface_bsp_n128'] = jac_case(surf_bsp, device,
                                                         'surface bsp')
    out['geo_jac_fields']['surface_nurbs_n128'] = jac_case(surf, device,
                                                           'surface nurbs')
    for bd in FACES:
        asm = surface_asm('v * ds', 3, 48, device, boundary=bd)
        out['geo_jac_fields']['face_%s_n48' % bd] = jac_case(
            asm, device, 'face ' + bd)
        if bd == 'left':
            forms = {'v_ds_left': asm}
        if bd == 'front':       # the first stage's table is 1 x 1
            forms['v_ds_front'] = asm
    forms['normal_left'] = surface_asm('inner(v, n) * ds', 3, 48, device,
                                       boundary='left', bfuns=[('v', 3)])
    forms['gradgrad_ds_left'] = surface_asm(
        'inner(grad(u), grad(v)) * ds', 3, 48, device, boundary='left')
    forms['surface_v_ds_n128'] = surf
    forms['biharmonic_n128'] = surface_asm(
        'inner(hess(u), hess(v)) * dx', 2, 128, device,
        geo=geometry.quarter_annulus())
    from pyiga_tpu_torch import compile
    forms['hess_input_n128'] = compile.compile_vform(hessian_input_vf())(
        kvs_of(2, 128), geo=geometry.quarter_annulus(),
        f=laplacian_input(kvs_of(2, 128)), device=device)
    for name, asm in forms.items():
        out['vform_fields'][name] = vform_case(asm, device, tol=1e-13,
                                               name=name)
        out['chains'][name] = chain_case(asm, None, device, name)
    for name, r in out['geo_jac_fields'].items():
        log('  K1 jac %-18s %s: %.4f ms (device %.4f, plain %.4f, bound '
            '%.4f); ptxas %s' % (name, r['shape'], r['ms'], r['device_ms'],
                                 r['plain_ms'], r['bound_ms'], r['ptxas']))
    for name, r in out['vform_fields'].items():
        c = out['chains'][name]
        log('  %-18s K5 %.4f ms (device %.4f, bound %.4f)  K2 x%d %.4f ms '
            '(plain %.4f, matmul %.4f, bound %.4f)  K3 x%d %.4f ms (plain '
            '%.4f, matmul %.4f, bound %.4f)'
            % (name, r['ms'], r['device_ms'], r['bound_ms'],
               c['stage']['launches'], c['stage']['ms'],
               c['stage']['plain_ms'], c['stage']['library_ms'],
               c['stage']['bound_ms'], c['fold']['launches'],
               c['fold']['ms'], c['fold']['plain_ms'],
               c['fold']['library_ms'], c['fold']['bound_ms']))
    return out


def dense(x):
    return x.toarray() if hasattr(x, 'toarray') else np.asarray(x)


def held_to_cpu(name, got, make_cpu, tol=1e-13):
    """`got` (a matrix or vector assembled on the card) against the same
    call on a CPU setup (`make_cpu()`), `tol` relative to its largest
    entry."""
    ref = make_cpu()
    a, b = dense(got), dense(ref)
    if a.shape != b.shape:
        raise RuntimeError('%s: card %s but CPU %s' % (name, a.shape,
                                                       b.shape))
    rel = float(np.abs(a - b).max() / np.abs(b).max())
    ok = np.isfinite(a).all() and rel <= tol
    log('  %-34s card vs CPU rel %.3e (tol %.0e) %s'
        % (name, rel, tol, 'ok' if ok else 'FAIL'))
    if not ok:
        raise RuntimeError('%s: the card disagrees with the CPU' % name)
    return rel


def timed(fn, device):
    """``(result, ms)`` of one call of `fn`, synchronized."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, 1e3 * (time.perf_counter() - t0)


def run_item8_call(name, call, device, tol=1e-13):
    """`call(dev)` on the card, warm (the first call builds the form's K5
    and probes it), timed, and held to the same call on the CPU."""
    call(device)
    got, ms = timed(lambda: call(device), device)
    rec = dict(ms=ms, rel_vs_cpu=held_to_cpu(name, got, lambda: call('cpu'),
                                             tol))
    log('  %-34s assemble %.2f ms' % (name, ms))
    return got, rec


def run_surface(device, n=48):
    """Phase 17: surface integrals at full width on :func:`geo3` at 3D p=3
    n=48 (132,651 dofs): ``v * ds`` on each of the six faces (each sum the
    face's area to 1e-10), ``inner(v, n) * ds`` packed (the averaged
    normals), ``inner(grad(u), grad(v)) * ds`` on 'left', the tangential
    form on 'front' against ``assemble.stiffness`` of the quarter annulus
    (1e-12), and ``VForm(2, geo_dim=3)``'s ``v * ds`` on :func:`geo3`'s
    'left' face at n=128; each held to a CPU setup (1e-13) with its
    ``assemble()`` ms."""
    from pyiga_tpu_torch import assemble, geometry
    kvs = kvs_of(3, n)
    rec = {'faces': {}}
    for bd in FACES:
        f, r = run_item8_call('v * ds %s' % bd, lambda dev: assemble.assemble(
            'v * ds', kvs, geo=geo3(), boundary=bd, device=dev), device)
        r['sum'] = float(f.sum())
        if abs(r['sum'] - FACE_AREAS[bd]) > 1e-10:
            raise RuntimeError('v * ds on %s sums to %r, not %r'
                               % (bd, r['sum'], FACE_AREAS[bd]))
        nv, rn = run_item8_call(
            'inner(v, n) * ds %s' % bd, lambda dev: assemble.assemble(
                'inner(v, n) * ds', kvs, bfuns=[('v', 3)], geo=geo3(),
                boundary=bd, layout='packed', device=dev), device)
        r['normal'] = [float(x) for x in nv.sum(axis=(0, 1, 2))]
        if not np.allclose(r['normal'], FACE_NORMALS[bd], rtol=0,
                           atol=1e-10):
            raise RuntimeError('normals on %s: %s' % (bd, r['normal']))
        r['normal_ms'], r['normal_rel_vs_cpu'] = rn['ms'], rn['rel_vs_cpu']
        rec['faces'][bd] = r
    A, rec['gradgrad_left'] = run_item8_call(
        'grad.grad ds left', lambda dev: assemble.assemble(
            'inner(grad(u), grad(v)) * ds', kvs, geo=geo3(),
            boundary='left', device=dev), device)
    rec['gradgrad_left']['shape'] = list(A.shape)
    A, rec['tangential_front'] = run_item8_call(
        'tangential ds front', lambda dev: assemble.assemble(
            'inner(cross(n, grad(u)), cross(n, grad(v))) * ds', kvs,
            geo=geo3(), boundary='front', device=dev), device)
    A2 = assemble.stiffness(kvs[1:], geo=geometry.quarter_annulus(),
                            device=device)
    rec['tangential_front']['rel_vs_stiffness'] = held_to_cpu(
        'tangential front = 2D stiffness', A, lambda: A2, 1e-12)
    f, rec['surface_vf_n128'] = run_item8_call(
        'surface v * ds n=128', lambda dev: surface_vf(
            dev).assemble_vector(), device)
    rec['surface_vf_n128']['sum'] = float(f.sum())
    if abs(f.sum() - np.pi / 2) > 1e-10:
        raise RuntimeError('surface v * ds sums to %r' % f.sum())
    return rec


def run_second_derivatives(device, n=128):
    """Phase 18: second derivatives at full width on the NURBS quarter
    annulus at 2D p=3 n=128 (17,161 dofs): the biharmonic (Kirchhoff
    plate) matrix by ``run_device`` and ``assemble()`` (ms and launches)
    held to a CPU setup (1e-13); the Laplacian functional of the
    interpolant of ``x^2 y + y^3`` within :data:`LAPLACIAN_TOL` of the
    exact ``8 y``; and ``u * v * dx`` on the polar ``UserFunction`` at
    n=60 held to a CPU setup."""
    from pyiga_tpu_torch import _cuda, assemble, compile, geometry
    from pyiga_tpu_torch.assemble import instantiate_assembler
    kvs = kvs_of(2, n)
    rec = {}
    bih = 'inner(hess(u), hess(v)) * dx'
    asm = instantiate_assembler(bih, kvs, {'geo': geometry.quarter_annulus()},
                                None, device=device)
    asm.run_device()
    _cuda.reset_launches()
    _, rd_ms = timed(asm.run_device, device)
    rec['biharmonic'] = dict(
        run_device_ms=rd_ms, combos=len(asm.combos),
        fold_plan=len(asm._fold_plan or ()),
        launches_run_device=dict(_cuda.LAUNCHES))
    A, r = run_item8_call('biharmonic n=128', lambda dev: assemble.assemble(
        bih, kvs, geo=geometry.quarter_annulus(), device=dev), device)
    rec['biharmonic'].update(r)
    log('  biharmonic: %d combos, run_device %.2f ms, launches %s'
        % (len(asm.combos), rd_ms, rec['biharmonic']['launches_run_device']))
    del asm, A
    f = laplacian_input(kvs)
    b, r = run_item8_call('laplacian functional n=128', lambda dev:
                          compile.compile_vform(hessian_input_vf())(
                              kvs, geo=geometry.quarter_annulus(), f=f,
                              device=dev).assemble_vector(), device)
    b_ex = assemble.inner_products(kvs, lambda x, y: 8 * y, f_physical=True,
                                   geo=geometry.quarter_annulus())
    r['rel_err_vs_8y'] = float(np.abs(b - b_ex).max() / np.abs(b_ex).max())
    log('  Laplacian functional: rel error vs 8y %.3e (tol %.3e)'
        % (r['rel_err_vs_8y'], LAPLACIAN_TOL))
    if r['rel_err_vs_8y'] >= LAPLACIAN_TOL:
        raise RuntimeError('Laplacian functional error %r'
                           % r['rel_err_vs_8y'])
    rec['laplacian'] = r
    _, rec['usergeo_mass_n60'] = run_item8_call(
        'UserFunction u * v * dx n=60', lambda dev: assemble.assemble(
            'u * v * dx', kvs_of(2, 60), geo=polar_annulus(), device=dev),
        device)
    return rec


def run_multipatch(device, n=128, p=3, n_hs=48):
    """Phase 19: ``examples/torch_multipatch_poisson.py``'s ``main(p=3,
    n=128)`` (an L shape of 3 patches, 17,161 dofs each, 51,221 global):
    its checks (interface jump below 1e-12, ``u.max() > 0``), the
    assembly ms per patch and the host solve ms, ``automatch=True``
    against the hand-joined patches (``numdofs``, ``shared_per_patch``),
    the global matrix held to a CPU setup (1e-13); then ``assemble(
    stiffness, hs)``, the load vector and ``approx.project_L2(hs, f)`` on
    the (48, 3) HB space of phase 8b, held to a CPU setup (the
    projection, a solve, to 1e-11)."""
    from pyiga_tpu_torch import approx, assemble, geometry, vform
    mod = load_example('torch_multipatch_poisson')
    mod.main(p=2, n=8, device=device)          # builds the forms' K5
    u, info = mod.main(p=p, n=n, device=device)
    MP = info['MP']
    rec = dict(numdofs=int(MP.numdofs), jump=info['jump'],
               u_max=float(u.max()), assemble_ms=info['assemble_ms'],
               solve_ms=info['solve_ms'])
    if MP.numdofs != 3 * (n + p) ** 2 - 2 * (n + p):
        raise RuntimeError('multipatch numdofs %d' % MP.numdofs)
    hand = assemble.Multipatch(MP.patches)
    hand.join_boundaries(0, 'right', 1, 'left')
    hand.join_boundaries(1, 'top', 2, 'bottom')
    hand.finalize()
    if hand.numdofs != MP.numdofs or \
            hand.shared_per_patch != MP.shared_per_patch:
        raise RuntimeError('automatch differs from the hand-joined patches')
    rec['patch_ms'] = []
    for k, (pk, geo) in enumerate(MP.patches):
        _, ms = timed(lambda: assemble.assemble(
            vform.stiffness_vf(2), pk, geo=geo, device=device), device)
        rec['patch_ms'].append(ms)
    log('  multipatch %d dofs: assembly %.1f ms (per patch %s ms), host '
        'solve %.1f ms, jump %.2e'
        % (MP.numdofs, info['assemble_ms'],
           ['%.1f' % t for t in rec['patch_ms']], info['solve_ms'],
           info['jump']))

    def system(dev):
        return MP.assemble_system(vform.stiffness_vf(2),
                                  vform.L2functional_vf(2, physical=True),
                                  f=lambda x, y: 1.0, device=dev)
    rec['rel_vs_cpu'] = held_to_cpu('multipatch global matrix', info['A'],
                                    lambda: system('cpu')[0])
    hs = localmg_space(n_hs)
    geo = geometry.unit_square()
    f = lambda x, y: x ** 2 - 4 * x * y + y ** 3    # noqa: E731
    _, rec['hspace_stiffness'] = run_item8_call(
        'assemble(stiffness, hs) (%d,3)' % n_hs, lambda dev:
        assemble.assemble(vform.stiffness_vf(2), hs, geo=geo, device=dev),
        device)
    _, rec['hspace_load_vector'] = run_item8_call(
        'assemble(f v dx, hs) (%d,3)' % n_hs, lambda dev: assemble.assemble(
            vform.L2functional_vf(2, physical=True), hs, geo=geo, f=f,
            device=dev), device)
    # the projection solves with the mass matrix, whose condition number
    # scales the rounding of the assembled operands (1e-16) up: 1e-11
    _, rec['hspace_project_L2'] = run_item8_call(
        'project_L2(hs, f) (%d,3)' % n_hs, lambda dev: approx.project_L2(
            hs, f, f_physical=True, geo=geo, device=dev), device, tol=1e-11)
    rec['hspace_numdofs'] = int(hs.numdofs)
    return rec


def run_item8_phase(name, fn, device):
    """One of phases 17-19 with the launch counts set to 0 just before and
    read just after; raises if a kernel of :data:`ITEM8_KERNELS` was never
    launched."""
    from pyiga_tpu_torch import _cuda
    _cuda.reset_launches()
    rec = fn(device)
    rec['launches'] = dict(_cuda.LAUNCHES)
    log('  launches: %s' % rec['launches'])
    missing = [k for k in ITEM8_KERNELS if rec['launches'][k] <= 0]
    if missing:
        raise RuntimeError('%s never launched %s' % (name, missing))
    return rec


################################################################################
# Differentiable assembly (phase 20): diff.py's backward kernels and paths
################################################################################

# the backward kernels of the differentiable assembly: the JAX package
# differentiates the XLA forms of these functions (pyiga_tpu/diff.py:
# 108-142 and compile.py:1171-1240 _eval_combo_fields), so each entry names
# the TPU kernel whose counterpart's VJP it is
DIFF_F64_KERNELS = ('fields_bwd', 'mass_fields_bwd', 'geo_jac_fields_bwd',
                    'stage_bwd', 'fold_bwd', 'vform_adjoint')
# their float32 instances (phases 20f, 20g)
DIFF_F32_KERNELS = tuple(k + '_f32' for k in DIFF_F64_KERNELS)
DIFF_KERNELS = DIFF_F64_KERNELS + DIFF_F32_KERNELS
_VJP = ' (its VJP; pyiga_tpu/diff.py differentiates the XLA form)'
# phase 20f's tolerance, relative to the largest output: float32 against
# float32 in another order of summation
DIFF_F32_TOL = 1e-5
# the float32 backward instances in the package's library, by mangled
# name: K1-bwd <..., float>, K2-/K3-bwd f32 and its split's second pass
SASS_DIFF_F32 = {
    'geo_fields_bwd_kernel<float>': re.compile(
        r'geo_fields_bwd_kernelI.*EfEv'),
    'stage_bwd_f32_kernel': re.compile(r'stage_bwd_f32_kernel'),
    'chunk_sum_f32_kernel': re.compile(r'chunk_sum_f32_kernel'),
}
KERNELS.update({
    'fields_bwd': ('cuda', 'pyiga_tpu_torch/csrc/fields.cu',
                   'pyiga_tpu/ops/pallas_sumfac.py:1087' + _VJP),
    'mass_fields_bwd': ('cuda', 'pyiga_tpu_torch/csrc/fields.cu',
                        'pyiga_tpu/ops/pallas_sumfac.py:1087' + _VJP),
    'geo_jac_fields_bwd': ('cuda', 'pyiga_tpu_torch/csrc/fields.cu',
                           'pyiga_tpu/ops/pallas_sumfac.py:1087' + _VJP),
    'stage_bwd': ('cuda', 'pyiga_tpu_torch/csrc/sumfac.cu',
                  'pyiga_tpu/ops/pallas_sumfac.py:353' + _VJP),
    'fold_bwd': ('cuda', 'pyiga_tpu_torch/csrc/sumfac.cu',
                 'pyiga_tpu/ops/pallas_sumfac.py:781' + _VJP),
    # CUDA C generated per form, beside the forward's
    'vform_adjoint': ('cuda', 'pyiga_tpu_torch/ops/cuda_vform.py',
                      'pyiga_tpu/compile.py:974' + _VJP),
    # the float32 instances: K1-bwd templated on its scalar, K2-/K3-bwd
    # the FFMA kernel stage_bwd_f32_kernel (a tile spanning K, M split in
    # a fixed order where the output tiles cannot fill the card), the
    # adjoint generated in float
    'fields_bwd_f32': ('cuda', 'pyiga_tpu_torch/csrc/fields_f32.cu',
                       'pyiga_tpu/ops/pallas_sumfac.py:1087' + _VJP),
    'mass_fields_bwd_f32': ('cuda', 'pyiga_tpu_torch/csrc/fields_f32.cu',
                            'pyiga_tpu/ops/pallas_sumfac.py:1087' + _VJP),
    'geo_jac_fields_bwd_f32': ('cuda', 'pyiga_tpu_torch/csrc/fields_f32.cu',
                               'pyiga_tpu/ops/pallas_sumfac.py:1087'
                               + _VJP),
    'stage_bwd_f32': ('cuda', 'pyiga_tpu_torch/csrc/sumfac_f32.cu',
                      'pyiga_tpu/ops/pallas_sumfac.py:353' + _VJP),
    'fold_bwd_f32': ('cuda', 'pyiga_tpu_torch/csrc/sumfac_f32.cu',
                     'pyiga_tpu/ops/pallas_sumfac.py:781' + _VJP),
    'vform_adjoint_f32': ('cuda', 'pyiga_tpu_torch/ops/cuda_vform.py',
                          'pyiga_tpu/compile.py:974' + _VJP),
})
NONLINEAR = '(1 + w*w) * inner(grad(w), grad(v)) * dx'
BIHARMONIC = 'inner(hess(u), hess(v)) * dx'


def compare_all(name, got, ref, rtol):
    """:func:`compare` over matching lists of tensors: each held against
    its own largest reference entry; returns the largest error and the
    worst relative error."""
    err = worst = 0.0
    ok = True
    for a, b in zip(got, ref):
        e = float((a.double() - b.double()).abs().max())
        scale = float(b.double().abs().max())
        rel = e / scale if scale > 0 else e
        ok = ok and bool(torch.isfinite(a).all()) and rel <= rtol
        err, worst = max(err, e), max(worst, rel)
    log('  %-16s max_abs_err %.3e  worst rel %.3e over %d tensors  '
        '(tol %.0e)  %s' % (name, err, worst, len(got), rtol,
                            'ok' if ok else 'FAIL'))
    if not ok:
        raise RuntimeError('%s disagrees with its plain version' % name)
    return err, worst


def check_repeat_all(name, fn, got):
    """:func:`check_repeat` for a function returning a list of tensors."""
    again = fn()
    sync(got[0].device)
    if not all(torch.equal(a, b) for a, b in zip(again, got)):
        raise RuntimeError('%s: two launches on the same inputs differ'
                           % name)
    return True


def tf32_unchanged(name, fn, got):
    """The tensors `fn()` returns, computed again with torch's global TF32
    on, bitwise equal to `got` (the float32 kernels and their plain
    versions take no TF32)."""
    with GlobalTF32():
        again = fn()
        sync(got[0].device)
    if not all(torch.equal(a, b) for a, b in zip(again, got)):
        raise RuntimeError('%s: global TF32 changed the f32 results' % name)


def fields_bwd_flops(kind, d, G, nurbs, nL):
    """Operations of one Gauss point of K1's backward, counted from the
    body of ``geo_fields_bwd_kernel`` and ``point_vjp`` (csrc/fields.cu)
    as written: an add, multiply, divide or copysign is one, a
    multiply-add two (a sign flip none)."""
    C = G + int(nurbs)
    vals = nurbs or kind == 'jac'
    ops = 2 * C * d * nL                        # the Jacobian's dots
    if vals:
        ops += 2 * C * nL                       # the values' dots
    if nurbs:
        ops += 2 + G                            # 1 / W, its square, x_c
    if kind != 'jac':
        ops += 1                                # gw
        if nurbs:
            ops += 3 * d * d                    # J by the quotient rule
        ops += {2: 3, 3: 32}[d]                 # adj J, det J
        if kind == 'mass':
            ops += 2 + d * d                    # f, gJ = f adj^T
        else:           # Gs, 1 / det and f; Gs adj, Gs : A, adj^T Gs adj, gJ
            ops += (d * (d - 1) // 2 + 4 + 2 * d ** 3 + 2 * d * d
                    + d * d * (d + 1) + d * d * (2 * d + 4))
    if nurbs:                                   # the quotient rule's VJP
        ops += 5 * G * d + d * (2 * G + 1) + G * (3 * d + 1) + 1
        if kind == 'jac':                       # the values' share
            ops += 4 * G
    return ops + 2 * d * C * nL + (2 * C * nL if vals else 0)  # the sums


# a K1 / K1-bwd instance in ptxas's output: the kernel, its template
# arguments <D, G, NURBS, KIND, NL>, the forward's ROWS, and its scalar
# (d or f)
FIELDS_INSTANCE = re.compile(r'(geo_fields(?:_bwd)?_kernel)ILi(\d+)ELi(\d+)E'
                             r'Lb([01])ELi(\d+)ELi(\d+)E(?:Lb([01])E)?([df])E')


def fields_ptxas(build_log):
    """ptxas's registers and spills of every ``geo_fields_kernel`` and
    ``geo_fields_bwd_kernel`` instance in a build's log: ``{(kernel, D,
    G, NURBS, KIND, NL, ROWS, scalar): 'R registers, S B spill stores, L
    B spill loads'}`` (ROWS None for the backward)."""
    lines = build_log.splitlines()
    out = {}
    for i, line in enumerate(lines):
        m = FIELDS_INSTANCE.search(line)
        if not (m and 'Compiling entry' in line):
            continue
        spill = next(x for x in lines[i:] if 'spill' in x)
        regs = next(x for x in lines[i:] if 'registers' in x)
        key = (m.group(1),) + tuple(int(v) for v in m.groups()[1:6]) + (
            None if m.group(7) is None else int(m.group(7)), m.group(8))
        out[key] = '%s registers, %s B spill stores, %s B spill loads' % (
            re.search(r'Used (\d+) registers', regs).group(1),
            re.search(r'(\d+) bytes spill stores', spill).group(1),
            re.search(r'(\d+) bytes spill loads', spill).group(1))
    return out


def fields_instance(kind, Y, nurbs, bwd, QL=None):
    """The ptxas key (:func:`fields_ptxas`) of the K1 or K1-bwd instance
    that runs on the operands `Y` (and the forward's last axis `QL`)."""
    d, C, _q, nL = Y.shape
    key = ('geo_fields_bwd_kernel' if bwd else 'geo_fields_kernel', d,
           C - int(nurbs), int(nurbs),
           {'stiffness': 0, 'mass': 1, 'jac': 2}[kind],
           nL if nL <= 4 and d > 1 else 0)
    return key + (None if bwd else int(QL < 8),
                  'f' if Y.dtype == torch.float32 else 'd')


def fields_bwd_case(kind, Y, T, w12, wL, nurbs, device, name, seed,
                    tol=1e-13):
    """K1's backward of `kind` against its plain formulas (`tol`, bitwise
    on a repeat; float32 operands: the float32 instance, also bitwise
    unchanged with torch's global TF32 on), with its ms through the
    wrapper, the device time of one bare launch (:func:`bare_times`), the
    plain version's ms, the bound (Y, T, the weights and the output's
    gradient read once, gY written once; per point the operations of
    :func:`fields_bwd_flops`, at the f64 or f32 FMA peak) and ptxas's
    registers and spills of the instance."""
    from pyiga_tpu_torch import _cuda
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    d, C, Q12, nL = Y.shape
    G = C - int(nurbs)
    QL = T.shape[1]
    f32 = Y.dtype == torch.float32
    shape = {'stiffness': (d * (d + 1) // 2, Q12, QL), 'mass': (Q12, QL),
             'jac': (G + G * d, Q12, QL)}[kind]
    rng = np.random.RandomState(seed)
    g = torch.as_tensor(rng.rand(*shape) - 0.5, dtype=Y.dtype,
                        device=device)
    got = cs.fields_bwd(kind, Y, T, w12, wL, nurbs, g)
    ref = cs._fields_vjp_plain(kind, Y, T, w12, wL, nurbs, g)
    sync(device)
    label = '%s_bwd%s %s' % (kind, ' f32' if f32 else '', name)
    err, rel = compare(label, got, ref, tol)
    check_repeat(label,
                 lambda: cs.fields_bwd(kind, Y, T, w12, wL, nurbs, g), got)
    if f32:
        tf32_unchanged(label, lambda: [
            cs.fields_bwd(kind, Y, T, w12, wL, nurbs, g),
            cs._fields_vjp_plain(kind, Y, T, w12, wL, nurbs, g)], [got, ref])
    ops = Q12 * QL * fields_bwd_flops(kind, d, G, nurbs, nL)
    code = {'stiffness': 0, 'mass': 1, 'jac': 2}[kind]
    if w12 is None:
        w12 = wL = torch.empty(0, dtype=Y.dtype, device=device)
    rec = dict(max_abs_err=err, rel=rel, Y=list(Y.shape), QL=QL,
               repeat_equal=True,
               ms=time_ms(lambda: cs.fields_bwd(kind, Y, T, w12, wL, nurbs,
                                                g), device),
               plain_ms=time_ms(lambda: cs._fields_vjp_plain(
                   kind, Y, T, w12, wL, nurbs, g), device, reps=3),
               library_ms=None,
               ptxas=fields_ptxas(_cuda.BUILD_INFO['log']).get(
                   fields_instance(kind, Y, nurbs, True), 'not found'),
               **bound(nbytes(Y, T, g, got) + (0 if kind == 'jac' else
                                                nbytes(w12, wL)),
                       ops, F32_PER_MS if f32 else F64_FMA_PER_MS))
    if f32:
        rec.update(tf32_on_unchanged=True)
    rec.update(bare_times(
        'fields_bwd', (_cuda.library().pyiga_fields_bwd_f32 if f32 else
                       _cuda.library().pyiga_fields_bwd_f64),
        [Y, T, w12, wL, g, torch.empty_like(Y)],
        lambda ts: (code,) + tuple(t.data_ptr() for t in ts) + (
            d, G, int(nurbs), Q12, QL, nL), device))
    log('  %-28s %s: %.4f ms (device %.4f, plain %.4f, bound %.4f '
        '%s, %.0f %% of it); ptxas %s'
        % (label, list(shape), rec['ms'], rec['device_ms'],
           rec['plain_ms'], rec['bound_ms'], rec['bound_by'],
           100 * rec['bound_ms'] / rec['device_ms'], rec['ptxas']))
    del g, got, ref
    return rec


def spline_partials(asm):
    """K1's operands ``(Y, T, w12, wL, nurbs)`` of a Gauss assembler's
    spline geometry on its device."""
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    (Y, T, w12, wL, nurbs), _grid = cs._spline_stages(asm.geo_inputs())
    return Y, T, w12, wL, nurbs


def host_ms(fn, device, reps=50, runs=3):
    """Milliseconds a call of `fn()` by the host clock: the best of `runs`
    runs of `reps` calls back to back, each ended by a synchronize, after
    a warm call."""
    fn()
    best = float('inf')
    for _ in range(runs):
        sync(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync(device)
        best = min(best, time.perf_counter() - t0)
    return 1e3 * best / reps


def adjoint_bare_times(adj, arrays, g, device):
    """The K5 adjoint's C entry apart from ``launch`` (:func:`bare_times`:
    its kernel and, with parameters, the parameter sum), the operands and
    the tensors it writes cycling through copies larger than the L2."""
    fwd = adj.forward
    d, ns = len(arrays['weights']), len(fwd.sources)
    grads, gparams, part = adj.outputs(arrays)
    has_p = gparams is not None
    operands = (list(arrays['weights']) + [arrays[k] for k in fwd.sources]
                + [arrays['params']] * has_p + [g]
                + [grads[k] for k in fwd.sources] + [gparams, part] * has_p)

    def args_of(ts):
        it = iter(ts)
        arr = dict(weights=[next(it) for _ in range(d)])
        arr.update((k, next(it)) for k in fwd.sources)
        if has_p:
            arr['params'] = next(it)
        gg = next(it)
        gr = {k: next(it) for k in fwd.sources}
        outs = (gr, next(it), next(it)) if has_p else (gr, None, None)
        return adj.arguments(arr, gg, outs, 0)[:-1]
    return bare_times('vform_adjoint', adj.entry(), operands, args_of, device)


def adjoint_case(asm, device, name, seed, tol=1e-13):
    """The generated K5 adjoint of a form's fold-plan program in the
    compute dtype against ``run_adjoint_plain`` on the same operands (each
    gradient to `tol` of its own largest entry, bitwise on a repeat; in
    float32 also bitwise unchanged with torch's global TF32 on); its
    times: ``ms`` through
    ``launch`` by CUDA events, ``host_ms`` by the host clock,
    ``device_ms`` a CUDA graph of ``launch`` and ``kernel_ms`` one of the
    bare C entry (:func:`adjoint_bare_times`); and its bound: the rows the
    adjoint program reads (source rows and the output's gradient), the
    weights and parameters read once, every gradient tensor ``launch``
    returns written in full; one operation per adjoint SSA instruction and
    point (at the f64 or f32 FMA peak)."""
    import pyiga_tpu_torch
    from pyiga_tpu_torch import _cuda
    from pyiga_tpu_torch.ops import cuda_vform as cv
    dtype = pyiga_tpu_torch.get_dtype()
    f32 = dtype == torch.float32
    plan = asm._fold_plan or [(t, False) for t in range(len(asm.combos))]
    prog = asm._program([asm.combos[t] for t, _m in plan], dtype)
    adj = prog.adjoint()
    arrays = asm.device_arrays()
    grid = tuple(w.shape[0] for w in arrays['weights'])
    rng = np.random.RandomState(seed)
    g = torch.as_tensor(rng.rand(len(prog.outputs), *grid) - 0.5,
                        dtype=dtype, device=device)
    t0 = time.perf_counter()
    grads, gp = adj.launch(arrays, g)
    build_s = time.perf_counter() - t0
    rg, rp = cv.run_adjoint_plain(prog, arrays, g)
    sync(device)

    def flat(gr, p):
        return [gr[k] for k in prog.sources] + ([p] if p is not None
                                                else [])
    got, ref = flat(grads, gp), flat(rg, rp)
    label = '%s %s' % (adj.counter, name)
    err, rel = compare_all(label, got, ref, tol)
    check_repeat_all(label, lambda: flat(*adj.launch(arrays, g)), got)
    if f32:
        tf32_unchanged(label, lambda: flat(*adj.launch(arrays, g)) + flat(
            *cv.run_adjoint_plain(prog, arrays, g)), got + ref)
    lib = [k for k in _cuda.GEN_BUILDS if re.search(
        r'lib%s_[0-9a-f]{16}\.so$' % adj.counter, k)][-1]
    build = dict(_cuda.GEN_BUILDS[lib], path=lib)
    for line in build['log'].splitlines():
        if 'registers' in line or 'spill' in line:
            log('  ' + line.strip())
    N = g[0].numel()
    rows = {s for s in adj.program.leaf_src if s is not None}
    read = g.element_size() * (
        len(rows) * N + sum(w.numel() for w in arrays['weights'])
        + (arrays['params'].numel() if adj.program.params else 0))
    shape = adj.shape(math.prod(grid[:-1]), grid[-1])
    bare = adjoint_bare_times(adj, arrays, g, device)
    rec = dict(max_abs_err=err, rel=rel, instrs=len(prog.instrs),
               adjoint_instrs=len(adj.program.instrs),
               targets=len(adj.src_targets),
               params=len(adj.param_targets), first_call_s=build_s,
               repeat_equal=True, build=build, grid=list(grid),
               shape=dict(zip(('rows', 'threads', 'rb', 'blocks'), shape)),
               ms=time_ms(lambda: adj.launch(arrays, g), device),
               host_ms=host_ms(lambda: adj.launch(arrays, g), device),
               device_ms=graph_ms(lambda i: adj.launch(arrays, g), device),
               kernel_ms=bare['device_ms'],
               kernel_launch_ms=bare['launch_ms'],
               plain_ms=time_ms(lambda: cv.run_adjoint_plain(prog, arrays,
                                                             g), device,
                                reps=3),
               library_ms=None, tf32_on_unchanged=f32 or None,
               **bound(read + nbytes(*got), len(adj.program.instrs) * N,
                       F32_PER_MS if f32 else F64_FMA_PER_MS))
    log('  %s: %d forward + %d adjoint SSA instrs, %d rows, %d '
        'params; %s; nvcc %.2f s' % (label, len(prog.instrs),
                                     len(adj.program.instrs),
                                     len(adj.src_targets),
                                     len(adj.param_targets), rec['shape'],
                                     build['seconds']))
    return rec


def stage_bwd_case(name, tables, idx, g, device, tol=1e-13):
    """K2-/K3-bwd (``stage_bwd_kernel``, or for float32 operands
    ``stage_bwd_f32_kernel`` of ``csrc/sumfac_f32.cu``, its plan logged:
    tile, chunks of M, blocks and waves) of the terms `idx` over `tables`
    against ``fold_bwd_plain`` (`tol` relative, bitwise on a repeat, in
    float32 also bitwise unchanged with torch's global TF32 on; one table
    through ``stage_bwd``), its ms, the plain version's, one
    ``torch.matmul`` of the distinct tables concatenated (TF32 off) and
    the bound: the distinct tables and `g` read once, ``(G, K, R)``
    written once, 2 K R M operations a table at the f64 tensor cores' or
    the f32 FMA units' peak (both 67 TFLOP/s)."""
    from pyiga_tpu_torch import _cuda
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    R, M = g.shape
    K = tables[0].shape[1]
    if len(idx) == 1:
        T = tables[idx[0]]

        def run():
            return [cs.stage_bwd(T, g)]

        def plain():
            return [cs.stage_bwd_plain(T, g)]
    else:
        def run():
            return cs.fold_bwd(tables, idx, g)

        def plain():
            return cs.fold_bwd_plain(tables, idx, g)
    f32 = g.dtype == torch.float32
    label = 'stage_bwd%s %s' % (' f32' if f32 else '', name)
    got, ref = run(), plain()
    sync(device)
    err, rel = compare_all(label, got, ref, tol)
    check_repeat_all(label, run, got)
    if f32:
        tf32_unchanged(label, lambda: run() + plain(), got + ref)
    used = [tables[i] for i in dict.fromkeys(idx)]
    tcat = torch.cat(used, dim=1).t().contiguous()
    rec = dict(max_abs_err=err, rel=rel, shape=[K, R, M], terms=len(idx),
               tables=len(used), repeat_equal=True,
               tf32_on_unchanged=f32 or None,
               ms=time_ms(run, device), plain_ms=time_ms(plain, device),
               library_ms=time_ms(lambda: torch.matmul(tcat, g.t()), device),
               **bound(nbytes(g, *used) + g.element_size() * K * R
                       * len(used), 2 * K * R * M * len(used),
                       F32_PER_MS if f32 else F64_TENSOR_PER_MS))
    plan = ''
    if f32:
        p = cs.stage_bwd_f32_plan(K, R, M, len(used), _cuda.sm_count(g),
                                  cs.stage_bwd_f32_tiles(_cuda.library()))
        rec['plan'] = {k: p[k] for k in ('bk', 'br', 'chunks', 'blocks',
                                         'waves')}
        plan = '; tile %d x %d, S %d, %d blocks, %.2f waves' % (
            p['bk'], p['br'], p['chunks'], p['blocks'], p['waves'])
    log('  %-24s (K, R, M) = (%d, %d, %d), %d tables: %.4f ms '
        '(plain %.4f, matmul %.4f, bound %.4f, %.0f %%)%s'
        % (label, K, R, M, len(used), rec['ms'], rec['plain_ms'],
           rec['library_ms'], rec['bound_ms'],
           100 * rec['bound_ms'] / rec['ms'], plan))
    del got, ref, tcat
    return rec


def fold_bwd_tables(asm):
    """The final tables of `asm`'s compact chains as its fold's backward
    reads them: the distinct tables in order of first use and each term's
    index among them."""
    cops = asm._compact_operands()
    last = [cops['last_idx'][t] for t, _m in cops['plan']]
    first = {}
    for t, _m in cops['plan']:
        first.setdefault(cops['last_idx'][t], t)
    slot = {i: s for s, i in enumerate(first)}
    return ([cops['term_tables'][t][-1] for t in first.values()],
            [slot[i] for i in last])


def stage_bwd_f32_edges(rand, device, tol):
    """Phase 20f's edge cases of ``stage_bwd_f32_kernel``, each a
    :func:`stage_bwd_case`: 16 tables in one launch at an odd R, M < 16,
    an odd R, g and a table 4 bytes off their 16-byte alignment (the
    tables' 4-byte copies), K = 1, and a split of M whose last chunk is
    short (M = 1,001 over 15 chunks)."""
    def shifted(*shape):
        buf = rand(int(np.prod(shape)) + 1)
        return buf[1:].view(*shape)
    return {
        '16 tables': stage_bwd_case(
            '16 tables', [rand(345, 192) for _ in range(16)],
            list(range(16)), rand(4097, 345), device, tol=tol),
        'M < 16': stage_bwd_case('M < 16', [rand(5, 64)], [0],
                                 rand(300, 5), device, tol=tol),
        'odd R': stage_bwd_case('odd R', [rand(345, 192)], [0],
                                rand(4097, 345), device, tol=tol),
        'g, T 4 bytes off': stage_bwd_case(
            'g, T 4 bytes off', [shifted(345, 192)], [0],
            shifted(1000, 345), device, tol=tol),
        'K = 1': stage_bwd_case('K = 1', [rand(40, 1)], [0], rand(999, 40),
                                device, tol=tol),
        'short last chunk': stage_bwd_case(
            'short last chunk', [rand(1001, 64)], [0], rand(130, 1001),
            device, tol=tol),
    }


def check_diff_kernels(device, n3=48, n2=128, dtype=torch.float64):
    """Phase 20a (float64) and 20f (float32, under ``set_dtype``): each
    backward kernel against its plain version on the card at the
    forward's phase shapes, bitwise on a second launch, at most 1e-13
    (float64) or :data:`DIFF_F32_TOL` (float32, also bitwise unchanged
    with torch's global TF32 on) relative: K1's backward of the stiffness
    and mass kinds on the 3D p=3 n=48 twisted box, of the ``jac`` kind
    there, on the 2D n=128 NURBS quarter annulus, on a surface (G = 3,
    n=128) and on the 'left' face's boundary grid of the extruded annulus
    at n=48 (QL = 1); K2's and K3's backward (:func:`stage_bwd_case`) at
    the headline's compact chain (the two stage shapes, and the fold's
    terms over their distinct tables in one launch, R = M^2), at 2D
    n=128's stage shape (512, 512, 905), on the 2D n=128 stiffness
    gradient's fold (512, 905, 905) over its distinct final tables, on a
    ragged fold (K = 33, R = 1,001, M = 7, 3 terms over 2 tables) and, in
    float32, on :func:`stage_bwd_f32_edges`; the generated K5 adjoint on
    convection-diffusion, on :data:`NONLINEAR` and on the biharmonic at
    2D n=128, and on ``inner(grad(u), grad(v)) * ds`` on the 'left'
    face's boundary grid of the extruded annulus at 3D n=48 (QL = 1).
    Float32 also checks the SASS of every float32 backward instance and
    generated float32 adjoint library for float64 instructions
    (:func:`sass_f64_free`).  The records' keys are the kernels' launch
    counters (``_f32`` for float32)."""
    from pyiga_tpu_torch import _cuda, geometry
    from pyiga_tpu_torch.assemblers import StiffnessAssembler
    from pyiga_tpu_torch.assemble import instantiate_assembler
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    f32 = dtype == torch.float32
    sfx = '_f32' if f32 else ''
    tol = DIFF_F32_TOL if f32 else 1e-13
    out = {}
    with ComputeDtype(dtype):
        asm = main_path_setup(3, n3, device)
        args = spline_partials(asm)
        out['fields_bwd' + sfx] = fields_bwd_case(
            'stiffness', *args, device, '3D n=%d' % n3, 1, tol=tol)
        out['mass_fields_bwd' + sfx] = fields_bwd_case(
            'mass', *args, device, '3D n=%d' % n3, 2, tol=tol)
        jac = {'volume_n48': fields_bwd_case(
            'jac', args[0], args[1], None, None, args[4], device,
            '3D n=%d' % n3, 10, tol=tol)}
        del args
        a2 = StiffnessAssembler(kvs_of(2, n2), geometry.quarter_annulus(),
                                device=device)
        fold2 = fold_bwd_tables(a2)
        Y, T, _w12, _wL, nurbs = spline_partials(a2)
        jac['annulus_n128'] = fields_bwd_case(
            'jac', Y, T, None, None, nurbs, device, 'annulus n=%d' % n2, 3,
            tol=tol)
        surf = surface_vf(device, n=n2)
        ops = surf._device_operands()
        Y, _ = cs.geo_stage12(ops['geo_tables'], ops['geo_coeffs'], 2)
        T = ops['geo_tables'][1][:2].contiguous()
        jac['surface_n128'] = fields_bwd_case(
            'jac', Y, T, None, None, surf._geo_is_nurbs, device,
            'surface n=%d' % n2, 4, tol=tol)
        # a boundary Gauss grid: the 'left' face of the extruded annulus,
        # its last axis one point (no sum over it)
        face = surface_asm('v * ds', 3, n3, device, boundary='left')
        ops = face._device_operands()
        Y, _ = cs.geo_stage12(ops['geo_tables'], ops['geo_coeffs'], 3)
        T = ops['geo_tables'][2][:2].contiguous()
        jac['face_left_n48'] = fields_bwd_case(
            'jac', Y, T, None, None, face._geo_is_nurbs, device,
            'face left n=%d' % n3, 11, tol=tol)
        out['geo_jac_fields_bwd' + sfx] = dict(jac['annulus_n128'],
                                               cases=jac)
        del Y, T, a2, surf, ops, face

        # K2's and K3's backward: the headline's compact chain, 2D n=128's
        # stage shape and a ragged fold
        rng = np.random.RandomState(5)

        def rand(*shape):
            return torch.as_tensor(rng.rand(*shape) - 0.5, dtype=dtype,
                                   device=device)
        cops = asm._compact_operands()
        tabs = cops['term_tables'][0]
        M, K = tabs[0].shape
        cases = {}
        for name, Tt, R in (('n%d R=%d' % (n3, K * K), tabs[0], K * K),
                            ('n%d R=%d' % (n3, K * M), tabs[1], K * M),
                            ('2D n=%d' % n2, rand(905, 512), 512)):
            cases[name] = stage_bwd_case(name, [Tt], [0],
                                         rand(R, Tt.shape[0]), device,
                                         tol=tol)
        ftabs, fidx = fold_bwd_tables(asm)
        fold_rec = stage_bwd_case('fold n=%d' % n3, ftabs, fidx,
                                  rand(M * M, M), device, tol=tol)
        # the 2D n=128 stiffness gradient's fold: (K, R, M) = (512, 905,
        # 905) over its distinct final tables
        M2 = fold2[0][0].shape[0]
        cases['2D fold n=%d' % n2] = stage_bwd_case(
            '2D fold n=%d' % n2, *fold2, rand(M2, M2), device, tol=tol)
        del fold2
        cases['ragged fold'] = stage_bwd_case(
            'ragged fold', [rand(7, 33), rand(7, 33)], [1, 0, 1],
            rand(1001, 7), device, tol=tol)
        if f32:
            cases.update(stage_bwd_f32_edges(rand, device, tol))
        both = list(cases.values())[:2]         # the n=48 stage shapes
        out['stage_bwd' + sfx] = dict(
            {k: sum(r[k] for r in both) for k in ('ms', 'plain_ms',
                                                  'library_ms')},
            max_abs_err=max(r['max_abs_err'] for r in cases.values()),
            rel=max(r['rel'] for r in cases.values()), repeat_equal=True,
            tf32_on_unchanged=f32 or None,
            shapes=[r['shape'] for r in both], cases=cases,
            **bound(sum(r['bound_bytes'] for r in both),
                    sum(r['bound_flops'] for r in both),
                    F32_PER_MS if f32 else F64_TENSOR_PER_MS))
        out['fold_bwd' + sfx] = fold_rec
        del tabs, ftabs, asm, cops

        adj = {}
        _kvs, _geo, conv, _f = convdiff_setup(n2, device)
        adj['convdiff_n128'] = adjoint_case(conv, device, 'convdiff', 6,
                                            tol=tol)
        w = geometry.BSplineFunc(kvs_of(2, n2), np.random.RandomState(
            7).rand(n2 + 3, n2 + 3))
        nl = instantiate_assembler(NONLINEAR, kvs_of(2, n2), {
            'geo': geometry.quarter_annulus(), 'w': w}, None, device=device)
        adj['nonlinear_n128'] = adjoint_case(nl, device, 'nonlinear', 8,
                                             tol=tol)
        bih = instantiate_assembler(BIHARMONIC, kvs_of(2, n2), {
            'geo': geometry.quarter_annulus()}, None, device=device)
        adj['biharmonic_n128'] = adjoint_case(bih, device, 'biharmonic', 9,
                                              tol=tol)
        # a boundary Gauss grid (QL = 1): the rows mapping
        face = surface_asm('inner(grad(u), grad(v)) * ds', 3, n3, device,
                           boundary='left')
        adj['gradgrad_ds_left_n48'] = adjoint_case(
            face, device, 'gradgrad ds left', 12, tol=tol)
        del face, conv, nl, bih
        key = 'vform_adjoint' + sfx
        out[key] = dict(adj['convdiff_n128'], cases=adj)
        out[key]['max_abs_err'] = max(r['max_abs_err'] for r in adj.values())
    torch.cuda.empty_cache()
    log('  nvcc of the %s adjoints: %s s' % (dtype, {
        k: round(r['build']['seconds'], 2) for k, r in adj.items()}))
    if f32:
        gen = [k for k in _cuda.GEN_BUILDS
               if os.path.basename(k).startswith('libvform_adjoint_f32_')]
        out['sass_f64_free'] = sass_f64_free(
            _cuda.BUILD_INFO['path'], gen, SASS_DIFF_F32,
            ('vform_adjoint_kernel', 'vform_param_sum_kernel'))
    for k in (DIFF_F32_KERNELS if f32 else DIFF_F64_KERNELS):
        r = out[k]
        log('  %-22s kernel %.4f ms   device %s   plain %.4f ms   library '
            '%s   bound %.4f ms (%s)'
            % (k, r['ms'], '%.4f ms' % r['device_ms']
               if 'device_ms' in r else '-', r['plain_ms'],
               'none' if r['library_ms'] is None
               else '%.4f ms' % r['library_ms'], r['bound_ms'],
               r['bound_by']))
    for k in ('geo_jac_fields_bwd' + sfx, 'vform_adjoint' + sfx):
        for c, r in out[k]['cases'].items():
            log('    %s %s: %.4f ms (%s%splain %.4f, bound %.4f)'
                % (k, c, r['ms'], 'device %.4f, ' % r['device_ms']
                   if 'device_ms' in r else '',
                   'kernel %.4f, host %.4f, ' % (r['kernel_ms'], r['host_ms'])
                   if 'kernel_ms' in r else '', r['plain_ms'],
                   r['bound_ms']))
    return out


class PlainKernels:
    """A context in which the kernel wrappers of the differentiable path
    run their plain PyTorch versions on the card (K1's kinds, K2, K3 and
    K5), so that autograd differentiates plain torch: the reference the
    kernels' gradients are held to."""

    def __enter__(self):
        from pyiga_tpu_torch.ops import cuda_sumfac as cs
        from pyiga_tpu_torch.ops import cuda_vform as cv
        self.saved = [(cs, k, getattr(cs, k)) for k in (
            'stage', 'fold', 'fields', 'fields_mass', 'geo_jac_fields')]
        self.saved.append((cv, 'combo_fields', cv.combo_fields))
        cs.stage, cs.fold = cs.stage_plain, cs.fold_plain
        cs.fields, cs.fields_mass = cs.fields_plain, cs.fields_mass_plain
        cs.geo_jac_fields = cs.geo_jac_fields_plain
        cv.combo_fields = cv.combo_fields_plain
        return self

    def __exit__(self, *exc):
        for mod, k, fn in self.saved:
            setattr(mod, k, fn)
        return False


def grad_case(name, fn, x0, device, seed, fd_dirs=3, h=1e-4, fd_tol=1e-6):
    """The gradient of ``sum(w * fn(x))`` (w seeded) at `x0` on the card:
    the forward's and the backward's ms (host clock after a synchronize,
    the backward's launches counted), held against autograd through the
    plain versions on the card (1e-12 relative) and against central
    differences on `fd_dirs` seeded directions (`fd_tol` relative)."""
    from pyiga_tpu_torch import _cuda
    f64 = torch.float64
    x = torch.as_tensor(np.asarray(x0, dtype=float), dtype=f64,
                        device=device)
    with torch.no_grad():
        shape = fn(x).shape
    rng = np.random.RandomState(seed)
    w = torch.as_tensor(rng.rand(*shape), dtype=f64, device=device)

    def fwd_bwd():
        xr = x.clone().requires_grad_(True)
        sync(device)
        t0 = time.perf_counter()
        out = fn(xr)
        obj = (w * out).sum()
        sync(device)
        t1 = time.perf_counter()
        before = dict(_cuda.LAUNCHES)
        g, = torch.autograd.grad(obj, xr)
        sync(device)
        t2 = time.perf_counter()
        return out.detach(), g, 1e3 * (t1 - t0), 1e3 * (t2 - t1), \
            {k: v - before[k] for k, v in _cuda.LAUNCHES.items()
             if v != before[k]}
    fwd_bwd()                           # builds, warms
    fwd_ms, bwd_ms = [], []
    for _ in range(3):
        out, g, tf, tb, launches = fwd_bwd()
        fwd_ms.append(tf)
        bwd_ms.append(tb)
    again = fwd_bwd()[1]
    if not torch.equal(again, g):
        raise RuntimeError('%s: two backward passes differ' % name)
    with PlainKernels():
        xr = x.clone().requires_grad_(True)
        gp, = torch.autograd.grad((w * fn(xr)).sum(), xr)
    err, rel = compare(name + ' grad', g, gp, 1e-12)
    fd = []
    with torch.no_grad():
        for k in range(fd_dirs):
            v = torch.as_tensor(rng.rand(*x.shape) - 0.5, dtype=f64,
                                device=device)
            v = v / v.abs().max()
            num = (float((w * fn(x + h * v)).sum())
                   - float((w * fn(x - h * v)).sum())) / (2 * h)
            ana = float((g * v).sum())
            fd.append(dict(fd=num, grad=ana, rel=abs(num - ana) / abs(ana)))
            log('  %s direction %d: grad.v %.10e  FD %.10e  rel %.2e'
                % (name, k, ana, num, fd[-1]['rel']))
            if not fd[-1]['rel'] <= fd_tol:
                raise RuntimeError('%s: gradient disagrees with central '
                                   'differences' % name)
    rec = dict(shape=list(shape), x_shape=list(x.shape), max_abs_err=err,
               rel=rel, fd=fd, forward_ms=fwd_ms, backward_ms=bwd_ms,
               launches_backward=launches, repeat_equal=True)
    log('  %s: forward %s ms, backward %s ms, backward launches %s'
        % (name, ['%.2f' % t for t in fwd_ms], ['%.2f' % t for t in bwd_ms],
           launches))
    return rec


def run_diff_gradients(device, n3=48, n2=128):
    """Phase 20b: ``assembly_coeff_fn`` on the headline's
    ``StiffnessAssembler`` at 3D p=3 n=48 (132,651 dofs): ``fn(coeffs0)``
    bitwise equal to ``run_device()``, the gradient of ``sum(w * A)``
    against autograd through the plain versions on the card and against
    central differences on 3 seeded directions; the same for the mass
    assembler at 3D n=48 and the convection-diffusion VForm at 2D n=128
    (the ``jac`` kind's and K5's backward on the path)."""
    from pyiga_tpu_torch.assemblers import MassAssembler
    from pyiga_tpu_torch.diff import assembly_coeff_fn
    rec = {}
    asm = main_path_setup(3, n3, device)
    fn, c0 = assembly_coeff_fn(asm)
    with torch.no_grad():
        if not torch.equal(fn(c0), asm.run_device()):
            raise RuntimeError('fn(coeffs0) differs from run_device()')
    log('  fn(coeffs0) == run_device(): bitwise')
    rec['stiffness_3d'] = grad_case('stiffness 3D n=%d' % n3, fn, c0,
                                    device, 11)
    del asm, fn
    masm = MassAssembler(kvs_of(3, n3), main_geo(3), device=device)
    fn, c0 = assembly_coeff_fn(masm)
    rec['mass_3d'] = grad_case('mass 3D n=%d' % n3, fn, c0, device, 12,
                               fd_dirs=1)
    del masm, fn
    _kvs, _geo, conv, _f = convdiff_setup(n2, device)
    fn, c0 = assembly_coeff_fn(conv)
    with torch.no_grad():
        if not torch.equal(fn(c0), conv.run_device()[(None, None)]):
            raise RuntimeError('VForm fn(coeffs0) differs from run_device()')
    rec['convdiff_2d'] = grad_case('convdiff 2D n=%d' % n2, fn, c0, device,
                                   13, fd_dirs=1)
    return rec


def main_geo(dim):
    from pyiga_tpu_torch import geometry
    return geometry.twisted_box() if dim == 3 else geometry.quarter_annulus()


def run_diff_compliance(device, n=48):
    """Phase 20c: the compliance ``f^T u`` with ``A(c) u = f`` at 3D p=3
    n=48 through ``implicit_cg_solve`` over ``RestrictedOperator(
    MLMatvecOperator(fn(c)))`` with the weighted fast-diagonalization
    preconditioner (built from the assembler, no history): its
    directional derivative against a central difference, the forward and
    adjoint CG iterations and ms."""
    from pyiga_tpu_torch.diff import assembly_coeff_fn, implicit_cg_solve
    from pyiga_tpu_torch.ops.fastdiag import (fastdiag_precond_weighted,
                                              interior_dofs)
    from pyiga_tpu_torch.ops.matfree import RestrictedOperator
    from pyiga_tpu_torch.ops.mlmatvec import MLMatvecOperator
    f64 = torch.float64
    asm = main_path_setup(3, n, device)
    fn, c0 = assembly_coeff_fn(asm)
    free = interior_dofs(asm.kvs)
    P = fastdiag_precond_weighted(asm, dirichlet=True, dtype=f64)
    rng = np.random.RandomState(14)
    f = torch.as_tensor(rng.rand(len(free)), dtype=f64, device=device)
    calls = {'n': 0}

    def compliance(c):
        op = RestrictedOperator(MLMatvecOperator(fn(c), asm.structure), free)

        def matvec(x):
            calls['n'] += 1
            return op(x)
        return torch.dot(f, implicit_cg_solve(matvec, f, tol=1e-13,
                                              precond=P))

    x = torch.as_tensor(c0, dtype=f64, device=device)
    compliance(x.clone())               # warm
    xr = x.clone().requires_grad_(True)
    sync(device)
    calls['n'] = 0
    t0 = time.perf_counter()
    J = compliance(xr)
    sync(device)
    t1 = time.perf_counter()
    fwd_calls = calls['n']
    g, = torch.autograd.grad(J, xr)
    sync(device)
    t2 = time.perf_counter()
    adj_calls = calls['n'] - fwd_calls
    v = torch.as_tensor(rng.rand(*x.shape) - 0.5, dtype=f64, device=device)
    v = v / v.abs().max()
    h = 1e-4
    with torch.no_grad():
        num = (float(compliance(x + h * v))
               - float(compliance(x - h * v))) / (2 * h)
    ana = float((g * v).sum())
    rel = abs(num - ana) / abs(ana)
    # forward: the CG iterations, then two matvecs for the residuals of
    # the implicit terms (the tangent's and the adjoint's); adjoint: the
    # CG iterations
    J = float(J.detach())
    rec = dict(compliance=J, forward_ms=1e3 * (t1 - t0),
               backward_ms=1e3 * (t2 - t1), forward_cg_iters=fwd_calls - 2,
               adjoint_cg_iters=adj_calls, fd=num, grad_v=ana, rel=rel,
               free_dofs=len(free))
    log('  compliance %.12e: forward %.1f ms (%d CG iterations), backward '
        '%.1f ms (%d adjoint CG iterations); grad.v %.10e FD %.10e rel '
        '%.2e' % (J, rec['forward_ms'], rec['forward_cg_iters'],
                  rec['backward_ms'], adj_calls, ana, num, rel))
    if not (np.isfinite(J) and rel <= 1e-6):
        raise RuntimeError('compliance derivative disagrees with central '
                           'differences')
    return rec


def run_diff_inputs(device, n=128):
    """Phase 20d: ``assembly_input_fn`` at 2D p=3 n=128 on the NURBS
    quarter annulus for ``(c * inner(grad(u), grad(v)) + eps *
    dot(grad(c), grad(u)) * v) * dx``: the gradient with respect to the
    spline input ``c`` (its values and first derivatives recomputed from
    its coefficients) and to the parameter ``eps``, each against autograd
    through the plain versions on the card and a central difference."""
    from pyiga_tpu_torch import approx, geometry
    from pyiga_tpu_torch.assemble import instantiate_assembler
    from pyiga_tpu_torch.diff import assembly_input_fn
    kvs = kvs_of(2, n)
    c = geometry.BSplineFunc(kvs, approx.interpolate(
        kvs, lambda x, y: 1.0 + x * y))
    asm = instantiate_assembler(
        '(c * inner(grad(u), grad(v)) + eps * dot(grad(c), grad(u)) * v)'
        ' * dx', kvs, {'geo': geometry.quarter_annulus(), 'c': c,
                       'eps': 0.7}, None, device=device)
    rec = {}
    fn, x0 = assembly_input_fn(asm, 'c')
    with torch.no_grad():
        d0 = fn(x0)
        ref = asm.run_device()[(None, None)]
    rel0 = float((d0 - ref).abs().max() / ref.abs().max())
    log('  fn(c0) against run_device(): rel %.2e' % rel0)
    if rel0 > 1e-13:
        raise RuntimeError('assembly_input_fn(c) differs from run_device()')
    rec['input_c'] = grad_case('input c 2D n=%d' % n, fn, x0, device, 15,
                               fd_dirs=1)
    fn, x0 = assembly_input_fn(asm, 'eps')
    rec['param_eps'] = grad_case('param eps 2D n=%d' % n, fn, x0, device,
                                 16, fd_dirs=1)
    return rec


def run_diff_examples(device):
    """Phase 20e: ``examples/torch_shape_derivative.py`` and
    ``examples/torch_nonlinear_poisson.py`` at their default sizes on the
    card against the CPU: compliance histories and Newton residual norms
    (1e-10) and ``max |u|`` (1e-12)."""
    rec = {}
    sd = load_example('torch_shape_derivative')
    t0 = time.perf_counter()
    hist = sd.main(device=device)
    rec['shape_derivative_s'] = time.perf_counter() - t0
    hist_cpu = sd.main(device='cpu')
    rel = max(abs(a - b) / abs(b) for a, b in zip(hist, hist_cpu))
    rec['shape_derivative'] = dict(history=hist, cpu=hist_cpu, rel=rel)
    log('  shape derivative: compliance %s, card vs CPU rel %.2e'
        % (['%.10f' % h for h in hist], rel))
    if len(hist) != len(hist_cpu) or rel > 1e-10:
        raise RuntimeError('torch_shape_derivative: card differs from CPU')
    nlp = load_example('torch_nonlinear_poisson')
    t0 = time.perf_counter()
    norms, umax = nlp.main(device=device)
    rec['nonlinear_poisson_s'] = time.perf_counter() - t0
    norms_cpu, umax_cpu = nlp.main(device='cpu')
    rec['nonlinear_poisson'] = dict(norms=norms, cpu=norms_cpu, umax=umax,
                                    umax_cpu=umax_cpu)
    log('  nonlinear Poisson: %d residuals (CPU %d), max |u| %.12f (CPU '
        '%.12f)' % (len(norms), len(norms_cpu), umax, umax_cpu))
    if len(norms) != len(norms_cpu) \
            or not np.allclose(norms, norms_cpu, rtol=1e-10, atol=1e-10) \
            or abs(umax - umax_cpu) > 1e-12 * abs(umax_cpu):
        raise RuntimeError('torch_nonlinear_poisson: card differs from CPU')
    return rec


def run_diff_phase(device, n3=48, n2=128, examples=True):
    """Phases 20b-20e with the launch counts set to 0 before each and
    read after: the differentiable path's launches of every kernel."""
    from pyiga_tpu_torch import _cuda
    rec = {}
    totals = dict.fromkeys(_cuda.LAUNCHES, 0)
    phases = [('20b', lambda: run_diff_gradients(device, n3, n2)),
              ('20c', lambda: run_diff_compliance(device, n3)),
              ('20d', lambda: run_diff_inputs(device, n2))]
    if examples:
        phases.append(('20e', lambda: run_diff_examples(device)))
    for ph, fn in phases:
        log('phase %s' % ph)
        _cuda.reset_launches()
        t0 = time.perf_counter()
        rec[ph] = fn()
        rec[ph + '_s'] = time.perf_counter() - t0
        rec[ph + '_launches'] = dict(_cuda.LAUNCHES)
        log('  phase %s backward launches: %s'
            % (ph, {k: _cuda.LAUNCHES[k] for k in DIFF_F64_KERNELS}))
        for k, v in _cuda.LAUNCHES.items():
            totals[k] += v
        torch.cuda.empty_cache()
    rec['launches'] = totals
    log('  phase 20 launches: %s' % {k: v for k, v in totals.items() if v})
    missing = [k for k in DIFF_F64_KERNELS if totals[k] <= 0]
    if missing:
        raise RuntimeError('the differentiable path never launched %s'
                           % missing)
    return rec


################################################################################
# The differentiable assembly in float32 (phases 20f, 20g)
################################################################################

def check_diff_f32_kernels(device, n3=48, n2=128):
    """Phase 20f: :func:`check_diff_kernels` in float32: K1-bwd f32,
    K2-/K3-bwd f32 and the float32 K5 adjoint at phase 20a's shapes, and
    no float64 instruction in their SASS."""
    return check_diff_kernels(device, n3, n2, dtype=torch.float32)


def event_ms(fn, device):
    """`fn()`'s result and its milliseconds by CUDA events (host clock
    on the CPU)."""
    if device.type != 'cuda':
        t0 = time.perf_counter()
        res = fn()
        return res, 1e3 * (time.perf_counter() - t0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = fn()
    end.record()
    end.synchronize()
    return res, start.elapsed_time(end)


def grad_f32(fn, x0, w, device, reps=3):
    """The value of ``fn(x)`` and the gradient of ``sum(w * fn(x))`` at
    `x0` (a float64 leaf, as a caller passes coefficients) in the compute
    dtype, with the forward's and the backward's ms by CUDA events over
    `reps` runs after a warm one; the last run's value and gradient."""
    x = torch.as_tensor(np.asarray(x0, dtype=float), dtype=torch.float64,
                        device=device)
    fwd, bwd = [], []
    for r in range(reps + 1):
        xr = x.clone().requires_grad_(True)
        sync(device)
        out, tf = event_ms(lambda: fn(xr), device)
        wt = torch.as_tensor(w, dtype=out.dtype, device=device)
        (g,), tb = event_ms(lambda: torch.autograd.grad(
            (wt * out).sum(), xr), device)
        if r:
            fwd.append(tf)
            bwd.append(tb)
    return out.detach(), g, fwd, bwd


def diff_f32_problems(device, n3, n2, only=None):
    """Phase 20g's problems on `device` (all, or the one named `only`):
    ``{name: (fn, x0)}`` under the current dtype: the 3D p=3 n=`n3`
    twisted-box stiffness and mass (shape gradients, 20b), and at 2D p=3
    n=`n2` on the NURBS quarter annulus the convection-diffusion form's
    shape gradient and its parameter ``b``, and 20d's form's input ``c``
    and parameter ``eps``."""
    from pyiga_tpu_torch import approx, geometry
    from pyiga_tpu_torch.assemblers import MassAssembler, StiffnessAssembler
    from pyiga_tpu_torch.assemble import instantiate_assembler
    from pyiga_tpu_torch.diff import assembly_coeff_fn, assembly_input_fn
    made = {}

    def conv():
        if 'conv' not in made:
            made['conv'] = convdiff_setup(n2, device)[2]
        return made['conv']

    def inp():
        if 'inp' not in made:
            kvs = kvs_of(2, n2)
            c = geometry.BSplineFunc(kvs, approx.interpolate(
                kvs, lambda x, y: 1.0 + x * y))
            made['inp'] = instantiate_assembler(
                '(c * inner(grad(u), grad(v)) + eps * dot(grad(c), '
                'grad(u)) * v) * dx', kvs, {
                    'geo': geometry.quarter_annulus(), 'c': c, 'eps': 0.7},
                None, device=device)
        return made['inp']
    build = {
        'stiffness_3d': lambda: assembly_coeff_fn(StiffnessAssembler(
            kvs_of(3, n3), main_geo(3), device=device)),
        'mass_3d': lambda: assembly_coeff_fn(MassAssembler(
            kvs_of(3, n3), main_geo(3), device=device)),
        'convdiff_shape_2d': lambda: assembly_coeff_fn(conv()),
        'convdiff_b_2d': lambda: assembly_input_fn(conv(), 'b'),
        'input_c_2d': lambda: assembly_input_fn(inp(), 'c'),
        'param_eps_2d': lambda: assembly_input_fn(inp(), 'eps')}
    return {name: make() for name, make in build.items()
            if only is None or name == only}


# phase 20g's problems held to a plain run on the CPU (the others to the
# plain versions on the card, as phase 20b)
DIFF_F32_ON_CPU = ('stiffness_3d', 'convdiff_b_2d', 'input_c_2d',
                   'param_eps_2d', 'convdiff_shape_2d')


def run_diff_f32(device, n3=48, n2=128):
    """Phase 20g: the differentiable assembly under ``set_dtype(float32)``
    on the card (:func:`diff_f32_problems`): every gradient's forward and
    backward ms by CUDA events, with the launch counts set to 0 before
    the float32 runs and read after them (no float64 kernel may launch,
    each float32 backward kernel must); the second run bitwise the first.
    Then each value and gradient against a plain run of the same inputs
    (:data:`DIFF_F32_ON_CPU` on the CPU, the others through the plain
    versions on the card: at most 2e-5 relative) and against the port's
    float64 run on the card (at most 1e-4 relative, and not equal: it
    was computed in float32)."""
    from pyiga_tpu_torch import _cuda
    f32, f64 = torch.float32, torch.float64
    rec, res = {}, {}
    with ComputeDtype(f32):
        probs = diff_f32_problems(device, n3, n2)
        ws = {}
        for name, (fn, x0) in probs.items():      # builds, warms
            with torch.no_grad():
                ws[name] = np.random.RandomState(
                    len(ws) + 30).rand(*fn(x0).shape)
        sync(device)
        _cuda.reset_launches()
        for name, (fn, x0) in probs.items():
            res[name] = grad_f32(fn, x0, ws[name], device)
        sync(device)
        launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
        for name, (fn, x0) in probs.items():
            again = grad_f32(fn, x0, ws[name], device, reps=0)
            if not (torch.equal(again[0], res[name][0])
                    and torch.equal(again[1], res[name][1])):
                raise RuntimeError('%s: two float32 runs differ' % name)
    log('  phase 20g float32 launches: %s' % launches)
    missing = [k for k in DIFF_F32_KERNELS + POISSON_F32_KERNELS[:-1]
               + ('geo_jac_fields_f32', 'vform_fields_f32')
               if launches.get(k, 0) <= 0]
    f64k = [k for k in F64_ASSEMBLY_KERNELS + DIFF_F64_KERNELS
            if launches.get(k, 0)]
    if (missing and device.type == 'cuda') or f64k:
        raise RuntimeError('phase 20g: float32 kernels never launched %s, '
                           'float64 kernels launched %s' % (missing, f64k))
    cpu = torch.device('cpu')
    with ComputeDtype(f32):
        for name in DIFF_F32_ON_CPU:
            fn, x0 = diff_f32_problems_one(name, cpu, n3, n2)
            t0 = time.perf_counter()
            val, g, _f, _b = grad_f32(fn, x0, ws[name], cpu, reps=0)
            rec[name] = dict(reference='plain versions on the CPU',
                             reference_s=time.perf_counter() - t0)
            res[name] += (val, g)
        with PlainKernels():
            for name, (fn, x0) in probs.items():
                if name in DIFF_F32_ON_CPU:
                    continue
                val, g, _f, _b = grad_f32(fn, x0, ws[name], device, reps=0)
                rec[name] = dict(reference='plain versions on the card')
                res[name] += (val, g)
    with ComputeDtype(f64):
        for name, (fn, x0) in probs.items():
            val, g, fwd64, bwd64 = grad_f32(fn, x0, ws[name], device, reps=1)
            res[name] += (val, g)
            rec[name].update(forward_ms_f64=fwd64, backward_ms_f64=bwd64)
    for name, (val, g, fwd, bwd, pval, pg, val64, g64) in res.items():
        r = rec[name]
        r.update(value_dtype=str(val.dtype), grad_dtype=str(g.dtype),
                 forward_ms=fwd, backward_ms=bwd,
                 value_rel_plain=rel_to(val, pval), grad_rel_plain=rel_to(
                     g, pg), value_rel_f64=rel_to(val, val64),
                 grad_rel_f64=rel_to(g, g64))
        log('  %-18s forward %s ms, backward %s ms (float64 %s / %s); '
            'against %s: value %.2e grad %.2e; against float64: value %.2e '
            'grad %.2e' % (name, ['%.2f' % t for t in fwd],
                           ['%.2f' % t for t in bwd],
                           ['%.2f' % t for t in r['forward_ms_f64']],
                           ['%.2f' % t for t in r['backward_ms_f64']],
                           r['reference'], r['value_rel_plain'],
                           r['grad_rel_plain'], r['value_rel_f64'],
                           r['grad_rel_f64']))
        if not (val.dtype == f32 and g.dtype == f64
                and r['value_rel_plain'] <= 2e-5
                and r['grad_rel_plain'] <= 2e-5
                and r['value_rel_f64'] <= 1e-4 and r['grad_rel_f64'] <= 1e-4
                and not torch.equal(val, val64.float())
                and not torch.equal(g, g64)):
            raise RuntimeError('phase 20g: %s disagrees with its plain run '
                               'or its float64 run, or was not computed in '
                               'float32' % name)
    rec['launches'] = launches
    return rec


def diff_f32_problems_one(name, device, n3, n2):
    """One of :func:`diff_f32_problems` on `device` (the CPU's run builds
    only the problem it checks)."""
    return diff_f32_problems(device, n3, n2, only=name)[name]


################################################################################
# Forward mode and second derivatives (phase 26): K1-jvp, K1-hvp and K5's
# generated tangent and second-order programs
################################################################################

# the forward-mode and second-order kernels, float64 then float32 (their
# launch counters): the JAX package runs jax.jvp / jax.hessian through the
# XLA forms of K1 and K5 (pyiga_tpu/diff.py), so each entry names the TPU
# kernel whose counterpart's tangent it is
FWD_F64_KERNELS = ('fields_jvp', 'mass_fields_jvp', 'geo_jac_fields_jvp',
                   'fields_hvp', 'mass_fields_hvp', 'geo_jac_fields_hvp',
                   'vform_tangent', 'vform_second')
FWD_F32_KERNELS = tuple(k + '_f32' for k in FWD_F64_KERNELS)
FWD_KERNELS = FWD_F64_KERNELS + FWD_F32_KERNELS
_JVP = ' (its tangent; pyiga_tpu/diff.py runs jax.jvp through the XLA form)'
_HVP = (' (the tangent of its VJP; pyiga_tpu/diff.py runs jax.hessian '
        'through the XLA form)')
# K1-jvp's float64 and float32 entries are translation units of their own
_JVP_SRC = 'pyiga_tpu_torch/csrc/fields_jvp%s.cu'
for _sfx in ('', '_f32'):
    KERNELS.update({
        'fields_jvp' + _sfx: ('cuda', _JVP_SRC % _sfx,
                              'pyiga_tpu/ops/pallas_sumfac.py:1087' + _JVP),
        'mass_fields_jvp' + _sfx: ('cuda', _JVP_SRC % _sfx,
                                   'pyiga_tpu/ops/pallas_sumfac.py:1087'
                                   + _JVP),
        'geo_jac_fields_jvp' + _sfx: ('cuda', _JVP_SRC % _sfx,
                                      'pyiga_tpu/ops/pallas_sumfac.py:1087'
                                      + _JVP),
        'fields_hvp' + _sfx: ('cuda', 'pyiga_tpu_torch/csrc/fields_hvp.cu',
                              'pyiga_tpu/ops/pallas_sumfac.py:1087' + _HVP),
        'mass_fields_hvp' + _sfx: ('cuda',
                                   'pyiga_tpu_torch/csrc/fields_hvp.cu',
                                   'pyiga_tpu/ops/pallas_sumfac.py:1087'
                                   + _HVP),
        'geo_jac_fields_hvp' + _sfx: ('cuda',
                                      'pyiga_tpu_torch/csrc/fields_hvp.cu',
                                      'pyiga_tpu/ops/pallas_sumfac.py:1087'
                                      + _HVP),
        # CUDA C generated per form and tangent mask, beside the adjoint's
        'vform_tangent' + _sfx: ('cuda', 'pyiga_tpu_torch/ops/cuda_vform.py',
                                 'pyiga_tpu/compile.py:974' + _JVP),
        'vform_second' + _sfx: ('cuda', 'pyiga_tpu_torch/ops/cuda_vform.py',
                                'pyiga_tpu/compile.py:974' + _HVP),
    })
# the JAX example's Newton residual norms and max |u| at its default size
# (p=2, n=8; scripts/jax_poisson_counts.py nonlinear), which phase 26 (d)
# holds the card's jacfwd Newton to
NLP_NORMS_JAX = (0.26014867090946653, 0.0015280218701892283,
                 1.2541230830386353e-07, 6.530606085103733e-16)
NLP_UMAX_JAX = 0.11876437703359931


class DualOps:
    """A per-point scalar of the ``Dual<S>`` algebra of K1-jvp and K1-hvp
    (csrc/fields.cuh) that counts the operations the kernel's formulas
    need: the value's (an add, multiply, divide, |x| or copysign is one)
    and, where a tangent reaches an operand (`t`), the tangent's rule: a
    sum's 1, a product's 3 (1 where one factor has none), a quotient's 3
    (1 by a divisor without one, 2 for a dividend without one).  A sign
    flip, |x|'s tangent (a select) and a sum's start from zero are free.
    The constants of a point (its gradient, its Gauss weight) are
    ``DualOps(False)``, literals plain floats."""

    n = 0

    def __init__(self, t=True):
        self.t = t

    def _op(self, o, both, mine, theirs):
        ot = isinstance(o, DualOps) and o.t
        DualOps.n += 1 + (both if self.t and ot else mine if self.t
                          else theirs if ot else 0)
        return DualOps(self.t or ot)

    def __add__(self, o):
        return self._op(o, 1, 0, 0)

    def __radd__(self, o):
        if isinstance(o, (int, float)) and o == 0:
            return self                 # sum()'s start
        return self._op(o, 1, 0, 0)

    __sub__ = __rsub__ = __add__

    def __mul__(self, o):
        return self._op(o, 3, 1, 1)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._op(o, 3, 1, 2)

    def __rtruediv__(self, o):          # a literal over a dual
        return self._op(o, 3, 2, 1)

    def __neg__(self):
        return self

    def __abs__(self):
        DualOps.n += 1
        return self


def _copysign_ops(x, _y):
    """``scopysign(x, y)``: one operation, the tangent of `x` (sign
    flipped or not)."""
    DualOps.n += 1
    return DualOps(x.t)


def _adj_det_ops(J, d):
    """``adj_det<D>`` (fields.cuh) on a d x d list: the adjugate, and the
    determinant from its first column."""
    if d == 2:
        return [[J[1][1], -J[0][1]], [-J[1][0], J[0][0]]], \
            J[0][0] * J[1][1] - J[0][1] * J[1][0]
    adj = [[J[(i + 1) % 3][(j + 1) % 3] * J[(i + 2) % 3][(j + 2) % 3]
            - J[(i + 1) % 3][(j + 2) % 3] * J[(i + 2) % 3][(j + 1) % 3]
            for i in range(3)] for j in range(3)]
    det = J[0][0] * adj[0][0] + J[0][1] * adj[1][0] + J[0][2] * adj[2][0]
    return adj, det


def k1_jvp_point_ops(kind, d, G, nurbs):
    """K1-jvp's per-point algebra after the contractions, as
    ``fields_tail`` (fields.cuh) runs it on ``Dual<S>``: the quotient rule
    (NURBS), then for 'jac' the values, for 'mass' ``gw |det J|`` (det
    alone), for 'stiffness' ``J^-1 = adj / det`` and ``gw |det J| (J^-1
    J^-T)_ab`` for a <= b (the cofactors of det counted once: they are
    the adjugate's first column)."""
    C = G + int(nurbs)
    jh = [[DualOps() for _k in range(d)] for _c in range(C)]
    val = [DualOps() for _c in range(C)]
    DualOps.n = 0
    if kind == 'jac':
        if nurbs:
            W = val[C - 1]
            WW = W * W
            [[(jh[c][k] * W - val[c] * jh[C - 1][k]) / WW for k in range(d)]
             for c in range(G)]
            [val[c] / W for c in range(G)]
        return DualOps.n
    J = jh
    if nurbs:
        W = val[C - 1]
        WW = W * W
        J = [[(jh[c][k] * W - val[c] * jh[C - 1][k]) / WW for k in range(d)]
             for c in range(d)]
    gw = DualOps(False) * DualOps(False)        # w12[q12] wl
    if kind == 'mass':                          # det_of<D>: det alone
        det = (J[0][0] * J[1][1] - J[0][1] * J[1][0] if d == 2 else
               sum(J[0][k] * (J[1][(k + 1) % 3] * J[2][(k + 2) % 3]
                              - J[1][(k + 2) % 3] * J[2][(k + 1) % 3])
                   for k in range(3)))
        gw * abs(det)
        return DualOps.n
    adj, det = _adj_det_ops(J, d)
    inv = [[adj[a][b] / det for b in range(d)] for a in range(d)]
    W = gw * abs(det)
    [W * sum(inv[a][m] * inv[b][m] for m in range(d))
     for a in range(d) for b in range(a, d)]
    return DualOps.n


def k1_hvp_point_ops(kind, d, G, nurbs):
    """K1-hvp's per-point algebra after the contractions: ``point_vjp``
    (fields.cuh) on ``Dual<S>`` with the output's gradient and the Gauss
    weight held (no tangent): the reciprocal of W (NURBS), for 'mass' ``f
    = copysign(gw, det) g`` (no tangent) times the adjugate, for
    'stiffness' ``f ((Gs : A) adj^T - 2 (adj^T Gs adj) adj^T)`` with ``f
    = gw sign(det) / det^2``, then the quotient rule's VJP."""
    C = G + int(nurbs)
    jh = [[DualOps() for _k in range(d)] for _c in range(C)]
    val = [DualOps() for _c in range(C)]
    ng = {'stiffness': d * (d + 1) // 2, 'mass': 1, 'jac': G + G * d}[kind]
    go = [DualOps(False) for _ in range(ng)]
    DualOps.n = 0
    if nurbs:
        iW = 1.0 / val[C - 1]
        iWW = iW * iW
        xv = [val[c] * iW for c in range(G)]
    if kind == 'jac':
        gx = go[:G]
        gJ = [[go[G + c * d + k] for k in range(d)] for c in range(G)]
    else:
        gw = DualOps(False) * DualOps(False)    # w12[q12] wL[q]
        J = ([[(jh[c][k] - xv[c] * jh[C - 1][k]) * iW for k in range(d)]
              for c in range(d)] if nurbs else jh)
        adj, det = _adj_det_ops(J, d)
        if kind == 'mass':
            f = _copysign_ops(gw, det) * go[0]
            gJ = [[f * adj[k][c] for k in range(d)] for c in range(d)]
        else:
            Gs = [[None] * d for _ in range(d)]
            o = 0
            for a in range(d):
                for b in range(a, d):
                    Gs[a][b] = Gs[b][a] = go[o] if a == b else 0.5 * go[o]
                    o += 1
            r = 1.0 / det
            f = _copysign_ops(gw * r * r, det)
            P1 = [[sum(Gs[a][b] * adj[b][m] for b in range(d))
                   for m in range(d)] for a in range(d)]
            GA = sum(P1[a][m] * adj[a][m] for a in range(d)
                     for m in range(d))
            Q = [[None] * d for _ in range(d)]
            for i in range(d):
                for j in range(i, d):
                    Q[i][j] = Q[j][i] = sum(adj[a][i] * P1[a][j]
                                            for a in range(d))
            gJ = [[f * (GA * adj[j][i]
                        - 2.0 * sum(Q[i][m] * adj[j][m] for m in range(d)))
                   for j in range(d)] for i in range(d)]
    if nurbs:
        gW = sum(gJ[c][k] * (2.0 * xv[c] * jh[C - 1][k] - jh[c][k])
                 for c in range(G) for k in range(d))
        for k in range(d):
            -sum(gJ[c][k] * val[c] for c in range(G)) * iWW
        for c in range(G):
            gv = -sum(gJ[c][k] * jh[C - 1][k] for k in range(d)) * iWW
            if kind == 'jac':
                gv + gx[c] * iW
            [gJ[c][k] * iW for k in range(d)]
        if kind == 'jac':
            gW = gW - sum(gx[c] * val[c] for c in range(G))
        gW * iWW
    return DualOps.n


def fields_ad_flops(mode, kind, d, G, nurbs, nL):
    """Operations a point of K1-jvp (`mode` 'jvp') or K1-hvp ('hvp') of
    `kind`, from the kernels' bodies: the contractions of Y and dY over
    the last axis (2 a multiply-add), the per-point algebra
    (:func:`k1_jvp_point_ops`, :func:`k1_hvp_point_ops`), and for K1-hvp
    the Gauss weight's product and the sums back over the last axis (a
    multiply-add each)."""
    C = G + int(nurbs)
    vals = nurbs or kind == 'jac'
    dots = 2 * C * d * nL + (2 * C * nL if vals else 0)
    if mode == 'jvp':
        return 2 * dots + k1_jvp_point_ops(kind, d, G, nurbs)
    return 2 * dots + k1_hvp_point_ops(kind, d, G, nurbs) + dots


def fields_ad_case(mode, kind, Y, T, w12, wL, nurbs, device, name, seed,
                   tol=1e-13):
    """K1-jvp (`mode` 'jvp') or K1-hvp ('hvp') of `kind` on the operands
    ``(Y, T, w12, wL, nurbs)`` against its plain version (`tol` relative,
    bitwise on a repeat; float32: the float32 instance, also bitwise
    unchanged with torch's global TF32 on), with its ms through the
    wrapper (CUDA events), its device ms (:func:`cold_graph_ms`: no
    operand warm in the L2), the plain version's ms, and the bound: Y,
    dY, T, the weights (and for K1-hvp the output's gradient) read once,
    the result written once; the operations of :func:`fields_ad_flops`
    at the f64 or f32 FMA peak."""
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    d, C, Q12, nL = Y.shape
    G = C - int(nurbs)
    QL = T.shape[1]
    f32 = Y.dtype == torch.float32
    rng = np.random.RandomState(seed)
    dY = torch.as_tensor(rng.rand(*Y.shape) - 0.5, dtype=Y.dtype,
                         device=device)
    if mode == 'jvp':
        def launch(Y, dY):
            return cs.fields_jvp(kind, Y, T, w12, wL, nurbs, dY)
        args = (Y, dY)

        def run():
            return launch(*args)

        def plain():
            return cs.fields_jvp_plain(kind, Y, T, w12, wL, nurbs, dY)
        g = None
    else:
        shape = {'stiffness': (d * (d + 1) // 2, Q12, QL), 'mass': (Q12, QL),
                 'jac': (G + G * d, Q12, QL)}[kind]
        g = torch.as_tensor(rng.rand(*shape) - 0.5, dtype=Y.dtype,
                            device=device)

        def launch(Y, g, dY):
            return cs.fields_hvp(kind, Y, T, w12, wL, nurbs, g, dY)
        args = (Y, g, dY)

        def run():
            return launch(*args)

        def plain():
            return cs.fields_hvp_plain(kind, Y, T, w12, wL, nurbs, g, dY)
    got, ref = run(), plain()
    sync(device)
    label = '%s_%s%s %s' % (kind, mode, ' f32' if f32 else '', name)
    err, rel = compare(label, got, ref, tol)
    check_repeat(label, run, got)
    if f32:
        tf32_unchanged(label, lambda: [run(), plain()], [got, ref])
    ops = Q12 * QL * fields_ad_flops(mode, kind, d, G, nurbs, nL)
    device_ms, copies = cold_graph_ms(launch, args, device)
    rec = dict(max_abs_err=err, rel=rel, Y=list(Y.shape), QL=QL,
               repeat_equal=True, tf32_on_unchanged=f32 or None,
               ms=time_ms(run, device), device_ms=device_ms,
               device_copies=copies,
               plain_ms=time_ms(plain, device, reps=3),
               library_ms=None,
               **bound(nbytes(Y, dY, T, got) + (nbytes(g) if g is not None
                                                else 0)
                       + (0 if kind == 'jac' else nbytes(w12, wL)),
                       ops, F32_PER_MS if f32 else F64_FMA_PER_MS))
    log('  %-28s %s: %.4f ms (device %.4f, plain %.4f, bound %.4f %s, '
        '%.0f %% of it)' % (label, list(got.shape), rec['ms'],
                            rec['device_ms'], rec['plain_ms'],
                            rec['bound_ms'], rec['bound_by'],
                            100 * rec['bound_ms'] / rec['device_ms']))
    del dY, g, got, ref
    return rec


def k5_ad_case(asm, device, name, seed, tol=1e-13):
    """The generated K5 tangent and second-order programs of a form's
    fold-plan program in the compute dtype, every source and the
    parameters with a tangent, against their plain runs
    (``run_tangent_plain``, ``run_second_plain``: `tol` of each tensor's
    largest entry, bitwise on a repeat, float32 also with TF32 on); their
    SSA sizes, nvcc seconds, ms by CUDA events, device ms
    (:func:`cold_graph_ms`: no operand warm in the L2), plain ms and
    bounds (the rows each program reads, the weights, parameters and
    output once; an operation per SSA instruction and point).  Returns
    ``{'vform_tangent': rec, 'vform_second': rec}``."""
    import pyiga_tpu_torch
    from pyiga_tpu_torch import _cuda
    from pyiga_tpu_torch.ops import cuda_vform as cv
    dtype = pyiga_tpu_torch.get_dtype()
    f32 = dtype == torch.float32
    plan = asm._fold_plan or [(t, False) for t in range(len(asm.combos))]
    prog = asm._program([asm.combos[t] for t, _m in plan], dtype)
    arrays = asm.device_arrays()
    grid = tuple(w.shape[0] for w in arrays['weights'])
    N = math.prod(grid)
    rng = np.random.RandomState(seed)

    def rand_like(t):
        return torch.as_tensor(rng.rand(*t.shape) - 0.5, dtype=dtype,
                               device=device)
    mask = (True,) * (len(prog.sources) + int(bool(prog.params)))
    tans = {k: rand_like(arrays[k]) for k in prog.sources}
    if prog.params:
        tans['params'] = rand_like(arrays['params'])
    g = torch.as_tensor(rng.rand(len(prog.outputs), *grid) - 0.5,
                        dtype=dtype, device=device)
    targs = cv.tangent_operands(prog, mask, arrays, tans)
    out = {}
    t0 = time.perf_counter()
    tprog, sprog = prog.tangent(mask), prog.second(mask)
    gen_s = time.perf_counter() - t0
    launches = {'vform_tangent': lambda targs, g: [tprog.launch(targs)],
                'vform_second': lambda targs, g: _k5_flat(
                    prog, *sprog.launch(targs, g))}
    for key, gen, run, plain in (
            ('vform_tangent', tprog,
             lambda: [tprog.launch(targs)],
             lambda: [cv.run_tangent_plain(prog, mask, arrays, tans)
                      .reshape((len(prog.outputs),) + grid)]),
            ('vform_second', sprog,
             lambda: _k5_flat(prog, *sprog.launch(targs, g)),
             lambda: _k5_flat(prog, *cv.run_second_plain(prog, mask, arrays,
                                                         g, tans)))):
        t0 = time.perf_counter()
        got = run()
        first_s = time.perf_counter() - t0
        ref = plain()
        sync(device)
        label = '%s%s %s' % (key, '_f32' if f32 else '', name)
        err, rel = compare_all(label, got, ref, tol)
        check_repeat_all(label, run, got)
        if f32:
            tf32_unchanged(label, lambda: run() + plain(), got + ref)
        lib = str(_cuda.generated_path(gen.counter, gen.source))
        build = dict(_cuda.GEN_BUILDS[lib], path=lib)
        prow = gen.program if key == 'vform_second' else gen
        rows = {s for s in prow.leaf_src if s is not None}
        read = g.element_size() * (
            len(rows) * N + sum(w.numel() for w in arrays['weights'])
            + (2 * arrays['params'].numel() if prog.params else 0))
        device_ms, copies = cold_graph_ms(launches[key], (targs, g), device)
        out[key] = dict(
            max_abs_err=err, rel=rel, instrs=len(prog.instrs),
            adjoint_instrs=len(prog.adjoint().program.instrs),
            program_instrs=len(prow.instrs), first_call_s=first_s,
            generate_s=gen_s, build=build, grid=list(grid),
            repeat_equal=True, tf32_on_unchanged=f32 or None,
            ms=time_ms(run, device), device_ms=device_ms,
            device_copies=copies,
            plain_ms=time_ms(plain, device, reps=3),
            library_ms=None,
            **bound(read + nbytes(*got), len(prow.instrs) * N,
                    F32_PER_MS if f32 else F64_FMA_PER_MS))
        log('  %s: %d SSA instrs (forward %d, adjoint %d); nvcc %.2f s; '
            '%.4f ms (device %.4f, plain %.4f, bound %.4f %s)'
            % (label, len(prow.instrs), len(prog.instrs),
               len(prog.adjoint().program.instrs), build['seconds'],
               out[key]['ms'], out[key]['device_ms'], out[key]['plain_ms'],
               out[key]['bound_ms'], out[key]['bound_by']))
    return out


def k5_prebuild(cases, dtypes):
    """Build the tangent and second-order programs of each ``(asm,
    tangent)`` case's fold-plan program in each of `dtypes`, one thread a
    library, so that their nvcc processes run at once (each program's
    time lands in ``_cuda.GEN_BUILDS``): `tangent` picks the sources that
    have a tangent (by key; the parameters when ``'params'`` passes)."""
    from concurrent.futures import ThreadPoolExecutor
    gens = []
    for asm, tangent in cases:
        plan = asm._fold_plan or [(t, False) for t in range(len(asm.combos))]
        for dtype in dtypes:
            prog = asm._program([asm.combos[t] for t, _m in plan], dtype)
            mask = tuple(tangent(k) for k in prog.sources) + (
                (tangent('params'),) if prog.params else ())
            gens += [prog.tangent(mask), prog.second(mask)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(gens)) as pool:
        list(pool.map(lambda gen: gen.entry(), gens))
    log('  %d generated programs built at once in %.1f s'
        % (len(gens), time.perf_counter() - t0))


def _k5_flat(prog, grads, gparams):
    return [grads[k] for k in prog.sources] + ([gparams] if gparams
                                               is not None else [])


def k5_ad_forms(device, n2=128, n3=48):
    """Phase 20a's K5 forms: convection-diffusion, ``(1 + w²)`` and the
    biharmonic at 2D n=128, ``grad(u).grad(v) ds`` on the 'left' face of
    the extruded annulus at 3D n=48 (QL = 1)."""
    from pyiga_tpu_torch import geometry
    from pyiga_tpu_torch.assemble import instantiate_assembler
    _kvs, _geo, conv, _f = convdiff_setup(n2, device)
    w = geometry.BSplineFunc(kvs_of(2, n2), np.random.RandomState(
        7).rand(n2 + 3, n2 + 3))
    nl = instantiate_assembler(NONLINEAR, kvs_of(2, n2), {
        'geo': geometry.quarter_annulus(), 'w': w}, None, device=device)
    bih = instantiate_assembler(BIHARMONIC, kvs_of(2, n2), {
        'geo': geometry.quarter_annulus()}, None, device=device)
    face = surface_asm('inner(grad(u), grad(v)) * ds', 3, n3, device,
                       boundary='left')
    return {'convdiff_n128': conv, 'nonlinear_n128': nl,
            'biharmonic_n128': bih, 'gradgrad_ds_left_n48': face}


def check_fwd_kernels(device, n3=48, n2=128, dtype=torch.float64):
    """Phase 26 (a), float64 and float32 (under ``set_dtype``): K1-jvp and
    K1-hvp of every kind against their plain versions (phase 20a's
    tolerances: 1e-13, or :data:`DIFF_F32_TOL`; bitwise on a repeat) on
    the 3D p=3 n=48 twisted box, the 2D n=128 NURBS quarter annulus and
    the 'left' face's boundary grid of the extruded annulus at n=48 (QL =
    1, the ``jac`` kind); the generated K5 tangent and second-order
    programs of phase 20a's forms (:func:`k5_ad_forms`).  The records'
    keys are the launch counters (``_f32`` for float32)."""
    from pyiga_tpu_torch import geometry
    from pyiga_tpu_torch.assemblers import StiffnessAssembler
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    f32 = dtype == torch.float32
    sfx = '_f32' if f32 else ''
    tol = DIFF_F32_TOL if f32 else 1e-13
    out = {}
    with ComputeDtype(dtype):
        a3 = main_path_setup(3, n3, device)
        a2 = StiffnessAssembler(kvs_of(2, n2), geometry.quarter_annulus(),
                                device=device)
        face = surface_asm('v * ds', 3, n3, device, boundary='left')
        ops = face._device_operands()
        Yf, _ = cs.geo_stage12(ops['geo_tables'], ops['geo_coeffs'], 3)
        Tf = ops['geo_tables'][2][:2].contiguous()
        geos = [('3D n=%d' % n3, spline_partials(a3)),
                ('annulus n=%d' % n2, spline_partials(a2))]
        for mode in ('jvp', 'hvp'):
            for kind, counter in (('stiffness', 'fields'),
                                  ('mass', 'mass_fields'),
                                  ('jac', 'geo_jac_fields')):
                cases = {}
                for i, (name, (Y, T, w12, wL, nurbs)) in enumerate(geos):
                    if kind == 'jac':
                        w12 = wL = None
                    cases[name] = fields_ad_case(
                        mode, kind, Y, T, w12, wL, nurbs, device, name,
                        40 + i, tol=tol)
                if kind == 'jac':
                    cases['face left n=%d' % n3] = fields_ad_case(
                        mode, kind, Yf, Tf, None, None, face._geo_is_nurbs,
                        device, 'face left n=%d' % n3, 43, tol=tol)
                first = next(iter(cases.values()))
                out['%s_%s%s' % (counter, mode, sfx)] = dict(
                    first, max_abs_err=max(r['max_abs_err']
                                           for r in cases.values()),
                    cases=cases)
        del geos, a3, a2, Yf, Tf, face, ops
        torch.cuda.empty_cache()
        forms = k5_ad_forms(device, n2, n3)
        k5_prebuild([(asm, lambda k: True) for asm in forms.values()],
                    [dtype])
        k5 = {name: k5_ad_case(asm, device, name, 50 + i, tol=tol)
              for i, (name, asm) in enumerate(forms.items())}
        for key in ('vform_tangent', 'vform_second'):
            cases = {name: r[key] for name, r in k5.items()}
            out[key + sfx] = dict(cases['convdiff_n128'], cases=cases,
                                  max_abs_err=max(r['max_abs_err']
                                                  for r in cases.values()))
        del forms
    torch.cuda.empty_cache()
    log('  nvcc of the %s tangent / second-order programs: %s s' % (dtype, {
        k: (round(r['vform_tangent']['build']['seconds'], 2),
            round(r['vform_second']['build']['seconds'], 2))
        for k, r in k5.items()}))
    return out


def fwd_problems(device, n3=48, n2=128):
    """Phase 26 (b)'s functions, each ``(fn, x0)``: ``assembly_coeff_fn``
    of the headline's stiffness and of the mass assembler at 3D p=3 n=48
    (20b's objectives), of the convection-diffusion VForm at 2D n=128
    (the ``jac`` kind and K5 under a geometry tangent), and
    ``assembly_input_fn`` of the ``(1 + w²)`` form in ``w`` at 2D n=128
    (K5 under an input tangent)."""
    from pyiga_tpu_torch import geometry
    from pyiga_tpu_torch.assemble import instantiate_assembler
    from pyiga_tpu_torch.assemblers import MassAssembler
    from pyiga_tpu_torch.diff import assembly_coeff_fn, assembly_input_fn
    out = {}
    out['stiffness_3d'] = assembly_coeff_fn(main_path_setup(3, n3, device))
    out['mass_3d'] = assembly_coeff_fn(MassAssembler(kvs_of(3, n3),
                                                     main_geo(3),
                                                     device=device))
    _kvs, _geo, conv, _f = convdiff_setup(n2, device)
    out['convdiff_2d'] = assembly_coeff_fn(conv)
    w = geometry.BSplineFunc(kvs_of(2, n2), 0.1 * np.random.RandomState(
        17).rand(n2 + 3, n2 + 3))
    nl = instantiate_assembler(NONLINEAR, kvs_of(2, n2), {
        'geo': geometry.quarter_annulus(), 'w': w}, None, device=device)
    out['nonlinear_2d'] = assembly_input_fn(nl, 'w')
    # the K5 programs their tangents reach: the geometry's sources, and
    # the input's values and derivatives
    k5 = [(conv, lambda k: k.startswith('geo_')),
          (nl, lambda k: k in ('input:w', 'ideriv:w:1'))]
    return out, k5


def _launched(before):
    from pyiga_tpu_torch import _cuda
    return {k: v - before[k] for k, v in _cuda.LAUNCHES.items()
            if v != before[k]}


def fwd_case(name, fn, x0, device, seed, h=1e-4, fd_tol=1e-6, tol=1e-12):
    """Phase 26 (b) and (c) on one function: with ``w`` and a direction
    ``v`` seeded, the tangent of ``fn`` at `x0` along ``v`` by
    ``torch.func.jvp`` and by ``torch.autograd.forward_ad``, the
    gradient of ``sum(w fn)`` (reverse mode), the HVP by forward over
    reverse (``jvp(grad)``) and by ``create_graph``; each with its ms by
    CUDA events and launches, held to the same through the plain
    versions on the card (`tol`), ``<w, tangent>`` to ``<grad, v>`` and
    to a central difference (`fd_tol`), the two HVPs to each other
    (`tol`), bitwise on a repeat.  In float32 (under ``set_dtype``) the
    tolerances are 2e-5 and no difference is taken."""
    import pyiga_tpu_torch
    from torch.autograd import forward_ad
    from pyiga_tpu_torch import _cuda
    f32 = pyiga_tpu_torch.get_dtype() == torch.float32
    f64 = torch.float64
    x = torch.as_tensor(np.asarray(x0, dtype=float), dtype=f64,
                        device=device)
    with torch.no_grad():
        shape = fn(x).shape
    rng = np.random.RandomState(seed)
    w = torch.as_tensor(rng.rand(*shape), device=device)
    v = torch.as_tensor(rng.rand(*x.shape) - 0.5, dtype=f64, device=device)
    v = v / v.abs().max()

    def obj(c):
        out = fn(c)
        return (w.to(out.dtype) * out).sum()

    def jvp():
        return torch.func.jvp(fn, (x,), (v,))[1]

    def dual():
        with forward_ad.dual_level():
            return forward_ad.unpack_dual(fn(forward_ad.make_dual(
                x, v))).tangent

    def grad():
        return torch.func.grad(obj)(x)

    def hvp_fwd():
        return torch.func.jvp(torch.func.grad(obj), (x,), (v,))[1]

    def hvp_rev():
        xr = x.clone().requires_grad_(True)
        g, = torch.autograd.grad(obj(xr), xr, create_graph=True)
        return torch.autograd.grad((g * v).sum(), xr)[0]
    rec, got = {}, {}
    for key, call in (('jvp', jvp), ('forward_ad', dual), ('grad', grad),
                      ('hvp_fwd', hvp_fwd), ('hvp_rev', hvp_rev)):
        call()                          # builds, warms
        before = dict(_cuda.LAUNCHES)
        res, ms = event_ms(call, device)
        launches = _launched(before)
        ms2 = [event_ms(call, device)[1] for _ in range(2)]
        again = call()
        sync(device)
        if not torch.equal(again, res):
            raise RuntimeError('%s %s: two runs differ' % (name, key))
        got[key] = res
        rec[key] = dict(ms=[ms] + ms2, launches=launches)
    with PlainKernels():
        ref = {'jvp': jvp(), 'grad': grad(), 'hvp_fwd': hvp_fwd()}
    t = tol if not f32 else 2e-5
    for key, r in (('jvp', 'jvp'), ('forward_ad', 'jvp'), ('grad', 'grad'),
                   ('hvp_fwd', 'hvp_fwd'), ('hvp_rev', 'hvp_fwd')):
        err, rel = compare('%s %s' % (name, key), got[key], ref[r], t)
        rec[key].update(max_abs_err=err, rel=rel)
    err, rel = compare('%s hvp fwd/rev' % name, got['hvp_rev'],
                       got['hvp_fwd'], t)
    rec['hvp_agree'] = rel
    wt = float((w.to(got['jvp'].dtype) * got['jvp']).sum())
    gv = float((got['grad'].double() * v).sum())
    rec['w_tangent'], rec['grad_v'] = wt, gv
    rec['tangent_vs_grad'] = abs(wt - gv) / abs(gv)
    if not f32:
        with torch.no_grad():
            num = (float(obj(x + h * v)) - float(obj(x - h * v))) / (2 * h)
        rec['fd'] = num
        rec['fd_rel'] = abs(num - wt) / abs(wt)
        if not (rec['fd_rel'] <= fd_tol and rec['tangent_vs_grad'] <= tol):
            raise RuntimeError('%s: <w, jvp> %.12e, <grad, v> %.12e, FD '
                               '%.12e' % (name, wt, gv, num))
    elif rec['tangent_vs_grad'] > 2e-5:
        raise RuntimeError('%s: <w, jvp> %.9e, <grad, v> %.9e'
                           % (name, wt, gv))
    log('  %s: jvp %s ms, forward_ad %s, grad %s, HVP fwd %s, rev %s; '
        '<w, jvp> vs <grad, v> %.2e, vs FD %s; launches jvp %s, HVP fwd %s'
        % (name, *['%.2f' % min(rec[k]['ms']) for k in (
            'jvp', 'forward_ad', 'grad', 'hvp_fwd', 'hvp_rev')],
           rec['tangent_vs_grad'],
           '%.2e' % rec['fd_rel'] if 'fd_rel' in rec else '-',
           rec['jvp']['launches'], rec['hvp_fwd']['launches']))
    return rec


def run_hessian_small(device):
    """Phase 26 (c): ``torch.func.hessian`` of a 2D p=2 n=4 mass objective
    on the card (jacfwd over jacrev: every K1-jvp, K1-hvp, K2 and K3 rule
    under vmap) against the same through the plain versions (1e-12)."""
    from pyiga_tpu_torch import bspline, geometry
    from pyiga_tpu_torch.assemblers import MassAssembler
    from pyiga_tpu_torch.diff import assembly_coeff_fn
    kvs = 2 * (bspline.make_knots(2, 0.0, 1.0, 4),)
    fn, c0 = assembly_coeff_fn(MassAssembler(kvs, geometry.quarter_annulus(),
                                             device=device))
    x = torch.as_tensor(c0, dtype=torch.float64, device=device)
    w = torch.as_tensor(np.random.RandomState(18).rand(*fn(x).shape),
                        device=device)

    def obj(c):
        return (w * fn(c)).sum()
    from pyiga_tpu_torch import _cuda
    before = dict(_cuda.LAUNCHES)
    H, ms = event_ms(lambda: torch.func.hessian(obj)(x), device)
    launches = _launched(before)
    with PlainKernels():
        ref = torch.func.hessian(obj)(x)
    err, rel = compare('hessian mass 2D n=4', H, ref, 1e-12)
    H2 = H.reshape(x.numel(), x.numel())
    asym = float((H2 - H2.T).abs().max())
    log('  hessian %s: %.1f ms, |H - H^T| %.1e, launches %s'
        % (list(H.shape), ms, asym, launches))
    return dict(shape=list(H.shape), ms=ms, launches=launches,
                max_abs_err=err, rel=rel, asym=asym)


def run_nlp_jacfwd(device):
    """Phase 26 (d): ``examples/torch_nonlinear_poisson.py`` (its Jacobian
    by ``torch.func.jacfwd``) on the card against the JAX example's norms
    (:data:`NLP_NORMS_JAX`; 1e-10) and ``max |u|`` (1e-12), its launches
    counted (phase 20e holds the same run to the CPU's)."""
    from pyiga_tpu_torch import _cuda
    nlp = load_example('torch_nonlinear_poisson')
    before = dict(_cuda.LAUNCHES)
    t0 = time.perf_counter()
    norms, umax = nlp.main(device=device)
    secs = time.perf_counter() - t0
    launches = _launched(before)
    ok = (len(norms) == len(NLP_NORMS_JAX)
          and np.allclose(norms, NLP_NORMS_JAX, rtol=1e-10, atol=1e-10)
          and abs(umax - NLP_UMAX_JAX) <= 1e-12 * NLP_UMAX_JAX)
    log('  nonlinear Poisson by jacfwd: norms %s (JAX %s), max |u| %.12f '
        '(JAX %.12f), %.1f s, launches %s'
        % (['%.3e' % r for r in norms], ['%.3e' % r for r in NLP_NORMS_JAX],
           umax, NLP_UMAX_JAX, secs, launches))
    if not ok:
        raise RuntimeError('torch_nonlinear_poisson (jacfwd): the card '
                           'differs from the JAX example')
    return dict(norms=norms, jax=list(NLP_NORMS_JAX), umax=umax,
                umax_jax=NLP_UMAX_JAX, seconds=secs, launches=launches)


def run_fwd_phase(device, n3=48, n2=128):
    """Phase 26 (b)-(d), float64 and float32, the launch counts set to 0
    before and read after: :func:`fwd_case` on :func:`fwd_problems` (the
    float32 run under ``set_dtype``), the small Hessian and the Newton
    example by ``jacfwd``.  Fails unless every kernel of
    :data:`FWD_KERNELS` launched and no float32 run launched a float64
    kernel of it."""
    from pyiga_tpu_torch import _cuda
    rec = {}
    problems, k5 = fwd_problems(device, n3, n2)
    k5_prebuild(k5, [torch.float64, torch.float32])
    _cuda.reset_launches()
    t0 = time.perf_counter()
    for i, (name, (fn, x0)) in enumerate(problems.items()):
        rec[name] = fwd_case(name, fn, x0, device, 60 + i)
    rec['hessian_mass_2d_n4'] = run_hessian_small(device)
    rec['nonlinear_poisson'] = run_nlp_jacfwd(device)
    rec['f64_s'] = time.perf_counter() - t0
    f64_launches = dict(_cuda.LAUNCHES)
    torch.cuda.empty_cache()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    with ComputeDtype(torch.float32):    # the same functions in float32
        for i, (name, (fn, x0)) in enumerate(problems.items()):
            rec[name + '_f32'] = fwd_case(name + ' f32', fn, x0, device,
                                          70 + i)
    rec['f32_s'] = time.perf_counter() - t0
    f32_launches = dict(_cuda.LAUNCHES)
    wrong = [k for k in FWD_F64_KERNELS if f32_launches[k]]
    if wrong:
        raise RuntimeError('phase 26: the float32 runs launched %s' % wrong)
    launches = {k: f64_launches[k] + f32_launches[k] for k in _cuda.LAUNCHES}
    rec['launches'] = launches
    log('  phase 26 launches: %s' % {k: v for k, v in launches.items() if v})
    missing = [k for k in FWD_KERNELS if launches[k] <= 0]
    if missing:
        raise RuntimeError('phase 26: never launched %s' % missing)
    torch.cuda.empty_cache()
    return rec


################################################################################
# The windowed route (phases 4m and 21): K8 and K8f, csrc/windowed.cu
################################################################################

# (p, elements, R, terms, tables); terms 0: one K8 stage.  p=2 (nqp 3),
# nwin = 1 (p=3 on 4 spans), p=1 and p=4 (b = 3 and 9), dof counts that
# fill no whole warp or run (15, 7, 41, 53, 14), R below and across the
# 32-wide r tile, a fold of 1 term and one of 16 over 4 tables, and a p=4
# fold over 64 dofs whose one run would not fit in shared memory
WINDOWED_RAGGED = ((2, 13, 1001, 0, 1), (3, 4, 45, 0, 1), (1, 40, 33, 0, 1),
                   (2, 13, 300, 1, 1), (3, 50, 77, 16, 4),
                   (4, 10, 100, 3, 2), (4, 60, 100, 3, 2))
# (p, elements, R, terms, tables, X 16-byte aligned) of the persistent
# walk and the copy and store paths: 301 tiles of 24 r (not a multiple
# of the 132 CTAs), even R (tensor copies, the output span by bulk
# stores) and odd R (16-byte cp.async from each row's aligned start, the
# last span ragged: a store loop), a fold of 18 terms (two launches), X
# not 16-byte aligned (8-byte cp.async) for both entries, Q and R odd
# (the last double of X copied alone: a pair would pass its end), a p=4
# stage over 64 dofs (no room for an output span), and a stage and a
# fold of 2 terms over one table at 64 dofs (one output span buffer, not
# two; tensor copies of two boxes a stage)
WINDOWED_PATHS = ((3, 20, 7210, 0, 1, True), (3, 20, 7211, 0, 1, True),
                  (3, 20, 7210, 0, 1, False), (3, 20, 7210, 6, 3, True),
                  (3, 20, 7211, 18, 3, True), (3, 20, 7210, 6, 3, False),
                  (2, 13, 1001, 3, 2, True), (4, 60, 2000, 0, 1, True),
                  (3, 61, 7210, 0, 1, True), (3, 61, 7210, 2, 1, True))
# ... and in float32 (phase 4o), whose 4-byte elements leave room for two
# span buffers at every shape above: a fold of 4 terms over 4 tables at 64
# dofs (one span buffer)
WINDOWED_PATHS_F32 = ((3, 61, 7210, 4, 4, True),)


def windowed_paths(xs, tabs, idx, fs, nqp):
    """The plan of a K8 / K8f launch (its first, for more than 16 terms)
    as ``pyiga_windowed_plan`` (``_plan_f32`` for float32 operands)
    computes it on the card, held to ``cuda_sumfac.windowed_plan`` for
    the operands' element size, and the copy and store paths of the
    launch just made: X by tensor copies (``tensor``: R a multiple of V,
    the elements of 16 bytes: 2 doubles, 4 floats), by 16-byte
    ``cp.async`` from each row's aligned start (``cp.async 16``; with
    ``Q R`` no multiple of V the last elements of X alone, ``last
    double`` / ``last floats``) or by ``cp.async`` of one element
    (``cp.async 8`` / ``cp.async 4``: X not 16-byte aligned), as the
    library reports it; the output spans by bulk stores from one buffer
    (``one span``) or two (``two spans``), the last one ragged (``loop
    span``), or ``direct`` stores."""
    import ctypes
    from pyiga_tpu_torch import _cuda
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    Q, R = xs[0].shape
    n, b, wsz = tabs[0].shape
    es = xs[0].element_size()
    V = 16 // es
    groups = len(set(idx[:16]))
    keys = ('rpt', 'run', 'nruns', 'cap', 'box', 'ps', 'xs', 'stages', 'nys',
            'rtiles', 'cpr', 'smem')
    lib = _cuda.library()
    copy = lib.pyiga_windowed_last_copy()
    nsm = torch.cuda.get_device_properties(xs[0].device).multi_processor_count
    out = (ctypes.c_longlong * 12)()
    (lib.pyiga_windowed_plan if es == 8 else lib.pyiga_windowed_plan_f32)(
        Q, R, n, b, wsz, nqp, groups, nsm, ctypes.cast(out, ctypes.c_void_p))
    plan = dict(zip(keys, list(out)))
    mirror = cs.windowed_plan(Q, R, n, b, wsz, nqp, groups, nsm, esize=es)
    if plan != mirror:
        raise RuntimeError('windowed plan %s differs from windowed_plan %s'
                           % (plan, mirror))
    aligned = not any(X.data_ptr() % 16 for X in xs)
    expect = 2 if aligned and R % V == 0 else 1 if aligned else 0
    if copy != expect:
        raise RuntimeError('windowed kernel copied X by path %d, expected '
                           '%d' % (copy, expect))
    paths = {('cp.async %d' % es, 'cp.async 16', 'tensor')[copy]}
    if copy == 1 and (Q * R) % V:
        paths.add('last double' if es == 8 else 'last floats')
    nr = R - (plan['rtiles'] - 1) * 8 * plan['rpt']
    if plan['nys']:
        paths.add('one span' if plan['nys'] == 1 else 'two spans')
        if nr * b * n % V:
            paths.add('loop span')
    else:
        paths.add('direct')
    return plan, sorted(paths)


def windowed_1d_tables(p, nel, device):
    """The windowed pair tables of the four derivative pairs of a 1D
    space (degree p, nel elements) on `device`, the window starts and
    nqp."""
    from pyiga_tpu_torch import bspline
    from pyiga_tpu_torch.mlmatrix import MLStructure
    from pyiga_tpu_torch.ops import sumfac
    kv = bspline.make_knots(p, 0.0, 1.0, nel)
    grid, _w = sumfac.quadrature_for((kv,))
    st = sumfac.SpaceTables((kv,), (kv,), grid,
                            MLStructure.from_kvs((kv,), (kv,)).bidx, 1)
    out = [st.windowed_pair_table(0, du, dv)
           for du, dv in ((0, 0), (0, 1), (1, 0), (1, 1))]
    return ([torch.as_tensor(P, device=device) for P, _fs in out],
            torch.as_tensor(out[0][1], device=device), st.nqps[0])


def windowed_bound(xs, tabs, fs, got):
    """Bytes (the fields, the distinct tables and the starts read once,
    the output written once) and operations (one product a distinct
    table over the band's entries inside the matrix, the terms sharing
    a table added first)."""
    Q, R = xs[0].shape
    n, b, wsz = tabs[0].shape
    p = (b - 1) // 2
    i = np.arange(n)
    pairs = int(np.sum(np.minimum(n, i + p + 1) - np.maximum(0, i - p)))
    flops = 2 * R * pairs * wsz * len(tabs) + (len(xs) - len(tabs)) * Q * R
    return bound(nbytes(*xs, *tabs, fs, got), flops,
                 F32_PER_MS if got.dtype == torch.float32 else F64_FMA_PER_MS)


def windowed_bare_times(xs, tabs, idx, fs, nqp, Y, fold, device):
    """:func:`bare_times` of K8's (`fold` False: the first term alone) or
    K8f's C entry on these operands (the float32 entry for float32
    ones): ``launch_ms`` and ``device_ms``."""
    import ctypes
    from pyiga_tpu_torch import _cuda
    lib = _cuda.library()
    sfx = '_f32' if Y.dtype == torch.float32 else '_f64'
    Q, R = xs[0].shape
    n, b, wsz = tabs[0].shape
    xs = list(xs) if fold else [xs[0]]
    nx, keep = len(xs), []
    if fold:
        fn = getattr(lib, 'pyiga_windowed_fold' + sfx)

        def args_of(ts):
            xp = (ctypes.c_uint64 * nx)(*[t.data_ptr() for t in ts[:nx]])
            tp = (ctypes.c_uint64 * nx)(*[ts[nx + i].data_ptr()
                                          for i in idx])
            keep.append((xp, tp))       # alive while the launches run
            return (ctypes.cast(xp, ctypes.c_void_p),
                    ctypes.cast(tp, ctypes.c_void_p), nx, ts[-2].data_ptr(),
                    ts[-1].data_ptr(), Q, R, n, b, wsz, nqp)
    else:
        fn = getattr(lib, 'pyiga_windowed_stage' + sfx)

        def args_of(ts):
            return (ts[0].data_ptr(), ts[1 + idx[0]].data_ptr(),
                    ts[-2].data_ptr(), ts[-1].data_ptr(), Q, R, n, b, wsz,
                    nqp)
    name = 'windowed_%s%s' % ('fold' if fold else 'stage',
                              '_f32' if sfx == '_f32' else '')
    return bare_times(name, fn, xs + list(tabs) + [fs, torch.empty_like(Y)],
                      args_of, device)


def windowed_case(name, xs, tabs, idx, fs, nqp, device, fold, btabs=None,
                  tol=1e-14):
    """K8 (`fold` False: one term) or K8f against its plain version at one
    shape: `tol` relative to the largest entry, bitwise on a repeat (for
    float32 operands also with torch's global TF32 on); the times of the
    kernel, of the plain version, of the einsum yardstick (one call over
    every term's windows, gathered outside its timing; TF32 off) and,
    with `btabs` (the banded pair tables of the same terms), of K2 / K3 on
    those: the same output, with the band's zeros in the contraction."""
    from pyiga_tpu_torch.config import no_tf32
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    if fold:
        def run():
            return cs.windowed_fold(xs, tabs, idx, fs, nqp)

        def plain():
            return cs.windowed_fold_plain(xs, tabs, idx, fs, nqp)
    else:
        def run():
            return cs.windowed_stage(xs[0], tabs[idx[0]], fs, nqp)

        def plain():
            return cs.windowed_stage_plain(xs[0], tabs[idx[0]], fs, nqp)
    got = run()
    sync(device)
    ref = plain()
    err, rel = compare(name, got, ref, tol)
    check_repeat(name, run, got)
    if got.dtype == torch.float32:
        with GlobalTF32():
            same = torch.equal(run(), got) and torch.equal(plain(), ref)
        if not same:
            raise RuntimeError('%s: global TF32 changed the f32 results'
                               % name)
    del ref
    plan, paths = windowed_paths(xs, tabs, idx, fs, nqp)
    rec = dict(max_abs_err=err, rel=rel, repeat_equal=True, plan=plan,
               paths=paths,
               shape=[len(xs)] + list(xs[0].shape) + list(tabs[0].shape),
               tables=len(tabs), ms=time_ms(run, device),
               plain_ms=time_ms(plain, device, reps=3),
               **windowed_bound(xs, tabs, fs, got))
    if device.type == 'cuda':
        rec.update(windowed_bare_times(xs, tabs, idx, fs, nqp, got, fold,
                                       device))
    del got
    wsz = tabs[0].shape[2]
    q = (fs[:, None] * nqp
         + torch.arange(wsz, device=device)[None, :]).reshape(-1)
    G = torch.stack([X[q].reshape(fs.shape[0], wsz, -1) for X in xs])
    Ps = torch.stack([tabs[i] for i in idx])
    with no_tf32(G.dtype):
        rec['library_ms'] = time_ms(
            lambda: torch.einsum('tiwr,tiow->roi', G, Ps), device)
    del G, Ps
    if btabs is not None:
        rec['k2k3_banded_ms'] = time_ms(
            (lambda: cs.fold(xs, btabs, idx)) if fold
            else (lambda: cs.stage(xs[0], btabs[idx[0]])), device)
    log('  %-26s kernel %.4f ms  device %s  plain %.4f  einsum %.4f  K2/K3 '
        'banded %s  bound %.4f (%s, %.1f MB)'
        % (name, rec['ms'], '%.4f' % rec['device_ms'] if 'device_ms' in rec
           else '-', rec['plain_ms'], rec['library_ms'],
           '%.4f' % rec['k2k3_banded_ms'] if btabs is not None else '-',
           rec['bound_ms'], rec['bound_by'], rec['bound_bytes'] / 1e6))
    return rec


# phase 4m's (dimension, elements) of the 3D twisted box and the 2D
# quarter annulus, p=3
WINDOWED_SIZES = ((3, 48), (2, 128))


def check_windowed_kernels(device, seed=13, dtype=torch.float64, tol=1e-14):
    """Phase 4m: K8 (``windowed_stage``) and K8f (``windowed_fold``)
    against their plain versions on `device` at the windowed route's
    shapes: the 3D p=3 n=48 twisted box's stage 1 and stage 2 and the
    fold of its 6 plan terms (3 tables), the 2D p=3 n=128 quarter
    annulus's stage 1 and fold (3 terms), and the ragged shapes above.
    The JSON line's numbers are the 3D ones (stage: both stages summed,
    as K2's).  `dtype` float32 (phase 4o) runs the kernels' float32
    instances (`tol` relative; keys ``windowed_stage_f32`` /
    ``windowed_fold_f32``)."""
    from pyiga_tpu_torch.ops import banded as bd
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    from pyiga_tpu_torch.ops.sumfac import last_table_groups
    rng = np.random.RandomState(seed)
    f64 = dtype
    es = torch.empty(0, dtype=dtype).element_size()
    sfx = '_f32' if dtype == torch.float32 else ''

    def rand(*shape):
        return torch.as_tensor(rng.rand(*shape), dtype=f64, device=device)

    def dev(a, dtype=f64):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)
    cases = {}
    for dim, n in WINDOWED_SIZES:
        asm = main_path_setup(dim, n, device)
        wtabs, fss = asm.tables.windowed_term_tables(asm.terms)
        btabs = asm.tables.banded_term_tables(asm.terms,
                                              bd.band_info(asm.structure))
        nqp, fs = asm.tables.nqps[0], dev(fss[0], torch.int64)
        Q = asm.tables.trial[0].shape[2]
        bn = wtabs[0][0].shape[0] * wtabs[0][0].shape[1]
        tag = '%dD n=%d' % (dim, n)
        # stage 1 (Q, Q^(d-1)) -> (Q^(d-1), b n); 3D stage 2 (Q, Q b n)
        for k, R in [(0, Q ** (dim - 1))] + ([(1, Q * bn)] if dim == 3
                                              else []):
            name = 'stage %d %s' % (k + 1, tag)
            cases[name] = windowed_case(
                name, [rand(Q, R)], [dev(wtabs[0][k])], [0], fs, nqp,
                device, False, btabs=[dev(btabs[0][k])], tol=tol)
        plan = asm._fold()
        idx = list(last_table_groups([wtabs[t] for t, _m in plan]))
        tabs, btab = [None] * (max(idx) + 1), [None] * (max(idx) + 1)
        for (t, _m), i in zip(plan, idx):
            tabs[i], btab[i] = dev(wtabs[t][-1]), dev(btabs[t][-1])
        name = 'fold %s' % tag
        cases[name] = windowed_case(
            name, [rand(Q, bn ** (dim - 1)) for _ in plan], tabs, idx, fs,
            nqp, device, True, btabs=btab, tol=tol)
        del asm
        torch.cuda.empty_cache()
    ragged = {}
    covered = {k: set() for k in WINDOWED_KERNELS}
    for k in WINDOWED_KERNELS:
        covered[k].update(*[c['paths'] for name, c in cases.items()
                            if name.startswith('fold')
                            == (k == 'windowed_fold')])
    for p, nel, R, nterms, ntab, aligned in (
            [c + (True,) for c in WINDOWED_RAGGED] + list(WINDOWED_PATHS)
            + list(WINDOWED_PATHS_F32 if es == 4 else ())):
        tabs, fs, nqp = windowed_1d_tables(p, nel, device)
        tabs = [P.to(dtype) for P in tabs[:ntab]]
        xs = []
        for _ in range(max(nterms, 1)):
            X = rand(nel * nqp, R)
            if not aligned:           # the same values one element on
                buf = torch.empty(X.numel() + 1, dtype=f64, device=device)
                X = buf[1:].view(X.shape).copy_(X)
            xs.append(X)
        idx = [t % ntab for t in range(len(xs))]

        def run():
            if nterms:
                return cs.windowed_fold(xs, tabs, idx, fs, nqp)
            return cs.windowed_stage(xs[0], tabs[0], fs, nqp)
        key = 'p=%d n=%d R=%d %s%s' % (
            p, fs.shape[0], R, '%d terms' % nterms if nterms else 'stage',
            '' if aligned else ', X %d bytes off' % es)
        got = run()
        sync(device)
        err, rel = compare(key, got, cs.windowed_fold_plain(
            xs, tabs, idx, fs, nqp), tol)
        check_repeat(key, run, got)
        plan, paths = windowed_paths(xs, tabs, idx, fs, nqp)
        covered['windowed_fold' if nterms else 'windowed_stage'].update(
            paths)
        ragged[key] = dict(max_abs_err=err, rel=rel, plan=plan, paths=paths)
        log('    plan %s, paths %s' % (plan, ', '.join(paths)))
    for k in WINDOWED_KERNELS:
        every = windowed_every_path(es, k == 'windowed_fold')
        log('  %s%s: paths exercised %s'
            % (k, sfx, ', '.join(sorted(covered[k]))))
        if covered[k] != every:
            raise RuntimeError('%s%s: paths %s not exercised'
                               % (k, sfx, sorted(every - covered[k])))
    n3 = dict(WINDOWED_SIZES)[3]
    s1, s2 = cases['stage 1 3D n=%d' % n3], cases['stage 2 3D n=%d' % n3]
    out = {'windowed_stage' + sfx: dict(
        max_abs_err=max(s1['max_abs_err'], s2['max_abs_err']),
        rel=max(s1['rel'], s2['rel']), repeat_equal=True,
        ms=s1['ms'] + s2['ms'], plain_ms=s1['plain_ms'] + s2['plain_ms'],
        library_ms=s1['library_ms'] + s2['library_ms'],
        k2k3_banded_ms=s1['k2k3_banded_ms'] + s2['k2k3_banded_ms'],
        ms_each=[s1['ms'], s2['ms']],
        **({'device_ms': s1['device_ms'] + s2['device_ms'],
            'launch_ms': s1['launch_ms'] + s2['launch_ms']}
           if 'device_ms' in s1 else {}),
        **bound(s1['bound_bytes'] + s2['bound_bytes'],
                s1['bound_flops'] + s2['bound_flops'],
                F32_PER_MS if dtype == torch.float32 else F64_FMA_PER_MS)),
        'windowed_fold' + sfx: dict(cases['fold 3D n=%d' % n3])}
    for k in WINDOWED_KERNELS:
        out[k + sfx]['cases'] = cases
        out[k + sfx]['ragged'] = ragged
    return out


def windowed_every_path(esize, fold):
    """The copy and store paths (:func:`windowed_paths`) that phase 4m
    (`esize` 8) and 4o (4) must see K8 or (`fold`) K8f take.  In float32
    a stage's plan never holds one span buffer alone: its one table (at
    most 64 x 236 floats) leaves room for two spans beside two stages at
    every shape of the route (b <= 9, at most 64 dofs a run)."""
    every = {'tensor', 'cp.async 16', 'cp.async %d' % esize,
             'last double' if esize == 8 else 'last floats', 'one span',
             'two spans', 'loop span', 'direct'}
    if esize == 4 and not fold:
        every.discard('one span')
    return every


# phase 21's cases: (dim, n, assembler, the cg_ir inner counts of phases
# 5 / 6 on this operator, or None: no solve)
WINDOWED_CASES = ((3, 48, 'StiffnessAssembler', [7, 9, 9]),
                  (3, 48, 'MassAssembler', None),
                  (2, 128, 'StiffnessAssembler', 17))


def windowed_route_case(dim, n, name, iters, device):
    """One case of phase 21 (see :func:`run_windowed_phase`)."""
    from pyiga_tpu_torch import assemblers, bspline, geometry
    from pyiga_tpu_torch import _cuda
    from pyiga_tpu_torch.ops import banded as bd
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    from pyiga_tpu_torch.ops import sumfac
    kvs = dim * (bspline.make_knots(3, 0.0, 1.0, n),)
    geo = geometry.twisted_box() if dim == 3 else geometry.quarter_annulus()
    t0 = time.perf_counter()
    asm = getattr(assemblers, name)(kvs, geo, device=device)
    ops = asm._windowed_operands()
    bws = bd.band_info(asm.structure)
    ns = tuple(b[0] for b in asm.structure.bs)
    btabs = asm.tables.banded_term_tables(asm.terms, bws)
    rec = dict(dim=dim, n=n, assembler=name,
               t_host_setup_ms=1e3 * (time.perf_counter() - t0))

    def route():
        return sumfac.run_windowed_assembly(
            asm.field_fn, asm.geo_inputs(), ops['wtabs'], ops['fss'],
            asm.tables.nqps, ops['plan'], ops['tperms'])
    route()                                # warm (caching allocator)
    base = peak_reset(device)
    _cuda.reset_launches()
    Z = route()
    rec['peak_bytes'] = peak_since(device, base)
    rec['launches'] = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    log('  %dD n=%d %s: launches %s, peak %.1f MB above the inputs'
        % (dim, n, name, rec['launches'], rec['peak_bytes'] / 1e6))
    if rec['launches'].get('fold', 0) or any(
            _cuda.LAUNCHES[k] <= 0 for k in WINDOWED_KERNELS):
        raise RuntimeError('windowed route: K3 launched or a windowed '
                           'kernel missed: %s' % rec['launches'])
    # 1. the compact take against run_device()'s compact data
    compact = asm.run_device()
    d = Z.dim()
    take = Z[tuple(m.reshape([-1 if a == k else 1 for a in range(d)])
                   for k, m in enumerate(ops['cmaps']))]
    sync(device)
    rec['compact_max_abs_err'], rec['compact_rel'] = compare(
        'compact take', take, compact, 1e-14)
    mlm = asm.assemble_windowed()
    if not np.array_equal(mlm.data, take.cpu().numpy()):
        raise RuntimeError('assemble_windowed() differs from its route')
    del compact, take, mlm
    # 2. the flat layout against assemble_banded()
    Dw = bd.flat_banded_from_padded_chain(Z, bws, ns, add_transpose=False)
    op_ref = asm.assemble_banded()
    sync(device)
    rec['flat_max_abs_err'], rec['flat_rel'] = compare(
        'flat vs banded', Dw, op_ref.D, 1e-13)
    op_w = bd.FlatBandedOperator(Dw, bws, ns)
    # 4. BandedOperator on the regular layout: K4's matvec bitwise
    bop = bd.BandedOperator(
        sumfac.banded_reorder(Z, tuple(2 * b + 1 for b in bws), ns), bws, ns)
    x = torch.as_tensor(np.random.RandomState(3).rand(op_w.shape[0]),
                        device=device)
    _cuda.reset_launches()
    yb, yf = bop(x), op_w(x)
    sync(device)
    if not torch.equal(yb, yf) or (device.type == 'cuda' and
                                   _cuda.LAUNCHES['flat_banded_f64'] != 2):
        raise RuntimeError('BandedOperator disagrees with FlatBandedOperator')
    rec['banded_operator_bitwise'] = True
    # 3. the solve of phases 5 / 6 on the windowed operator
    if iters is not None:
        _cuda.reset_launches()
        xw, info, res, _, t_solve = solve_case(asm, op_w, device)
        rec['solve_launches'] = {k: v for k, v in _cuda.LAUNCHES.items()
                                 if v}
        xr, info_r, res_r, _, _ = solve_case(asm, op_ref, device)
        got = info['inner_iters'] if dim == 3 else sum(info['inner_iters'])
        rec.update(inner_iters=info['inner_iters'], residual=res,
                   inner_iters_banded=info_r['inner_iters'],
                   t_solve_ms=1e3 * t_solve,
                   x_rel=float((xw - xr).abs().max() / xr.abs().max()))
        log('  cg_ir on the windowed operator: inner %s (assemble_banded: '
            '%s), residual %.3e, x vs banded rel %.3e, launches %s'
            % (info['inner_iters'], info_r['inner_iters'], res,
               rec['x_rel'], rec['solve_launches']))
        if got != iters or info_r['inner_iters'] != info['inner_iters'] \
                or not res <= 1e-8:
            raise RuntimeError('windowed operator: inner %s, expected %s'
                               % (info['inner_iters'], iters))
    del op_w, bop, Dw, op_ref
    # 5. warm times: the route, its chains alone, the mirror, beside
    # assemble_banded() and its chains (K2 + K3)
    F = asm.field_fn(asm.geo_inputs())
    plan = ops['plan'] or [(t, False) for t in range(len(asm.terms))]
    rec['route_ms'] = time_ms(route, device)
    rec['chains_ms'] = time_ms(lambda: cs.assemble_terms_windowed(
        ops['wtabs'], ops['fss'], asm.tables.nqps, F, ops['plan'],
        ops['tperms']), device)
    if ops['tperms'] is not None:
        ix = tuple(p.reshape([-1 if a == k else 1 for a in range(d)])
                   for k, p in enumerate(ops['tperms']))
        rec['mirror_ms'] = time_ms(lambda: Z + Z[ix], device)
    # K4's layout from the banded-flat tensor: the regular layout's
    # reshape (one permuting copy) against the relayout's slices
    bsz = tuple(2 * b + 1 for b in bws)
    rec['reorder_ms'] = time_ms(lambda: bd.flat_banded_embed_device(
        sumfac.banded_reorder(Z, bsz, ns), bws, ns), device)
    rec['relayout_ms'] = time_ms(lambda: bd.flat_banded_from_padded_chain(
        Z, bws, ns, add_transpose=False), device)
    saved, cs.TAIL_FUSED = cs.TAIL_FUSED, False
    try:
        base = peak_reset(device)
        asm.assemble_banded()
        rec['banded_peak_bytes'] = peak_since(device, base)
        rec['assemble_banded_ms'] = time_ms(asm.assemble_banded, device)
        up = {}
        tabs = [[up.setdefault(id(T), torch.as_tensor(T, device=device))
                 for T in btabs[t]] for t, _m in plan]
        last_idx = sumfac.last_table_groups([btabs[t] for t, _m in plan])
        Fp = [F[t] for t, _m in plan]
        rec['banded_chains_ms'] = time_ms(
            lambda: cs.chain_folded(tabs, Fp, last_idx), device)
    finally:
        cs.TAIL_FUSED = saved
    log('  warm: windowed route %.3f ms (chains %.3f, mirror %s) | '
        'assemble_banded %.3f ms (K2 + K3 chains %.3f); peak %.1f / %.1f MB'
        % (rec['route_ms'], rec['chains_ms'],
           '%.3f' % rec['mirror_ms'] if 'mirror_ms' in rec else '-',
           rec['assemble_banded_ms'], rec['banded_chains_ms'],
           rec['peak_bytes'] / 1e6, rec['banded_peak_bytes'] / 1e6))
    log('  to the flat layout: regular-layout reshape %.3f ms, relayout '
        'slices %.3f ms' % (rec['reorder_ms'], rec['relayout_ms']))
    return rec


def peak_reset(device):
    """Reset the peak device bytes; returns those allocated now (0 on
    the CPU)."""
    if device.type != 'cuda':
        return 0
    sync(device)
    torch.cuda.reset_peak_memory_stats(device)
    return torch.cuda.memory_allocated(device)


def peak_since(device, base):
    """Peak device bytes above `base` since :func:`peak_reset`."""
    if device.type != 'cuda':
        return 0
    sync(device)
    return torch.cuda.max_memory_allocated(device) - base


def run_windowed_phase(device):
    """Phase 21: the windowed route end to end on the 3D p=3 n=48 twisted
    box (stiffness and mass) and the 2D p=3 NURBS quarter annulus n=128
    (stiffness).  Each case runs ``run_windowed_assembly`` with the
    launches counted from zero (K8 and K8f, the geometry stages' K2, no
    K3) and the peak device bytes; holds its compact take to
    ``run_device()`` (1e-14 relative) and to ``assemble_windowed()``
    (bitwise), its flat layout (``flat_banded_from_padded_chain``, no
    transpose) to ``assemble_banded().D`` (1e-13); solves the stiffness
    cases by phase 5 / 6's ``cg_ir`` on that operator ([7, 9, 9] at 3D,
    17 at 2D, each equal to ``assemble_banded()``'s); holds
    ``BandedOperator`` on ``banded_reorder(Z)`` to ``FlatBandedOperator``
    bitwise; and times the route, its chains alone and the mirror, warm,
    beside ``assemble_banded()`` and its K2 + K3 chains, and the two ways
    from Z to K4's layout (the regular layout's reshape, the relayout's
    slices)."""
    out = {}
    for dim, n, name, iters in WINDOWED_CASES:
        out['%s %dD n=%d' % (name, dim, n)] = windowed_route_case(
            dim, n, name, iters, device)
        torch.cuda.empty_cache()
    return out


################################################################################
# The headline's sibling lines (phases 4n, 22, 22b): the f32 line and n=96
################################################################################

# the f32 line (phase 22b): K1's two kinds, K2 and K3 in float32, K4's
# float instance
POISSON_F32_KERNELS = ('fields_f32', 'mass_fields_f32', 'stage_f32',
                       'fold_f32', 'flat_banded_f32')
# fibers of phase 22: random banded rows of the trailing axes, and two
# rows on the band's padding (the first dof's left offsets)
N96_FIBERS = 16
F32_TOL = 1e-5


class GlobalTF32:
    """torch's global TF32 switches on inside the block, restored after."""

    def __enter__(self):
        self.saved = (torch.get_float32_matmul_precision(),
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True

    def __exit__(self, *exc):
        torch.set_float32_matmul_precision(self.saved[0])
        torch.backends.cudnn.allow_tf32 = self.saved[1]


def f32_check(name, fn, plain, args, device, lib=None, tol=F32_TOL):
    """A float32 kernel at one shape against its plain version (`tol`
    relative to the largest output), bitwise on a repeat, and again with
    torch's global TF32 on (the kernel and the plain version both bitwise
    unchanged: neither may take TF32).  Returns the output, the error,
    its ratio and the yardstick `lib`'s output under TF32."""
    got, ref = fn(*args), plain(*args)
    sync(device)
    err, rel = compare(name, got, ref, tol)
    check_repeat(name, lambda: fn(*args), got)
    with GlobalTF32():
        got_tf, ref_tf = fn(*args), plain(*args)
        lib_tf = lib() if lib is not None else None
        sync(device)
    if not (torch.equal(got_tf, got) and torch.equal(ref_tf, ref)):
        raise RuntimeError('%s: global TF32 changed the f32 results' % name)
    return got, err, rel, lib_tf


def f32_case(name, fn, plain, args, device, flops, lib=None):
    """:func:`f32_check` with the kernel's ms, the plain version's, the
    one-call yardstick `lib`'s and the bound (its inputs and output over
    3.35 TB/s, `flops` over 67 TFLOP/s f32)."""
    got, err, rel, lib_tf = f32_check(name, fn, plain, args, device, lib)
    rec = dict(max_abs_err=err, rel=rel, shape=list(got.shape),
               repeat_equal=True, tf32_on_unchanged=True,
               ms=time_ms(lambda: fn(*args), device),
               plain_ms=time_ms(lambda: plain(*args), device, reps=3),
               library_ms=None if lib is None else time_ms(lib, device),
               **bound(nbytes(*[a for a in args if torch.is_tensor(a)],
                              got), flops, F32_PER_MS))
    if lib is not None:
        # the yardstick under TF32: the gap the kernels must not take
        rec['library_tf32_rel'] = float((lib_tf.double() - lib().double())
                                        .abs().max() / lib().double()
                                        .abs().max())
    return got, rec


# K2f / K3f's staging paths (K, R, M, X's offset in floats from a 16-byte
# boundary): R % 4 = 1, 2, 3 and 0 (scalar and float4 loads of X), X 4, 8
# and 12 bytes off, K not a multiple of the 8-deep slice, M = 1, 357, 385
# (scalar stores), 358 (float2) and 356 (float4)
F32_STAGE_RAGGED = ((13, 1001, 385, 0), (37, 4098, 1, 0), (203, 515, 357, 0),
                    (192, 36864, 357, 1), (192, 36866, 357, 2),
                    (192, 4099, 385, 3), (192, 4100, 356, 0),
                    (100, 4102, 358, 0))
# folds (K, R, M, table of each term, X's offset): 1, 2, 6 (3 tables, a
# table repeated out of order) and 16 terms, at odd and aligned R
F32_FOLD_RAGGED = ((192, 5001, 357, (0,), 0), (192, 5001, 357, (0, 0), 1),
                   (13, 4098, 385, (0, 1, 0, 2, 1, 2), 2),
                   (192, 4100, 357, (0, 1, 0, 2, 1, 2), 0),
                   (37, 1001, 1, tuple(t % 5 for t in range(16)), 3))
# the K2f shape past 2^31 output elements (R M = 2,177,700,357; X 4.7 GB,
# out 8.7 GB), checked on sampled rows
F32_BIG = (192, 6100001, 357)


def f32_offset_rand(rng, off, *shape):
    """A float32 operand on the card whose data starts `off` floats past
    a 16-byte boundary (a contiguous view into a larger tensor)."""
    n = int(np.prod(shape))
    base = torch.empty(n + off, dtype=torch.float32, device=rng['device'])
    base[off:] = torch.as_tensor(rng['rs'].rand(n), dtype=torch.float32,
                                 device=rng['device'])
    return base[off:].view(*shape)


def check_f32_staging(device, seed=22):
    """Phase 4n's ragged part: K2f and K3f through every staging path
    (:data:`F32_STAGE_RAGGED`, :data:`F32_FOLD_RAGGED`) by
    :func:`f32_check`, and K2f past 2^31 output elements
    (:data:`F32_BIG`): against the plain version on about 4,000 rows (the
    last 1,024, the 64 around row 2^31 / M and the rest drawn at random),
    bitwise on a repeat and with TF32 on."""
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    rng = dict(rs=np.random.RandomState(seed), device=device)
    stage, fold = {}, {}
    for K, R, M, off in F32_STAGE_RAGGED:
        X = f32_offset_rand(rng, off, K, R)
        T = f32_offset_rand(rng, 0, M, K)
        key = '%dx%dx%d X+%dB' % (K, R, M, 4 * off)
        _, err, rel, _ = f32_check('stage_f32 ' + key, cs.stage,
                                   cs.stage_plain, (X, T), device)
        stage[key] = dict(max_abs_err=err, rel=rel)
    for K, R, M, idx, off in F32_FOLD_RAGGED:
        xs = [f32_offset_rand(rng, off, K, R) for _ in idx]
        tabs = [f32_offset_rand(rng, 0, M, K) for _ in range(max(idx) + 1)]
        key = '%dx%dx%d,%d terms %s X+%dB' % (K, R, M, len(idx),
                                              ''.join(map(str, idx))
                                              if len(idx) < 10 else
                                              'over %d tables'
                                              % len(tabs), 4 * off)
        _, err, rel, _ = f32_check(
            'fold_f32 ' + key, lambda *a: cs.fold(list(a), tabs, list(idx)),
            lambda *a: cs.fold_plain(list(a), tabs, list(idx)), xs, device)
        fold[key] = dict(max_abs_err=err, rel=rel)
        del xs
    K, R, M = F32_BIG
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    X = torch.rand((K, R), generator=gen, device=device,
                   dtype=torch.float32)
    T = torch.rand((M, K), generator=gen, device=device, dtype=torch.float32)
    edge = (2 ** 31) // M
    rows = np.unique(np.concatenate([
        rng['rs'].randint(0, R, 4096 - 1024 - 64),
        np.arange(R - 1024, R), np.arange(edge - 32, edge + 32)]))
    rows = rows[rows < R]
    ri = torch.as_tensor(rows, device=device)
    sync(device)
    t0 = time.perf_counter()
    got = cs.stage(X, T)
    sync(device)
    ms = 1e3 * (time.perf_counter() - t0)
    ref = cs.stage_plain(X[:, ri].contiguous(), T)
    key = '%dx%dx%d (R M = %d)' % (K, R, M, R * M)
    err, rel = compare('stage_f32 ' + key, got[ri], ref, F32_TOL)
    check_repeat('stage_f32 ' + key, lambda: cs.stage(X, T), got)
    with GlobalTF32():
        same = torch.equal(cs.stage(X, T), got)
    if not same:
        raise RuntimeError('stage_f32 %s: global TF32 changed the result'
                           % key)
    stage[key] = dict(max_abs_err=err, rel=rel, rows_checked=len(rows),
                      host_ms=ms, out_bytes=R * M * 4)
    log('  stage_f32 %s: %d rows checked, %.1f ms by the host clock'
        % (key, len(rows), ms))
    del X, got, ref
    torch.cuda.empty_cache()
    return stage, fold


def check_f32_kernels(device, n=48, seed=21):
    """Phase 4n: the float32 instances of K1 (stiffness and ``mass``), K2
    and K3 against their plain versions on the card at the 3D p=3 n=48
    f32 line's shapes (the twisted box's geometry partials, the banded
    stage tables, the fold's 6 terms over 3 tables) and at ragged shapes,
    F32_TOL relative, bitwise on a repeat and unchanged under global
    TF32 (:func:`f32_case`).  Yardstick: one ``torch.matmul`` in float32
    with TF32 off for K2 (and K3 over its operands concatenated along K);
    K1 has none."""
    from pyiga_tpu_torch import _cuda
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    from pyiga_tpu_torch.ops import banded as bd
    from pyiga_tpu_torch.ops.sumfac import last_table_groups

    f32 = torch.float32
    rng = np.random.RandomState(seed)

    def rand(*shape):
        return torch.as_tensor(rng.rand(*shape), dtype=f32, device=device)

    asm = main_path_setup(3, n, device)
    out = {}
    gi = asm.geo_inputs(f32)
    Y, _ = cs.geo_stage12(gi['geo_tables_bsp'], gi['geo_coeffs'], 3)
    T = gi['geo_tables_bsp'][2][:2].contiguous()
    w12, wL = (gi['weights'][0][:, None] * gi['weights'][1]).reshape(-1), \
        gi['weights'][2]
    args = (Y, T, w12, wL, False)
    d, C, _, nL = Y.shape
    Q = w12.numel() * wL.numel()
    Y64, _ = cs.geo_stage12(asm.geo_inputs(torch.float64)['geo_tables_bsp'],
                            asm.geo_inputs(torch.float64)['geo_coeffs'], 3)
    args64 = tuple(a.double() if torch.is_tensor(a) else a
                   for a in (Y64,) + args[1:])
    for name, fn, plain, ops, entry in (
            ('fields_f32', cs.fields, cs.fields_plain, 2 * C * d * nL + 100,
             'stiff_fields'),
            ('mass_fields_f32', cs.fields_mass, cs.fields_mass_plain,
             2 * C * d * nL + 20, 'mass_fields')):
        got, out[name] = f32_case(name, fn, plain, args, device, Q * ops)
        out[name]['ragged'] = check_fields_ragged(
            'stiffness' if name == 'fields_f32' else 'mass', device,
            dtype=f32, tol=F32_TOL)
        # the bare C entries' device times, float32 and float64 on the same
        # geometry (the wrapper's host time hides them in `ms`)
        if device.type != 'cuda':
            continue
        for suffix, a, g in (('f32', args, got),
                             ('f64', args64, fn(*args64))):
            out[name]['bare_' + suffix] = bare_times(
                name, getattr(_cuda.library(), 'pyiga_%s_%s'
                              % (entry, suffix)),
                list(a[:4]) + [torch.empty_like(g)],
                lambda ts: tuple(t.data_ptr() for t in ts)
                + (d, 0, w12.numel(), wL.numel(), nL), device)
        out[name].update(device_ms=out[name]['bare_f32']['device_ms'],
                         launch_ms=out[name]['bare_f32']['launch_ms'])
        log('  %s bare: device %.4f ms (the f64 kernel %.4f ms)'
            % (name, out[name]['bare_f32']['device_ms'],
               out[name]['bare_f64']['device_ms']))
    del Y, Y64, args, args64

    bws = bd.band_info(asm.structure)
    btabs = asm.tables.banded_term_tables(asm.terms, bws)
    K, M = btabs[0][0].shape[1], btabs[0][0].shape[0]
    recs = []
    for R, Tt in ((K * K, btabs[0][0]), (K * M, btabs[0][1])):
        Tt = torch.as_tensor(Tt, dtype=f32, device=device)
        X = rand(K, R)
        _, r = f32_case('stage_f32 R=%d' % R, cs.stage, cs.stage_plain,
                        (X, Tt), device, 2 * K * R * M,
                        lib=lambda: torch.matmul(X.t(), Tt.t()))
        recs.append(r)
        del X
    out['stage_f32'] = dict(
        max_abs_err=max(r['max_abs_err'] for r in recs),
        rel=max(r['rel'] for r in recs),
        shapes=[[K, K * K, M], [K, K * M, M]], repeat_equal=True,
        tf32_on_unchanged=True,
        **{k: sum(r[k] for r in recs)
           for k in ('ms', 'plain_ms', 'library_ms')},
        **bound(sum(r['bound_bytes'] for r in recs),
                sum(r['bound_flops'] for r in recs), F32_PER_MS),
        each=recs)
    out['stage_f32']['ragged'] = check_stage_ragged('stage_f32', rand,
                                                    F32_TOL)

    plan = asm._fold()
    idx = list(last_table_groups([btabs[t] for t, _m in plan]))
    tabs = [None] * (max(idx) + 1)
    for (t, _m), i in zip(plan, idx):
        tabs[i] = torch.as_tensor(btabs[t][2], dtype=f32, device=device)
    xs = [rand(K, M * M) for _ in plan]
    xcat = torch.cat(xs, dim=0).t()
    tcat = torch.cat([tabs[i] for i in idx], dim=1).t()
    _, out['fold_f32'] = f32_case(
        'fold_f32', lambda *a: cs.fold(list(a), tabs, idx),
        lambda *a: cs.fold_plain(list(a), tabs, idx), xs, device,
        2 * K * M * M * M * len(set(idx)),
        lib=lambda: torch.matmul(xcat, tcat))
    out['fold_f32'].update(tables=len(tabs), shape=[len(xs), K, M * M, M])
    # the bound's bytes: the fields, the distinct tables and the output
    out['fold_f32'].update(bound(
        nbytes(*xs, *tabs) + M * M * M * 4,
        2 * K * M * M * M * len(set(idx)), F32_PER_MS))
    del xs, xcat, tcat
    out['fold_f32']['ragged'] = check_fold_ragged('fold_f32', rand, F32_TOL)
    out['stage_f32']['staging'], out['fold_f32']['staging'] = \
        check_f32_staging(device)
    for name in ('fields_f32', 'mass_fields_f32', 'stage_f32', 'fold_f32'):
        r = out[name]
        log('  %-16s kernel %.4f ms   plain %.4f ms   library %s   bound '
            '%.4f ms (%s)' % (name, r['ms'], r['plain_ms'],
                              'none' if r['library_ms'] is None
                              else '%.4f ms' % r['library_ms'],
                              r['bound_ms'], r['bound_by']))
    return out


class GCPauses:
    """The milliseconds the Python garbage collector ran inside the
    block (``gc.callbacks``): a pause there stalls the host that feeds
    the card."""

    def __enter__(self):
        import gc
        self.ms, self._t0 = 0.0, None

        def cb(phase, info):
            if phase == 'start':
                self._t0 = time.perf_counter()
            elif self._t0 is not None:
                self.ms += 1e3 * (time.perf_counter() - self._t0)
        self._cb = cb
        gc.callbacks.append(cb)
        return self

    def __exit__(self, *exc):
        import gc
        gc.callbacks.remove(self._cb)
        return False


def host_times(fn, device, reps=5):
    """`reps` calls of `fn`, each alone between synchronizes by the host
    clock, with the garbage collector's pauses inside each: ``ms``
    (each), ``gc_ms`` (each), and the median."""
    ms, gcs = [], []
    for _ in range(reps):
        sync(device)
        with GCPauses() as g:
            t0 = time.perf_counter()
            fn()
            sync(device)
            ms.append(1e3 * (time.perf_counter() - t0))
        gcs.append(g.ms)
    return dict(ms=ms, gc_ms=gcs, median_ms=float(np.median(ms)))


def profile_top(fn, device, k=8):
    """`fn()` once under ``torch.profiler`` (CPU and CUDA activity) after
    a warm call: the `k` operations with the most device time (ms, calls)
    and the device time in all.  A profiler that records no device time
    gives an empty list; one that fails is recorded, not raised (the
    smoke run does not depend on it)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync(device)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            sync(device)
        rows = []
        for e in prof.key_averages():
            t = getattr(e, 'device_time_total',
                        getattr(e, 'cuda_time_total', 0)) / 1e3
            if t > 0 and getattr(e, 'device_type', None) is not None \
                    and 'CUDA' in str(e.device_type):
                rows.append((t, e.key, e.count))
        rows.sort(reverse=True)
        host = sorted(((e.self_cpu_time_total / 1e3, e.key, e.count)
                       for e in prof.key_averages()), reverse=True)
        return dict(device_ms=sum(r[0] for r in rows),
                    top=[dict(ms=t, name=n[:80], calls=c)
                         for t, n, c in rows[:k]],
                    host_top=[dict(ms=t, name=n[:60], calls=c)
                              for t, n, c in host[:k]])
    except Exception as e:          # the profiler is optional here
        return dict(error='%s: %s' % (type(e).__name__, e))


def assembly_breakdown(asm, device):
    """``assemble_banded()``'s parts in float64 and float32 in one
    process, warm, by CUDA events: the fields (geometry stages by K2, K1),
    the chains (K2 stages, one K3), the relayout into K4's layout
    (``flat_banded_from_padded_chain``) and the whole call."""
    import pyiga_tpu_torch
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    from pyiga_tpu_torch.ops import sumfac
    from pyiga_tpu_torch.ops.banded import (band_info,
                                            flat_banded_from_padded_chain)
    bws = band_info(asm.structure)
    ns = tuple(b[0] for b in asm.structure.bs)
    plan = asm._fold() or [(t, False) for t in range(len(asm.terms))]
    btabs = asm.tables.banded_term_tables(asm.terms, bws)
    last_idx = sumfac.last_table_groups([btabs[t] for t, _m in plan])
    out = {}
    for dt in (torch.float64, torch.float32):
        up = {}
        tabs = [[up.setdefault(id(T), torch.as_tensor(T, dtype=dt,
                                                      device=device))
                 for T in btabs[t]] for t, _m in plan]
        F = asm.field_fn(asm.geo_inputs(dt))
        Fp = [F[t] for t, _m in plan]
        Z = cs.chain_folded(tabs, Fp, last_idx)
        r = dict(fields_ms=time_ms(lambda: asm.field_fn(asm.geo_inputs(dt)),
                                   device, reps=3),
                 chains_ms=time_ms(lambda: cs.chain_folded(tabs, Fp,
                                                           last_idx),
                                   device, reps=3),
                 relayout_ms=time_ms(lambda: flat_banded_from_padded_chain(
                     Z, bws, ns), device, reps=3))
        saved = pyiga_tpu_torch.get_dtype()
        pyiga_tpu_torch.set_dtype(dt)
        try:
            r['assemble_banded_ms'] = time_ms(asm.assemble_banded, device,
                                              reps=3)
        finally:
            pyiga_tpu_torch.set_dtype(saved)
        out[str(dt).replace('torch.', '')] = r
        log('  %s assemble_banded %.2f ms: fields %.2f, chains %.2f, '
            'relayout %.2f (warm, CUDA events)'
            % (dt, r['assemble_banded_ms'], r['fields_ms'], r['chains_ms'],
               r['relayout_ms']))
        del tabs, F, Fp, Z
    return out


def fiber_rows(asm, count, seed=12345):
    """`count` random banded rows of the trailing axes (``s_k = mu_k n_k +
    i_k``) and two on the band's padding (``mu_1 = 0`` at the first dofs:
    the offset leaves the matrix)."""
    from pyiga_tpu_torch.ops.banded import band_info
    bws = band_info(asm.structure)
    ns = [b[0] for b in asm.structure.bs]
    rng = np.random.RandomState(seed)
    rows = [[int(rng.randint((2 * b + 1) * n)) for b, n in
             zip(bws[1:], ns[1:])] for _ in range(count)]
    return rows + [[0] * (asm.dim - 1), [1] + [ns[2] + 5] * (asm.dim - 2)]


def run_n96(device, n=96):
    """Phase 22: the 3D p=3 twisted box at n=96 in float64 (970,299
    dofs): ``assemble_banded()`` with the peak device bytes from a reset
    just before it, then phase 5's ``cg_ir``, its counts held to the JAX
    package's on the CPU (:data:`POISSON_COUNTS_JAX`); 16 random banded
    fibers and two on the band's padding gathered from the card's flat
    layout and held to :func:`~pyiga_tpu_torch.ops.sumfac.
    banded_fibers_exact` on the host (1e-13 relative to the largest
    entry); the windowed route at n=96 (its outputs past 2^31 bytes) laid
    into the flat layout and held to ``assemble_banded().D`` (1e-14),
    with its own peak bytes."""
    from pyiga_tpu_torch import _cuda
    from pyiga_tpu_torch.ops import banded as bd
    from pyiga_tpu_torch.ops import sumfac

    t0 = time.perf_counter()
    asm = main_path_setup(3, n, device)
    t_host = time.perf_counter() - t0
    bws = bd.band_info(asm.structure)
    ns = tuple(b[0] for b in asm.structure.bs)
    rec = dict(dim=3, n=n, p=3, ndofs=int(np.prod(ns)),
               t_host_setup_ms=1e3 * t_host)
    base = peak_reset(device)
    _cuda.reset_launches()
    t0 = time.perf_counter()
    op = asm.assemble_banded()
    sync(device)
    rec['t_assembly_ms'] = 1e3 * (time.perf_counter() - t0)
    rec['peak_bytes_assembly'] = peak_since(device, base)
    rec['max_memory_allocated'] = (torch.cuda.max_memory_allocated(device)
                                   if device.type == 'cuda' else 0)
    x, info, res, t_setup, t_solve = solve_case(asm, op, device)
    rec['peak_bytes'] = peak_since(device, base)
    rec['launches'] = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    rec.update(t_precond_setup_ms=1e3 * t_setup, t_solve_ms=1e3 * t_solve,
               dof_per_s=rec['ndofs'] / (1e-3 * (rec['t_assembly_ms']
                                                 + 1e3 * t_solve)),
               outer=info['outer'], inner_iters=info['inner_iters'],
               iters=sum(info['inner_iters']), residual=res,
               D_bytes=nbytes(op.D))
    log('  3D p=3 n=%d: %d dofs; host setup %.1f ms; assembly %.2f ms, '
        'solve %.2f ms (precond setup %.1f ms); peak %.1f MB above %.1f MB '
        '(assembly %.1f MB), max_memory_allocated %.1f MB'
        % (n, rec['ndofs'], rec['t_host_setup_ms'], rec['t_assembly_ms'],
           rec['t_solve_ms'], rec['t_precond_setup_ms'],
           rec['peak_bytes'] / 1e6, base / 1e6,
           rec['peak_bytes_assembly'] / 1e6,
           rec['max_memory_allocated'] / 1e6))
    outer, inner = POISSON_COUNTS_JAX[('float64', n)]
    log('  outer %d inner_iters %s (JAX CPU: %s %s), rel residual %.3e, '
        'launches %s' % (info['outer'], info['inner_iters'], outer, inner,
                         res, rec['launches']))
    if (info['outer'], info['inner_iters']) != (outer, inner) \
            or not res <= 1e-8:
        raise RuntimeError('n=%d: cg_ir gives %s %s, the JAX package %s %s'
                           % (n, info['outer'], info['inner_iters'], outer,
                              inner))
    missing = [k for k in POISSON_KERNELS if _cuda.LAUNCHES[k] <= 0]
    if missing and device.type == 'cuda':
        raise RuntimeError('n=%d path never launched %s' % (n, missing))
    del x

    rows = fiber_rows(asm, N96_FIBERS)
    t0 = time.perf_counter()
    host = sumfac.banded_fibers_exact(asm, rows)
    rec['t_fibers_host_ms'] = 1e3 * (time.perf_counter() - t0)
    got = sumfac.banded_fibers(op.D, bws, ns, rows).cpu().numpy()
    scale = np.abs(host).max()
    rel = np.abs(got - host).max(axis=1) / scale
    rec.update(fibers=len(rows), fiber_rel=rel.tolist(),
               fiber_rel_max=float(rel.max()),
               padding_fibers_zero=bool(not got[-2:].any()
                                        and not host[-2:].any()))
    log('  %d fibers vs the host float64 chain: max rel %.3e (tol 1e-13); '
        'padding fibers zero on both sides: %s'
        % (len(rows), rec['fiber_rel_max'], rec['padding_fibers_zero']))
    if not (rel.max() <= 1e-13 and rec['padding_fibers_zero']):
        raise RuntimeError('n=%d fibers disagree with the host chain' % n)

    ops = asm._windowed_operands()
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    base = peak_reset(device)
    _cuda.reset_launches()
    t0 = time.perf_counter()
    Z = sumfac.run_windowed_assembly(
        asm.field_fn, asm.geo_inputs(), ops['wtabs'], ops['fss'],
        asm.tables.nqps, ops['plan'], ops['tperms'])
    sync(device)
    rec['windowed_ms'] = 1e3 * (time.perf_counter() - t0)
    rec['windowed_peak_bytes'] = peak_since(device, base)
    rec['windowed_launches'] = {k: v for k, v in _cuda.LAUNCHES.items()
                                if v}
    if device.type == 'cuda' and any(_cuda.LAUNCHES[k] <= 0
                                     for k in WINDOWED_KERNELS):
        raise RuntimeError('n=%d windowed route missed a kernel' % n)
    Dw = bd.flat_banded_from_padded_chain(Z, bws, ns, add_transpose=False)
    del Z
    rec['windowed_flat_max_abs_err'], rec['windowed_flat_rel'] = compare(
        'n=%d windowed flat vs banded' % n, Dw, op.D, 1e-14)
    log('  windowed route %.2f ms cold, peak %.1f MB above the operator, '
        'launches %s' % (rec['windowed_ms'], rec['windowed_peak_bytes'] / 1e6,
                         rec['windowed_launches']))
    del Dw, op
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    rec['t_assembly_warm_ms'] = time_ms(asm.assemble_banded, device, reps=2,
                                        warmup=1)
    log('  assemble_banded warm %.2f ms' % rec['t_assembly_warm_ms'])
    return rec


def run_f32_line(device, n=48):
    """Phase 22b: the f32 line (``bench.py:333-361``, solve ``:482-499``)
    at 3D p=3 n=48 on the twisted box.  Phase 5's float64 operator and
    ``cg_ir`` solution first (the same right-hand side), then under
    ``set_dtype(float32)``, launches counted from zero:
    ``assemble_banded()`` (K2 f32 geometry stages, K1 f32, K2 f32 chain
    stages, K3 f32; a float32 ``FlatBandedOperator``), then ``cg`` on
    ``RestrictedOperator`` with the float32 weighted fastdiag, tol 1e-8,
    maxiter 600 (K4 f32); and ``MassAssembler.assemble_banded()`` (K1
    f32's mass kind).  Records the count beside the JAX package's on the
    CPU for the port's float32 operator (:data:`POISSON_COUNTS_JAX`),
    holds the solution to the float64 one (1e-5 relative in the 2-norm;
    the max-norm ratio recorded beside it) and both
    operators to their float64 counterparts (1e-6 relative to the
    largest entry).  ``set_dtype(float64)`` is restored in a
    ``finally``."""
    import pyiga_tpu_torch
    from pyiga_tpu_torch import _cuda, bspline, geometry, solvers
    from pyiga_tpu_torch.assemblers import MassAssembler
    from pyiga_tpu_torch.ops.fastdiag import (fastdiag_precond_weighted,
                                              interior_dofs)
    from pyiga_tpu_torch.ops.matfree import RestrictedOperator

    asm = main_path_setup(3, n, device)
    mass = MassAssembler(asm.kvs, geometry.twisted_box(), device=device)
    op64 = asm.assemble_banded()
    M64 = mass.assemble_banded().D
    x64, info64, _, _, _ = solve_case(asm, op64, device)
    free = interior_dofs(asm.kvs)
    b = torch.as_tensor(np.random.RandomState(0).rand(len(free)),
                        dtype=torch.float32, device=device)
    rec = dict(dim=3, n=n, p=3, ndofs=op64.shape[0],
               f64_inner_iters=info64['inner_iters'])
    pyiga_tpu_torch.set_dtype(np.float32)
    try:
        runs = []
        for rep in range(2):               # cold, then warm
            _cuda.reset_launches()
            sync(device)
            mem0 = torch.cuda.memory_stats(device) \
                if device.type == 'cuda' else {}
            with GCPauses() as pauses:
                t0 = time.perf_counter()
                op32 = asm.assemble_banded()
                sync(device)
                t_asm = time.perf_counter() - t0
            mem1 = torch.cuda.memory_stats(device) \
                if device.type == 'cuda' else {}
            allocs = {k: mem1[k] - mem0.get(k, 0) for k in
                      ('num_alloc_retries', 'segment.all.allocated',
                       'segment.all.freed') if k in mem1}
            t0 = time.perf_counter()
            P = fastdiag_precond_weighted(asm, dirichlet=True)
            sync(device)
            t_setup = time.perf_counter() - t0
            A = RestrictedOperator(op32, free)
            t0 = time.perf_counter()
            x32, it = solvers.cg(A, b, tol=1e-8, maxiter=600, precond=P)
            sync(device)
            t_solve = time.perf_counter() - t0
            launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
            runs.append(dict(t_assembly_ms=1e3 * t_asm,
                             t_precond_setup_ms=1e3 * t_setup,
                             t_solve_ms=1e3 * t_solve, cg_iters=it,
                             dof_per_s=rec['ndofs'] / (t_asm + t_solve),
                             launches=launches, allocator=allocs,
                             gc_ms=pauses.ms))
        # more assemblies where the two timed ones ran: each alone by the
        # host clock with the collector's pauses, then under the profiler
        rec['assembly_host'] = host_times(asm.assemble_banded, device)
        rec['profile_in_place'] = profile_top(asm.assemble_banded, device)
        log('  f32 assemble_banded in place: allocator %s / %s; host ms %s, '
            'gc ms %s; profiler device %.3f ms'
            % (runs[0]['allocator'], runs[1]['allocator'],
               ['%.1f' % t for t in rec['assembly_host']['ms']],
               ['%.1f' % t for t in rec['assembly_host']['gc_ms']],
               rec['profile_in_place'].get('device_ms', float('nan'))))
        _cuda.reset_launches()
        M32 = mass.assemble_banded().D
        sync(device)
        mass_launches = _cuda.LAUNCHES['mass_fields_f32']
        dtypes = (op32.D.dtype, M32.dtype, P(b).dtype, x32.dtype)
    finally:
        pyiga_tpu_torch.set_dtype(np.float64)
    rec.update(runs[0], warm=runs[1], mass_launches=mass_launches,
               dtypes=[str(t) for t in dtypes])
    rec['launches']['mass_fields_f32'] = mass_launches
    if any(t != torch.float32 for t in dtypes):
        raise RuntimeError('the f32 line computed in %s' % (dtypes,))
    rec['D_rel_vs_f64'] = float((op32.D.double() - op64.D).abs().max()
                                / op64.D.abs().max())
    rec['mass_rel_vs_f64'] = float((M32.double() - M64).abs().max()
                                   / M64.abs().max())
    # the solution against the float64 one: relative in the 2-norm (the
    # gate) and in the max norm (recorded; the float32 operator alone
    # moves it ~5e-6 at n=48, f32 CG's attainable accuracy as much again)
    dx = x32.double() - x64
    rec['x_rel_vs_f64'] = float(torch.linalg.vector_norm(dx)
                                / torch.linalg.vector_norm(x64))
    rec['x_maxrel_vs_f64'] = float(dx.abs().max() / x64.abs().max())
    r64 = RestrictedOperator(op64, free)
    bd64 = b.double()
    rec['residual_f64'] = float(torch.linalg.vector_norm(bd64 - r64(
        x32.double())) / torch.linalg.vector_norm(bd64))
    rec['cg_iters_jax'] = POISSON_COUNTS_JAX[('float32', n)]
    log('  f32 n=%d: assembly %.2f ms (warm %.2f), solve %.2f ms (warm %.2f)'
        ', precond setup %.1f ms; cg %d iterations (JAX CPU on this operator'
        ': %d); %.0f dof/s warm' % (n, rec['t_assembly_ms'],
                                    rec['warm']['t_assembly_ms'],
                                    rec['t_solve_ms'],
                                    rec['warm']['t_solve_ms'],
                                    rec['t_precond_setup_ms'],
                                    rec['cg_iters'], rec['cg_iters_jax'],
                                    rec['warm']['dof_per_s']))
    log('  D32 vs D64 rel %.3e, mass rel %.3e, x32 vs x64 rel %.3e (2-norm,'
        ' tol 1e-5; max norm %.3e), f64 residual of x32 %.3e; launches %s'
        % (rec['D_rel_vs_f64'], rec['mass_rel_vs_f64'], rec['x_rel_vs_f64'],
           rec['x_maxrel_vs_f64'], rec['residual_f64'], rec['launches']))
    missing = [k for k in POISSON_F32_KERNELS if rec['launches'].get(k, 0)
               <= 0]
    f64_kernels = [k for k in ('fields', 'mass_fields', 'stage', 'fold',
                               'flat_banded_f64', 'stage_T', 'tail_fused')
                   if rec['launches'].get(k, 0)]
    if (missing and device.type == 'cuda') or f64_kernels:
        raise RuntimeError('f32 line: kernels never launched %s, float64 '
                           'kernels launched %s' % (missing, f64_kernels))
    if not (rec['x_rel_vs_f64'] <= 1e-5 and rec['cg_iters'] < 600
            and rec['D_rel_vs_f64'] <= 1e-6
            and rec['mass_rel_vs_f64'] <= 1e-6):
        raise RuntimeError('f32 line disagrees with the float64 line')
    del op32, op64, M32, M64
    rec['breakdown'] = assembly_breakdown(asm, device)

    def f32_assembly():
        pyiga_tpu_torch.set_dtype(np.float32)
        try:
            asm.assemble_banded()
        finally:
            pyiga_tpu_torch.set_dtype(np.float64)
    rec['profile_f32_assembly'] = profile_top(f32_assembly, device)
    log('  f32 assemble_banded under the profiler: %s'
        % json.dumps(rec['profile_f32_assembly'])[:600])
    return rec


################################################################################
# Every assembly path in float32 (phases 4o, 22c)
################################################################################

# the float32 instances of K1's jac kind, K1', K5, K8 and K8f
F32_ASSEMBLY_KERNELS = ('geo_jac_fields_f32', 'host_jac_fields_f32',
                        'vform_fields_f32', 'windowed_stage_f32',
                        'windowed_fold_f32')
# the float64 kernels of the assembly paths: none may launch under float32
F64_ASSEMBLY_KERNELS = ('fields', 'mass_fields', 'geo_jac_fields',
                        'host_jac_fields', 'stage', 'fold', 'stage_T',
                        'tail_fused', 'vform_fields', 'windowed_stage',
                        'windowed_fold', 'flat_banded_f64')
# phase 4o's tolerance: relative to the largest output
F32_ASM_TOL = 2e-6
# float64 arithmetic or conversions in SASS: a float32 instance holds none
SASS_F64 = re.compile(r'\b(D(ADD|MUL|FMA|SETP|MNMX|MMA)|[FI]2[FI]\S*F64)\b')
# the float32 instances in the package's library, by mangled name: K1
# (S = float last), K1' <D, float>, K8 / K8f <float, B, RPT>, K2 / K3 f32,
# K4's float instance
SASS_F32_KERNELS = {
    'geo_fields_kernel<float>': re.compile(r'geo_fields_kernelI.*Lb[01]EfE'),
    'host_jac_fields_kernel<float>': re.compile(
        r'host_jac_fields_kernelILi[23]EfE'),
    'windowed_kernel<float>': re.compile(r'windowed_kernelIfLi'),
    'fold_f32_kernel': re.compile(r'fold_f32_kernel'),
    'flat_banded_kernel<float>': re.compile(r'flat_banded_kernelIfE'),
}


class ComputeDtype:
    """``set_dtype(dtype)`` inside the block, the caller's dtype restored
    after it (also when the block raises)."""

    def __init__(self, dtype):
        self.dtype = dtype

    def __enter__(self):
        import pyiga_tpu_torch
        self.saved = pyiga_tpu_torch.get_dtype()
        pyiga_tpu_torch.set_dtype(self.dtype)

    def __exit__(self, *exc):
        import pyiga_tpu_torch
        pyiga_tpu_torch.set_dtype(self.saved)


def sass_functions(path):
    """``{function: [SASS lines]}`` of a library, by ``cuobjdump
    --dump-sass`` from the toolkit that built it."""
    from pyiga_tpu_torch import _cuda
    tool = os.path.join(os.path.dirname(_cuda._nvcc()), 'cuobjdump')
    sass = subprocess.run([tool, '--dump-sass', path], check=True,
                          capture_output=True, text=True,
                          timeout=300).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        if 'Function :' in line:
            fn = line.split('Function :')[1].strip()
            out[fn] = []
        elif fn is not None:
            out[fn].append(line)
    return out


def sass_f64_free(lib_path, gen_paths, families=None,
                  gen_kernels=('vform_fields_kernel',)):
    """The float32 instances' SASS holds no float64 arithmetic or
    conversion (:data:`SASS_F64`): every function of the package's library
    that `families` (default :data:`SASS_F32_KERNELS`) names, and the
    kernels `gen_kernels` of each generated float32 library in
    `gen_paths`.  Returns per family the instances checked and the
    float64 instructions found; raises if a family has no instance or any
    instruction is found."""
    families = SASS_F32_KERNELS if families is None else families
    found = {k: dict(instances=0, f64=[]) for k in families}
    for name in gen_kernels:
        found['%s (float32)' % name] = dict(instances=0, f64=[])
    for fn, lines in sass_functions(lib_path).items():
        for fam, pat in families.items():
            if pat.search(fn):
                found[fam]['instances'] += 1
                found[fam]['f64'] += [ln.strip() for ln in lines
                                      if SASS_F64.search(ln)][:5]
    for path in gen_paths:
        for fn, lines in sass_functions(path).items():
            for name in gen_kernels:
                if name in fn:
                    rec = found['%s (float32)' % name]
                    rec['instances'] += 1
                    rec['f64'] += [ln.strip() for ln in lines
                                   if SASS_F64.search(ln)][:5]
    for fam, r in found.items():
        log('  SASS %-32s %3d float32 instances, float64 instructions: %s'
            % (fam, r['instances'], r['f64'] or 'none'))
    bad = [k for k, r in found.items() if r['f64'] or not r['instances']]
    if bad:
        raise RuntimeError('float64 instructions in (or no instance of) the '
                           'float32 kernels %s' % bad)
    return found


def host_jac_f32_case(name, jac, w12, wL, device):
    """K1' in float32 against its plain version (:func:`f32_check`,
    F32_ASM_TOL), timed as :func:`jac_case`."""
    from pyiga_tpu_torch import _cuda
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    args = (jac, w12, wL)
    got, err, rel, _ = f32_check("K1' f32 " + name, cs.host_jac_fields,
                                 cs.host_jac_fields_plain, args, device,
                                 tol=F32_ASM_TOL)
    d = jac.shape[0]
    rec = dict(max_abs_err=err, rel=rel, shape=list(got.shape),
               repeat_equal=True, tf32_on_unchanged=True,
               ms=time_ms(lambda: cs.host_jac_fields(*args), device,
                          reps=50),
               plain_ms=time_ms(lambda: cs.host_jac_fields_plain(*args),
                                device, reps=3),
               library_ms=None,
               # det, adjugate, the unique products: ~60 operations a point
               **bound(nbytes(jac, w12, wL, got), 60 * got.shape[1],
                       F32_PER_MS))
    rec.update(bare_times(
        'host_jac_fields_f32', _cuda.library().pyiga_host_jac_fields_f32,
        [jac, w12, wL, torch.empty_like(got)],
        lambda ts: tuple(t.data_ptr() for t in ts)
        + (d, w12.numel(), wL.numel()), device))
    return rec


def check_f32_assembly_kernels(device):
    """Phase 4o: the float32 instances of K1's ``jac`` kind, K1', K5, K8
    and K8f against their plain versions on the card (F32_ASM_TOL = 2e-6
    relative to the largest output, bitwise on a repeat, bitwise
    unchanged with torch's global TF32 on), each with its device time,
    bound and yardstick: K1 ``jac`` at the 3D p=3 n=48 twisted box, the 2D
    n=128 NURBS quarter annulus, a surface (G = 3, the extruded annulus's
    'left' face at n=128), a boundary grid (QL = 1, its 'left' face at
    3D n=48) and ragged shapes; K1' at the 2D n=128 polar annulus (a
    ``UserFunction``), the 3D n=48 twisted box's Jacobian and ragged
    shapes; K5 on the 2D n=128 convection-diffusion form, the 3D n=48
    stiffness form and ``v * ds`` on the 'left' face (its rows mapping,
    also bitwise against its columns mapping); K8 / K8f at phase 4m's
    shapes (every copy and store path, each launch's plan held to
    ``windowed_plan(..., esize=4)``).  Then the SASS of every float32
    instance, the generated float32 K5 libraries included, holds no
    float64 instruction (:func:`sass_f64_free`)."""
    from pyiga_tpu_torch import _cuda, geometry
    from pyiga_tpu_torch.assemblers import StiffnessAssembler
    from pyiga_tpu_torch.ops import cuda_sumfac as cs
    from pyiga_tpu_torch.ops import geom
    f32 = torch.float32
    out = {}
    with ComputeDtype(f32):
        # K1 jac f32 and K5 f32 on the forms' own operands
        forms = {'2d_n128_convdiff': convdiff_setup(128, device)[2],
                 '3d_n48_stiffness': surface_asm(
                     'inner(grad(u), grad(v)) * dx', 3, 48, device,
                     geo=geometry.twisted_box()),
                 'v_ds_left_n48': surface_asm('v * ds', 3, 48, device,
                                              boundary='left')}
        jac = {key: jac_case(asm, device, key, tol=F32_ASM_TOL)
               for key, asm in (('3d_n48_bspline',
                                 forms['3d_n48_stiffness']),
                                ('2d_n128_nurbs', forms['2d_n128_convdiff']),
                                ('surface_nurbs_n128', surface_vf(device)),
                                ('face_left_n48', forms['v_ds_left_n48']))}
        k5 = {key: vform_case(asm, device, tol=F32_ASM_TOL, name=key)
              for key, asm in forms.items()}
        for r in k5.values():
            r.update(repeat_equal=True, tf32_on_unchanged=True)
        # the twisted box's float32 Jacobian and weights, for K1' at 3D
        ops3 = forms['3d_n48_stiffness']._device_operands()
        _, jac3 = cs.geometry_fields(ops3['geo_tables'], ops3['geo_coeffs'],
                                     False)
        jac3 = jac3.reshape(3, 3, -1).contiguous()
        w3 = geom.gauss_weight_factors(ops3['inputs']['weights'])
        del forms, ops3
    torch.cuda.empty_cache()
    out['geo_jac_fields_f32'] = dict(
        jac['3d_n48_bspline'], cases=jac,
        ragged=check_fields_ragged('jac', device, dtype=f32,
                                   tol=F32_ASM_TOL))
    out['vform_fields_f32'] = dict(k5['2d_n128_convdiff'], cases=k5)

    # K1' f32
    hj = {}
    gi = StiffnessAssembler(kvs_of(2, 128), polar_annulus(),
                            device=device).geo_inputs(f32)
    jac2, _ = cs._host_jacobian(gi)
    hj['2d_n128_user'] = host_jac_f32_case(
        '2D n=128', jac2, *geom.gauss_weight_factors(gi['weights']), device)
    hj['3d_n48_twisted'] = host_jac_f32_case('3D n=48', jac3, *w3, device)
    del gi, jac2, jac3
    out['host_jac_fields_f32'] = dict(
        hj['2d_n128_user'], cases=hj,
        ragged=check_host_jac_ragged(device, dtype=f32, tol=F32_ASM_TOL))

    # K8 / K8f f32
    out.update(check_windowed_kernels(device, dtype=f32, tol=F32_ASM_TOL))
    for k in ('windowed_stage_f32', 'windowed_fold_f32'):
        out[k].update(tf32_on_unchanged=True)

    gen = [k for k in _cuda.GEN_BUILDS
           if os.path.basename(k).startswith('libvform_fields_f32_')]
    out['sass_f64_free'] = sass_f64_free(_cuda.BUILD_INFO['path'], gen)
    for name in F32_ASSEMBLY_KERNELS:
        r = out[name]
        log('  %-20s kernel %.4f ms   device %s   plain %.4f ms   library '
            '%s   bound %.4f ms (%s)'
            % (name, r['ms'], '%.4f ms' % r['device_ms']
               if 'device_ms' in r else '-', r['plain_ms'],
               'none' if r['library_ms'] is None
               else '%.4f ms' % r['library_ms'], r['bound_ms'],
               r['bound_by']))
    return out


def f32_launches(what, expect, device):
    """The launches counted since the last reset (nonzero ones), raising
    if a float32 kernel of `expect` never launched on the card or any
    float64 assembly kernel launched (:data:`F64_ASSEMBLY_KERNELS`)."""
    from pyiga_tpu_torch import _cuda
    sync(device)
    launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    missing = [k for k in expect if launches.get(k, 0) <= 0]
    f64 = [k for k in F64_ASSEMBLY_KERNELS if launches.get(k, 0)]
    log('  %s launches: %s' % (what, launches))
    if (missing and device.type == 'cuda') or f64:
        raise RuntimeError('%s: float32 kernels never launched %s, float64 '
                           'kernels launched %s' % (what, missing, f64))
    return launches


def rel_to(got, ref):
    """max |got - ref| over max |ref| (tensors, numpy or scipy sparse)."""
    if hasattr(got, 'tocsr'):
        return float(abs(got - ref).max() / abs(ref).max())
    got = torch.as_tensor(np.asarray(got) if not torch.is_tensor(got)
                          else got).double().cpu()
    ref = torch.as_tensor(np.asarray(ref) if not torch.is_tensor(ref)
                          else ref).double().cpu()
    return float((got - ref).abs().max() / ref.abs().max())


def best_ms(fn, device, reps=3):
    """Best of `reps` calls of `fn` after a warm one, by the host clock
    around synchronizes (as phase 7 times ``run_device``)."""
    fn()
    sync(device)
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync(device)
        best = min(best, time.perf_counter() - t0)
    return 1e3 * best


def f32_convdiff(device, n=128):
    """Phase 22c (a): phase 7's convection-diffusion VForm at 2D p=3
    n=128 in float32: ``run_device()`` (K1 jac, K5, K2 / K3 in float32)
    and ``assemble()`` (float64 data holding the float32 values) timed,
    the matrix held to phase 7's float64 one (1e-6 relative to its
    largest entry), and phase 7's GMRES solve on it, its count held to the
    JAX package's on the port's float32 matrix on the CPU
    (:data:`CONVDIFF_COUNTS_JAX`).  The card's float32 compact data goes
    to ``chiprun_out/f32_convdiff_n128.npy`` (its JAX count:
    ``scripts/jax_poisson_counts.py convdiff 128 --data``)."""
    from pyiga_tpu_torch import _cuda
    kvs, geo, asm, asm_f = convdiff_setup(n, device)
    D64 = asm.run_device()[(None, None)]
    f = asm_f.assemble_vector()
    _, it64, _, _, _ = solve_convdiff(asm, D64, f, device)
    with ComputeDtype(torch.float32):
        _cuda.reset_launches()
        D32 = asm.run_device()[(None, None)]
        launches = f32_launches('convdiff f32', (
            'geo_jac_fields_f32', 'vform_fields_f32', 'stage_f32',
            'fold_f32'), device)
        t_run = best_ms(asm.run_device, device)
        t_asm = best_ms(asm.assemble, device)
        A32 = asm.assemble()
    if D32.dtype != torch.float32 or A32.data.dtype != np.float64 or \
            not np.array_equal(A32.data, D32.cpu().numpy().astype(np.float64)):
        raise RuntimeError('convdiff f32: run_device %s, assemble() %s'
                           % (D32.dtype, A32.data.dtype))
    rel = rel_to(D32, D64)
    x32, it32, res32, _, t_solve = solve_convdiff(asm, D32.double(), f,
                                                  device)
    os.makedirs(os.path.join(REPO, 'chiprun_out'), exist_ok=True)
    np.save(os.path.join(REPO, 'chiprun_out', 'f32_convdiff_n%d.npy' % n),
            D32.cpu().numpy())
    jax_it = CONVDIFF_COUNTS_JAX[('float32', n)]
    rec = dict(n=n, t_run_device_ms=t_run, t_assemble_ms=t_asm,
               D_rel_vs_f64=rel, gmres_iters=it32, gmres_iters_f64=it64,
               gmres_iters_jax=jax_it, residual=res32,
               t_solve_ms=t_solve * 1e3, launches=launches)
    log('  convdiff f32 n=%d: run_device %.2f ms, assemble() %.2f ms; D vs '
        'f64 rel %.3e; GMRES %d (f64 matrix %d, JAX CPU on the port\'s f32 '
        'matrix %d), residual %.3e' % (n, t_run, t_asm, rel, it32, it64,
                                      jax_it, res32))
    if not (rel <= 1e-6 and res32 <= 1e-9 and it32 == jax_it):
        raise RuntimeError('convdiff f32: rel %.3e, GMRES %d (JAX %d), '
                           'residual %.3e' % (rel, it32, jax_it, res32))
    return rec


def f32_vform_aca(device, n=48, p=3):
    """Phase 22c (b): the 3D p=3 n=48 twisted box in float32: the VForm
    stiffness (``assemble.assemble``'s string form through K1 jac, K5,
    K2 / K3 in float32) held to the float32 ``StiffnessAssembler.
    run_device()`` (2e-6 relative to its largest entry), and
    ``aca_3d_device`` on phase 13's assembler with ``tol=1e-6`` (float32
    slices, float64 crosses) held to the float64 ``run_device()`` (1e-5),
    its pivot count recorded beside phase 13's."""
    from pyiga_tpu_torch import _cuda, geometry, lowrank
    from pyiga_tpu_torch.assemble import instantiate_assembler
    from pyiga_tpu_torch.compile import compile_vform
    from pyiga_tpu_torch.vform import stiffness_vf
    kvs = kvs_of(3, n, p)
    geo = geometry.twisted_box()
    sasm = main_path_setup(3, n, device)
    vasm = instantiate_assembler('inner(grad(u), grad(v)) * dx', kvs,
                                 {'geo': geo}, None, device=device)
    aasm = compile_vform(stiffness_vf(3))(kvs, geo=geo, device=device)
    ref64 = aasm.run_device()[(None, None)].cpu().numpy()
    counts = []
    inflate = lowrank._aca_inflate

    def counting(cols, mats, count, shp):
        counts.append(int(count))
        return inflate(cols, mats, count, shp)
    with ComputeDtype(torch.float32):
        S32 = sasm.run_device()
        _cuda.reset_launches()
        V32 = vasm.run_device()[(None, None)]
        launches = f32_launches('VForm stiffness f32', (
            'geo_jac_fields_f32', 'vform_fields_f32', 'stage_f32',
            'fold_f32'), device)
        t_vform = best_ms(vasm.run_device, device)
        rel_v = rel_to(V32, S32)
        del V32, S32
        lowrank._aca_inflate = counting
        try:
            _cuda.reset_launches()
            t0 = time.perf_counter()
            X = lowrank.aca_3d_device(aasm, tol=1e-6, verbose=0)
            sync(device)
            t_cold = 1e3 * (time.perf_counter() - t0)
            aca_launches = f32_launches('ACA f32', (
                'geo_jac_fields_f32', 'vform_fields_f32', 'stage_f32'),
                device)
            t0 = time.perf_counter()            # warm, as phase 13 times it
            X = lowrank.aca_3d_device(aasm, tol=1e-6, verbose=0)
            sync(device)
            t_aca = 1e3 * (time.perf_counter() - t0)
            fields = aasm._slice_operands()[0]
            slice_dtypes = sorted({str(F.dtype) for F in fields})
            del fields
        finally:
            lowrank._aca_inflate = inflate
    rel_a = rel_to(X, ref64)
    rec = dict(n=n, p=p, t_vform_run_device_ms=t_vform, vform_rel=rel_v,
               vform_launches=launches, t_aca_cold_ms=t_cold, t_aca_ms=t_aca,
               aca_rel=rel_a, aca_pivots=counts[-1],
               aca_pivots_cold=counts[0],
               aca_pivots_f64_tol1e10=ACA_PIVOTS[n],
               slice_dtypes=slice_dtypes, aca_dtype=str(X.dtype),
               aca_launches=aca_launches)
    log('  3D n=%d f32: VForm stiffness run_device %.2f ms, vs f32 '
        'StiffnessAssembler rel %.3e; aca_3d_device(tol=1e-6) cold %.1f ms '
        '(the float32 K5 program\'s build included), warm %.1f ms, %d pivots '
        '(phase 13 f64 tol 1e-10: %d), vs f64 run_device rel %.3e, slices '
        '%s, crosses %s' % (n, t_vform, rel_v, t_cold, t_aca, counts[-1],
                            ACA_PIVOTS[n], rel_a, slice_dtypes, X.dtype))
    if not (rel_v <= F32_ASM_TOL and rel_a <= 1e-5
            and counts[0] == counts[-1]
            and slice_dtypes == ['torch.float32'] and X.dtype == np.float64):
        raise RuntimeError('3D f32 VForm / ACA: rel %.3e / %.3e'
                           % (rel_v, rel_a))
    return rec


# phase 22c (c)'s cases: (dim, n, assembler, float32 kernels of its fields,
# whether to solve)
F32_WINDOWED_CASES = ((3, 48, 'StiffnessAssembler', 'fields_f32', True),
                      (3, 48, 'MassAssembler', 'mass_fields_f32', False),
                      (2, 128, 'StiffnessAssembler', 'fields_f32', False))


def f32_windowed(device):
    """Phase 22c (c): the windowed route in float32, as phase 21: 3D p=3
    n=48 stiffness and mass, 2D p=3 n=128 stiffness.  Launches counted
    from zero (K8 / K8f f32, the geometry stages' K2 f32, K1 f32; no K3,
    no float64 kernel), the peak device bytes, the flat layout held to
    the float32 ``assemble_banded()`` (2e-6), ``assemble_windowed()``
    float64 holding the float32 values, and at 3D n=48 stiffness ``cg``
    on its ``BandedOperator`` (regular layout, K4 f32) with the float32
    weighted fastdiag (phase 22b's settings), its count held to the JAX
    package's on the port's float32 windowed operator on the CPU
    (:data:`POISSON_COUNTS_JAX`)."""
    from pyiga_tpu_torch import _cuda, assemblers, geometry, solvers
    from pyiga_tpu_torch.ops import banded as bd
    from pyiga_tpu_torch.ops import sumfac
    from pyiga_tpu_torch.ops.fastdiag import (fastdiag_precond_weighted,
                                              interior_dofs)
    from pyiga_tpu_torch.ops.matfree import RestrictedOperator
    out = {}
    for dim, n, name, fk, solve in F32_WINDOWED_CASES:
        geo = geometry.twisted_box() if dim == 3 else \
            geometry.quarter_annulus()
        asm = getattr(assemblers, name)(kvs_of(dim, n), geo, device=device)
        bws = bd.band_info(asm.structure)
        ns = tuple(b[0] for b in asm.structure.bs)
        rec = dict(dim=dim, n=n, assembler=name)
        with ComputeDtype(torch.float32):
            ops = asm._windowed_operands()

            def route():
                return sumfac.run_windowed_assembly(
                    asm.field_fn, asm.geo_inputs(), ops['wtabs'],
                    ops['fss'], asm.tables.nqps, ops['plan'], ops['tperms'])
            route()                        # warm (caching allocator)
            base = peak_reset(device)
            _cuda.reset_launches()
            Z = route()
            rec['peak_bytes'] = peak_since(device, base)
            rec['launches'] = f32_launches(
                'windowed f32 %dD n=%d %s' % (dim, n, name),
                ('windowed_stage_f32', 'windowed_fold_f32', 'stage_f32', fk),
                device)
            if rec['launches'].get('fold_f32', 0):
                raise RuntimeError('windowed f32 route launched K3')
            rec['route_ms'] = time_ms(route, device)
            Dw = bd.flat_banded_from_padded_chain(Z, bws, ns,
                                                  add_transpose=False)
            op_ref = asm.assemble_banded()
            sync(device)
            rec['flat_max_abs_err'], rec['flat_rel'] = compare(
                'windowed f32 flat vs banded', Dw, op_ref.D, F32_ASM_TOL)
            mlm = asm.assemble_windowed()
            rec['dtypes'] = [str(Z.dtype), str(mlm.data.dtype)]
            if Z.dtype != torch.float32 or mlm.data.dtype != np.float64:
                raise RuntimeError('windowed f32: route %s, host %s'
                                   % tuple(rec['dtypes']))
            del Dw, op_ref, mlm
            if solve:
                bop = bd.BandedOperator(sumfac.banded_reorder(
                    Z, tuple(2 * b + 1 for b in bws), ns), bws, ns)
                free = interior_dofs(asm.kvs)
                b = torch.as_tensor(np.random.RandomState(0).rand(len(free)),
                                    dtype=torch.float32, device=device)
                P = fastdiag_precond_weighted(asm, dirichlet=True)
                _cuda.reset_launches()
                t0 = time.perf_counter()
                x, it = solvers.cg(RestrictedOperator(bop, free), b,
                                   tol=1e-8, maxiter=600, precond=P)
                sync(device)
                rec.update(t_solve_ms=1e3 * (time.perf_counter() - t0),
                           cg_iters=it,
                           cg_iters_jax=POISSON_COUNTS_JAX[
                               ('float32 windowed', n)],
                           solve_dtype=str(x.dtype),
                           solve_launches={k: v for k, v in
                                           _cuda.LAUNCHES.items() if v})
                log('  cg on the f32 windowed BandedOperator: %d iterations '
                    '(JAX CPU on the port\'s f32 windowed operator: %d), '
                    '%.2f ms, launches %s'
                    % (it, rec['cg_iters_jax'], rec['t_solve_ms'],
                       rec['solve_launches']))
                if it != rec['cg_iters_jax'] or x.dtype != torch.float32 \
                        or (device.type == 'cuda' and _cuda.LAUNCHES[
                            'flat_banded_f32'] <= 0):
                    raise RuntimeError('f32 windowed cg: %d iterations, JAX '
                                       '%d' % (it, rec['cg_iters_jax']))
                del bop, P, x
            del Z
        log('  windowed f32 %dD n=%d %s: route %.3f ms, peak %.1f MB, flat '
            'rel %.3e' % (dim, n, name, rec['route_ms'],
                          rec['peak_bytes'] / 1e6, rec['flat_rel']))
        out['%s %dD n=%d' % (name, dim, n)] = rec
        del asm
        torch.cuda.empty_cache()
    return out


def f32_user_geometry(device, n=60):
    """Phase 22c (d): K1' in float32 on its path: the stiffness of phase
    10b's polar quarter annulus (a ``UserFunction``) at 2D p=3 n=60,
    ``run_device()`` in float32 (K1' f32, K2 / K3 f32) held to the float64
    one (1e-6 relative to its largest entry)."""
    from pyiga_tpu_torch import _cuda
    from pyiga_tpu_torch.assemblers import StiffnessAssembler
    asm = StiffnessAssembler(kvs_of(2, n), polar_annulus(), device=device)
    D64 = asm.run_device()
    with ComputeDtype(torch.float32):
        _cuda.reset_launches()
        D32 = asm.run_device()
        launches = f32_launches("K1' f32 user geometry", (
            'host_jac_fields_f32', 'stage_f32', 'fold_f32'), device)
        t = best_ms(asm.run_device, device)
    rel = rel_to(D32, D64)
    log("  polar UserFunction n=%d f32: run_device %.2f ms, vs f64 rel %.3e"
        % (n, t, rel))
    if not (rel <= 1e-6 and D32.dtype == torch.float32):
        raise RuntimeError("K1' f32 path: rel %.3e, %s" % (rel, D32.dtype))
    return dict(n=n, t_run_device_ms=t, rel_vs_f64=rel, launches=launches)


def f32_hb(device, n0=24):
    """Phase 22c (e): phase 8's HB (24, 3) ``assemble_matrix()`` and
    ``assemble_rhs()`` in float32 (the ``bbox`` VForm assemblers: K1 jac,
    K5, K2 / K3 in float32), held to float64 (1e-6 relative to the
    largest entry); the solve stays float64 (local MG has no float32
    kernels)."""
    from pyiga_tpu_torch import _cuda
    hs = localmg_space(n0)
    hd = localmg_discretization(hs, device)
    A64, f64 = hd.assemble_matrix(), hd.assemble_rhs()
    with ComputeDtype(torch.float32):
        _cuda.reset_launches()
        t0 = time.perf_counter()
        A32, f32 = hd.assemble_matrix(), hd.assemble_rhs()
        sync(device)
        t_cold = 1e3 * (time.perf_counter() - t0)
        launches = f32_launches('HB f32', (
            'geo_jac_fields_f32', 'vform_fields_f32', 'stage_f32',
            'fold_f32'), device)
        t = min(best_ms(hd.assemble_matrix, device, reps=1)
                + best_ms(hd.assemble_rhs, device, reps=1) for _ in range(3))
    rel_A, rel_f = rel_to(A32, A64), rel_to(f32, f64)
    log('  HB (%d, 3) f32: %d dofs, assemble_matrix + rhs cold %.1f ms (the '
        'float32 K5 programs\' builds included), warm %.1f ms; A vs f64 rel '
        '%.3e, f rel %.3e' % (n0, A32.shape[0], t_cold, t, rel_A, rel_f))
    if not (rel_A <= 1e-6 and rel_f <= 1e-6 and A32.dtype == np.float64):
        raise RuntimeError('HB f32: rel %.3e / %.3e' % (rel_A, rel_f))
    return dict(n0=n0, ndofs=int(A32.shape[0]), t_assemble_cold_ms=t_cold,
                t_assemble_ms=t, A_rel_vs_f64=rel_A, f_rel_vs_f64=rel_f,
                launches=launches)


def run_f32_assembly(device):
    """Phase 22c: the f32 line beyond Poisson at full width, each part
    under ``set_dtype(float32)`` with its launches counted from zero and
    float64 restored after it (:class:`ComputeDtype`): (a)
    :func:`f32_convdiff`, (b) :func:`f32_vform_aca`, (c)
    :func:`f32_windowed`, (d) :func:`f32_user_geometry`, (e)
    :func:`f32_hb`.  Raises if a float32 kernel of a part never launched
    or a float64 kernel launched there."""
    out = {}
    for key, fn in (('a_convdiff_2d_n128', f32_convdiff),
                    ('b_3d_n48_vform_aca', f32_vform_aca),
                    ('c_windowed', f32_windowed),
                    ('d_user_geometry_n60', f32_user_geometry),
                    ('e_hb_24_3', f32_hb)):
        t0 = time.perf_counter()
        out[key] = fn(device)
        out[key]['phase_s'] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    return out


# -- phase 23: the host API and the device Krylov entry points ---------

# the JAX package's counts on the CPU (scripts/jax_poisson_counts.py):
# cg_jit on the port's float64 operator at 3D n=48 with the float64
# weighted fastdiag, and gmres_jit on phase 7's float64 convection-
# diffusion matrix at 2D n=128, each (from zero, from seeded_x0(seed))
# for seed 0 (``cgjit``, ``convdiff64``)
CG_JIT_COUNTS_JAX = {(48, 0): (24, 24)}
GMRES_JIT_COUNTS_JAX = {(128, 0): (41, 52)}
# what the five example twins print at their default sizes in the JAX
# package on the CPU (``examples``): CG-IR inner iterations, GMRES
# (preconditioned, plain), local MG (levels, dofs, iterations per sweep),
# two-grid, and the tour's areas and volumes
EXAMPLE_COUNTS_JAX = {
    'poisson_3d': {'outer': 4, 'inner_iters': [7, 8, 8, 8]},
    'convection_diffusion': {'gmres_precond': 227, 'gmres_plain': 327},
    'adaptive_poisson': {'sweeps': [[2, 169, 9], [3, 244, 11],
                                    [4, 352, 10]]},
    'subspace_correction_mg': {'twogrid': [31, 32, 8, 30]},
}
TOUR_VALUES_JAX = {
    'quarter_annulus': 2.3561944901923444,
    'bspline_quarter_annulus': 2.4999999999999996,
    'transformed': 9.424777960769378, 'disk': 7.068583470577033,
    'twisted_box': 2.3992559523809502, 'cylinder': 4.712388980384687}
# the kernels each part of phase 23 must launch: (a) cg_jit on K4, (b)
# cg_ir_traceable on K4 in float64 and float32, (d) the assembly entries
# on K1 (stiffness, mass), K2 and K3, (e) the examples on K1, K1 jac, K5,
# K2, K3 and K6 ((c) runs torch's gather matvec and fastdiag)
HOST_API_KERNELS = {'a': ('flat_banded_f64',),
                    'b': ('flat_banded_f64', 'flat_banded_f32'),
                    'd': ('fields', 'mass_fields', 'stage', 'fold'),
                    'e': ('fields', 'geo_jac_fields', 'vform_fields',
                          'stage', 'fold', 'vcycle')}


def counts_script():
    """``scripts/jax_poisson_counts.py`` as a module (it imports jax only
    inside the functions that run the JAX package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        'jax_poisson_counts', os.path.join(REPO, 'scripts',
                                           'jax_poisson_counts.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def seeded_x0(n, seed, device):
    """The nonzero start of phase 23's Krylov solves, the counts script's
    on `device`."""
    return torch.as_tensor(counts_script().seeded_x0(n, seed),
                           device=device)


def _krylov_rec(name, x, it, b, A, r0, times, expect=None):
    """A solve's record: count, relative residuals to ||b|| and to the
    initial residual, ms of each call (`times`) and their median; raises
    on a count other than `expect` or a non-finite x."""
    res = float(torch.linalg.vector_norm(b - A(x)))
    rec = dict(iters=it, expect=expect, ms=float(np.median(times)),
               ms_calls=times,
               res_rel_b=res / float(torch.linalg.vector_norm(b)),
               res_rel_r0=res / r0)
    log('  %-28s %4s iterations (JAX CPU %s)  %.2f ms (median of %s)  '
        'res/|b| %.2e  res/|r0| %.2e'
        % (name, it, expect, rec['ms'], ', '.join('%.2f' % t for t in times),
           rec['res_rel_b'], rec['res_rel_r0']))
    if not bool(torch.isfinite(x).all()):
        raise RuntimeError('%s: solution not finite' % name)
    if expect is not None and it != expect:
        raise RuntimeError('%s: %s iterations, the JAX CPU takes %s'
                           % (name, it, expect))
    return rec


def _launched_since(before):
    """The kernel launches since the snapshot `before` of the counts."""
    from pyiga_tpu_torch import _cuda
    return {k: v - before.get(k, 0) for k, v in _cuda.LAUNCHES.items()
            if v - before.get(k, 0)}


def _timed(fn, device):
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, 1e3 * (time.perf_counter() - t0)


def _timed_turns(fns, device, rounds=3):
    """Each of `fns` called `rounds` times in turns (host clock after a
    synchronize; the host-bound loops vary by tens of percent between
    calls): the last results and every call's ms, per function."""
    outs, times = [None] * len(fns), [[] for _ in fns]
    for _ in range(rounds):
        for i, fn in enumerate(fns):
            outs[i], t = _timed(fn, device)
            times[i].append(t)
    return outs, times


def host_api_krylov(device, seed=0, n=48, n2=128):
    """Phase 23 (a)-(c): ``cg_jit`` from zero and from a seeded start on
    the main path's restricted K4 operator with the float64 weighted
    fastdiag (3D n=48), ``cg_ir_traceable``'s run against ``cg_ir`` on
    phase 5's operator pair, ``gmres_jit`` from zero and from the seeded
    start on phase 7's operator (2D n=128), each beside the eager loop
    it wraps, in turns; counts held to the JAX CPU's."""
    from pyiga_tpu_torch import _cuda, solvers
    from pyiga_tpu_torch.ops import fastdiag, matfree
    from pyiga_tpu_torch.ops.mlmatvec import MLMatvecOperator

    rec = {}
    asm = main_path_setup(3, n, device)
    op = asm.assemble_banded()
    free = fastdiag.interior_dofs(asm.kvs)
    A = matfree.RestrictedOperator(op, free)
    P = fastdiag.fastdiag_precond_weighted(asm, dirichlet=True)
    b = torch.as_tensor(np.random.RandomState(0).rand(len(free)),
                        device=device)
    x0 = seeded_x0(len(free), seed, device)
    expect = CG_JIT_COUNTS_JAX.get((n, seed), (None, None))
    log('  (a) cg_jit, 3D p=3 n=%d: %d free dofs, float64 K4 + weighted '
        'fastdiag (float64)' % (n, len(free)))
    before = dict(_cuda.LAUNCHES)
    solvers.cg_jit(A, b, tol=1e-8, precond=P)
    rec['a_launches'] = _launched_since(before)
    outs, times = _timed_turns([
        lambda: solvers.cg_jit(A, b, tol=1e-8, precond=P),
        lambda: solvers.cg_jit(A, b, x0=x0, tol=1e-8, precond=P),
        lambda: solvers.cg(A, b, tol=1e-8, precond=P)], device)
    norm_b = float(torch.linalg.vector_norm(b))
    r0 = float(torch.linalg.vector_norm(b - A(x0)))
    rec['a_from_zero'] = _krylov_rec('cg_jit from 0', *outs[0], b, A,
                                     norm_b, times[0], expect[0])
    rec['a_from_x0'] = _krylov_rec('cg_jit from x0(seed %d)' % seed,
                                   *outs[1], b, A, r0, times[1], expect[1])
    rec['a_eager_cg'] = _krylov_rec('cg (eager, from 0)', *outs[2], b, A,
                                    norm_b, times[2], expect[0])
    for key in ('a_from_zero', 'a_from_x0'):
        if rec[key]['res_rel_r0'] > 1e-8:
            raise RuntimeError('%s: residual %.2e of the initial one'
                               % (key, rec[key]['res_rel_r0']))

    log('  (b) cg_ir_traceable vs cg_ir on phase 5\'s operator pair')
    A32 = matfree.RestrictedOperator(op.to(torch.float32), free)
    P32 = fastdiag.fastdiag_precond_weighted(asm, dirichlet=True,
                                             dtype=torch.float32)
    run, hi_ops, lo_ops, pc_ops = solvers.cg_ir_traceable(
        A, A32, tol=1e-8, precond_lo=P32, inner_tol=3e-3)
    before = dict(_cuda.LAUNCHES)
    run(b, hi_ops, lo_ops, pc_ops)
    launches = _launched_since(before)
    ((x_ref, info), (x, packed)), (t_ref, t) = _timed_turns([
        lambda: solvers.cg_ir(A, A32, b, tol=1e-8, precond_lo=P32,
                              inner_tol=3e-3),
        lambda: run(b, hi_ops, lo_ops, pc_ops)], device)
    info2 = solvers.cg_ir_info(packed)
    err = float((x - x_ref).abs().max() / x_ref.abs().max())
    rec['b'] = dict(info=info2, info_cg_ir=info, x_rel=err,
                    ms=float(np.median(t)), ms_calls=t,
                    cg_ir_ms=float(np.median(t_ref)), cg_ir_ms_calls=t_ref,
                    launches=launches)
    log('  cg_ir_traceable run: inner_iters %s (cg_ir %s), x vs cg_ir rel '
        '%.1e, %.2f ms (median of %s; cg_ir %.2f, of %s)'
        % (info2['inner_iters'], info['inner_iters'], err, rec['b']['ms'],
           ', '.join('%.2f' % v for v in t), rec['b']['cg_ir_ms'],
           ', '.join('%.2f' % v for v in t_ref)))
    if info2 != info or not err <= 1e-12:
        raise RuntimeError('cg_ir_traceable disagrees with cg_ir')
    del op, A, A32, P, P32, x, x_ref, x0, asm
    if device.type == 'cuda':
        torch.cuda.empty_cache()

    log('  (c) gmres_jit, 2D p=3 convection-diffusion n=%d' % n2)
    kvs, geo, casm, asm_f = convdiff_setup(n2, device)
    data = casm.run_device()[(None, None)]
    f = asm_f.assemble_vector()
    free = fastdiag.interior_dofs(casm.kvs0)
    C = matfree.RestrictedOperator(MLMatvecOperator(data, casm.structure),
                                   free)
    Pc = fastdiag.fastdiag_precond(casm.kvs0, dirichlet=True, device=device)
    bc = torch.as_tensor(np.asarray(f).ravel()[free], dtype=torch.float64,
                         device=device)
    x0 = seeded_x0(len(free), seed, device)
    expect = GMRES_JIT_COUNTS_JAX.get((n2, seed), (None, None))
    before = dict(_cuda.LAUNCHES)
    solvers.gmres_jit(C, bc, tol=1e-10, restart=30, precond=Pc)
    rec['c_launches'] = _launched_since(before)
    outs, times = _timed_turns([
        lambda: solvers.gmres_jit(C, bc, tol=1e-10, restart=30,
                                  precond=Pc),
        lambda: solvers.gmres_jit(C, bc, x0=x0, tol=1e-10, restart=30,
                                  precond=Pc),
        lambda: solvers.gmres(C, bc, tol=1e-10, restart=30, precond=Pc)],
        device)
    norm_b = float(torch.linalg.vector_norm(bc))
    r0 = float(torch.linalg.vector_norm(bc - C(x0)))
    rec['c_from_zero'] = _krylov_rec('gmres_jit from 0', *outs[0], bc, C,
                                     norm_b, times[0], expect[0])
    rec['c_from_x0'] = _krylov_rec('gmres_jit from x0(seed %d)' % seed,
                                   *outs[1], bc, C, r0, times[1], expect[1])
    rec['c_eager_gmres'] = _krylov_rec('gmres (eager, from 0)', *outs[2],
                                       bc, C, norm_b, times[2], expect[0])
    # the target is tol * ||b|| from either start
    for key in ('c_from_zero', 'c_from_x0'):
        if rec[key]['res_rel_b'] > 1e-10:
            raise RuntimeError('%s: residual %.2e of ||b||'
                               % (key, rec[key]['res_rel_b']))
    return rec


def host_api_assembly(device, n=48):
    """Phase 23 (d): the reference-signature assembly entries at 3D n=48
    on the main path's kernels: ``assemblers.stiffness_fields`` and
    ``ops.sumfac.run_matrix_assembly`` bitwise equal to ``run_device()``;
    ``run_banded_assembly`` of the mass bitwise equal to the mass
    ``assemble_banded()`` (the same unfolded chain) and of the stiffness
    to ``assemble_banded()``'s folded chain within 1e-13; the launches of
    K1 (stiffness, mass), K2 and K3 counted."""
    from pyiga_tpu_torch import _cuda, assemblers, geometry
    from pyiga_tpu_torch.mlmatrix import transpose_idx_for_bidx
    from pyiga_tpu_torch.ops import banded, sumfac

    rec = {}
    asm = main_path_setup(3, n, device)
    kvs = asm.kvs
    ref = asm.run_device()
    before = dict(_cuda.LAUNCHES)
    plan = asm._fold()
    tperms = [transpose_idx_for_bidx(bx) for bx in asm.structure.bidx]
    (F, t_f) = _timed(lambda: assemblers.stiffness_fields(asm.geo_inputs()),
                      device)
    ref_F = asm.field_fn(asm.geo_inputs())
    same_F = all(torch.equal(a, b_) for a, b_ in zip(F, ref_F))
    data, t_m = _timed(lambda: sumfac.run_matrix_assembly(
        assemblers.stiffness_fields, asm.geo_inputs(),
        asm.tables.term_tables(asm.terms), plan, tperms), device)
    same = torch.equal(data, ref)
    del data, ref
    bws = banded.band_info(asm.structure)
    ns = tuple(bk[0] for bk in asm.structure.bs)
    bsz = tuple(2 * bw + 1 for bw in bws)
    Db, t_b = _timed(lambda: sumfac.run_banded_assembly(
        assemblers.stiffness_fields, asm.geo_inputs(),
        asm.tables.banded_term_tables(asm.terms, bws), bsz, ns), device)
    flat = banded.flat_banded_embed_device(Db, bws, ns)
    Dref = asm.assemble_banded().D
    rel_stiff = float((flat - Dref).abs().max() / Dref.abs().max())
    del Db, flat, Dref, asm
    masm = assemblers.MassAssembler(kvs, geometry.twisted_box(),
                                    device=device)
    Dm, t_mb = _timed(lambda: sumfac.run_banded_assembly(
        assemblers.mass_fields, masm.geo_inputs(),
        masm.tables.banded_term_tables(masm.terms, bws), bsz, ns), device)
    same_mass = torch.equal(banded.flat_banded_embed_device(Dm, bws, ns),
                            masm.assemble_banded().D)
    rec.update(fields_bitwise=same_F, run_matrix_assembly_bitwise=same,
               run_banded_assembly_stiffness_rel=rel_stiff,
               run_banded_assembly_mass_bitwise=same_mass,
               stiffness_fields_ms=t_f, run_matrix_assembly_ms=t_m,
               run_banded_assembly_ms=t_b, run_banded_assembly_mass_ms=t_mb,
               launches=_launched_since(before))
    log('  (d) stiffness_fields bitwise %s (%.2f ms); run_matrix_assembly '
        'bitwise %s (%.2f ms); run_banded_assembly: stiffness rel %.1e '
        '(%.2f ms), mass bitwise %s (%.2f ms); launches %s'
        % (same_F, t_f, same, t_m, rel_stiff, t_b, same_mass, t_mb,
           rec['launches']))
    if not (same_F and same and same_mass and rel_stiff <= 1e-13):
        raise RuntimeError('the assembly entries disagree with the route')
    if device.type == 'cuda':
        missing = [k for k in HOST_API_KERNELS['d']
                   if rec['launches'].get(k, 0) <= 0]
        if missing:
            raise RuntimeError('phase 23 (d) never launched %s' % missing)
    return rec


def host_api_examples(device):
    """Phase 23 (e): the five example twins at their default sizes on
    `device`, what each prints parsed by the counts script and held to
    the JAX CPU's; the tour's areas and volumes to 1e-12; wall times."""
    import contextlib
    import importlib.util
    import io

    counts = counts_script()
    rec = {}
    for name in ('poisson_3d', 'convection_diffusion', 'adaptive_poisson',
                 'geometry_tour', 'subspace_correction_mg'):
        spec = importlib.util.spec_from_file_location(
            'torch_example_' + name,
            os.path.join(REPO, 'examples', 'torch_%s.py' % name))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        buf = io.StringIO()
        sync(device)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            ret = mod.main(device=device)
        sync(device)
        wall = time.perf_counter() - t0
        got = counts.parse_example(name, buf.getvalue())
        for line in buf.getvalue().splitlines():
            log('    %s: %s' % (name, line))
        if name == 'geometry_tour':
            errs = {k: abs(ret[k] - v) / abs(v)
                    for k, v in TOUR_VALUES_JAX.items()}
            ok = max(errs.values()) <= 1e-12
            rec[name] = dict(wall_s=wall, rel_errs=errs)
        else:
            ok = got == EXAMPLE_COUNTS_JAX[name]
            rec[name] = dict(wall_s=wall, printed=got,
                             jax=EXAMPLE_COUNTS_JAX[name])
        log('  (e) %-24s %.2f s  %s' % (name, wall,
                                         'matches the JAX CPU' if ok
                                         else 'DIFFERS'))
        if not ok:
            raise RuntimeError('example %s differs from the JAX CPU: %s'
                               % (name, rec[name]))
    return rec


def host_api_hessian(device, n=128):
    """Phase 23 (f): the host ``NurbsFunc.grid_hessian`` of the quarter
    annulus on the 2D p=3 n=128 Gauss grid against
    ``cuda_sumfac.geometry_hessian`` (K2 stages) on `device`, 1e-12."""
    from pyiga_tpu_torch import bspline, geometry
    from pyiga_tpu_torch.ops import cuda_sumfac, geom, sumfac
    geo = geometry.quarter_annulus()
    kvs = 2 * (bspline.make_knots(3, 0.0, 1.0, n),)
    grid, _ = sumfac.quadrature_for(kvs)
    tables, coeffs, nurbs = geom.geo_eval_tables(geo, grid, numderiv=2)
    Hd, t_d = _timed(lambda: cuda_sumfac.geometry_hessian(
        [torch.as_tensor(t, device=device) for t in tables],
        torch.as_tensor(coeffs, device=device), nurbs), device)
    t0 = time.perf_counter()
    Hh = geo.grid_hessian(grid)
    t_h = 1e3 * (time.perf_counter() - t0)
    Hd = Hd.cpu().numpy()
    err = 0.0
    for m, (i, j) in enumerate([(1, 1), (1, 0), (0, 0)]):
        for c in range(2):
            err = max(err, float(np.abs(Hd[1 - c, i, j] - Hh[..., c, m]).max()
                                 / np.abs(Hh).max()))
    log('  (f) NurbsFunc.grid_hessian (host, %.1f ms) vs geometry_hessian '
        '(%s, %.2f ms) on the %dx%d Gauss grid: rel %.1e'
        % (t_h, device.type, t_d, Hh.shape[0], Hh.shape[1], err))
    if not err <= 1e-12:
        raise RuntimeError('host and device Hessians disagree')
    return dict(rel=err, host_ms=t_h, device_ms=t_d)


def run_host_api_phase(device, seed=0):
    """Phase 23: the host API and the device Krylov entry points ((a)-(f)
    above); the launches of the whole phase (counted from zero) and of
    each part."""
    from pyiga_tpu_torch import _cuda
    rec = {}
    t0 = time.perf_counter()
    _cuda.reset_launches()
    rec['krylov'] = host_api_krylov(device, seed)
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    rec['assembly'] = host_api_assembly(device)
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    before = dict(_cuda.LAUNCHES)
    rec['examples'] = host_api_examples(device)
    rec['examples_launches'] = _launched_since(before)
    log('  (e) launches: %s' % rec['examples_launches'])
    rec['hessian'] = host_api_hessian(device)
    rec['launches'] = _launched_since({})
    rec['seconds'] = time.perf_counter() - t0
    log('  launches: %s' % rec['launches'])
    if device.type == 'cuda':
        parts = dict(a=rec['krylov']['a_launches'],
                     b=rec['krylov']['b']['launches'],
                     d=rec['assembly']['launches'],
                     e=rec['examples_launches'])
        missing = ['%s:%s' % (p, k) for p, ks in HOST_API_KERNELS.items()
                   for k in ks if parts[p].get(k, 0) <= 0]
        if missing:
            raise RuntimeError('phase 23 never launched %s' % missing)
    log('  phase 23 took %.1f s' % rec['seconds'])
    return rec


# phase 24: the entry twin's kernels, their names in a profiler trace, and
# the convection-diffusion form of str2asm (constants: the CLI passes no
# input or parameter)
ENTRY_KERNELS = ('fields', 'stage', 'fold')
ENTRY_TRACE_NAMES = ('geo_fields_kernel', 'stage_kernel', 'fold_kernel')
CLI_CONVDIFF = ('(0.05 * inner(grad(u), grad(v)) + dot(as_vector([3.0, '
                '-1.0]), grad(u)) * v) * dx')


def host_cg(A, b, iters):
    """`iters` unpreconditioned CG steps from zero on the host (float64
    numpy, a scipy matrix), in the entry step's order of updates."""
    x = np.zeros_like(b)
    r = b - A @ x
    p, rz = r, r @ r
    for _ in range(iters):
        Ap = A @ p
        alpha = rz / (p @ Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        rz_new = r @ r
        p = r + (rz_new / rz) * p
        rz = rz_new
    return x


def entry_small(device):
    """Phase 24 (a), JAX's size: ``entry()`` on the card against
    ``entry(device='cpu')`` (the plain versions), data and x to 1e-12."""
    from pyiga_tpu_torch.__graft_entry__ import entry
    fn, args = entry()
    if args[2].device.type != 'cuda':
        raise RuntimeError('entry() did not default to the card')
    data, x = fn(*args)
    cfn, cargs = entry(device='cpu')
    cdata, cx = cfn(*cargs)
    rec = {}
    for name, got, ref in (('data', data, cdata), ('x', x, cx)):
        rec[name + '_err'], rec[name + '_rel'] = compare(
            'entry() ' + name, got.cpu(), ref, 1e-12)
    rec['shapes'] = [list(data.shape), list(x.shape)]
    return rec


def entry_step_n48(device, n=48, p=3, cg_iters=8):
    """Phase 24 (a) at the headline's size: ``_single_chip_step`` on the
    twisted box, its launches, its data against ``run_device()`` (1e-13 of
    the largest entry: the folded route sums mirrored terms in another
    order) and x against a float64 host CG on the same data (1e-10), and
    its ms (CUDA events, warm median of 5).  Returns the record and the
    step with its arguments for (b)."""
    from pyiga_tpu_torch import _cuda, bspline, geometry
    from pyiga_tpu_torch.__graft_entry__ import _single_chip_step
    from pyiga_tpu_torch.assemblers import StiffnessAssembler
    kvs = 3 * (bspline.make_knots(p, 0.0, 1.0, n),)
    asm = StiffnessAssembler(kvs, geometry.twisted_box(), device=device)
    step, args = _single_chip_step(asm, cg_iters=cg_iters)
    before = dict(_cuda.LAUNCHES)
    data, x = step(*args)
    sync(device)
    launches = _launched_since(before)
    log('  n=%d step: data %s, x %s, launches %s'
        % (n, tuple(data.shape), tuple(x.shape), launches))
    missing = [k for k in ENTRY_KERNELS if launches.get(k, 0) <= 0]
    if missing:
        raise RuntimeError('phase 24: the entry step never launched %s'
                           % missing)
    rec = dict(n=n, p=p, cg_iters=cg_iters, launches=launches,
               numdofs=int(x.numel()), data_shape=list(data.shape))
    rec['data_err'], rec['data_rel'] = compare(
        'data vs run_device', data, asm.run_device(), 1e-13)
    t0 = time.perf_counter()
    A = asm.structure.make_mlmatrix(data=data.cpu().numpy()).asmatrix()
    xh = host_cg(A, args[2].cpu().numpy(), cg_iters)
    rec['host_cg_s'] = time.perf_counter() - t0
    rec['x_err'], rec['x_rel'] = compare('x vs host CG', x.cpu(),
                                         torch.as_tensor(xh), 1e-10)
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    rec['ms_calls'] = times
    rec['ms'] = float(np.median(times))
    log('  n=%d step %.3f ms (median of %s; CUDA events)  K1 %d  K2 %d  K3 %d'
        ' launches  (%s)'
        % (n, rec['ms'], ', '.join('%.3f' % t for t in times),
           *(launches.get(k, 0) for k in ('fields', 'stage', 'fold')),
           nvidia_smi()))
    return rec, step, args


def read_trace(path, skip=0):
    """A ``torch.profiler`` trace file's kernels and launches.  Returns
    the kernel records less those of the first `skip` launches (name ->
    its streams, launches and device microseconds), the microseconds from
    the first of these kernels' start to the last one's end, and the
    completeness of the whole file: the launches it records
    (``cudaLaunchKernel``), the kernel records CUPTI delivered for them,
    and the CPU op of each launch without its record, in launch order."""
    with open(path) as f:
        events = json.load(f)['traceEvents']
    launches = sorted((e for e in events if e.get('cat') == 'cuda_runtime'
                       and e['name'] == 'cudaLaunchKernel'),
                      key=lambda e: e['ts'])
    records = [e for e in events if e.get('cat') == 'kernel']
    recorded = {e['args'].get('correlation') for e in records}
    ops = [e for e in events if e.get('cat') == 'cpu_op']
    lost = []
    for i, e in enumerate(launches):
        if e['args'].get('correlation') not in recorded:
            inner = sorted((o for o in ops
                            if o['ts'] <= e['ts'] <= o['ts'] + o.get('dur', 0)),
                           key=lambda o: o['ts'])
            lost.append(dict(index=i, op=inner[-1]['name'] if inner else None))
    skipped = {e['args'].get('correlation') for e in launches[:skip]}
    kept = [e for e in records if e['args'].get('correlation') not in skipped]
    kernels = {}
    for e in kept:
        r = kernels.setdefault(e['name'], dict(streams=set(), launches=0,
                                               device_us=0.0))
        r['streams'].add(e['args'].get('stream'))
        r['launches'] += 1
        r['device_us'] += e['dur']
    span = (max(e['ts'] + e['dur'] for e in kept)
            - min(e['ts'] for e in kept)) if kept else 0.0
    return kernels, span, dict(launches=len(launches),
                               kernel_records=len(records), lost=lost)


def entry_profiling(step, args, device):
    """Phase 24 (b): ``profiling.timed`` around the n=48 step reads at
    least the step's CUDA-event time; a ``profiling.trace`` of one step
    holds device events named for K1, K2 and K3, on a stream torch's own
    kernels of the step ran on."""
    import glob
    import shutil
    from pyiga_tpu_torch import profiling
    rec = {}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profiling.timed('entry step', verbose=False) as box:
        start.record()
        out = step(*args)
        end.record()
        box['result'] = out
    event_ms = start.elapsed_time(end)
    rec['timed_ms'], rec['event_ms'] = 1e3 * box['seconds'], event_ms
    # the same block with nothing to sync on: the host clock of the
    # enqueue, for scale (not a check)
    with profiling.timed('entry step, no sync', verbose=False) as box:
        step(*args)
    rec['unsynced_ms'] = 1e3 * box['seconds']
    sync(device)
    log('  timed %.3f ms >= CUDA events %.3f ms (without a result to sync '
        'on: %.3f ms)' % (rec['timed_ms'], event_ms, rec['unsynced_ms']))
    if not rec['timed_ms'] >= event_ms:
        raise RuntimeError('profiling.timed stopped before the kernels '
                           'ended')

    logdir = os.path.join(REPO, 'chiprun_out', 'entry_trace')
    shutil.rmtree(logdir, ignore_errors=True)
    with profiling.trace(logdir):
        step(*args)
        sync(device)
    files = glob.glob(os.path.join(logdir, '*.pt.trace.json'))
    if len(files) != 1:
        raise RuntimeError('profiling.trace wrote %d trace files' % len(files))
    kernels, span_us, complete = read_trace(
        files[0], skip=profiling.TRACE_WARMUP)
    ours = {want: sorted(k for k in kernels if want in k)
            for want in ENTRY_TRACE_NAMES}
    mine = {k for ks in ours.values() for k in ks}
    streams_ours = set().union(*(kernels[k]['streams'] for k in mine))
    streams_torch = set().union(*(r['streams'] for k, r in kernels.items()
                                  if k not in mine))
    busy_us = sum(r['device_us'] for r in kernels.values())
    rec.update(trace_file=os.path.relpath(files[0], REPO),
               trace_bytes=os.path.getsize(files[0]),
               kernels={k: dict(r, streams=sorted(map(str, r['streams'])))
                        for k, r in kernels.items()},
               found=ours, streams_ours=sorted(map(str, streams_ours)),
               streams_torch=sorted(map(str, streams_torch)),
               busy_us=busy_us, span_us=span_us,
               completeness=complete)
    log('  trace: %d kernel names, %s; ours on streams %s, torch\'s on %s; '
        'device busy %.1f of %.1f us from the first kernel to the last'
        % (len(kernels), {w: len(ks) for w, ks in ours.items()},
           rec['streams_ours'], rec['streams_torch'], busy_us, span_us))
    c = rec['completeness']
    c['lost_in_step'] = [x for x in c['lost']
                         if x['index'] >= profiling.TRACE_WARMUP]
    log('  trace: %d launches (%d of the warm-up), %d kernel records; '
        'launches without their record: %s; of the step: %d'
        % (c['launches'], profiling.TRACE_WARMUP, c['kernel_records'],
           [(x['index'], x['op']) for x in c['lost']],
           len(c['lost_in_step'])))
    for k, r in sorted(kernels.items(), key=lambda kr: -kr[1]['device_us']):
        log('    %-60.60s %4d launches %9.1f us' % (k, r['launches'],
                                                    r['device_us']))
    missing = [w for w, ks in ours.items() if not ks]
    if missing:
        raise RuntimeError('phase 24: the trace has no device event named '
                           'for %s (kernels seen: %s)'
                           % (missing, sorted(kernels)))
    if not streams_ours <= streams_torch:
        raise RuntimeError('phase 24: the kernels ran on streams %s, torch\'s '
                           'own kernels on %s' % (sorted(streams_ours),
                                                  sorted(streams_torch)))
    return rec


def entry_cli():
    """Phase 24 (c): ``str2asm_main([... '--source'])`` for a convection-
    diffusion form: the plan lines and the generated K5 source with its C
    entry (not built)."""
    import contextlib
    import io
    from pyiga_tpu_torch._cli import str2asm_main
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        str2asm_main([CLI_CONVDIFF, '--dim', '2', '--degree', '3',
                      '--source'])
    lines = buf.getvalue().splitlines()
    plan = [ln for ln in lines if ln.startswith('assembly plan:')]
    terms = [ln for ln in lines if ln.startswith('  term:')]
    rec = dict(seconds=time.perf_counter() - t0, plan=plan, terms=len(terms),
               source_lines=len(lines) - 4 - len(terms))
    log('  str2asm: %s, %d term lines, %d lines of source'
        % (plan, len(terms), rec['source_lines']))
    if plan != ['assembly plan: 6 term(s) after pruning (of 9 derivative/'
                'component combinations)'] or len(terms) != 6:
        raise RuntimeError('phase 24: str2asm printed %s' % lines[:10])
    if 'pyiga_vform_fields' not in buf.getvalue():
        raise RuntimeError('phase 24: the printed source has no '
                           'pyiga_vform_fields')
    return rec


def run_entry_phase(device):
    """Phase 24: the entry twin ((a) at JAX's size and at 3D p=3 n=48),
    the profiling layer around it (b) and the str2asm command (c)."""
    t0 = time.perf_counter()
    rec = dict(small=entry_small(device))
    rec['n48'], step, args = entry_step_n48(device)
    rec['launches'] = rec['n48']['launches']
    rec['profiling'] = entry_profiling(step, args, device)
    del step, args
    rec['cli'] = entry_cli()
    rec['seconds'] = time.perf_counter() - t0
    log('  phase 24 took %.1f s' % rec['seconds'])
    return rec


# the kernels each rank of the sharded flagship and step runs (phase 25),
# and the backward kernels of its vmap(grad) (25d)
PARALLEL_KERNELS = ('fields', 'stage', 'fold', 'flat_banded_f64',
                    'flat_banded_f32')
PARALLEL_BWD_KERNELS = ('mass_fields_bwd', 'stage_bwd', 'fold_bwd')
# phase 5's cg_ir counts at 3D p=3 n=48 (inner_tol 3e-3)
FLAGSHIP_COUNTS = [7, 9, 9]
# the two-rank flagship's solution against world size 1's (relative
# 2-norm): the slabs' dots sum in another order, so not bitwise, but far
# below what a wrong operator leaves at cg_ir's tol of 1e-8
U_REL_SHARED = 1e-10


def parallel_flagship(asm, mesh, device):
    """The sharded flagship pipeline at `asm`'s size on this rank, phase
    5's settings (tol 1e-8, inner_tol 3e-3, ``b = RandomState(0).rand``):
    the launches of a first run, then the warm assembly and ``cg_ir`` ms
    by CUDA events, then one more solve with the collectives timed (each
    between two synchronizes; gloo's host copies synchronize there
    anyway) for their share of that solve (its host seconds:
    ``cg_ir_profiled_s``), and the halo bytes of one matvec.  Returns the
    record and the solution."""
    from pyiga_tpu_torch import _cuda, solvers
    from pyiga_tpu_torch.parallel import _comm
    from pyiga_tpu_torch.parallel.flagship import sharded_flagship_pipeline
    fn, (b,) = sharded_flagship_pipeline(asm, mesh, inner_tol=3e-3)
    before = dict(_cuda.LAUNCHES)
    D, u, info = fn(b)
    sync(device)
    launches = _launched_since(before)
    missing = [k for k in PARALLEL_KERNELS if launches.get(k, 0) <= 0]
    if missing and device.type == 'cuda':
        raise RuntimeError('phase 25: rank %d never launched %s'
                           % (fn.space.index, missing))
    D, t_asm = event_ms(fn.assemble, device)
    (u, info), t_solve = event_ms(lambda: fn.solve(D, b), device)
    _comm.reset_stats()
    sync(device)
    with _comm.profile(device):
        t0 = time.perf_counter()
        fn.solve(D, b)
        t_host = time.perf_counter() - t0
    stats = {k: (list(v) if isinstance(v, list) else v)
             for k, v in _comm.STATS.items()}
    info = solvers.cg_ir_info(info)
    A_hi, _ = fn.operators(D)
    rec = dict(rank=fn.space.index, ranks=fn.space.size,
               slab=[fn.lo, fn.hi], launches=launches,
               inner_iters=info['inner_iters'], outer=info['outer'],
               residual=info['residual'], assembly_ms=t_asm,
               cg_ir_ms=t_solve, cg_ir_profiled_s=t_host,
               halo_bytes_matvec=A_hi.op.halo_bytes(),
               precond_gather_bytes=4 * fn.n_free, collectives=stats,
               collective_share=stats['seconds'] / t_host)
    return rec, u


def parallel_step(asm, mesh, device, cg_iters=8):
    """``sharded_stiffness_step`` at `asm`'s size with `cg_iters` CG
    steps on one right-hand side: data against ``run_device()`` (relative
    to its largest entry), X, the launches and the step's ms by CUDA
    events (its first call, the host's term tables already uploaded)."""
    from pyiga_tpu_torch import _cuda
    from pyiga_tpu_torch.parallel import sharded_stiffness_step
    step, args = sharded_stiffness_step(asm, mesh, cg_iters=cg_iters,
                                        num_rhs=1)
    before = dict(_cuda.LAUNCHES)
    (data, X), ms = event_ms(lambda: step(*args), device)
    launches = _launched_since(before)
    ref = asm.run_device()
    err = float((data - ref).abs().max() / ref.abs().max())
    del data, ref
    return dict(launches=launches, step_ms=ms, data_rel=err), X[0]


def _gloo_cuda_probe(device):
    """Whether gloo's all-reduce and all-gather take CUDA tensors here
    (the layer copies every collective of a CUDA tensor to the host:
    :mod:`pyiga_tpu_torch.parallel._comm`).  Send and receive are not
    probed: gloo's send of a CUDA tensor aborted the rank process on this
    machine (``writev ... Bad address``)."""
    import torch.distributed as dist
    out = {}
    t = torch.ones(4, device=device)
    for name, call in (
            ('all_reduce', lambda: dist.all_reduce(t)),
            ('all_gather', lambda: dist.all_gather(
                [torch.empty_like(t) for _ in range(2)], t))):
        try:
            call()
            sync(device)
            out[name] = 'ok'
        except Exception as e:          # noqa: BLE001 (a probe)
            out[name] = '%s: %s' % (type(e).__name__, str(e)[:120])
    return out


def parallel_rank(device, n, cg_iters=8):
    """One rank of phase 25 (b)-(d) (``backend='gloo'``, the ranks sharing
    the card): the flagship and the step at 3D p=3 n=48, the three
    patches of ``tests/test_parallel.py`` over the ranks against the
    per-patch assembly, and ``vmap(grad)`` of ``test_grad_composes_with_
    sharding``'s mass objective with a batch of 4 split over the ranks
    against the loop of ``grad`` (1e-12) and its backward launches."""
    from pyiga_tpu_torch import _cuda, bspline, geometry, parallel
    from pyiga_tpu_torch.assemble import Multipatch
    from pyiga_tpu_torch.assemblers import MassAssembler, StiffnessAssembler
    from pyiga_tpu_torch.diff import assembly_coeff_fn
    torch.backends.cuda.matmul.allow_tf32 = False
    if device.type == 'cuda':
        _cuda.library()
    mesh = parallel.make_mesh(axis_names=('space',), device=device)
    rec = dict(gloo_cuda=_gloo_cuda_probe(device))
    asm = main_path_setup(3, n, device)
    rec['flagship'], u = parallel_flagship(asm, mesh, device)
    rec['step'], X = parallel_step(StiffnessAssembler(
        asm.kvs, asm.geo, device=device), mesh, device, cg_iters)

    kvs = 2 * (bspline.make_knots(2, 0.0, 1.0, 6),)
    squ = geometry.unit_square()
    geos = (squ, squ.translate((1, 0)), squ.scale((-1, 1)).translate((2, 1)))
    MP = Multipatch([(kvs, g) for g in geos])
    MP.join_boundaries(0, 'right', 1, 'left')
    MP.join_boundaries(1, 'top', 2, 'bottom', flip=(True,))
    MP.finalize()
    asms = [StiffnessAssembler(kvs, g, device=device) for g in geos]
    data = parallel.sharded_multipatch_data(asms, mesh)
    rec['multipatch_rel'] = max(
        float(np.abs(data[p] - a.run_device().cpu().numpy()).max()
              / np.abs(data[p]).max()) for p, a in enumerate(asms))
    if rec['multipatch_rel'] > 1e-12:
        raise RuntimeError('phase 25: sharded_multipatch_data %.2e from the '
                           'per-patch assembly' % rec['multipatch_rel'])

    masm = MassAssembler(2 * (bspline.make_knots(2, 0.0, 1.0, 4),),
                         geometry.bspline_quarter_annulus(), device=device)
    fn, c0 = assembly_coeff_fn(masm)
    w = torch.as_tensor(np.random.RandomState(42).rand(*fn(c0).shape),
                        device=device)
    rng = np.random.RandomState(7)
    batch = torch.as_tensor(np.stack([c0 + 0.01 * rng.randn(*c0.shape)
                                      for _ in range(4)]), device=device)

    def obj(c):
        return torch.sum(w * fn(c))
    comm = parallel.axis_comm(mesh, 'space')
    lo, hi = comm.slab(4)
    before = dict(_cuda.LAUNCHES)
    mine = torch.func.vmap(torch.func.grad(obj))(batch[lo:hi])
    sync(device)
    rec['vmap_launches'] = _launched_since(before)
    missing = [k for k in PARALLEL_BWD_KERNELS
               if rec['vmap_launches'].get(k, 0) <= 0]
    if missing and device.type == 'cuda':
        raise RuntimeError('phase 25d: vmap(grad) never launched %s'
                           % missing)
    g = comm.gather(mine, [q1 - q0 for q0, q1 in comm.slabs(4)])
    loop = torch.stack([torch.func.grad(obj)(c) for c in batch])
    rec['vmap_rel'] = float((g - loop).abs().max() / loop.abs().max())
    if rec['vmap_rel'] > 1e-12:
        raise RuntimeError('phase 25d: vmap(grad) %.2e from the loop of '
                           'grad' % rec['vmap_rel'])
    return rec, u.cpu().numpy(), X.cpu().numpy()


def nccl_rank(device, n):
    """One rank of phase 25 (e): the flagship at 3D p=3 n=48 over NCCL,
    a card a rank."""
    from pyiga_tpu_torch import _cuda, parallel
    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.library()
    mesh = parallel.make_mesh(axis_names=('space',))
    rec, u = parallel_flagship(main_path_setup(3, n, device), mesh, device)
    return rec, u.cpu().numpy()


def _rank_lines(tag, recs, card):
    for r in recs:
        f = r['flagship'] if 'flagship' in r else r
        log('  %s rank %d/%d rows %s: assembly %.2f ms, cg_ir %.2f ms '
            '(CUDA events), inner_iters %s, halo %d B a matvec, '
            'collectives %.1f %% of a solve  (%s)'
            % (tag, f['rank'], f['ranks'], f['slab'], f['assembly_ms'],
               f['cg_ir_ms'], f['inner_iters'], f['halo_bytes_matvec'],
               100 * f['collective_share'], card))


def _add_counts(*counts):
    """The sum of launch counts by kernel."""
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def parallel_single(device, n, cg_iters, rec):
    """Phase 25 (a): world size 1 over NCCL in this process at 3D p=3 `n`:
    the sharded flagship against phase 5's counts and solution
    (``solve_case`` rerun, 1e-12), the sharded step's data within 1e-14
    of ``run_device()`` and X within 1e-12 of ``_single_chip_step``.
    ``rec['launches']`` is the sharded flagship's first run and the
    sharded step's, each counted around its own call (the references'
    launches left out).  Returns its record, the solution and X."""
    import torch.distributed as dist
    from pyiga_tpu_torch import _cuda, parallel
    from pyiga_tpu_torch.__graft_entry__ import _single_chip_step
    from pyiga_tpu_torch.assemblers import StiffnessAssembler
    dist.init_process_group('nccl', store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        one = torch.ones(1, device=device)
        dist.all_reduce(one)            # NCCL itself, once
        rec['nccl_all_reduce'] = float(one)
        mesh = parallel.make_mesh(axis_names=('space',))
        asm = main_path_setup(3, n, device)
        a, u = parallel_flagship(asm, mesh, device)
        x5, info5, _res, _t1, _t2 = solve_case(asm, asm.assemble_banded(),
                                               device)
        if a['inner_iters'] != info5['inner_iters'] or \
                a['inner_iters'] != FLAGSHIP_COUNTS:
            raise RuntimeError('phase 25a: counts %s, phase 5 %s'
                               % (a['inner_iters'], info5['inner_iters']))
        a['u_rel'] = float(torch.linalg.vector_norm(u - x5)
                           / torch.linalg.vector_norm(x5))
        if a['u_rel'] > 1e-12:
            raise RuntimeError('phase 25a: solution %.2e from phase 5\'s'
                               % a['u_rel'])
        asm_c = StiffnessAssembler(asm.kvs, asm.geo, device=device)
        a['step'], X = parallel_step(asm_c, mesh, device, cg_iters)
        step1, args1 = _single_chip_step(asm_c, cg_iters=cg_iters)
        x1 = step1(*args1)[1]
        a['step']['x_rel'] = float((X - x1).abs().max() / x1.abs().max())
        if a['step']['data_rel'] > 1e-14 or a['step']['x_rel'] > 1e-12:
            raise RuntimeError('phase 25a: step data %.2e, X %.2e'
                               % (a['step']['data_rel'], a['step']['x_rel']))
        rec['launches'] = _add_counts(a['launches'],
                                      a['step']['launches'])
    finally:
        dist.destroy_process_group()
    return a, u.cpu().numpy(), X.cpu().numpy()


def parallel_shared(pool, n, cg_iters, a, u_a, X_a, card):
    """Phase 25 (b)-(d) on the two ranks of `pool` sharing the card over
    gloo (:func:`parallel_rank`), held to (a)'s counts, solution (2-norm,
    :data:`U_REL_SHARED`) and X (1e-12).  Returns the ranks' records."""
    out = pool.run(parallel_rank, n, cg_iters)
    recs = [r for r, _u, _x in out]
    _rank_lines('(b) gloo', recs, card)
    for r, u_b, X_b in out:
        f = r['flagship']
        if f['inner_iters'] != a['inner_iters']:
            raise RuntimeError('phase 25b: rank %d counts %s, (a) %s'
                               % (f['rank'], f['inner_iters'],
                                  a['inner_iters']))
        r['u_rel_a'] = float(np.linalg.norm(u_b - u_a)
                             / np.linalg.norm(u_a))
        r['step']['x_rel_a'] = float(np.abs(X_b - X_a).max()
                                     / np.abs(X_a).max())
        log('  (b) rank %d: u vs (a) %.2e, step %.2f ms, data %.2e, X vs '
            '(a) %.2e, launches %s; (c) patches %.2e; (d) vmap(grad) %.2e, '
            'launches %s; gloo on CUDA tensors %s'
            % (f['rank'], r['u_rel_a'], r['step']['step_ms'],
               r['step']['data_rel'], r['step']['x_rel_a'], f['launches'],
               r['multipatch_rel'], r['vmap_rel'], r['vmap_launches'],
               r['gloo_cuda']))
        if r['u_rel_a'] > U_REL_SHARED:
            raise RuntimeError('phase 25b: rank %d solution %.2e from (a)\'s'
                               % (f['rank'], r['u_rel_a']))
        if r['step']['data_rel'] > 1e-14 or r['step']['x_rel_a'] > 1e-12:
            raise RuntimeError('phase 25b: rank %d step data %.2e, X %.2e'
                               % (f['rank'], r['step']['data_rel'],
                                  r['step']['x_rel_a']))
    return recs


def run_parallel_phase(device, n=48, cg_iters=8):
    """Phase 25: the multi-device layer (``pyiga_tpu_torch.parallel``):
    (a) world size 1 over NCCL in this process (:func:`parallel_single`),
    (b) two rank processes sharing the card over gloo, started while (a)
    runs: the same two problems, each rank's K1, K2, K3, K4 f64 and f32
    launched, the counts (a)'s (:func:`parallel_shared`); (c)
    ``dryrun_multichip(4, backend='gloo')`` and the three patches over
    the ranks; (d) ``vmap(grad)`` with the batch split over the ranks;
    (e) NCCL across cards where there are two or more."""
    from pyiga_tpu_torch.__graft_entry__ import dryrun_multichip
    from pyiga_tpu_torch.parallel import _launch
    t_start = time.perf_counter()
    card = nvidia_smi()
    rec = {}
    pool = []
    starter = threading.Thread(target=lambda: pool.append(
        _launch.RankPool(2, backend='gloo', timeout=240)))
    starter.start()
    try:
        a, u_a, X_a = parallel_single(device, n, cg_iters, rec)
        rec['a'] = a
        _rank_lines('(a) nccl', [a], card)
        log('  (a) NCCL all_reduce %s; u vs phase 5 %.2e; step %.2f ms, '
            'data %.2e of the largest entry, X %.2e of _single_chip_step; '
            'launches %s'
            % (rec['nccl_all_reduce'], a['u_rel'], a['step']['step_ms'],
               a['step']['data_rel'], a['step']['x_rel'], rec['launches']))
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        starter.join()
        if not pool:
            raise RuntimeError('phase 25b: the two ranks did not start')
        rec['b'] = parallel_shared(pool[0], n, cg_iters, a, u_a, X_a, card)
        rec['b_seconds'] = time.perf_counter() - t0
    finally:
        starter.join()
        for p in pool:
            p.close()
    rec['launches'] = _add_counts(rec['launches'],
                                  rec['b'][0]['vmap_launches'])

    # (c) the dry run entry, 4 ranks on the card over gloo
    t0 = time.perf_counter()
    rec['c_dryrun'] = dryrun_multichip(4, backend='gloo')
    rec['c_seconds'] = time.perf_counter() - t0
    log('  (c) dryrun_multichip(4, backend=\'gloo\') OK in %.1f s: %s'
        % (rec['c_seconds'], rec['c_dryrun'][0]))

    # (e) NCCL across cards
    count = torch.cuda.device_count()
    if count >= 2:
        a_inner = a['inner_iters']
        with _launch.RankPool(min(count, 4), backend='nccl',
                              timeout=240) as p:
            rec['e'] = [r for r, _u in p.run(nccl_rank, n)]
        _rank_lines('(e) nccl', rec['e'], card)
        for r in rec['e']:
            if r['inner_iters'] != a_inner:
                raise RuntimeError('phase 25e: counts %s, (a) %s'
                                   % (r['inner_iters'], a_inner))
    else:
        rec['e'] = 'not run: %d card' % count
        log('  (e) NCCL across cards not run: %d card visible' % count)
    rec['seconds'] = time.perf_counter() - t_start
    log('  phase 25 took %.1f s' % rec['seconds'])
    return rec


def cutoff_crossover(device, sizes=(24, 48), reps=3):
    """The crossover that the JAX package's host cutoffs route by (the
    port has none), on this card: the HB (n0, 3) hierarchy's assembly
    (``assemble_matrix`` + ``assemble_rhs``) on the card and on the CPU,
    and its local-MG solve on the card (K6) and by the host sweeps, each
    the best of `reps` warm calls (host clock after a synchronize).  Not
    run by :func:`main`
    (``scripts/torch_parallel_phase.py --cutoffs`` runs it)."""
    from pyiga_tpu_torch import solvers
    out = {}
    cpu = torch.device('cpu')
    for n0 in sizes:
        hs = localmg_space(n0)
        r = dict(numdofs=hs.numdofs,
                 level_dofs=[int(np.prod(hs.mesh(k).numdofs))
                             for k in range(hs.numlevels)])
        for name, dev in (('card', device), ('cpu', cpu)):
            hd = localmg_discretization(hs, dev)
            times = []
            for _ in range(reps + 1):
                sync(device)
                t0 = time.perf_counter()
                A = hd.assemble_matrix()
                f = hd.assemble_rhs()
                sync(device)
                times.append(1e3 * (time.perf_counter() - t0))
            r['assembly_ms_' + name] = min(times[1:])
        for name, kw in (('card', dict(device=device)),
                         ('host', dict(device=device,
                                       relax_backend='host'))):
            times, its = [], None
            for _ in range(reps + 1):
                sync(device)
                t0 = time.perf_counter()
                _x, its = solvers.solve_hmultigrid(hs, A, f, **kw)
                sync(device)
                times.append(1e3 * (time.perf_counter() - t0))
            r['solve_ms_' + name] = min(times[1:])
            r['iters_' + name] = its
        log('  HB (%d, 3): %d dofs (levels %s); assembly card %.1f ms, CPU '
            '%.1f ms; solve card %.1f ms (%d), host %.1f ms (%d)  (%s)'
            % (n0, r['numdofs'], r['level_dofs'], r['assembly_ms_card'],
               r['assembly_ms_cpu'], r['solve_ms_card'], r['iters_card'],
               r['solve_ms_host'], r['iters_host'], nvidia_smi()))
        out['%d_3' % n0] = r
    return out


def main():
    import argparse
    ap = argparse.ArgumentParser(description='Drive the port on one CUDA '
                                 'card and hold every kernel against its '
                                 'plain version.')
    ap.add_argument('--seed', type=int, default=0,
                    help="phase 23's nonzero Krylov start")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device available', file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from pyiga_tpu_torch import _cuda

    t_start = time.perf_counter()
    device = torch.device('cuda', 0)
    card = nvidia_smi()
    log('phase 1: %s | torch %s | CUDA %s | %s x%d'
        % (card, torch.__version__, torch.version.cuda,
           torch.cuda.get_device_name(0), torch.cuda.device_count()))

    t0 = time.perf_counter()
    _cuda.library()
    t_build = time.perf_counter() - t0
    log('phase 2: kernels built+loaded in %.1f s (nvcc %.1f s) -> %s'
        % (t_build, _cuda.BUILD_INFO['seconds'], _cuda.BUILD_INFO['path']))
    log('  nvcc seconds a source: %s' % _cuda.BUILD_INFO.get('sources'))
    for line in _cuda.BUILD_INFO['log'].splitlines():
        if 'registers' in line or 'spill' in line or 'Compiling' in line:
            log('  ' + line.strip())
    dmma = sass_dmma(_cuda.BUILD_INFO['path'])

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log('phase 3: matmul.allow_tf32=%s cudnn.allow_tf32=%s'
        % (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32))

    log('phase 4: kernels vs plain versions at the 3D n=48 shapes, K2 and '
        'K3 also at ragged shapes')
    kern = check_kernels(device)
    torch.cuda.empty_cache()

    log('phase 4n: the float32 K1 (stiffness, mass), K2 and K3 vs plain '
        'versions at the 3D n=48 f32 shapes and ragged shapes, TF32 off '
        'and on')
    kern.update(check_f32_kernels(device))
    torch.cuda.empty_cache()

    log('phase 4b: whole path on small inputs')
    small = check_small(device)
    torch.cuda.empty_cache()

    log('phase 4c: K1 jac kind and generated K5 vs plain versions')
    kern.update(check_vform_kernels(device))
    torch.cuda.empty_cache()

    log('phase 4d: VForm path on small inputs, card vs CPU')
    small.update(check_vform_small(device))
    torch.cuda.empty_cache()

    log('phase 5: main path, 3D p=3 twisted box n=48, float64')
    _cuda.reset_launches()
    main3 = run_main_path(3, 48, device)
    launches = dict(_cuda.LAUNCHES)
    log('  launches: %s' % launches)
    missing = [k for k in POISSON_KERNELS if launches[k] <= 0]
    if missing:
        raise RuntimeError('main path never launched %s' % missing)
    main3['warm'] = run_main_path(3, 48, device)
    torch.cuda.empty_cache()

    log('phase 6: main path, 2D p=3 NURBS quarter annulus n=128, float64')
    _cuda.reset_launches()
    main2 = run_main_path(2, 128, device)
    main2['launches'] = dict(_cuda.LAUNCHES)
    log('  launches: %s' % main2['launches'])
    if any(main2['launches'][k] <= 0 for k in POISSON_KERNELS):
        raise RuntimeError('2D main path missed a kernel')
    main2['warm'] = run_main_path(2, 128, device)
    torch.cuda.empty_cache()

    log('phase 7: VForm path, 2D p=3 convection-diffusion n=128, float64')
    _cuda.reset_launches()
    conv = run_convdiff(device)
    conv['launches'] = dict(_cuda.LAUNCHES)
    log('  launches: %s' % conv['launches'])
    missing = [k for k in VFORM_KERNELS if conv['launches'][k] <= 0]
    if missing:
        raise RuntimeError('VForm path never launched %s' % missing)
    launches.update((k, conv['launches'][k])
                    for k in ('geo_jac_fields', 'vform_fields'))
    log('  warm:')
    conv['warm'] = run_convdiff(device)
    torch.cuda.empty_cache()

    log('phase 4e: K6 (V-cycle) vs its plain version, (24,3), (48,3) and '
        '(96,3)')
    kern.update(check_vcycle_kernel(device))
    torch.cuda.empty_cache()

    log('phase 4f: local-MG path on small inputs, card vs CPU')
    small.update(check_localmg_small(device))
    torch.cuda.empty_cache()

    log('phase 8: local-MG path, 2D p=3 HB (24,3), float64')
    lmg = run_localmg(device, 24)
    launches['vcycle'] = lmg['launches']['vcycle']
    log('  warm:')
    lmg['warm'] = run_localmg(device, 24)
    torch.cuda.empty_cache()
    log('phase 8b: local-MG path, 2D p=3 HB (48,3), solve_hmultigrid '
        'defaults')
    lmg48 = run_localmg(device, 48)
    torch.cuda.empty_cache()

    log('phase 4j: the wavefront kernels (wavefront_gs, K6 wavefront mode) '
        'vs plain versions at (24,3) and (96,3)')
    kern.update(check_wavefront_kernels(device))
    torch.cuda.empty_cache()

    log('phase 8c: local-MG path, 2D p=3 HB (96,3), solve_hmultigrid '
        'defaults (the wavefront route)')
    lmg96 = run_localmg(device, 96)
    launches['vcycle_wavefront'] = lmg96['launches']['vcycle_wavefront']
    torch.cuda.empty_cache()

    log('phase 8c-f32: local-MG path, 2D p=3 HB (96,3) under set_dtype('
        'float32): the float32 assembly, the float64 solve')
    with ComputeDtype(torch.float32):
        lmg96_f32 = run_localmg(device, 96, iters_jax=LOCALMG_ITERS_F32[
            (96, 3)], kernels=WAVE_LOCALMG_F32_KERNELS)
    f64_launched = [k for k in F64_ASSEMBLY_KERNELS
                    if lmg96_f32['launches'][k]]
    if f64_launched:
        raise RuntimeError('phase 8c-f32: float64 assembly kernels launched '
                           '%s' % f64_launched)
    torch.cuda.empty_cache()

    log("phase 8d: local_mg_step(relax_backend='device') under "
        'iterative_solve, (24,3)')
    lmg_step = run_localmg_step_device(device)
    launches['wavefront_gs'] = lmg_step['launches']['wavefront_gs']
    torch.cuda.empty_cache()

    log("phase 4g: K1 mass kind and K1' vs plain versions")
    kern.update(check_mass_kernels(device))
    torch.cuda.empty_cache()

    log('phase 4h: mass/stiffness fixtures and the small heat problem, '
        'card vs CPU')
    small.update(check_mass_small(device))
    torch.cuda.empty_cache()

    log('phase 9: mass path, 3D p=3 twisted box n=48, float64')
    mass3 = run_mass_path(device)
    launches['mass_fields'] = mass3['launches']['mass_fields']
    torch.cuda.empty_cache()

    log('phase 10: heat equation, host integrators, 2D p=3 NURBS quarter '
        'annulus n=128')
    heat = run_heat_host(device)
    torch.cuda.empty_cache()

    log('phase 10b: heat equation, device Rosenbrock, 2D p=3 polar '
        'UserFunction n=60')
    heat_dev = run_heat_device(device)
    launches['host_jac_fields'] = heat_dev['launches']['host_jac_fields']
    torch.cuda.empty_cache()

    log('phase 4i: K7 (stage_T, tail_fused) vs plain versions at the 3D '
        'n=48 flat-banded shapes')
    kern.update(check_tail_kernels(device))
    torch.cuda.empty_cache()

    log('phase 11: headline assemble_banded with the fused tail on, then '
        'off, 3D p=3 n=48')
    tail = run_tail_fused_path(device)
    launches.update((k, tail['launches_path'][k])
                    for k in ('stage_T', 'tail_fused'))
    torch.cuda.empty_cache()

    log('phase 12: 3D Dirichlet Poisson path (harmonic data), p=3 twisted '
        'box n=48, fused tail')
    dirichlet = run_dirichlet_path(device)
    torch.cuda.empty_cache()

    log('phase 12b: Dirichlet path on small inputs (n=8), card vs CPU')
    small.update(check_dirichlet_small(device))
    torch.cuda.empty_cache()

    log('phase 13: low-rank ACA assembly, 3D p=3 twisted box n=48 '
        '(aca_3d_device)')
    aca = run_aca(device)
    torch.cuda.empty_cache()

    log('phase 13b: mass_fast / stiffness_fast on the card against the '
        'fixtures')
    small['fast_fixtures'] = check_fast_fixtures(device)
    torch.cuda.empty_cache()

    log('phase 4k: K1 jac, K5, K2 and K3 on the Navier-Stokes forms at '
        '(16,32), vs plain versions; K2 and K3 at ragged two-space shapes')
    ns_kern = check_ns_kernels(device)
    torch.cuda.empty_cache()

    log('phase 14: vector assembly, divdiv 3D p=3 n=48 and the 2D p=3 '
        'n=128 vector Laplacian')
    vec = run_vector_assembly(device)
    torch.cuda.empty_cache()

    log('phase 15: examples/torch_stokes.py main() at (8,12)')
    stokes = run_stokes(device)
    torch.cuda.empty_cache()

    log('phase 16: Navier-Stokes path, examples/torch_navier_stokes.py at '
        '(16,32), ROWDAIND2 to t=1.0')
    nsrec = run_navier_stokes(device)
    torch.cuda.empty_cache()

    log('phase 4l: K1 jac, K5, K2 and K3 at the surface and second-'
        'derivative shapes, vs plain versions')
    item8_kern = check_item8_kernels(device)
    torch.cuda.empty_cache()

    log('phase 17: surface integrals, 3D p=3 n=48 on the extruded quarter '
        'annulus, and a surface VForm at n=128')
    surface = run_item8_phase('phase 17', run_surface, device)
    torch.cuda.empty_cache()

    log('phase 18: second derivatives, 2D p=3 NURBS quarter annulus n=128; '
        'a UserFunction geometry at n=60')
    second = run_item8_phase('phase 18', run_second_derivatives, device)
    torch.cuda.empty_cache()

    log('phase 19: examples/torch_multipatch_poisson.py main(p=3, n=128); '
        'assemble and project_L2 over the (48,3) HB space')
    multipatch = run_item8_phase('phase 19', run_multipatch, device)
    torch.cuda.empty_cache()

    log('phase 20a: the backward kernels of the differentiable assembly '
        'vs plain versions')
    diff_kern = check_diff_kernels(device)
    kern.update(diff_kern)
    torch.cuda.empty_cache()

    log('phase 20: differentiable assembly: gradients at 3D p=3 n=48 and 2D '
        'n=128, an implicit CG compliance, input and parameter '
        'derivatives, the two examples')
    diffrec = run_diff_phase(device)
    launches.update((k, diffrec['launches'][k]) for k in DIFF_F64_KERNELS)
    torch.cuda.empty_cache()

    log('phase 20f: the float32 backward kernels (K1-bwd, K2-/K3-bwd, the '
        'K5 adjoint) vs plain versions, TF32 off and on; no float64 '
        'instruction in their SASS')
    diff_f32_kern = check_diff_f32_kernels(device)
    kern.update((k, diff_f32_kern[k]) for k in DIFF_F32_KERNELS)
    torch.cuda.empty_cache()

    log('phase 20g: the differentiable assembly under set_dtype(float32): '
        'the 3D n=48 gradients, 2D n=128 shape, parameter and input '
        'gradients, against plain runs and the float64 gradients')
    diff_f32 = run_diff_f32(device)
    launches.update((k, diff_f32['launches'].get(k, 0))
                    for k in DIFF_F32_KERNELS)
    torch.cuda.empty_cache()

    log('phase 4m: K8 (windowed_stage) and K8f (windowed_fold) vs plain '
        'versions at the 3D n=48 and 2D n=128 shapes and ragged shapes')
    win_kern = check_windowed_kernels(device)
    kern.update(win_kern)
    torch.cuda.empty_cache()

    log('phase 21: the windowed route, 3D p=3 n=48 stiffness and mass, 2D '
        'p=3 n=128 stiffness, held to run_device(), assemble_banded() and '
        'its solve')
    windowed = run_windowed_phase(device)
    launches.update((k, windowed['StiffnessAssembler 3D n=48']['launches'][k])
                    for k in WINDOWED_KERNELS)
    torch.cuda.empty_cache()

    log('phase 22: 3D p=3 twisted box n=96, float64: assemble_banded + '
        'cg_ir, peak bytes, fibers, the windowed route')
    n96 = run_n96(device)
    torch.cuda.empty_cache()

    log('phase 22b: the f32 line, 3D p=3 twisted box n=48: set_dtype('
        'float32), assemble_banded + cg')
    f32line = run_f32_line(device)
    launches.update((k, f32line['launches'][k])
                    for k in POISSON_F32_KERNELS if k != 'flat_banded_f32')
    torch.cuda.empty_cache()

    log('phase 4o: the float32 K1 jac, K1\', K5, K8 and K8f vs plain '
        'versions, TF32 off and on; no float64 instruction in the float32 '
        'instances\' SASS')
    f32_asm_kern = check_f32_assembly_kernels(device)
    kern.update((k, f32_asm_kern[k]) for k in F32_ASSEMBLY_KERNELS)
    torch.cuda.empty_cache()

    log('phase 22c: the f32 line beyond Poisson: convection-diffusion 2D '
        'n=128, the 3D n=48 VForm and ACA, the windowed route, K1\', HB '
        '(24,3)')
    f32asm = run_f32_assembly(device)
    launches.update(
        geo_jac_fields_f32=f32asm['a_convdiff_2d_n128']['launches'][
            'geo_jac_fields_f32'],
        vform_fields_f32=f32asm['a_convdiff_2d_n128']['launches'][
            'vform_fields_f32'],
        host_jac_fields_f32=f32asm['d_user_geometry_n60']['launches'][
            'host_jac_fields_f32'],
        **{k: f32asm['c_windowed']['StiffnessAssembler 3D n=48'][
            'launches'][k] for k in ('windowed_stage_f32',
                                     'windowed_fold_f32')})
    for key, r in windowed.items():
        log('  windowed %s peak: float32 %.1f MB, float64 (phase 21) %.1f '
            'MB' % (key, f32asm['c_windowed'][key]['peak_bytes'] / 1e6,
                    r['peak_bytes'] / 1e6))
    torch.cuda.empty_cache()

    log('phase 23: the host API and the device Krylov entry points: '
        'cg_jit / cg_ir_traceable at 3D n=48, gmres_jit at 2D n=128, the '
        'assembly entries at 3D n=48, the five example twins, the host '
        'NURBS Hessian (seed %d)' % args.seed)
    host_api = run_host_api_phase(device, args.seed)
    torch.cuda.empty_cache()

    log('phase 24: the entry twin (entry() card vs CPU, _single_chip_step '
        'at 3D p=3 n=48), profiling.timed / trace around it, str2asm '
        '--source')
    entry_rec = run_entry_phase(device)
    torch.cuda.empty_cache()

    log('phase 25: the multi-device layer: the sharded flagship and step at '
        '3D p=3 n=48 over NCCL at world size 1, on 2 ranks sharing the card '
        "(gloo), dryrun_multichip(4, backend='gloo'), the three patches, "
        'vmap(grad) over 2 ranks')
    par = run_parallel_phase(device)
    torch.cuda.empty_cache()

    log('phase 26a: K1-jvp, K1-hvp and the generated K5 tangent and '
        'second-order programs vs plain versions, float64 and float32')
    t26 = time.perf_counter()
    fwd_kern = check_fwd_kernels(device)
    fwd_kern.update(check_fwd_kernels(device, dtype=torch.float32))
    kern.update(fwd_kern)
    torch.cuda.empty_cache()

    log('phase 26: forward mode and second derivatives: torch.func.jvp, '
        'forward_ad and HVPs through assembly_coeff_fn at 3D p=3 n=48 and '
        '2D n=128 and assembly_input_fn at 2D n=128, a Hessian, the Newton '
        'example by jacfwd')
    fwd = run_fwd_phase(device)
    launches.update((k, fwd['launches'][k]) for k in FWD_KERNELS)
    fwd['seconds'] = time.perf_counter() - t26
    log('  phase 26 took %.1f s' % fwd['seconds'])

    # the NS shapes of the kernels the NS path runs, beside their launches
    # in phase 16's integration
    ns_line = {k: dict(launches=nsrec['launches'][k]) for k in NS_KERNELS}
    keys = ('ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms',
            'max_abs_err')
    ns_line['geo_jac_fields']['channel'] = {
        t: ns_kern['geo_jac_fields'][t] for t in keys + ('device_ms',)}
    for form in ('nlconv', 'linconv'):
        ns_line['vform_fields'][form] = {
            t: ns_kern['vform_fields'][form][t] for t in keys}
        for k in ('stage', 'fold'):
            ns_line[k][form] = {t: ns_kern['chains'][form][k][t]
                                for t in keys + ('launches',)}

    # the surface and second-derivative shapes (phase 4l) beside their
    # launches in phases 17-19
    item8_line = {k: dict(launches={
        ph: r['launches'][k] for ph, r in (('17', surface), ('18', second),
                                           ('19', multipatch))})
        for k in ITEM8_KERNELS}
    for case, r in item8_kern['geo_jac_fields'].items():
        item8_line['geo_jac_fields'][case] = {
            t: r[t] for t in keys + ('device_ms',)}
    for form, r in item8_kern['vform_fields'].items():
        item8_line['vform_fields'][form] = {
            t: r[t] for t in keys + ('device_ms',)}
        for k in ('stage', 'fold'):
            item8_line[k][form] = {t: item8_kern['chains'][form][k][t]
                                   for t in keys + ('launches',)}

    kernels = [dict(name=k, route=KERNELS[k][0], source=KERNELS[k][1],
                    replaces=KERNELS[k][2], launches=launches[k],
                    max_abs_err=kern[k]['max_abs_err'], ms=kern[k]['ms'],
                    plain_ms=kern[k]['plain_ms'],
                    bound_ms=kern[k]['bound_ms'],
                    bound_by=kern[k]['bound_by'],
                    library_ms=kern[k]['library_ms'],
                    **{t: kern[k][t] for t in ('launch_ms', 'device_ms')
                       if t in kern[k]},
                    launches_phase23=host_api['launches'].get(k, 0),
                    launches_phase24=entry_rec['launches'].get(k, 0),
                    launches_phase25=par['launches'].get(k, 0),
                    **({'ns': ns_line[k]} if k in ns_line else {}),
                    **({'item8': item8_line[k]} if k in item8_line else {}))
               for k in KERNELS]
    record = dict(card=card, torch=torch.__version__,
                  cuda=torch.version.cuda, build_s=t_build,
                  build_sources_s=_cuda.BUILD_INFO.get('sources'),
                  sass_dmma=dmma, kernels=kern,
                  small=small, main3d=main3, main2d=main2,
                  convdiff2d=conv, localmg_24_3=lmg, localmg_48_3=lmg48,
                  localmg_96_3=lmg96, localmg_96_3_f32=lmg96_f32,
                  localmg_step_device=lmg_step,
                  aca3d=aca,
                  mass3d=mass3, heat2d=heat, heat2d_device=heat_dev,
                  tail_fused3d=tail, dirichlet3d=dirichlet,
                  ns_kernels=ns_kern, vector3d2d=vec, stokes=stokes,
                  navier_stokes=nsrec, item8_kernels=item8_kern,
                  surface=surface, second_derivatives=second,
                  multipatch=multipatch, diff_kernels=diff_kern,
                  diff=diffrec, diff_f32_kernels=diff_f32_kern,
                  diff_f32=diff_f32, windowed_kernels=win_kern,
                  windowed=windowed, n96=n96, f32_line=f32line,
                  f32_assembly_kernels=f32_asm_kern, f32_assembly=f32asm,
                  host_api=host_api, entry=entry_rec, parallel=par,
                  fwd_kernels=fwd_kern, fwd=fwd,
                  seconds=time.perf_counter() - t_start)
    os.makedirs(os.path.join(REPO, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(REPO, 'chiprun_out', 'chip_smoke.json'), 'w') as f:
        json.dump(record, f, indent=1, default=str)

    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
