"""Entry point: the flagship forward step on one card.

`entry()` returns the forward step of the flagship workload (3D Poisson:
sum-factorization stiffness assembly + a fixed count of matrix-free CG
steps) together with example arguments on the card, the twin of the JAX
package's ``__graft_entry__.entry()``:

    step, args = entry()                 # entry(device='cpu') on the CPU
    data, x = step(*args)

The step runs the geometry fields (K1), the contraction chains of every
term (K2 stages and one K3 fold, :func:`~pyiga_tpu_torch.ops.sumfac.
assemble_terms`) and `cg_iters` unpreconditioned CG steps from zero on
:func:`~pyiga_tpu_torch.ops.mlmatvec.ml_matvec` over the compact data.
As the JAX ``fori_loop``, the CG loop runs its fixed count and never
reads the host.

`dryrun_multichip(n)` runs the sharded step, the matrix-free CG and the
flagship pipeline of :func:`pyiga_tpu_torch.parallel.dryrun` in `n` rank
processes over ``torch.distributed`` (3D p=3, tiny shapes), each held to
its run on one rank:

    dryrun_multichip(4)                    # 4 cards, NCCL
    dryrun_multichip(4, backend='gloo')    # 4 ranks sharing the card(s)
    dryrun_multichip(4, device='cpu')      # 4 ranks on the CPU, gloo

    python -m pyiga_tpu_torch.__graft_entry__ [cpu]
"""

import numpy as np
import torch

from . import geometry
from .assemblers import StiffnessAssembler
from .bspline import make_knots
from .config import get_dtype
from .ops.mlmatvec import ml_matvec
from .ops.sumfac import assemble_terms


def _single_chip_step(asm, cg_iters=8):
    """``(step, args)`` for the assembler `asm`: ``step(geo_inputs,
    term_tables, b)`` returns the compact data tensor and the iterate
    after `cg_iters` CG steps on ``A x = b``; `args` are the assembler's
    geometry tensors, its compact term tables (each distinct table
    uploaded once) and ``b = RandomState(0).rand(n)``, all on the
    assembler's device in the compute dtype."""
    S = asm.structure
    shape_dofs = tuple(b[0] for b in S.bs)
    bidx = [torch.as_tensor(np.asarray(bx, dtype=np.int64),
                            device=asm.device) for bx in S.bidx]
    field_fn = asm.field_fn
    # grouped on the host tables (the pair-table cache interns them)
    ops = asm._compact_operands()
    last_idx = ops['last_idx']

    def step(geo_inputs, term_tables, b):
        fields = field_fn(geo_inputs)
        data = assemble_terms(term_tables, fields, last_idx=last_idx)

        def matvec(x):
            return ml_matvec(data, bidx, shape_dofs, shape_dofs,
                             x).reshape(-1)

        x = torch.zeros_like(b)
        r = b - matvec(x)
        p, rz = r, torch.vdot(r, r)
        for _ in range(cg_iters):
            Ap = matvec(p)
            alpha = rz / torch.vdot(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            rz_new = torch.vdot(r, r)
            p = r + (rz_new / rz) * p
            rz = rz_new
        return data, x

    n_total = int(np.prod(shape_dofs))
    b = torch.as_tensor(np.random.RandomState(0).rand(n_total),
                        dtype=get_dtype(), device=asm.device)
    args = (asm.geo_inputs(), ops['term_tables'], b)
    return step, args


def entry(device=None):
    """Forward step (3D stiffness assembly + CG) and example args on
    `device` (default the card)."""
    kvs = 3 * (make_knots(2, 0.0, 1.0, 6),)
    asm = StiffnessAssembler(kvs, geometry.twisted_box(), device=device)
    return _single_chip_step(asm)


def _dryrun_rank(device, n_devices, dev):
    """One rank of :func:`dryrun_multichip` (in the package, so that the
    ``spawn`` start method can import it)."""
    from .parallel import dryrun
    data, X = dryrun(n_devices, dim=3, nspans=4, p=3, cg_iters=4,
                     check_parity=True, device=dev)
    if not (np.all(np.isfinite(data)) and np.all(np.isfinite(X))):
        raise AssertionError('dryrun: data or iterates not finite')
    return data.shape, X.shape


def dryrun_multichip(n_devices, device=None, backend=None):
    """Run :func:`pyiga_tpu_torch.parallel.dryrun` (the sharded 3D p=3
    stiffness step with its one-rank parity check, the matrix-free mass
    CG and the flagship f64 pipeline) in `n_devices` rank processes that
    meet through a file store in a temporary directory (no port).

    On the card (default) each rank takes card ``rank % device_count``
    and the backend is NCCL: with fewer cards than ranks this raises, as
    ``make_mesh`` does, unless ``backend='gloo'`` lets ranks share a card.
    ``device='cpu'`` runs the ranks on the CPU over gloo.  On the card
    the kernel library is built (or loaded) here before the ranks start,
    so that they do not build it together.  Raises if any rank fails;
    returns each rank's ``(data shape, X shape)``."""
    from .parallel import _launch
    kind, backend = _launch.resolve(n_devices, device, backend)
    if kind == 'cuda':
        from . import _cuda
        _cuda.library()
    cpu = kind == 'cpu'
    return _launch.run(_dryrun_rank, n_devices, n_devices,
                       'cpu' if cpu else None, device=device,
                       backend=backend, threads=1 if cpu else None)


if __name__ == '__main__':
    import sys
    fn, args = entry(sys.argv[1] if len(sys.argv) > 1 else None)
    out = fn(*args)
    print('entry() OK:', [tuple(o.shape) for o in out])
