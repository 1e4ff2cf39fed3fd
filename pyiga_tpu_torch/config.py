"""Compute dtype and default device of the port.

The JAX package's config also salts a persistent XLA cache and selects
Pallas interpret mode; neither exists here.  Float64 is native on the
GPU, so the compute dtype is float64 (the f32 Krylov operators of
:func:`~pyiga_tpu_torch.solvers.cg_ir` name float32 themselves).  There
is no mutable global state: every entry point takes ``device=``, and
omitting it means the CPU, where each kernel wrapper runs its plain
PyTorch version.
"""

import torch

DTYPE = torch.float64
DEFAULT_DEVICE = torch.device('cpu')


def resolve_device(device):
    """``device`` as a :class:`torch.device` (None -> the CPU)."""
    return DEFAULT_DEVICE if device is None else torch.device(device)
