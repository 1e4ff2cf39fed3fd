"""Compute dtype and default device of the port.

The JAX package's config also salts a persistent XLA cache and selects
Pallas interpret mode; neither exists here.  Float64 is native on the
GPU, so the compute dtype is float64 (the f32 Krylov operators of
:func:`~pyiga_tpu_torch.solvers.cg_ir` name float32 themselves).  There
is no mutable global state: every entry point takes ``device=``, and
omitting it means the card (``torch.device('cuda')``).  Pass
``device='cpu'`` to run on the CPU, where each kernel wrapper runs its
plain PyTorch version.  No entry point checks for a card or falls back
to the CPU: on a machine without one, a call that omits ``device=``
fails where torch first touches CUDA.
"""

import torch

DTYPE = torch.float64
DEFAULT_DEVICE = torch.device('cuda')


def resolve_device(device):
    """``device`` as a :class:`torch.device` (None -> the card)."""
    return DEFAULT_DEVICE if device is None else torch.device(device)
