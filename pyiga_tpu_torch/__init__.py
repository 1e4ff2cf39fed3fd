"""pyiga_tpu_torch: the PyTorch/CUDA port of pyiga_tpu.

A second package beside :mod:`pyiga_tpu` that runs the same isogeometric
analysis in PyTorch, with hand-written CUDA kernels (``csrc/``) for the
Hopper GPU where the JAX package used Pallas kernels for the TPU.  The
module names follow the JAX package so that each counterpart is easy to
find; numpy-only host code (knot vectors, quadrature, geometry,
sparsity structures) is carried over as a copy.

This package imports torch and never jax or pyiga_tpu.  Every tensor it
creates names its dtype; torch's global default dtype is never changed.
Entry points run on the card: a ``device=`` argument that is omitted
means ``torch.device('cuda')``, and ``device='cpu'`` asks for the CPU.
On a CPU tensor each kernel wrapper runs its plain PyTorch version; on a
CUDA tensor it launches the CUDA kernel.  The compute dtype is float64
unless ``set_dtype(np.float32)`` selects the f32 line (as in the JAX
package).
"""

__version__ = '0.1.0'

from .config import (            # noqa: F401
    get_max_threads, set_max_threads,
    get_dtype, set_dtype, default_assembly_mode,
)
