"""horovod_tpu_torch: the port of horovod_tpu to PyTorch and CUDA on
NVIDIA Hopper (H100).

horovod_tpu (JAX on a TPU) stays the reference. This package grows
slice by slice (ROADMAP.md); so far it serves the flagship transformer
on one card, with prompt attention through a hand-written sm_90a
flash-attention kernel (ops/csrc/flash_fwd.cu). It has no runtime yet:
``init()``, the collectives and training come in later slices.

Entry points run on ``torch.device("cuda")`` unless the caller passes
``device="cpu"``, where each kernel's plain PyTorch version runs
instead.
"""

from . import models, serve

__version__ = "0.1.0"

__all__ = ["models", "serve", "__version__"]
