"""nf_tpu_torch — the PyTorch / CUDA port of nf_tpu for NVIDIA Hopper.

Mirrors ``nf_tpu``'s layout and names module by module; inside, it is
PyTorch idiom: ``nn.Module``s holding their parameters and buffers, an
explicit ``device`` and explicit ``torch.Generator``s.  Entry points run on
the CUDA card unless the caller asks for the CPU.  Every TPU (Pallas)
kernel on a ported path has a hand-written Hopper kernel under ``csrc/``
with its plain PyTorch version beside the wrapper; the wrapper runs the
plain version for CPU tensors and launches the kernel (or raises) for CUDA
tensors.
"""
from .core import Bijector, Chain, Inverted  # noqa: F401

__version__ = "0.1.0"
