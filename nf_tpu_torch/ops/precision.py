"""The precision of the models' f32 library products (counterpart of
``nf_tpu``'s ``jax_default_matmul_precision``, which ``build_model`` sets
for the process).

Under ``"bfloat16"`` (JAX's fastest level: the scalar products of f32
matmuls and convs take bf16 operands) every model's dense product and
conv goes through ``matmul`` / ``linear`` / ``conv2d`` /
``conv_transpose2d`` here: the operands are rounded to bf16 and the
product runs on the tensor cores in TF32 mode, where a bf16-rounded f32
operand is exact, so the products are exact and the sums f32; the result
is f32.  The backward pass of such a product runs at f32.  The CPU
computes f32 whatever is asked, as XLA's CPU does, and so do tensors that
are not f32 (``compute_dtype="bfloat16"``'s own bf16 products).  The
hand-written kernels keep their own precisions.

Left at f32 whatever is asked: the weight algebra of a layer, C x C or
matrix-vector work that sets the weights the products use: the 1x1
conv's P L U product and triangular inverses (so its inverse stays the
inverse of its forward weight), and the dense spectral norms' power
iterations and sigma (the conv operator's power iteration runs through
its conv and follows the setting).
"""
from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.nn.functional as F

PRECISIONS = (None, "float32", "highest", "bfloat16")
_BF16 = False


def set_matmul_precision(precision) -> None:
    """Set the library products' precision for the process (``None``,
    ``"float32"`` and ``"highest"``: f32)."""
    global _BF16
    if precision not in PRECISIONS:
        raise ValueError(f"unknown matmul_precision {precision!r}")
    _BF16 = precision == "bfloat16"


def matmul_precision() -> str:
    return "bfloat16" if _BF16 else "float32"


def _reduced(x: torch.Tensor) -> bool:
    return _BF16 and x.is_cuda and x.dtype == torch.float32


def _bf16(t):
    return None if t is None else t.to(torch.bfloat16).to(torch.float32)


@contextmanager
def _tensor_cores():
    """TF32 tensor-core mode for cuBLAS and cuDNN for the block."""
    mm, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cudnn


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if not _reduced(a):
        return a @ b
    with _tensor_cores():
        return _bf16(a) @ _bf16(b)


def linear(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """x @ w.T (+ b, added in f32)."""
    if not _reduced(x):
        return F.linear(x, w, b)
    with _tensor_cores():
        return F.linear(_bf16(x), _bf16(w), b)


def conv2d(x: torch.Tensor, w: torch.Tensor, b=None, **kw) -> torch.Tensor:
    """``F.conv2d`` (NCHW), the bias added in f32."""
    if not _reduced(x):
        return F.conv2d(x, w, b, **kw)
    with _tensor_cores():
        return F.conv2d(_bf16(x), _bf16(w), b, **kw)


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor, **kw) -> torch.Tensor:
    if not _reduced(x):
        return F.conv_transpose2d(x, w, **kw)
    with _tensor_cores():
        return F.conv_transpose2d(_bf16(x), _bf16(w), **kw)
