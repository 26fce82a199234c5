"""Logistic-mixture CDF inverse on Hopper (counterpart of
``nf_tpu/ops/pallas/mixlogcdf.py``).

``nf_tpu_torch/csrc/mixlogcdf.cu`` replaces ``_bisect_kernel`` (launched by
``mix_log_cdf_inverse_pallas``): per element of y (B, N) it solves
``MixLogisticCDF(x; logpi, mu, s) = y`` with ``bijectors/mixlogcdf.py``'s
bracket-safeguarded Newton (same constants, the converged-freeze as an
early exit) and writes the per-row log-det ``-sum_N log pdf(x)``.  The
mixture tensors keep ``nf_tpu``'s own (B, N, K) layout: on Hopper the K
parameters of one element are contiguous, so the TPU's (B, K, N) sublane
transpose is not copied.

``MixLogCdfInverse`` is the ``torch.autograd.Function``: its forward
launches the kernel; its backward raises, as ``nf_tpu``'s kernel has no
VJP.  The plain version is ``bijectors/mixlogcdf.py``'s
``mix_log_cdf_inverse_reference``; ``mix_log_cdf_inverse`` there is the
dispatcher.  ``LAUNCHES`` counts the wrapper's launches where it launches.

Bound (H100 SXM): 4 (2 + 3K) bytes per element against about (K + 1)
transcendentals and 11K + 20 f32 operations per Newton evaluation, 4 to 8
evaluations per element on typical data (chip_smoke.py counts them).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

LAUNCHES = {"mix_log_cdf_inverse": 0}
MIXTURES = (8, 32)   # the kernel's padded mixture counts KP


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def padded_mixtures(K: int) -> int:
    """The kernel's KP for K components; NotImplementedError past the
    largest."""
    for kp in MIXTURES:
        if K <= kp:
            return kp
    raise NotImplementedError(f"the mixture-inverse kernel covers K <= {MIXTURES[-1]}, got K = {K}")


def _fn():
    fn = _build.load("mixlogcdf").nf_mix_log_cdf_inverse
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def launch(y, logpi, mu, s):
    """The kernel on y (B, N) and contiguous (B, N, K) mixture tensors, all
    float32 on one CUDA device: (x (B, N), ld (B,))."""
    if not y.is_cuda:
        raise ValueError(f"the mixture-inverse kernel needs a CUDA tensor, got {y.device}")
    if y.dim() != 2 or logpi.dim() != 3:
        raise ValueError(f"the mixture-inverse kernel takes y (B, N) and (B, N, K) mixture "
                         f"tensors, got {tuple(y.shape)} and {tuple(logpi.shape)}")
    B, N = y.shape
    K = logpi.shape[2]
    kp = padded_mixtures(K)
    for t, want in ((y, (B, N)), (logpi, (B, N, K)), (mu, (B, N, K)), (s, (B, N, K))):
        if (t.device != y.device or t.dtype != torch.float32 or tuple(t.shape) != want
                or not t.is_contiguous()):
            raise ValueError(f"the mixture-inverse kernel takes contiguous float32 {want} on "
                             f"{y.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    x = torch.empty_like(y)
    ld = torch.empty(B, dtype=torch.float32, device=y.device)
    if B == 0:
        return x, ld
    with torch.cuda.device(y.device):
        err = _fn()(y.data_ptr(), logpi.data_ptr(), mu.data_ptr(), s.data_ptr(),
                    x.data_ptr(), ld.data_ptr(), B, N, K, kp,
                    torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"mix_log_cdf_inverse kernel failed to launch: CUDA error {err}")
    LAUNCHES["mix_log_cdf_inverse"] += 1
    return x, ld


class MixLogCdfInverse(torch.autograd.Function):
    """The kernel's inverse; no gradient (nor has ``nf_tpu``'s kernel)."""

    @staticmethod
    def forward(ctx, y, logpi, mu, s):
        return launch(y.contiguous(), logpi.contiguous(), mu.contiguous(), s.contiguous())

    @staticmethod
    def backward(ctx, gx, gld):
        raise NotImplementedError("the mixture-CDF inverse kernel is inference only: it has "
                                  "no gradient (nor has nf_tpu's)")
