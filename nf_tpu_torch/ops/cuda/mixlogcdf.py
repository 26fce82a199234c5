"""Logistic-mixture CDF inverse on Hopper (counterpart of
``nf_tpu/ops/pallas/mixlogcdf.py``).

``nf_tpu_torch/csrc/mixlogcdf.cu`` replaces ``_bisect_kernel`` (launched by
``mix_log_cdf_inverse_pallas``): per element of y (B, N) it solves
``MixLogisticCDF(x; logpi, mu, s) = y`` with ``bijectors/mixlogcdf.py``'s
bracket-safeguarded Newton (same constants, the converged-freeze as an
early exit) and writes the per-row log-det ``-sum_N log pdf(x)``, for any
number of components K.  The mixture tensors keep ``nf_tpu``'s own
(B, N, K) layout: on Hopper the K parameters of one element are
contiguous, so the TPU's (B, K, N) sublane transpose is not copied.

The kernel's schedule, kept here where the CPU tests walk it:

* ``component_chunks``: the components in chunks of ``COMPONENT_CHUNK``, in
  k order; up to one chunk (``resident``) a lane keeps its element's
  mixture (pi, exp(-s), mu) in its slot of shared memory through the
  Newton trips, past that it reads the chunks from memory at each trip;
* ``rows_per_block``: a block of ``WARPS`` warps takes that many
  consecutive rows as one run of elements, chosen so the grid is about one
  wave of the card; ``warp_parts``: each warp's contiguous part of its
  block's run;
* lane refill: a lane whose element is done takes the next element of its
  warp's part at the next trip; ``part_trips`` counts the trips a part
  takes from its elements' Newton evaluations.

``MixLogCdfInverse`` is the ``torch.autograd.Function``: its forward
launches the kernel; its backward raises, as ``nf_tpu``'s kernel has no
VJP.  The plain version is ``bijectors/mixlogcdf.py``'s
``mix_log_cdf_inverse_reference``; ``mix_log_cdf_inverse`` there is the
dispatcher.  ``LAUNCHES`` counts the wrapper's launches where it launches.

Bound (H100 SXM): 4 (2 + 3K) bytes per element against about (K + 1)
transcendentals and 11K + 20 f32 operations per Newton evaluation, 4 to 5
evaluations per element on typical data (chip_smoke.py counts them).
"""
from __future__ import annotations

import ctypes
import heapq
from typing import Dict, List, Sequence, Tuple

import torch

from ...utils.tracing import span
from . import _build

LAUNCHES = {"mix_log_cdf_inverse": 0}
WARPS = 8             # warps per block
CHUNK = 2048          # elements of a block's run held in shared memory
COMPONENT_CHUNK = 8   # components a lane works on at once

_info: Dict[Tuple[int, bool], Tuple[int, int, int]] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def component_chunks(K: int) -> List[Tuple[int, int]]:
    """The kernel's walk over K components: [k0, k1) chunks in k order."""
    return [(k0, min(K, k0 + COMPONENT_CHUNK)) for k0 in range(0, K, COMPONENT_CHUNK)]


def resident(K: int) -> bool:
    """Whether a lane keeps its element's mixture through its Newton trips
    (one chunk)."""
    return K <= COMPONENT_CHUNK


def rows_per_block(B: int, N: int, resident_blocks: int) -> int:
    """Rows a block takes: enough that the grid fits ``resident_blocks``
    (the blocks the card holds at once) where the run fits ``CHUNK``."""
    most = max(1, CHUNK // N)
    return max(1, min(most, -(-B // resident_blocks)))


def warp_parts(B: int, N: int, rows: int) -> List[Tuple[int, int]]:
    """Each warp's [start, end) of the flattened (B, N) elements, block by
    block and, within a block's run (pieces of CHUNK elements for rows
    longer than that), warp by warp."""
    parts = []
    for row0 in range(0, B, rows):
        base, total = row0 * N, min(rows, B - row0) * N
        for c0 in range(0, total, CHUNK):
            length = min(CHUNK, total - c0)
            part = -(-length // WARPS)
            for w in range(WARPS):
                lo = min(length, w * part)
                parts.append((base + c0 + lo, base + c0 + min(length, lo + part)))
    return parts


def part_trips(evaluations: Sequence[int]) -> int:
    """Trips a warp takes over its part, elements handed out in order to the
    lanes as they come free (lanes free at the same trip in lane order),
    each lane running its element's Newton evaluations back to back."""
    free = [(0, lane) for lane in range(32)]
    end = 0
    for n in evaluations:
        t, lane = heapq.heappop(free)
        heapq.heappush(free, (t + int(n), lane))
        end = max(end, t + int(n))
    return end


def warp_evaluations(evaluations: torch.Tensor, rows: int) -> int:
    """Lane slots the kernel's warps run on these per-element Newton
    evaluation counts (B, N): 32 per trip of every warp."""
    B, N = evaluations.shape
    flat = evaluations.reshape(-1).tolist()
    return 32 * sum(part_trips(flat[a:b]) for a, b in warp_parts(B, N, rows))


def kernel_info(K: int, device=None) -> Tuple[int, int, int]:
    """(registers per thread, blocks per SM, SMs) of the kernel K
    components take on the card, from the CUDA runtime; asked once per
    card and kernel."""
    index = torch.cuda.current_device() if device is None else torch.device(device).index
    key = (index, resident(K))
    if key not in _info:
        fn = _build.load("mixlogcdf").nf_mix_log_cdf_inverse_info
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 2
            fn.restype = ctypes.c_int
        regs, per_sm = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(index):
            err = fn(K, ctypes.byref(regs), ctypes.byref(per_sm))
        if err != 0:
            raise RuntimeError(f"mix_log_cdf_inverse: kernel query failed: CUDA error {err}")
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        _info[key] = (regs.value, per_sm.value, sms)
    return _info[key]


def launch_rows(y: torch.Tensor, K: int) -> int:
    """The rows per block of a launch on y (B, N) on its card."""
    B, N = y.shape
    _, per_sm, sms = kernel_info(K, y.device)
    return rows_per_block(B, N, per_sm * sms)


def _fn():
    fn = _build.load("mixlogcdf").nf_mix_log_cdf_inverse
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def launch(y, logpi, mu, s):
    """The kernel on y (B, N) and contiguous (B, N, K) mixture tensors, all
    float32 on one CUDA device: (x (B, N), ld (B,)); the span
    ``launch.mix_log_cdf_inverse``."""
    with span("launch.mix_log_cdf_inverse"):
        return _launch(y, logpi, mu, s)


def _launch(y, logpi, mu, s):
    if not y.is_cuda:
        raise ValueError(f"the mixture-inverse kernel needs a CUDA tensor, got {y.device}")
    if y.dim() != 2 or logpi.dim() != 3:
        raise ValueError(f"the mixture-inverse kernel takes y (B, N) and (B, N, K) mixture "
                         f"tensors, got {tuple(y.shape)} and {tuple(logpi.shape)}")
    B, N = y.shape
    K = logpi.shape[2]
    for t, want in ((y, (B, N)), (logpi, (B, N, K)), (mu, (B, N, K)), (s, (B, N, K))):
        if (t.device != y.device or t.dtype != torch.float32 or tuple(t.shape) != want
                or not t.is_contiguous()):
            raise ValueError(f"the mixture-inverse kernel takes contiguous float32 {want} on "
                             f"{y.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    x = torch.empty_like(y)
    ld = torch.empty(B, dtype=torch.float32, device=y.device)
    if B == 0:
        return x, ld
    if N == 0 or K == 0:
        raise ValueError(f"the mixture-inverse kernel takes N, K >= 1, got N = {N}, K = {K}")
    rows = launch_rows(y, K)
    with torch.cuda.device(y.device):
        err = _fn()(y.data_ptr(), logpi.data_ptr(), mu.data_ptr(), s.data_ptr(),
                    x.data_ptr(), ld.data_ptr(), B, N, K, rows,
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
