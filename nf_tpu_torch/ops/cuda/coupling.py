"""Fused affine-coupling transform on Hopper (counterpart of
``nf_tpu/ops/pallas/coupling.py``).

Over (B, N) halves, with s = tanh(raw_s) * gain + bias:

    forward:  y = z0 * exp(s) + t,     ld = sum_row(s)
    inverse:  x = (y0 - t) * exp(-s),  ld = -sum_row(s)

``nf_tpu_torch/csrc/coupling.cu`` holds three kernels: the forward and the
inverse (replacing ``_fwd_kernel`` / ``_inv_kernel``, launched by ``_call``)
and the analytic backward of the forward (``nf_tpu``'s ``_cf_bwd``, which
XLA compiles there).  Beside them, their plain PyTorch versions
``coupling_fwd_reference``, ``coupling_inv_reference`` and
``coupling_bwd_reference``.

* ``CouplingFwd`` is the ``torch.autograd.Function``: on a CUDA tensor its
  forward launches the forward kernel and its backward the backward
  kernel; on a CPU tensor it runs the two plain versions, so the CPU tests
  exercise the same analytic backward.  Its residuals are ``nf_tpu``'s
  (z0, raw_s, gain, bias); tanh and exp(s) are recomputed.
* ``CouplingInv`` launches the inverse kernel (plain version on the CPU).
  It has no gradient, as in ``nf_tpu``, where nothing differentiates
  through an image inverse.
* ``coupling_fwd`` / ``coupling_inv`` are the dispatchers, with
  ``nf_tpu``'s gate: a 2-D half whose width is a multiple of 128 goes
  through the Function; anything else takes the plain version, as
  ``nf_tpu`` does on a TPU.  ``nf_tpu``'s model inverse computes the same
  function in jnp and never dispatches its inverse kernel; the port uses
  its kernel there, so nothing on the card's main path runs a plain
  version.  ``NF_TPU_NO_PALLAS`` has no counterpart.

gain and bias stay on the device: the kernels read them from device
memory, so a call never synchronizes.  ``LAUNCHES`` counts each wrapper's
launches where it launches; each launch is the span ``launch.<its key>``.
The backward is one launch: its last block folds the rows' partial sums
into dgain and dbias in a fixed order (``FOLD_THREADS`` threads, rows
strided, then a butterfly per warp and the warps in order), found by an
atomic ticket that ``_ticket`` keeps zeroed per device and stream.

Bound (H100 SXM): 16 bytes per element for the forward and the inverse
(three reads, one write), 20 for the backward (three reads, two writes)
against about 5 f32 operations and 2 transcendentals per element, so
memory bounds them: 2.5 us per forward call at (1024, 512) at 3.35 TB/s.
"""
from __future__ import annotations

import ctypes

import torch

from ...utils.tracing import span
from . import _build

LAUNCHES = {"coupling_fwd": 0, "coupling_inv": 0, "coupling_bwd": 0}
SPANS = {k: f"launch.{k}" for k in LAUNCHES}   # each launch's span (utils/tracing.py)
LANES = 128   # nf_tpu's gate: the flattened half's width is a multiple of this
# csrc/coupling.cu: a block is ROWS_PER_BLOCK warps, one row each; the
# last block folds the partials with its FOLD_THREADS threads
ROWS_PER_BLOCK = 4
FOLD_THREADS = 32 * ROWS_PER_BLOCK

_tickets = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------
def _scale(raw_s, gain, bias):
    return torch.tanh(raw_s) * gain + bias


def coupling_fwd_reference(z0, t, raw_s, gain, bias):
    s = _scale(raw_s, gain, bias)
    return z0 * torch.exp(s) + t, s.sum(dim=1)


def coupling_inv_reference(y0, t, raw_s, gain, bias):
    s = _scale(raw_s, gain, bias)
    return (y0 - t) * torch.exp(-s), -s.sum(dim=1)


def coupling_bwd_reference(z0, raw_s, gain, bias, gy, gld):
    """``nf_tpu``'s ``_cf_bwd``: the gradients of (z0, t, raw_s, gain, bias)
    from the cotangents gy (B, N) of y and gld (B,) of ld."""
    th = torch.tanh(raw_s)
    es = torch.exp(th * gain + bias)
    ds = gy * z0 * es + gld[:, None]
    graw = ds * gain * (1.0 - th * th)
    return (gy * es, gy, graw, (ds * th).sum().reshape(gain.shape),
            ds.sum().reshape(bias.shape))


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------
def _fn(name, n_pointers, n_ints):
    fn = getattr(_build.load("coupling"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(name, halves, scalars):
    """The kernels take contiguous, 16-byte aligned float32 (B, N) halves
    with N % 4 == 0 and (1,) float32 scalars, all on one CUDA device."""
    ref = halves[0]
    if not ref.is_cuda:
        raise ValueError(f"{name} kernel needs a CUDA tensor, got {ref.device}")
    if ref.dim() != 2 or ref.shape[1] % 4 != 0:
        raise ValueError(f"{name} kernel takes (B, N) halves with N % 4 == 0, "
                         f"got {tuple(ref.shape)}")
    for x in halves:
        if (x.device != ref.device or x.dtype != torch.float32 or x.shape != ref.shape
                or not x.is_contiguous() or x.data_ptr() % 16 != 0):
            raise ValueError(f"{name} kernel takes contiguous, 16-byte aligned float32 "
                             f"{tuple(ref.shape)} tensors on {ref.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    for x in scalars:
        if x.device != ref.device or x.dtype != torch.float32 or x.numel() != 1:
            raise ValueError(f"{name} kernel takes (1,) float32 gain and bias on "
                             f"{ref.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel failed to launch: CUDA error {err}")


def launch(a, t, raw_s, gain, bias, inverse: bool):
    """The forward (or inverse) kernel on (B, N) halves: (out, ld (B,))."""
    name = "coupling_inv" if inverse else "coupling_fwd"
    with span(SPANS[name]):
        _check(name, (a, t, raw_s), (gain, bias))
        B, N = a.shape
        out = torch.empty_like(a)
        ld = torch.empty(B, dtype=torch.float32, device=a.device)
        if B == 0:
            return out, ld
        with torch.cuda.device(a.device):
            err = _fn("nf_coupling", 7, 3)(
                a.data_ptr(), t.data_ptr(), raw_s.data_ptr(), gain.data_ptr(),
                bias.data_ptr(), out.data_ptr(), ld.data_ptr(), B, N, int(inverse),
                torch.cuda.current_stream().cuda_stream)
        _raise_on(err, name)
        LAUNCHES[name] += 1
        return out, ld


def _ticket(device, stream):
    """The backward's ticket (one int32, zero between calls) for this device
    and stream: calls on one stream run in order, so they share it safely;
    zeroed once, at its first use."""
    key = (device, stream)
    if key not in _tickets:
        _tickets[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _tickets[key]


def launch_bwd(z0, raw_s, gain, bias, gy, gld):
    """The backward kernel, one launch: (gz0, graw, dgain, dbias); gt is gy
    itself."""
    with span(SPANS["coupling_bwd"]):
        _check("coupling_bwd", (z0, raw_s, gy), (gain, bias))
        B, N = z0.shape
        if gld.device != z0.device or gld.dtype != torch.float32 or gld.shape != (B,) \
                or not gld.is_contiguous():
            raise ValueError(f"coupling_bwd kernel takes a contiguous float32 ({B},) gld, "
                             f"got {gld.dtype} {tuple(gld.shape)} on {gld.device}")
        gz0 = torch.empty_like(z0)
        graw = torch.empty_like(z0)
        partial = torch.empty(B, 2, dtype=torch.float32, device=z0.device)
        dgain = torch.empty_like(gain)
        dbias = torch.empty_like(bias)
        with torch.cuda.device(z0.device):
            stream = torch.cuda.current_stream().cuda_stream
            ticket = _ticket(z0.device, stream)
            err = _fn("nf_coupling_bwd", 12, 2)(
                gy.data_ptr(), gld.data_ptr(), z0.data_ptr(), raw_s.data_ptr(),
                gain.data_ptr(), bias.data_ptr(), gz0.data_ptr(), graw.data_ptr(),
                partial.data_ptr(), ticket.data_ptr(), dgain.data_ptr(), dbias.data_ptr(),
                B, N, stream)
        _raise_on(err, "coupling_bwd")
        LAUNCHES["coupling_bwd"] += 1
        return gz0, graw, dgain, dbias


def _dense(x):
    """x as the kernels take it: contiguous and 16-byte aligned (a copy
    only where x is not)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


# --------------------------------------------------------------------------
# autograd and dispatch
# --------------------------------------------------------------------------
class CouplingFwd(torch.autograd.Function):
    """The forward with ``nf_tpu``'s analytic backward: kernels on the
    card, the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, z0, t, raw_s, gain, bias):
        if z0.device.type == "cpu":
            y, ld = coupling_fwd_reference(z0, t, raw_s, gain, bias)
        else:
            z0, t, raw_s = _dense(z0), _dense(t), _dense(raw_s)
            y, ld = launch(z0, t, raw_s, gain, bias, inverse=False)
        ctx.save_for_backward(z0, raw_s, gain, bias)
        return y, ld

    @staticmethod
    def backward(ctx, gy, gld):
        z0, raw_s, gain, bias = ctx.saved_tensors
        if z0.device.type == "cpu":
            return coupling_bwd_reference(z0, raw_s, gain, bias, gy, gld)
        gz0, graw, dgain, dbias = launch_bwd(z0, raw_s, gain, bias, _dense(gy),
                                             gld.contiguous())
        return gz0, gy, graw, dgain, dbias


class CouplingInv(torch.autograd.Function):
    """The inverse: the kernel on the card, the plain version on the CPU;
    no gradient."""

    @staticmethod
    def forward(ctx, y0, t, raw_s, gain, bias):
        if y0.device.type == "cpu":
            return coupling_inv_reference(y0, t, raw_s, gain, bias)
        return launch(_dense(y0), _dense(t), _dense(raw_s), gain, bias, inverse=True)

    @staticmethod
    def backward(ctx, gx, gld):
        raise NotImplementedError("the coupling inverse has no gradient (nor has nf_tpu's)")


def eligible(z0) -> bool:
    """``nf_tpu``'s gate: a 2-D half whose width is a multiple of 128."""
    return z0.dim() == 2 and z0.shape[1] % LANES == 0


def coupling_fwd(z0, t, raw_s, gain, bias):
    """(y, ld): through ``CouplingFwd`` where the gate passes, else the
    plain forward."""
    if not eligible(z0):
        return coupling_fwd_reference(z0, t, raw_s, gain, bias)
    return CouplingFwd.apply(z0, t, raw_s, gain, bias)


def coupling_inv(y0, t, raw_s, gain, bias):
    """(x, ld): through ``CouplingInv`` where the gate passes, else the
    plain inverse."""
    if not eligible(y0):
        return coupling_inv_reference(y0, t, raw_s, gain, bias)
    return CouplingInv.apply(y0, t, raw_s, gain, bias)
