"""Profiling and cost counting (counterpart of ``nf_tpu/utils/profiling.py``).

* ``trace(log_dir)``: a ``torch.profiler`` window (CPU activity, and CUDA
  activity where a card is present) whose Chrome trace is written into
  ``log_dir`` when the window closes, the port's spans (``utils/tracing.py``)
  recorded in it as ranges of their names;
* ``StepTimer``: nf_tpu's rolling wall-clock window; ``mark()`` first
  synchronizes the card when the timer was given a CUDA device;
* ``cost_analysis(fn, *args)``: ``{"flops", "bytes accessed"}`` of one
  call, counted op by op by a ``TorchDispatchMode``: matmuls and
  convolutions by ``torch.utils.flop_counter``'s formulas, every other op
  one flop per output element (XLA's cost analysis counts element-wise
  work so), views nothing; bytes are each op's inputs and outputs;
* ``bijector_cost`` / ``model_flops``: the pass walked through ``Chain``
  and ``ScannedChain`` as nf_tpu's walker walks them, a scanned block
  costed once and multiplied by its repeats;
* ``roofline_estimate``: nf_tpu's keys against the H100's peaks.

What is counted is the plain versions' work: pass CPU tensors and a model
on the CPU, where every kernel wrapper runs its plain version.  The count
never looks at the card's kernels, so it reads the same work whatever
implements a kernel.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from . import tracing


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` window, spans recorded (``tracing.recording``):
    each shows in the trace as a range of its name.  On exit its Chrome
    trace is written to ``<log_dir>/trace_<time>_<pid>.json``.  Yields the
    profiler, whose ``trace_path`` names the file after the window."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.trace_path = None
    with prof, tracing.recording():
        yield prof
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    path = os.path.join(log_dir, f"trace_{time.strftime('%Y%m%d-%H%M%S')}_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    prof.trace_path = path


class StepTimer:
    """Rolling wall-clock timer over the last ``window`` marks; with a CUDA
    ``device`` each ``mark()`` synchronizes it before reading the clock."""

    def __init__(self, window: int = 50, device: Optional[torch.device] = None):
        self.window = window
        self.device = None if device is None else torch.device(device)
        self._times = []
        self._last = None

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        self._sync()
        self._last = time.perf_counter()

    def mark(self) -> float:
        self._sync()
        now = time.perf_counter()
        dt = now - (self._last if self._last is not None else now)
        self._last = now
        self._times.append(dt)
        if len(self._times) > self.window:
            self._times.pop(0)
        return dt

    @property
    def mean(self) -> float:
        return sum(self._times) / max(len(self._times), 1)


# the H100 SXM's dense f32 peak (FFMA) and HBM3 rate (NVIDIA data sheet, 700 W),
# the peaks chip_smoke.py's kernel bounds use
_CHIP_PEAKS = {"h100": {"flops": 67e12, "hbm_gbps": 3350.0}}


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class _CostMode(TorchDispatchMode):
    """Counts flops and bytes of every op dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view or func._overloadpacket in _FREE:
            return out
        packet = func._overloadpacket
        outs = _tensors(out)
        if packet in flop_registry:
            self.flops += float(flop_registry[packet](*args, **kwargs, out_val=out))
        else:
            self.flops += float(sum(t.numel() for t in outs))
        self.bytes += float(sum(t.numel() * t.element_size()
                                for t in _tensors((args, kwargs)) + outs))
        return out


_aten = torch.ops.aten
# ops that move no data: metadata, aliasing, fresh storage
_FREE = {_aten.detach, _aten.alias, _aten.lift_fresh, _aten.empty, _aten.empty_strided,
         _aten.empty_like}


def cost_analysis(fn, *args) -> dict:
    """``{"flops", "bytes accessed"}`` of ``fn(*args)``, counted op by op
    without a gradient (see the module's docstring)."""
    mode = _CostMode()
    with torch.no_grad(), mode:
        fn(*args)
    return {"flops": mode.flops, "bytes accessed": mode.bytes}


def _acc(a: dict, b: dict, mult: float = 1.0):
    a["flops"] += mult * b.get("flops", 0.0)
    a["bytes_accessed"] += mult * b.get("bytes_accessed", b.get("bytes accessed", 0.0))


def bijector_cost(bij, x, method: str = "forward") -> tuple:
    """Scan-aware cost of ``bij``'s ``method`` on ``x``: (cost, output).
    A ``Chain`` is walked layer by layer (reversed for the inverse), a
    ``ScannedChain``'s block 0 is costed once and counted ``len(blocks)``
    times, and every other layer is costed by ``cost_analysis``; the
    output is threaded through for the next layer's shapes."""
    from ..core.bijector import Chain, ScannedChain, call_forward, call_inverse

    total = {"flops": 0.0, "bytes_accessed": 0.0}
    if isinstance(bij, Chain):
        layers = list(bij.layers)
        for layer in (layers if method == "forward" else reversed(layers)):
            c, x = bijector_cost(layer, x, method)
            _acc(total, c)
        return total, x
    if isinstance(bij, ScannedChain):
        c, _ = bijector_cost(bij.blocks[0], x, method)
        _acc(total, c, mult=len(bij.blocks))
        with torch.no_grad():
            y, _ = (bij(x) if method == "forward" else bij.inverse(x))
        return total, y
    call = call_forward if method == "forward" else call_inverse
    out = {}

    def run(xx):
        out["y"] = call(bij, xx)[0]

    _acc(total, cost_analysis(run, x))
    return total, out["y"]


def model_flops(model, x, method: str = "forward") -> dict:
    """Scan-aware cost of a ``FlowModel`` pass (see ``bijector_cost``)."""
    cost, _ = bijector_cost(model.bijector, x, method)
    return cost


def roofline_estimate(fn, *args, chip: str = "h100",
                      measured_seconds: Optional[float] = None) -> dict:
    """nf_tpu's roofline keys for ``fn(*args)`` against the H100's peaks:
    arithmetic intensity, the ridge, and with a measured time the achieved
    rates and their shares of the peaks."""
    if chip not in _CHIP_PEAKS:
        raise ValueError(f"no peaks for chip {chip!r}; known: {sorted(_CHIP_PEAKS)}")
    ca = cost_analysis(fn, *args)
    flops = float(ca["flops"])
    bytes_ = float(ca["bytes accessed"])
    peaks = _CHIP_PEAKS[chip]
    out = {
        "flops": flops,
        "bytes_accessed": bytes_,
        "arithmetic_intensity": flops / bytes_ if bytes_ else float("inf"),
        "ridge_intensity": peaks["flops"] / (peaks["hbm_gbps"] * 1e9),
    }
    if measured_seconds:
        out["achieved_flops_per_s"] = flops / measured_seconds
        out["pct_of_peak_flops"] = 100.0 * out["achieved_flops_per_s"] / peaks["flops"]
        out["achieved_gbps"] = bytes_ / measured_seconds / 1e9
        out["pct_of_peak_bw"] = 100.0 * out["achieved_gbps"] / peaks["hbm_gbps"]
    return out
