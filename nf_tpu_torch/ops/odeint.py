"""ODE solvers and adjoint backprop over tuples of tensors (counterpart of
``nf_tpu/ops/odeint.py``).

* ``midpoint`` / ``rk4``: fixed steps over the time grid;
* ``bosha3`` / ``dopri5``: embedded Runge-Kutta pairs (nf_tpu's tableaus)
  with true accept / reject step control: the error norm
  ``rms(err / (atol + rtol * max(|x|, |x + dx|)))`` over every tensor of the
  state, dt clamped to [0.2, 5] x the nominal step and clipped to the time
  remaining, a step accepted when its error norm is at most 1 or dt is at
  the floor; at most ``12 n + 16`` trips for n nominal steps, after which
  an unfinished solve returns NaN;
* ``odeint_adjoint``: the reverse-time solve of the augmented state
  (adjoint, state, parameter adjoint) as a ``torch.autograd.Function``.

In a data-parallel step (``parallel/distributed.py::global_batch``) the
error norm is that of nf_tpu's one program over the whole batch: each
rank's sum of squared ratios over its rows is summed over the data group
in one all-reduce a trip, so every rank accepts the same steps.  A leaf
that is a sum over the batch (the adjoint's parameter adjoints) has its
error, value and increment summed over the ranks first, and its ratios
formed from those sums.

nf_tpu runs the adaptive loop as a fixed-trip ``fori_loop`` whose finished
trips cost nothing.  Here it is a Python ``while`` that reads the step's
error norm once per trip (one device read) and stops when the solve is
done, so both take the same steps.  The times ``t``, ``dt`` and the
controller's ``dt_new`` are float32 on the host (``np.float32``), as nf_tpu
keeps them float32 scalars: the last step, the end test and the accept
decisions then fall where nf_tpu's do.  The controller is never
differentiated.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel.distributed import all_reduce, batch_mesh

State = Tuple[torch.Tensor, ...]
F32 = np.float32


@dataclass
class SolveStats:
    """Counts a caller may hand a solve: solves, dynamics evaluations and
    the adaptive solvers' accepted and rejected steps (fixed-step solvers
    count every step as accepted)."""
    solves: int = 0
    evaluations: int = 0
    accepted: int = 0
    rejected: int = 0

    def add(self, other: "SolveStats") -> None:
        for k in ("solves", "evaluations", "accepted", "rejected"):
            setattr(self, k, getattr(self, k) + getattr(other, k))


def _axpy(a, xs: State, ys: State) -> State:
    """ys + a * xs."""
    return tuple(y + a * x for x, y in zip(xs, ys))


def _weighted_sum(coeffs: Sequence[float], kss: Sequence[State]) -> State:
    """sum_i coeffs[i] * kss[i], the zero coefficients skipped, in nf_tpu's
    order."""
    acc = tuple(coeffs[0] * k for k in kss[0])
    for c, ks in zip(coeffs[1:], kss[1:]):
        if c == 0.0:
            continue
        acc = tuple(a + c * k for a, k in zip(acc, ks))
    return acc


class _Counted:
    """``func`` with its evaluations counted."""

    def __init__(self, func, stats: SolveStats):
        self.func, self.stats = func, stats

    def __call__(self, t, x):
        self.stats.evaluations += 1
        return self.func(float(t), x)


# ------------------------------------------------------------- fixed-step
def _midpoint_step(func, t, x, dt):
    k1 = func(t, x)
    k2 = func(t + F32(0.5) * dt, _axpy(float(F32(0.5) * dt), k1, x))
    return tuple(float(dt) * k for k in k2)


def _rk4_step(func, t, x, dt):
    half = F32(0.5) * dt
    k1 = func(t, x)
    k2 = func(t + half, _axpy(float(half), k1, x))
    k3 = func(t + half, _axpy(float(half), k2, x))
    k4 = func(t + dt, _axpy(float(dt), k3, x))
    return tuple(float(dt) * (a + 2 * b + 2 * c + d) / 6.0
                 for a, b, c, d in zip(k1, k2, k3, k4))


def _fixed_integrate(step_fn, func, x0: State, times: np.ndarray, stats: SolveStats):
    x = x0
    for t0, t1 in zip(times[:-1], times[1:]):
        dx = step_fn(func, t0, x, t1 - t0)
        x = tuple(a + d for a, d in zip(x, dx))
        stats.accepted += 1
    return x


# --------------------------------------------------------------- adaptive
@dataclass(frozen=True)
class Tableau:
    order: int
    c_t: Sequence[float]
    c_x: Sequence[Sequence[float]]
    c_err: Sequence[float]
    rtol: float
    atol: float


BOSHA3 = Tableau(
    order=3,
    c_t=[1 / 2, 3 / 4, 1.0, 1.0],
    c_x=[
        [1 / 2],
        [0.0, 3 / 4],
        [2 / 9, 1 / 3, 4 / 9],
        [2 / 9, 1 / 3, 4 / 9, 0.0],
    ],
    c_err=[2 / 9 - 7 / 24, 1 / 3 - 1 / 4, 4 / 9 - 1 / 3, 0.0 - 1 / 8],
    rtol=1.0e-3, atol=1.0e-3,
)

DOPRI5 = Tableau(
    order=5,
    c_t=[1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0],
    c_x=[
        [1 / 5],
        [3 / 40, 9 / 40],
        [44 / 45, -56 / 15, 32 / 9],
        [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
        [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
        [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
    ],
    c_err=[
        35 / 384 - 5179 / 57600,
        0.0,
        500 / 1113 - 7571 / 16695,
        125 / 192 - 393 / 640,
        -2187 / 6784 + 92097 / 339200,
        11 / 84 - 187 / 2100,
        0.0 - 1 / 40,
    ],
    rtol=1.0e-2, atol=1.0e-2,
)


def _error_norm(tab: Tableau, x_err: State, x: State, dx: State, summed) -> torch.Tensor:
    """rms(err / (atol + rtol max(|x|, |x + dx|))) over every element of the
    state, the whole batch's within ``global_batch``: the per-sample
    leaves' sums of squared ratios are summed over the data group, and the
    ``summed`` leaves (sums over the batch) have their error, value and
    increment summed before the ratio, in one all-reduce."""
    mesh = batch_mesh()
    summed = summed if summed is not None else (False,) * len(x)

    def ratio_sq(e, xx, dd):
        etol = tab.atol + tab.rtol * torch.maximum(xx.abs(), (xx + dd).abs())
        r = e / etol
        return (r * r).sum()

    total, count = 0.0, 0
    sums = []
    for e, xx, dd, is_sum in zip(x_err, x, dx, summed):
        xx, dd = xx.detach(), dd.detach()
        if mesh is not None and is_sum:
            sums.append((e, xx, dd))
            continue
        total = total + ratio_sq(e, xx, dd)
        # a per-sample leaf counts the rows of every data rank (of one size)
        count += e.numel() * (1 if mesh is None else mesh.data_size)
    if sums:
        flat = torch.cat([torch.as_tensor(total, dtype=torch.float32,
                                          device=x[0].device).reshape(1)]
                         + [t.reshape(-1) for trio in sums for t in trio])
        all_reduce(flat, mesh.group)
        total, offset = flat[0], 1
        for e, _, _ in sums:
            n = e.numel()
            e_, xx_, dd_ = (flat[offset + k * n:offset + (k + 1) * n].view(e.shape)
                            for k in range(3))
            total = total + ratio_sq(e_, xx_, dd_)
            count += n
            offset += 3 * n
    elif mesh is not None:
        total = all_reduce(total.reshape(1).clone(), mesh.group)[0]
    return torch.sqrt(torch.clamp(total / count, min=1e-24))


def _adaptive_step(tab: Tableau, func, t, x: State, dt, summed=None):
    """One embedded RK step; returns (dx, err_norm, dt_new), the last two
    float32 on the host."""
    ks = [func(t, x)]
    for i in range(tab.order + 1):
        kx = _weighted_sum(tab.c_x[i], ks[: len(tab.c_x[i])])
        xi = _axpy(float(dt), kx, x)
        ks.append(func(t + F32(tab.c_t[i]) * dt, xi))

    dx = tuple(float(dt) * k for k in _weighted_sum(tab.c_x[-1], ks[: len(tab.c_x[-1])]))
    with torch.no_grad():
        x_err = tuple(float(dt) * k for k in _weighted_sum(tab.c_err, ks[: len(tab.c_err)]))
        err = _error_norm(tab, x_err, x, dx, summed)
    err_norm = F32(err.item())
    dt_new = dt * (F32(0.5) / max(err_norm, F32(1e-10))) ** F32(1.0 / tab.order)
    return dx, err_norm, dt_new


def max_trips(n_nominal: int) -> int:
    """The adaptive loop's trip budget: pacing at dt_min (5 x the nominal
    steps) with rejects interleaved."""
    return 12 * n_nominal + 16


def _adaptive_integrate(tab: Tableau, func, x0: State, times: np.ndarray,
                        stats: SolveStats, summed=None):
    t_start, t_end = times[0], times[-1]
    n_nominal = times.shape[0] - 1
    dt0 = (t_end - t_start) / F32(n_nominal)
    dt_min, dt_max = abs(dt0) * F32(0.2), abs(dt0) * F32(5.0)
    sign = np.sign(dt0)
    end_tol = F32(1.0e-6) * max(F32(1.0), abs(t_end))
    t, x, dt, done = t_start, x0, dt0, False
    for _ in range(max_trips(n_nominal)):
        remaining = t_end - t
        dt_eff = remaining if abs(dt) > abs(remaining) else dt
        dx, err, dt_new = _adaptive_step(tab, func, t, x, dt_eff, summed)
        if err <= 1.0 or abs(dt_eff) <= dt_min * F32(1.001):
            x = tuple(a + d for a, d in zip(x, dx))
            t = t + dt_eff
            stats.accepted += 1
        else:
            stats.rejected += 1
        dt = sign * np.clip(abs(dt_new), dt_min, dt_max)
        done = abs(t - t_end) <= end_tol
        if done:
            break
    if not done:
        # an exhausted budget never returns a short integration
        x = tuple(torch.full_like(a, float("nan")) for a in x)
    return x


# ----------------------------------------------------------------- public
_FIXED = {"midpoint": _midpoint_step, "rk4": _rk4_step}
_ADAPTIVE = {"bosha3": BOSHA3, "dopri5": DOPRI5}
SOLVERS = tuple(sorted(list(_FIXED) + list(_ADAPTIVE)))


def check_solver(method: str) -> None:
    if method not in SOLVERS:
        raise ValueError(f"unknown solver {method!r}; available: {SOLVERS}")


def _resolve_tableau(method: str, rtol, atol) -> Tableau:
    tab = _ADAPTIVE[method]
    return Tableau(tab.order, tab.c_t, tab.c_x, tab.c_err,
                   tab.rtol if rtol is None else rtol,
                   tab.atol if atol is None else atol)


def host_times(times) -> np.ndarray:
    """The time grid as float32 on the host."""
    if isinstance(times, torch.Tensor):
        times = times.detach().cpu().numpy()
    return np.asarray(times, dtype=np.float32)


def odeint(func: Callable, x0: Sequence[torch.Tensor], times, method: str = "dopri5",
           rtol: Optional[float] = None, atol: Optional[float] = None,
           stats: Optional[SolveStats] = None, summed: Optional[Sequence[bool]] = None) -> State:
    """Integrate dx/dt = func(t, x) from times[0] to times[-1].

    ``x0`` is a tuple of tensors and ``func(t, x)`` (t a Python float)
    returns a tuple of the same shapes.  Differentiable through the loop
    (backprop 'normal').  ``rtol`` / ``atol`` override the adaptive
    tableau's tolerances (fixed-step solvers ignore them).  ``stats``, when
    given, has this solve's counts added to it.  ``summed`` flags the
    leaves of ``x0`` that are sums over the batch, not per sample (for the
    error norm within ``global_batch``; default none)."""
    check_solver(method)
    own = SolveStats(solves=1)
    counted = _Counted(func, own)
    x0, times = tuple(x0), host_times(times)
    if method in _FIXED:
        x = _fixed_integrate(_FIXED[method], counted, x0, times, own)
    else:
        x = _adaptive_integrate(_resolve_tableau(method, rtol, atol), counted, x0, times, own,
                                summed)
    if stats is not None:
        stats.add(own)
    return x


class _Adjoint(torch.autograd.Function):
    """x1 = odeint(func(params, .), x0); the backward integrates
    (adjoint, x, parameter adjoint) from times[-1] back to times[0], x
    solved again backward from x1 (no stored trajectory)."""

    @staticmethod
    def forward(ctx, func, method, rtol, atol, times, stats, shared, n_state, *tensors):
        x0, params = tensors[:n_state], tensors[n_state:]
        x1 = odeint(lambda t, x: func(params, t, x), x0, times, method, rtol, atol, stats)
        ctx.func, ctx.method, ctx.rtol, ctx.atol = func, method, rtol, atol
        ctx.times, ctx.stats, ctx.n_state, ctx.shared = times, stats, n_state, shared
        ctx.save_for_backward(*x1, *params)
        return x1

    @staticmethod
    def backward(ctx, *ct_x1):
        n = ctx.n_state
        saved = ctx.saved_tensors
        x1 = saved[:n]
        params = tuple(p.detach().requires_grad_() for p in saved[n:])
        func = ctx.func

        def aug_dyn(t, aug):
            adj, x = aug[:n], aug[n:2 * n]
            with torch.enable_grad():
                xs = tuple(a.detach().requires_grad_() for a in x)
                f = func(params, t, xs)
                outs = [(o, -a) for o, a in zip(f, adj) if o.requires_grad]
                vjp = torch.autograd.grad([o for o, _ in outs], xs + params,
                                          [a for _, a in outs], allow_unused=True)
            vjp = tuple(torch.zeros_like(w) if g is None else g
                        for g, w in zip(vjp, xs + params))
            return vjp[:n] + tuple(v.detach() for v in f) + vjp[n:]

        aug0 = (tuple(c.contiguous() for c in ct_x1) + tuple(x1)
                + tuple(torch.zeros_like(p) for p in params))
        out = odeint(aug_dyn, aug0, ctx.times[::-1].copy(), ctx.method, ctx.rtol, ctx.atol,
                     ctx.stats, (False,) * (2 * n) + ctx.shared)
        return (None,) * 8 + out[:n] + out[2 * n:]


def odeint_adjoint(func: Callable, params: Sequence[torch.Tensor],
                   x0: Sequence[torch.Tensor], times, method: str = "dopri5",
                   rtol: Optional[float] = None, atol: Optional[float] = None,
                   stats: Optional[SolveStats] = None,
                   shared: Optional[Sequence[bool]] = None) -> State:
    """``odeint`` of ``func(params, t, x)`` whose gradient for ``x0`` and
    every tensor of ``params`` comes from the adjoint: the augmented state
    integrated backward in time, with the same solver and tolerances, its
    error norm over every tensor of it (the parameter adjoints included).
    ``func`` must compute a VJP of its outputs with respect to ``params``
    and ``x`` when grad mode is on.  ``shared`` flags the parameters shared
    by the batch, whose adjoints are sums over it (default: all of them),
    against per-sample ones such as FFJORD's probes."""
    check_solver(method)
    x0, params = tuple(x0), tuple(params)
    shared = (True,) * len(params) if shared is None else tuple(bool(s) for s in shared)
    return _Adjoint.apply(func, method, rtol, atol, host_times(times), stats, shared, len(x0),
                          *x0, *params)
