"""Continuous normalizing flow, FFJORD (counterpart of
``nf_tpu/bijectors/cnf.py``).

* ``ODENet``: the time-conditioned network dz/dt = f(t, z): dense layers of
  ``(din + 1, dout)`` weights (``nf_tpu``'s orientation, applied as
  ``h @ w``) or 3x3 SAME convs over NHWC, the time channel concatenated
  FIRST to every layer's input, softplus between layers.
* ``CNF``: the ODE over the state (z, logdet) with d logdet / dt the trace
  of df/dz; ``forward`` integrates over the flipped times (t1 -> t0),
  ``inverse`` over the times as stored.  In train mode the trace is
  Hutchinson's with one probe drawn from the step's generator; in eval
  it is exact (``trace="exact"``) or Hutchinson's with 4 probes, drawn from
  the generator handed in (sampling through ``Trainer``) or from a
  generator seeded 0, anew for every CNF and call: the structure of
  ``nf_tpu``'s ``PRNGKey(0)``, not its values.  ``injected_probes`` replaces
  the draw (tests hand it ``nf_tpu``'s).  With ``backprop="adjoint"`` the
  probes and the net's parameters are explicit inputs of the adjoint, so
  its backward carries their cotangents in its augmented state, as
  ``nf_tpu``'s ``(params, v)``.

The trace needs autograd, so a CNF computes it under ``enable_grad`` also
inside ``no_grad`` callers (``EvalProgram``, ``Trainer.log_prob``,
``data_dependent_init``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.bijector import Bijector
from ..nets.layers import uniform
from ..ops import precision as pm
from ..ops.estimators import trace_exact, trace_hutchinson
from ..ops.odeint import SolveStats, check_solver, odeint, odeint_adjoint
from ..parallel.distributed import draw_rows

BACKPROPS = ("normal", "adjoint")
EVAL_PROBES = 4


class ODENet(nn.Module):
    """f(t, x): the hidden widths ``[c] + [base_filters] * n_layers + [c]``,
    c the last data axis; 2-D data (B, D) takes dense layers, NHWC images
    (len(dims) == 3) 3x3 convs (weights ``(out, in, 3, 3)``)."""

    def __init__(self, dims, base_filters: int = 32, n_layers: int = 2, device=None):
        super().__init__()
        self.dims = tuple(dims)
        self.is_image = len(self.dims) == 3
        c = self.dims[-1]
        self.hidden = [c] + [base_filters] * n_layers + [c]
        kw = dict(device=device, dtype=torch.float32)
        pairs = list(zip(self.hidden[:-1], self.hidden[1:]))
        shape = (lambda i, o: (o, i + 1, 3, 3)) if self.is_image else (lambda i, o: (i + 1, o))
        self.w = nn.ParameterList([nn.Parameter(torch.zeros(shape(i, o), **kw))
                                   for i, o in pairs])
        self.b = nn.ParameterList([nn.Parameter(torch.zeros(o, **kw)) for _, o in pairs])

    @torch.no_grad()
    def init(self, generator):
        """Kaiming-uniform, bound sqrt(1 / fan_in), fan_in = din + 1 (times
        9 for the conv), weight then bias per layer as ``nf_tpu`` draws."""
        for w, b in zip(self.w, self.b):
            fan_in = w[0].numel() if self.is_image else w.shape[0]
            bound = math.sqrt(1.0 / fan_in)
            w.copy_(uniform(generator, w.shape, bound, w.device))
            b.copy_(uniform(generator, b.shape, bound, b.device))

    def params(self):
        """The parameters in ``nf_tpu``'s pytree leaf order (biases, then
        weights), the order the adjoint's error norm sums them in."""
        return list(self.b) + list(self.w)

    def apply(self, params, t: float, x: torch.Tensor) -> torch.Tensor:
        """f(t, x) with ``params`` as ``params()`` orders them."""
        n = len(params) // 2
        bs, ws = params[:n], params[n:]
        h = x
        for i in range(n):
            tt = torch.full(h.shape[:-1] + (1,), t, dtype=h.dtype, device=h.device)
            h_in = torch.cat([tt, h], dim=-1)
            if self.is_image:
                h = pm.conv2d(h_in.permute(0, 3, 1, 2), ws[i], padding="same").permute(0, 2, 3, 1)
            else:
                h = pm.matmul(h_in, ws[i])
            h = h + bs[i]
            if i != n - 1:
                h = F.softplus(h)
        return h

    def forward(self, t: float, x: torch.Tensor) -> torch.Tensor:
        return self.apply(self.params(), t, x)


class CNF(Bijector):
    takes_generator = True
    inverse_takes_generator = True

    def __init__(self, dims, times, solver: str = "dopri5",
                 trace_estimator: str = "hutchinson", backprop: str = "adjoint",
                 base_filters: int = 32, n_layers: int = 2, rtol=None, atol=None,
                 device=None):
        super().__init__()
        check_solver(solver)
        if backprop not in BACKPROPS:
            raise ValueError(f"unknown backprop {backprop!r}; available: {BACKPROPS}")
        self.dims = tuple(dims)
        self.solver = solver
        self.trace_estimator = trace_estimator
        self.backprop = backprop
        self.rtol = rtol
        self.atol = atol
        self.register_buffer("times", torch.as_tensor(times, dtype=torch.float32)
                             .to(device).clone())
        self.net = ODENet(dims, base_filters, n_layers, device=device)
        # (P, *x.shape) used instead of a draw when set; P = 1 in train mode
        self.injected_probes: Optional[torch.Tensor] = None
        self.stats = SolveStats()

    def _probes(self, x, exact: bool, n_probes: int, generator):
        if self.injected_probes is not None:
            v = self.injected_probes.to(device=x.device, dtype=x.dtype)
            if v.shape[1:] != x.shape:
                raise ValueError(f"injected probes {tuple(v.shape)} do not fit {tuple(x.shape)}")
            return v
        if exact:
            return torch.zeros((1,) + x.shape, dtype=x.dtype, device=x.device)
        if generator is None:
            generator = torch.Generator(device=x.device).manual_seed(0)
        # this rank's rows of the host's draw in a data-parallel step
        v = draw_rows((n_probes,) + x.shape, generator, axis=1)
        return v.to(device=x.device, dtype=x.dtype)

    def _dynamics(self, exact: bool):
        """f over the state (z, logdet), with its parameters and the probes
        v as explicit inputs: ``params = net.params() + [v]``."""
        net = self.net

        def fn(params, t, state):
            *p, v = params
            f_of = lambda zz: net.apply(p, t, zz)  # noqa: E731
            if exact:
                return trace_exact(f_of, state[0])
            return trace_hutchinson(f_of, state[0], v)

        return fn

    def _solve(self, x, times, generator):
        if self.training:
            exact, n_probes = False, 1
        elif self.trace_estimator == "exact":
            exact, n_probes = True, 0
        else:
            exact, n_probes = False, EVAL_PROBES
        v = self._probes(x, exact, n_probes, generator)
        params = self.net.params() + [v]
        fn = self._dynamics(exact)
        state0 = (x, torch.zeros(x.shape[0], dtype=x.dtype, device=x.device))
        if self.backprop == "adjoint":
            # the net's parameters are shared by the batch, the probes per sample
            return odeint_adjoint(fn, params, state0, times, self.solver, self.rtol,
                                  self.atol, self.stats, (True,) * (len(params) - 1) + (False,))
        return odeint(lambda t, s: fn(params, t, s), state0, times, self.solver,
                      self.rtol, self.atol, self.stats)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        return self._solve(x, torch.flip(self.times, (0,)), generator)

    def inverse(self, y, generator: Optional[torch.Generator] = None):
        return self._solve(y, self.times, generator)
