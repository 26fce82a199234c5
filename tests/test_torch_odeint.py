"""The port's ODE solvers and adjoint against nf_tpu's, on the CPU.

The dynamics are a small nonlinear map over a tuple state (a (B, 3)
tensor and a (B,) accumulator, as FFJORD's (z, logdet)), the same
weights in both packages, made with numpy; the solver tests add a
forcing sin(20 t^2) that makes the adaptive solvers reject steps.

* every solver over the time grid of 11 points: the fixed-step solvers
  within 2e-5 (f32 rounding in another summation order); the adaptive
  solvers (rtol / atol 1e-4 and 1e-6, rejecting steps at both; bosha3
  at 1e-6 paces at the step floor) within 2e-5, with their dynamics
  evaluations equal to nf_tpu's, counted under
  ``jax.disable_jit()`` where its ``fori_loop`` and ``cond`` run as
  Python: equal counts show the same steps were taken (measured: 2.4e-7);
* the adjoint's gradients for the parameters and x0 against nf_tpu's
  adjoint within 1e-5 + 1e-5 relative (measured: 1.2e-6 at |g| = 4.6),
  its evaluations (both solves) equal to nf_tpu's; and against the port's
  own 'normal' backprop through the loop (the adjoint solves its backward
  on its own steps, so the two differ by the solver's truncation error,
  not f32 rounding): within 1e-3 (measured 5.9e-4 for bosha3), midpoint
  within 1e-2 (second order at dt = 0.1: measured 4.1e-3);
* an exhausted trip budget (a dynamics that turns NaN halfway, so every
  step is rejected from there on) runs nf_tpu's ``12 n + 16`` trips in
  both and returns NaN.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import close, normal

from nf_tpu.ops import odeint as jo
from nf_tpu_torch.ops import odeint as to

TIMES = np.linspace(0.0, 1.0, 11, dtype=np.float32)
B = 8
W = normal(0, (3, 3), 0.8)
BIAS = normal(1, (3,), 0.3)
A0 = normal(2, (B, 3))
CT = (normal(3, (B, 3)), normal(4, (B,)))


FORCING = 20.0


def jdyn(p, t, x, k=FORCING):
    w, b = p
    a, _ = x
    return jnp.tanh(a @ w + b + jnp.sin(k * t * t)), jnp.sum(jnp.tanh(a @ w) * a, axis=1)


def tdyn(p, t, x, k=FORCING):
    w, b = p
    a, _ = x
    t = np.float32(t)
    forcing = float(np.sin(np.float32(k) * t * t))
    return torch.tanh(a @ w + b + forcing), (torch.tanh(a @ w) * a).sum(1)


def smooth_jdyn(p, t, x):
    return jdyn(p, t, x, 0.0)


def smooth_tdyn(p, t, x):
    return tdyn(p, t, x, 0.0)


def _jax_solve(method, tol, dyn=jdyn):
    calls = [0]

    def f(t, x):
        calls[0] += 1
        return dyn((jnp.asarray(W), jnp.asarray(BIAS)), t, x)

    with jax.disable_jit():
        x = jo.odeint(f, (jnp.asarray(A0), jnp.zeros(B)), jnp.asarray(TIMES), method, tol, tol)
    return x, calls[0]


def _torch_solve(method, tol, dyn=tdyn):
    stats = to.SolveStats()
    p = (torch.from_numpy(W), torch.from_numpy(BIAS))
    x = to.odeint(lambda t, x: dyn(p, t, x), (torch.from_numpy(A0), torch.zeros(B)), TIMES,
                  method, tol, tol, stats)
    return x, stats


@pytest.mark.parametrize("method,tol", [("midpoint", None), ("rk4", None), ("bosha3", 1e-4),
                                        ("dopri5", 1e-4), ("bosha3", 1e-6), ("dopri5", 1e-6)])
def test_solver_matches_nf_tpu(method, tol):
    jx, jcalls = _jax_solve(method, tol)
    tx, stats = _torch_solve(method, tol)
    assert stats.evaluations == jcalls and stats.solves == 1
    if tol is not None:
        assert stats.rejected > 0          # the controller's reject branch is exercised
    for a, b in zip(tx, jx):
        assert bool(torch.isfinite(a).all())
        close(a, b, 2e-5)


def test_unknown_solver_names_nf_tpu_solvers():
    assert to.SOLVERS == jo.SOLVERS
    with pytest.raises(ValueError, match="available"):
        to.odeint(lambda t, x: x, (torch.zeros(2),), TIMES, "euler")


def _jax_adjoint_grads(method):
    calls = [0]

    def f(p, t, x):
        calls[0] += 1
        return smooth_jdyn(p, t, x)

    def loss(p, a):
        z, ld = jo.odeint_adjoint(f, p, (a, jnp.zeros(B)), jnp.asarray(TIMES), method,
                                  1e-4, 1e-4)
        return jnp.sum(z * CT[0]) + jnp.sum(ld * CT[1])

    with jax.disable_jit():
        (gw, gb), ga = jax.grad(loss, argnums=(0, 1))((jnp.asarray(W), jnp.asarray(BIAS)),
                                                      jnp.asarray(A0))
    return (gw, gb, ga), calls[0]


def _torch_grads(method, adjoint):
    p = [torch.tensor(W, requires_grad=True), torch.tensor(BIAS, requires_grad=True)]
    a = torch.tensor(A0, requires_grad=True)
    stats = to.SolveStats()
    x0 = (a, torch.zeros(B))
    if adjoint:
        z, ld = to.odeint_adjoint(smooth_tdyn, p, x0, TIMES, method, 1e-4, 1e-4, stats)
    else:
        z, ld = to.odeint(lambda t, x: smooth_tdyn(p, t, x), x0, TIMES, method, 1e-4, 1e-4,
                          stats)
    ((z * torch.from_numpy(CT[0])).sum() + (ld * torch.from_numpy(CT[1])).sum()).backward()
    return (p[0].grad, p[1].grad, a.grad), stats


@pytest.mark.parametrize("method,normal_atol", [("midpoint", 1e-2), ("rk4", 1e-3),
                                                ("bosha3", 1e-3), ("dopri5", 1e-3)])
def test_adjoint_matches_nf_tpu(method, normal_atol):
    jgrads, jcalls = _jax_adjoint_grads(method)
    grads, stats = _torch_grads(method, adjoint=True)
    assert stats.solves == 2 and stats.evaluations == jcalls
    for g, jg in zip(grads, jgrads):
        close(g, jg, 1e-5, 1e-5)
    normal_grads, _ = _torch_grads(method, adjoint=False)
    for g, gn in zip(grads, normal_grads):
        close(g, gn, normal_atol)


def test_exhausted_budget_is_nan():
    def jnan(p, t, x):
        z, tr = jdyn(p, t, x)
        return jnp.where(t > 0.5, jnp.nan, z), tr

    def tnan(p, t, x):
        z, tr = tdyn(p, t, x)
        return (z * float("nan") if t > 0.5 else z), tr

    jx, jcalls = _jax_solve("dopri5", 1e-4, jnan)
    tx, stats = _torch_solve("dopri5", 1e-4, tnan)
    trips = to.max_trips(len(TIMES) - 1)
    assert trips == 12 * (len(TIMES) - 1) + 16
    assert stats.accepted + stats.rejected == trips and stats.evaluations == jcalls == 7 * trips
    for a, b in zip(tx, jx):
        assert bool(torch.isnan(a).all()) and bool(np.isnan(np.asarray(b)).all())
