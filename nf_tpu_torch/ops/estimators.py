"""Log-det estimators for residual maps f(x) = x + g(x), ResFlow's
memory-saved training gradient, and FFJORD's trace estimators
(counterpart of ``nf_tpu/ops/estimators.py``).

* ``logdet_exact``: log|det(I + J)| from D vector-Jacobian products per
  sample and ``slogdet``;
* ``logdet_fixed``: the power series sum_k (-1)^(k+1) tr(J^k) / k cut at
  ``n_power_series`` terms, with Hutchinson probes;
* ``logdet_unbias``: the Russian-roulette series, ``n_terms = n_exact + G``
  with G geometric, term k weighted by ``1 / (k (1-p)^max(0, k-n_exact-1))``.

The Jacobian products come from autograd (``torch.func.vjp``), so the
estimators stay generic over ``g_fn``, as ``jax.vjp`` keeps ``nf_tpu``'s.

The probes are ARGUMENTS, never drawn inside an estimator: JAX's threefry
stream cannot be reproduced, so a comparison with ``nf_tpu`` hands both
packages the same draws.  ``draw_unbias_probes`` / ``draw_fixed_probes``
draw them from a caller's ``torch.Generator`` with ``nf_tpu``'s structure
(4 probes; a series length per probe for 'unbias'), and ``eval_probes``
is the serving set: ``nf_tpu``'s eval blocks all use ``PRNGKey(0)``, the
port a generator seeded 0 on the data's device, so every block and every
call at one batch size sees the same probes.  The estimators take probes
of the data's shape, (S, *x.shape); a (S, B, D) set is reshaped to it, so
one draw serves NHWC images too.

``iresblock_forward`` is the training forward of a residual block: one
Russian-roulette value (``n_exact = 1``) and, for the gradient, the
Neumann-series probe u = v sum_k (-J)^k weighted as the roulette, both
formed without keeping a graph; ``draw_train_probes`` draws its two
(series length, probe) pairs in ``nf_tpu``'s structure.

``trace_exact`` / ``trace_hutchinson`` (FFJORD's CNF) return the map's
value with its trace; they take the Hutchinson probes as a tensor too.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from ..parallel.distributed import draw_rows

# Cap for Russian-roulette series length: n_exact + Geom(p), G <= 32
SERIES_CAP = 32
TINY = torch.finfo(torch.float32).tiny
# serving-mode estimator constants (nf_tpu/bijectors/iresblock.py:62-65)
N_SAMPLES = 4
N_POWER_SERIES = 8
N_EXACT = 8
P = 0.5
# training: the value's roulette keeps one exact term (nf_tpu/ops/estimators.py
# iresblock_forward), the Neumann series' draw is 1 + G as well
TRAIN_N_EXACT = 1

# (V (S, B, D) or (S, *x.shape), n_terms (S,) int CPU tensor or None)
Probes = Tuple[torch.Tensor, Optional[torch.Tensor]]
# ((n_val, v_val), (n_grad, v_grad)): series lengths and probes of x's shape
TrainProbes = Tuple[Tuple[int, torch.Tensor], Tuple[int, torch.Tensor]]


def geometric(u: torch.Tensor, p: float) -> torch.Tensor:
    """G >= 1 with P(G = k) = p (1-p)^(k-1) from a uniform ``u`` in
    [tiny, 1): floor(log u / log1p(-p)) + 1, clipped to [1, SERIES_CAP]."""
    g = torch.floor(torch.log(u) / torch.log1p(torch.tensor(-p, dtype=u.dtype))) + 1.0
    return torch.clamp(g.to(torch.int32), 1, SERIES_CAP)


def _uniform_tiny(generator: torch.Generator) -> torch.Tensor:
    u = torch.rand((), generator=generator, device=generator.device, dtype=torch.float32)
    return torch.clamp(u, min=TINY)


def draw_unbias_probes(B: int, D: int, generator: torch.Generator) -> Probes:
    """The 'unbias' estimator's draws for a (B, D) batch, in ``nf_tpu``'s
    structure: per probe s, a series length ``n_exact + G`` then a normal
    (B, D) probe.  Returns (V (S, B, D) on the generator's device,
    n_terms (S,) int32 on the CPU)."""
    vs, nts = [], []
    for _ in range(N_SAMPLES):
        nts.append(N_EXACT + geometric(_uniform_tiny(generator), P))
        vs.append(torch.randn((B, D), generator=generator, device=generator.device,
                              dtype=torch.float32))
    return torch.stack(vs), torch.stack(nts).cpu()


def draw_fixed_probes(B: int, D: int, generator: torch.Generator) -> Probes:
    """The 'fixed' estimator's draws: 4 normal (B, D) probes, no lengths."""
    return torch.stack([torch.randn((B, D), generator=generator, device=generator.device,
                                    dtype=torch.float32)
                        for _ in range(N_SAMPLES)]), None


def eval_probes(estimator: str, B: int, D: int, device) -> Optional[Probes]:
    """The serving probe set for ``estimator`` at batch size B: drawn from a
    generator seeded 0 on ``device`` (None for 'exact')."""
    if estimator == "exact":
        return None
    g = torch.Generator(device=device).manual_seed(0)
    if estimator == "unbias":
        return draw_unbias_probes(B, D, g)
    if estimator == "fixed":
        return draw_fixed_probes(B, D, g)
    raise ValueError(f"unknown log-det estimator {estimator!r}")


def draw_train_probes(x_shape, generator: torch.Generator) -> TrainProbes:
    """The training draws of one residual block, in ``nf_tpu``'s structure:
    the value series' length ``1 + G`` then its normal probe of x's shape,
    then the Neumann series' pair the same way.  The lengths are read to
    the host together (one synchronization)."""
    def probe():   # this rank's rows of the host's draw in a data-parallel step
        return draw_rows(tuple(x_shape), generator)

    u_val = _uniform_tiny(generator)
    v_val = probe()
    u_grad = _uniform_tiny(generator)
    v_grad = probe()
    n_val, n_grad = (TRAIN_N_EXACT + geometric(torch.stack([u_val, u_grad]), P)).tolist()
    return (n_val, v_val), (n_grad, v_grad)


def _dot_per_sample(a, b):
    return (a.reshape(a.shape[0], -1) * b.reshape(b.shape[0], -1)).sum(dim=1)


def logdet_exact(g_fn: Callable, x: torch.Tensor) -> torch.Tensor:
    """Exact log|det(I + dg/dx)| per sample via D VJPs (small D only)."""
    _, vjp = torch.func.vjp(g_fn, x)
    B, D = x.shape[0], x[0].numel()
    eye = torch.eye(D, dtype=x.dtype, device=x.device)
    rows = [vjp(eye[i].reshape(x.shape[1:]).expand_as(x).contiguous())[0].reshape(B, D)
            for i in range(D)]
    jac = torch.stack(rows, dim=1)                                  # (B, D, D)
    return torch.linalg.slogdet(eye + jac)[1]


def logdet_fixed(g_fn: Callable, x: torch.Tensor, v: torch.Tensor,
                 n_power_series: int = 8) -> torch.Tensor:
    """Truncated power series with the Hutchinson probes v (S, *x.shape)
    or (S, B, D)."""
    _, vjp = torch.func.vjp(g_fn, x)
    est = []
    for vs in v:
        vs = vs.reshape(x.shape)
        w, acc = vs, torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for k in range(1, n_power_series + 1):
            w = vjp(w)[0]
            sign = 1.0 if k % 2 == 1 else -1.0
            acc = acc + sign * (_dot_per_sample(w, vs) / k)
        est.append(acc)
    return torch.stack(est).mean(dim=0)


def roulette_coefficient(k: int, p: float, n_exact: int) -> float:
    """sign_k / (k (1-p)^max(0, k - n_exact - 1)): the weight of term k."""
    sign = 1.0 if k % 2 == 1 else -1.0
    return sign / (k * (1.0 - p) ** max(0, k - n_exact - 1))


def logdet_unbias(g_fn: Callable, x: torch.Tensor, v: torch.Tensor,
                  n_terms: Sequence[int], p: float = 0.5, n_exact: int = 1) -> torch.Tensor:
    """Unbiased Russian-roulette series with probes v (S, *x.shape) or
    (S, B, D) and series lengths n_terms (S,); the terms past a probe's
    length count 0, as ``nf_tpu``'s fixed-cap loop masks them."""
    _, vjp = torch.func.vjp(g_fn, x)
    est = []
    for vs, nt in zip(v, [int(n) for n in n_terms]):
        vs = vs.reshape(x.shape)
        w, acc = vs, torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for k in range(1, nt + 1):
            w = vjp(w)[0]
            acc = acc + roulette_coefficient(k, p, n_exact) * _dot_per_sample(w, vs)
        est.append(acc)
    return torch.stack(est).mean(dim=0)


def neumann_coefficient(k: int) -> float:
    """(-1)^k / (1-p)^max(0, k - n_exact - 1) at training's p and n_exact:
    the weight of v J^k in the Neumann probe (no 1/k, unlike the log-det's
    terms)."""
    sign = -1.0 if k % 2 == 1 else 1.0
    return sign / (1.0 - P) ** max(0, k - TRAIN_N_EXACT - 1)


class _MemorySavedResBlock(torch.autograd.Function):
    """(g, logdet) of a residual block with ResFlow's memory-saved gradient.

    forward: g(x), the roulette log-det over (n_val, v_val) and the Neumann
    probe u over (n_grad, v_grad), every J^T product from one local graph
    of g that is dropped on return: only x, u and v_grad are saved.
    backward: the gradient, with respect to x and g's parameters, of
    <g, dL/dg> + sum_b (dL/dlogdet_b u_b) . (J_b v_b), the second term a
    double VJP: <(w u)^T J, v> with (w u)^T J formed under create_graph.
    The log-det cotangent w weights each sample (``nf_tpu``'s per-sample
    form, not the reference's uniform one)."""

    @staticmethod
    def forward(ctx, g_fn, draws, x, *params):
        (n_val, v_val), (n_grad, v_grad) = draws
        v_val = v_val.to(device=x.device, dtype=x.dtype).reshape(x.shape)
        v_grad = v_grad.to(device=x.device, dtype=x.dtype).reshape(x.shape)
        with torch.enable_grad():
            xx = x.detach().requires_grad_()
            g = g_fn(xx)

        def vjp(w):
            return torch.autograd.grad(g, xx, w, retain_graph=True)[0]

        w, logdet = v_val, torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for k in range(1, int(n_val) + 1):
            w = vjp(w)
            logdet = logdet + roulette_coefficient(k, P, TRAIN_N_EXACT) * _dot_per_sample(w, v_val)
        w, u = v_grad, v_grad
        for k in range(1, int(n_grad) + 1):
            w = vjp(w)
            u = u + neumann_coefficient(k) * w
        ctx.g_fn = g_fn
        ctx.params = params
        ctx.save_for_backward(x, u, v_grad)
        return g.detach(), logdet

    @staticmethod
    @once_differentiable
    def backward(ctx, dg, dlogdet):
        x, u, v = ctx.saved_tensors
        params = list(ctx.params)
        wu = dlogdet.reshape((-1,) + (1,) * (u.dim() - 1)) * u
        with torch.enable_grad():
            xx = x.detach().requires_grad_()
            g = ctx.g_fn(xx)
            wu_j = torch.autograd.grad(g, xx, wu, create_graph=True)[0]
            grads = torch.autograd.grad([g, wu_j], [xx] + params, [dg, v], allow_unused=True)
        return (None, None) + tuple(grads)


def iresblock_forward(g_fn: Callable, params: Sequence[torch.Tensor], x: torch.Tensor,
                      draws: TrainProbes):
    """(g, logdet) for f(x) = x + g(x) in training, g = ``g_fn(x)`` a map
    whose parameters are ``params``.  The value is one Russian-roulette
    estimate (n_exact = 1, p = 0.5) over ``draws``' first pair; its
    gradient the Neumann-series estimate over the second, with no series
    graph kept (``_MemorySavedResBlock``)."""
    return _MemorySavedResBlock.apply(g_fn, draws, x, *params)


# --------------------------------------------------------------------- trace
def _value_and_vjp(f_fn: Callable, z: torch.Tensor):
    """f_fn(z) and its VJP w -> w^T df/dz.  Under grad mode the VJPs are
    themselves differentiable (``create_graph``), as a trace that a loss or
    an adjoint differentiates needs; otherwise the value and the VJPs come
    back detached, so a solve of many steps keeps no graph alive."""
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        zz = z if create and z.requires_grad else z.detach().requires_grad_()
        f = f_fn(zz)

    def vjp(w):
        with torch.enable_grad():
            g = torch.autograd.grad(f, zz, w, retain_graph=True, create_graph=create)[0]
        return g if create else g.detach()

    return (f if create else f.detach()), vjp


def trace_exact(f_fn: Callable, z: torch.Tensor):
    """(f_fn(z), exact trace of df/dz) via D VJPs with basis vectors.
    ``f_fn`` maps (B, *dims) -> (B, *dims); the non-batch dims are
    flattened for the basis sweep, so NHWC images work (small D only)."""
    f, vjp = _value_and_vjp(f_fn, z)
    B, D = z.shape[0], z[0].numel()
    acc = torch.zeros(B, dtype=z.dtype, device=z.device)
    for i in range(D):
        e = torch.zeros(B, D, dtype=z.dtype, device=z.device)
        e[:, i] = 1.0
        acc = acc + vjp(e.reshape(z.shape)).reshape(B, D)[:, i]
    return f, acc


def trace_hutchinson(f_fn: Callable, z: torch.Tensor, v: torch.Tensor):
    """(f_fn(z), Hutchinson trace estimate): the mean over the probes
    v (P, *z.shape) of v_i^T (df/dz) v_i per sample."""
    f, vjp = _value_and_vjp(f_fn, z)
    ests = [_dot_per_sample(vjp(vi), vi) for vi in v]
    return f, sum(ests) / len(ests)
