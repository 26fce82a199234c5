"""FlowModel and its serving program (counterpart of
``nf_tpu/models/base.py``).

``forward(y) -> (z, logdet)`` is the normalizing direction and
``inverse(z) -> (y, logdet)`` the generative one, both accumulating from
zero; ``log_prob`` and ``sample`` are the density and sampling math under a
standard-normal base.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Tuple

import torch
from torch import nn

from ..bijectors.iresblock import InvertibleResBlock
from ..core.bijector import Bijector, call_forward, call_inverse
from ..ops.cuda.fused_flowpp import (FlowppSpec, PackedFlowpp, extract_flowpp_spec,
                                     fused_flowpp, pack_flowpp)
from ..ops.cuda.fused_resflow import (PackedResFlow, extract_resflow_spec,
                                      fused_resflow, pack_resflow)
from ..ops.cuda.fused_stack import (PackedStack, StackSpec, extract_stack_spec,
                                    fused_stack, pack_stack)
from ..ops.estimators import Probes, eval_probes
from ..ops.math import standard_normal_logprob
from ..utils.debug import probed
from ..utils.tracing import span

# ResFlow serving probe sets an EvalProgram keeps, one per batch size, the
# most recently used; an evicted set is drawn again, the same, when needed
PROBE_SETS_KEPT = 8


def fused_spec(bijector: Bijector, dims):
    """The fused pattern ``bijector`` matches, in ``nf_tpu``'s order (the
    RealNVP / Glow stack, Flow++, ResFlow: ``FlowModel._fused_spec``
    there), or None."""
    for extract in (extract_stack_spec, extract_flowpp_spec, extract_resflow_spec):
        spec = extract(bijector, dims)
        if spec is not None:
            return spec
    return None


def _normal(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Standard-normal draws from ``generator`` on its own device."""
    z = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=torch.float32)
    return z.to(device)


class FlowModel(nn.Module):
    def __init__(self, name: str, bijector: Bijector, dims: Tuple[int, ...],
                 device):
        super().__init__()
        self.name = name
        self.bijector = bijector
        self.dims = tuple(dims)
        self.device = torch.device(device)
        self.eval()

    # ------------------------------------------------------------ variables
    def init(self, generator: torch.Generator) -> dict:
        """Re-draw every parameter from ``generator``; returns the state
        dict (parameters and buffers)."""
        self.bijector.init(generator)
        return self.state_dict()

    @torch.no_grad()
    def data_dependent_init(self, batch: torch.Tensor,
                            generator: Optional[torch.Generator] = None) -> dict:
        """The one-time data-dependent pass (ActNorm's init; every flow and
        conditioner BatchNorm's running statistics move once): the chain's
        ``dd_init`` in train mode over ``batch``, without gradients,
        ``generator`` handed to the layers that draw (default: one seeded 0
        on the model's device, as ``nf_tpu``'s ``rng=None`` becomes
        ``PRNGKey(0)``).  The module's mode is restored after it.  Returns
        the state dict."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        mode = self.training
        self.train()
        try:
            self.bijector.dd_init(batch.to(device=self.device, dtype=torch.float32),
                                  generator)
        finally:
            self.train(mode)
        return self.state_dict()

    def eval_program(self, params: Optional[dict] = None,
                     probes: Optional[Probes] = None) -> "EvalProgram":
        """Build the serving program over fixed parameters: the weights are
        packed once and, for a stack that matches a fused pattern on the
        card, each call is ONE kernel launch (``ops/cuda/fused_stack.py``
        for RealNVP / Glow, ``ops/cuda/fused_flowpp.py`` for Flow++,
        ``ops/cuda/fused_resflow.py`` for ResFlow).  ``params`` is a state
        dict to load first, as ``init`` or ``convert.load_jax_variables``
        return it.  ``probes`` (ResFlow's stochastic log-det estimators
        only: ``ops/estimators.py``'s (V, n_terms)) replaces the serving
        probe set in every call; the batch size must then be V's."""
        if params is not None:
            self.load_state_dict(params)
        return EvalProgram(self, probes)

    # ------------------------------------------------------------- running
    def forward(self, y, generator: Optional[torch.Generator] = None):
        """data -> latent; returns (z, log|det J|).  ``generator`` feeds the
        layers that draw noise (``Trainer`` hands one per step); without it
        each draws its default (MAF nothing, FFJORD a generator seeded 0)
        or raises (variational dequantization)."""
        return call_forward(self.bijector, y, generator=generator)

    def inverse(self, z, generator: Optional[torch.Generator] = None):
        """latent -> data; returns (y, logdet of the inverse map);
        ``generator`` feeds the layers that draw while they sample."""
        return call_inverse(self.bijector, z, generator)

    def log_prob(self, y, generator: Optional[torch.Generator] = None):
        """log p(y) = log N(z) + log|det dz/dy|; returns (B,)."""
        z, logdet = self.forward(y, generator)
        return standard_normal_logprob(z) + logdet

    def sample(self, n: int, generator: torch.Generator):
        """Draw n samples; returns (y, log p(y)).  z is drawn from
        ``generator``, which then feeds the layers that draw (``nf_tpu``'s
        ``Ctx(rng=key)``)."""
        z = _normal(generator, (n,) + self.dims, self.device)
        y, logdet_inv = self.inverse(z, generator)
        return y, standard_normal_logprob(z) - logdet_inv


class EvalProgram:
    """Inference program over FIXED parameters (see FlowModel.eval_program).

    Dispatch in ``nf_tpu``'s order: a stack that matches the fused
    RealNVP / Glow pattern runs through ``fused_stack``, else one that
    matches the Flow++ pattern through ``fused_flowpp``, else one that
    matches the ResFlow pattern through ``fused_resflow`` (each the kernel
    on the card, its plain version on the CPU); any other stack runs the
    eager chain on the model's device, as ``nf_tpu`` runs its jitted chain
    where no fused kernel applies.  ``stack`` holds the packed weights, or
    None for the chain.  Every matched stack has a kernel on the card, at
    any width and dimension (``PackedStack``, ``PackedResFlow``); a matched
    stack never falls back to the chain.

    A program over the chain serves the live module in eval mode: a call
    sets it back to eval mode where training (``Trainer``) left it in train
    mode.  It hands the chain no generator: FFJORD's CNFs draw their probes
    from a generator seeded 0, and variational dequantization raises
    ``ValueError``, as ``nf_tpu``'s program (``rng=None``) does.

    ResFlow: with the 'unbias' estimator both directions are one kernel
    each, the series over the probe set of the call's batch size (drawn
    by ``eval_probes`` and kept for the last ``PROBE_SETS_KEPT`` batch
    sizes, or the ``probes`` given); with any
    other estimator the forward is the chain, and the inverse is the solve
    kernel followed by one chain forward at the solved x, negated, as
    ``nf_tpu`` serves it.  A ResFlow chain that matches no kernel (the
    image branch) runs eagerly, both directions handed the same probe
    sets, of the data's shape.

    Under ``run.debug`` (``utils/debug.py``): a chain with a probed
    top-level layer, tagged by ``check_chain`` or wrapped in a
    ``CheckedBijector``, runs eagerly whatever pattern it matches,
    through ``call_forward`` / ``call_inverse``, so every layer is
    checked: ``nf_tpu``'s probe wrappers hide the layers from its fused
    matchers alike.  ResFlow's blocks get their probe sets as above.

    Under ``utils/tracing.recording()`` a call is a request's root span
    (``EvalProgram.log_prob`` / ``.sample``), with ``EvalProgram.input``
    (the input's move and the eval-mode check), ``.draw`` (the base draw)
    and ``.logp`` (the log-density's epilogue) inside it."""

    def __init__(self, model: FlowModel, probes: Optional[Probes] = None):
        self.model = model.eval()
        self.dims = model.dims
        self.device = model.device
        bij = model.bijector
        self.stack = None
        self.probes = probes
        self._probe_sets = OrderedDict()
        spec = None if probed(bij) else fused_spec(bij, model.dims)
        if isinstance(spec, StackSpec):
            self.stack, run = PackedStack(spec, *pack_stack(bij, spec)), fused_stack
        elif isinstance(spec, FlowppSpec):
            self.stack, run = PackedFlowpp(spec, *pack_flowpp(bij, spec)), fused_flowpp
        if self.stack is not None:
            self._fwd = lambda x: run(self.stack, x, "forward")
            self._inv = lambda z: run(self.stack, z, "inverse")
            return
        if spec is None:
            estimators = {m.estimator for m in bij.modules()
                          if isinstance(m, InvertibleResBlock)}
            if len(estimators) > 1:
                raise ValueError(f"one log-det estimator per program, got {estimators}")
            self.estimator = next(iter(estimators), None)
            self._fwd = lambda x: call_forward(bij, x, self._probes(x))
            self._inv = lambda z: call_inverse(bij, z, probes=self._probes(z))
            return
        self.stack = PackedResFlow(spec, pack_resflow(bij, spec))
        self.estimator = spec.estimator
        if spec.estimator == "unbias":
            self._fwd = lambda x: fused_resflow(self.stack, x, "forward", self._probes(x))
            self._inv = lambda z: fused_resflow(self.stack, z, "inverse", self._probes(z))
        else:
            self._fwd = lambda x: bij(x, self._probes(x))
            self._inv = self._solve_and_replay

    def _probes(self, x) -> Optional[Probes]:
        """The ResFlow estimator's probes for the batch x, of x's shape
        (S, *x.shape): the given set, or the serving set of x's batch size:
        a seeded draw, so one drawn again after its eviction is the same
        set."""
        if self.estimator is None:  # no ResFlow block
            return None
        B = x.shape[0]
        if self.probes is not None:
            if self.probes[0].shape[1] != B:
                raise ValueError(f"the program's probes are for a batch of "
                                 f"{self.probes[0].shape[1]}, got {B}")
            probes = self.probes
        else:
            sets = self._probe_sets
            if B in sets:
                sets.move_to_end(B)
            else:
                sets[B] = eval_probes(self.estimator, B, x[0].numel(), self.device)
                if len(sets) > PROBE_SETS_KEPT:
                    sets.popitem(last=False)
            probes = sets[B]
        if probes is None:          # the 'exact' estimator draws none
            return None
        V, n_terms = probes
        return V.reshape((V.shape[0],) + tuple(x.shape)), n_terms

    def _solve_and_replay(self, z):
        x = fused_resflow(self.stack, z, "solve")
        _, ld = self.model.bijector(x, self._probes(x))
        return x, -ld

    def _input(self, x):
        with span("EvalProgram.input"):
            if self.model.training:
                self.model.eval()
            return x.to(device=self.device, dtype=torch.float32).contiguous()

    @torch.no_grad()
    def forward(self, x):
        """data -> latent; returns (z, logdet)."""
        return self._fwd(self._input(x))

    @torch.no_grad()
    def inverse(self, z):
        """latent -> data; returns (y, logdet of the inverse)."""
        return self._inv(self._input(z))

    def log_prob(self, x):
        """log p(x) under the flow; returns (B,)."""
        with span("EvalProgram.log_prob", request=True), torch.no_grad():
            z, logdet = self.forward(x)
            with span("EvalProgram.logp"):
                return standard_normal_logprob(z) + logdet

    def sample(self, n: int, generator: torch.Generator):
        """Draw n samples; returns (y, log p(y))."""
        with span("EvalProgram.sample", request=True), torch.no_grad():
            with span("EvalProgram.draw"):
                z = _normal(generator, (n,) + self.dims, self.device)
            y, logdet_inv = self.inverse(z)
            with span("EvalProgram.logp"):
                return y, standard_normal_logprob(z) - logdet_inv
