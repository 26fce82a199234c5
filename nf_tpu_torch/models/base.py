"""FlowModel and its serving program (counterpart of
``nf_tpu/models/base.py``).

``forward(y) -> (z, logdet)`` is the normalizing direction and
``inverse(z) -> (y, logdet)`` the generative one, both accumulating from
zero; ``log_prob`` and ``sample`` are the density and sampling math under a
standard-normal base.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..core.bijector import Bijector
from ..ops.cuda.fused_flowpp import (PackedFlowpp, extract_flowpp_spec,
                                     fused_flowpp, pack_flowpp)
from ..ops.cuda.fused_stack import (PackedStack, extract_stack_spec,
                                    fused_stack, pack_stack)
from ..ops.math import standard_normal_logprob


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

    def eval_program(self, params: Optional[dict] = None) -> "EvalProgram":
        """Build the serving program over fixed parameters: the weights are
        packed once and, for a stack that matches a fused pattern on the
        card, each call is ONE kernel launch (``ops/cuda/fused_stack.py``
        for RealNVP / Glow, ``ops/cuda/fused_flowpp.py`` for Flow++).
        ``params`` is a state dict to load first, as ``init`` or
        ``convert.load_jax_variables`` return it."""
        if params is not None:
            self.load_state_dict(params)
        return EvalProgram(self)

    # ------------------------------------------------------------- running
    def forward(self, y):
        """data -> latent; returns (z, log|det J|)."""
        return self.bijector(y)

    def inverse(self, z):
        """latent -> data; returns (y, logdet of the inverse map)."""
        return self.bijector.inverse(z)

    def log_prob(self, y):
        """log p(y) = log N(z) + log|det dz/dy|; returns (B,)."""
        z, logdet = self.forward(y)
        return standard_normal_logprob(z) + logdet

    def sample(self, n: int, generator: torch.Generator):
        """Draw n samples; returns (y, log p(y))."""
        z = _normal(generator, (n,) + self.dims, self.device)
        y, logdet_inv = self.inverse(z)
        return y, standard_normal_logprob(z) - logdet_inv


class EvalProgram:
    """Inference program over FIXED parameters (see FlowModel.eval_program).

    Dispatch in ``nf_tpu``'s order: a stack that matches the fused
    RealNVP / Glow pattern runs through ``fused_stack``, else one that
    matches the Flow++ pattern through ``fused_flowpp`` (each the kernel on
    the card, its plain version on the CPU); any other stack runs the eager
    chain on the model's device, as ``nf_tpu`` runs its jitted chain where
    no fused kernel applies.  ``stack`` holds the packed weights, or None
    for the chain."""

    def __init__(self, model: FlowModel):
        self.model = model.eval()
        self.dims = model.dims
        self.device = model.device
        bij = model.bijector
        self.stack = None
        spec = extract_stack_spec(bij, model.dims)
        if spec is not None:
            self.stack, run = PackedStack(spec, *pack_stack(bij, spec)), fused_stack
        else:
            spec = extract_flowpp_spec(bij, model.dims)
            if spec is not None:
                self.stack, run = PackedFlowpp(spec, *pack_flowpp(bij, spec)), fused_flowpp
        if self.stack is not None:
            self._fwd = lambda x: run(self.stack, x, "forward")
            self._inv = lambda z: run(self.stack, z, "inverse")
        else:
            self._fwd = bij
            self._inv = bij.inverse

    def _input(self, x):
        return x.to(device=self.device, dtype=torch.float32).contiguous()

    @torch.no_grad()
    def forward(self, x):
        """data -> latent; returns (z, logdet)."""
        return self._fwd(self._input(x))

    @torch.no_grad()
    def inverse(self, z):
        """latent -> data; returns (y, logdet of the inverse)."""
        return self._inv(self._input(z))

    @torch.no_grad()
    def log_prob(self, x):
        """log p(x) under the flow; returns (B,)."""
        z, logdet = self.forward(x)
        return standard_normal_logprob(z) + logdet

    @torch.no_grad()
    def sample(self, n: int, generator: torch.Generator):
        """Draw n samples; returns (y, log p(y))."""
        z = _normal(generator, (n,) + self.dims, self.device)
        y, logdet_inv = self.inverse(z)
        return y, standard_normal_logprob(z) - logdet_inv
