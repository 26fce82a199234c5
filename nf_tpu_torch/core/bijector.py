"""Core bijector protocol (counterpart of ``nf_tpu/core/bijector.py``).

In ``nf_tpu`` a bijector holds static configuration and its variables live
in an explicit ``{'params', 'state'}`` pytree.  Here a bijector is an
``nn.Module`` that owns its parameters and buffers; ``forward(x)`` maps data
to latent and returns ``(y, logdet (B,))``, ``inverse(y)`` is the generative
direction and returns the log-det of the inverse map, so summing the
returned values along a chain always gives the log-det of the composite map
that was applied.  ``init(generator)`` re-draws the parameters in place
from an explicit ``torch.Generator``.  ``nf_tpu``'s ``Ctx.train`` is the
module's ``training`` flag; ``dd_init(x)`` is the one-time data-dependent
pass, run by ``FlowModel.data_dependent_init`` in train mode.

``nf_tpu``'s ``Ctx.rng`` is a ``torch.Generator`` handed to ``forward``
where a layer draws noise (``takes_generator``: MAF's ``resample_masks``,
FFJORD's Hutchinson probes, variational dequantization) and to ``inverse``
where a layer draws noise while it samples (``inverse_takes_generator``:
FFJORD), and ResFlow's log-det probes a ``probes`` argument of both
directions (``takes_probes``); ``call_forward`` / ``call_inverse`` hand
each layer what it takes.  ``dd_init`` takes the data-dependent init's
generator.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn


def init_children(module: nn.Module, generator: torch.Generator) -> None:
    """Initialize every child that knows how to, in registration order."""
    for child in module.children():
        init = getattr(child, "init", None)
        if init is not None:
            init(generator)
        else:
            init_children(child, generator)


class Bijector(nn.Module):
    """Base class: subclasses implement ``forward`` and ``inverse``.
    ``takes_probes``: ``forward`` and ``inverse`` take ResFlow's log-det
    probes (``ops/estimators.py``'s (V, n_terms)) as ``probes``;
    ``takes_generator``: ``forward`` takes the training step's
    ``torch.Generator`` as ``generator`` (None: the layer's own default);
    ``inverse_takes_generator``: ``inverse`` takes one too."""

    takes_probes = False
    takes_generator = False
    inverse_takes_generator = False

    def init(self, generator: torch.Generator) -> None:
        """Re-draw this bijector's parameters in place."""
        init_children(self, generator)

    def forward(self, x: torch.Tensor):
        """data -> latent. Returns ``(y, logdet)``."""
        raise NotImplementedError

    def inverse(self, y: torch.Tensor):
        """latent -> data. Returns ``(x, logdet)``."""
        raise NotImplementedError

    def dd_init(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Data-dependent initialization; returns the forward-transformed
        batch for the layers after it.  Default: a forward in the module's
        mode (train mode under ``data_dependent_init``, so buffers such as
        running statistics move once), handed ``generator`` if it takes
        one, that keeps the parameters."""
        return call_forward(self, x, generator=generator)[0]


def call_forward(layer: Bijector, x: torch.Tensor, probes=None,
                 generator: Optional[torch.Generator] = None):
    """``layer(x)`` with the probes and the generator it takes."""
    kw = {}
    if layer.takes_probes:
        kw["probes"] = probes
    if layer.takes_generator:
        kw["generator"] = generator
    return layer(x, **kw)


def call_inverse(layer: Bijector, y: torch.Tensor,
                 generator: Optional[torch.Generator] = None, probes=None):
    """``layer.inverse(y)`` with the probes and the generator it takes."""
    kw = {}
    if layer.takes_probes:
        kw["probes"] = probes
    if layer.inverse_takes_generator:
        kw["generator"] = generator
    return layer.inverse(y, **kw)


class Chain(Bijector):
    """Sequential composition: forward in order, inverse reversed, per-layer
    logdets summed starting from zeros.  The ``probes`` of either
    direction go to every layer that takes them (one probe set for every
    block: ResFlow's serving semantics), and the ``generator`` (both
    directions, and ``dd_init``) to every layer that takes one, each
    drawing from it in turn."""

    takes_probes = True
    takes_generator = True
    inverse_takes_generator = True

    def __init__(self, layers: Sequence[Bijector]):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x, probes=None, generator=None):
        logdet = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
        for layer in self.layers:
            x, ld = call_forward(layer, x, probes, generator)
            logdet = logdet + ld
        return x, logdet

    def inverse(self, y, generator=None, probes=None):
        logdet = torch.zeros(y.shape[0], dtype=torch.float32, device=y.device)
        for layer in reversed(self.layers):
            y, ld = call_inverse(layer, y, generator, probes)
            logdet = logdet + ld
        return y, logdet

    def dd_init(self, x, generator=None):
        for layer in self.layers:
            x = layer.dd_init(x, generator)
        return x


class Inverted(Bijector):
    """Swap forward and inverse of a wrapped bijector."""

    def __init__(self, inner: Bijector):
        super().__init__()
        self.inner = inner

    def forward(self, x):
        return self.inner.inverse(x)

    def inverse(self, y):
        return self.inner(y)
