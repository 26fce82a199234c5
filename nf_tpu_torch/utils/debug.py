"""Numerical debugging (counterpart of ``nf_tpu/utils/debug.py``).

``run.debug=true`` turns on ``enable_nan_debugging`` in the CLI
(``torch.autograd.set_detect_anomaly``, nf_tpu's ``jax_debug_nans``),
which names the forward op behind a non-finite gradient, and
``check_chain``: every layer of a ``Chain`` (or a bijector that is no
``Chain``, as a whole) has its forward and inverse output and log-det
checked finite after each call, and a non-finite value raises
``FloatingPointError`` naming ``layer{i}:{Class}.forward`` /
``.inverse``, as nf_tpu's ``check_chain`` probes do.  It sets each
layer's ``debug_tag`` (``core/bijector.py``) and wraps nothing, so the
module tree and the checkpoint's structure do not change.

``CheckedBijector`` is nf_tpu's wrapper, for a caller who probes one
bijector of their own: the same checks, as a module around ``inner``.
Its state dict names ``inner.``'s tensors; its variables in ``nf_tpu``'s
tree are the inner bijector's, with no level of their own
(``convert.py``), so a checkpoint of a wrapped chain keeps nf_tpu's
layout.  A served model whose chain holds a probed layer, tagged or
wrapped, runs its eager chain (``models/base.py::EvalProgram``).
"""
from __future__ import annotations

import torch

from ..core.bijector import Bijector, Chain, call_forward, call_inverse, check_finite


def enable_nan_debugging() -> None:
    """Anomaly detection on: a backward that makes a non-finite value
    names the forward op behind it."""
    torch.autograd.set_detect_anomaly(True)


class CheckedBijector(Bijector):
    """``inner`` with its forward and inverse output and log-det checked
    finite after every call (``FloatingPointError`` naming
    ``{tag}.forward`` / ``.inverse``); ``tag`` defaults to ``inner``'s
    class name.  It takes the probes and generators ``inner`` takes."""

    def __init__(self, inner: Bijector, tag: str = ""):
        super().__init__()
        self.inner = inner
        self.tag = tag or type(inner).__name__
        self.takes_probes = inner.takes_probes
        self.takes_generator = inner.takes_generator
        self.inverse_takes_generator = inner.inverse_takes_generator

    def init(self, generator: torch.Generator) -> None:
        self.inner.init(generator)

    def dd_init(self, x, generator=None):
        return self.inner.dd_init(x, generator)

    def forward(self, x, probes=None, generator=None):
        return check_finite(f"{self.tag}.forward",
                            call_forward(self.inner, x, probes, generator))

    def inverse(self, y, generator=None, probes=None):
        return check_finite(f"{self.tag}.inverse",
                            call_inverse(self.inner, y, generator, probes))


def probed(bijector: Bijector) -> bool:
    """Whether a top-level layer of ``bijector`` (its layers, for a
    ``Chain``) is probed: tagged by ``check_chain`` or wrapped in a
    ``CheckedBijector``."""
    layers = bijector.layers if isinstance(bijector, Chain) else [bijector]
    return any(layer.debug_tag is not None or isinstance(layer, CheckedBijector)
               for layer in layers)


def check_chain(bijector: Bijector) -> Bijector:
    """Probe ``bijector``'s layers (in place); returns it."""
    if isinstance(bijector, Chain):
        for i, layer in enumerate(bijector.layers):
            layer.debug_tag = f"layer{i}:{type(layer).__name__}"
    else:
        bijector.debug_tag = type(bijector).__name__
    return bijector
