"""Numerical debugging (counterpart of ``nf_tpu/utils/debug.py``).

``run.debug=true`` turns on ``torch.autograd.set_detect_anomaly`` in the
CLI (nf_tpu's ``jax_debug_nans``), which names the forward op behind a
non-finite gradient, and ``check_chain``: every layer of a ``Chain`` (or
a bijector that is no ``Chain``, as a whole) has its forward and inverse
output and log-det checked finite after each call, and a non-finite value
raises ``FloatingPointError`` naming ``layer{i}:{Class}.forward`` /
``.inverse``, as nf_tpu's ``check_chain`` probes do.  It sets each
layer's ``debug_tag`` (``core/bijector.py``) and wraps nothing, so the
module tree and the checkpoint's structure do not change.
"""
from __future__ import annotations

from ..core.bijector import Bijector, Chain


def check_chain(bijector: Bijector) -> Bijector:
    """Probe ``bijector``'s layers (in place); returns it."""
    if isinstance(bijector, Chain):
        for i, layer in enumerate(bijector.layers):
            layer.debug_tag = f"layer{i}:{type(layer).__name__}"
    else:
        bijector.debug_tag = type(bijector).__name__
    return bijector
