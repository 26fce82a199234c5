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

``Chain(remat=True)`` and ``ScannedChain(remat=True)`` rematerialize
(``nf_tpu``'s ``jax.checkpoint``): each layer's, or each block's, forward
runs under ``torch.utils.checkpoint`` when grad is enabled, its
activations recomputed in the backward pass.  ``nf_tpu``'s checkpoint is
functional and throws the recomputed state away; here the recompute runs
under ``replaying()``, which the layers that move buffers in a forward
(batch-norm statistics, spectral-norm power iterations, ResFlow's
stateful pass) read to leave them as the first pass left them, and the
generator handed in is set back to its state before the first pass, so
the recompute draws the same noise and leaves the generator where the
forward left it.  Inverse and ``dd_init`` are never rematerialized.

Debug probes (``utils/debug.py::check_chain``, ``run.debug``): a layer
whose ``debug_tag`` is set has its output and log-det checked finite by
``call_forward`` / ``call_inverse`` after every call, and a non-finite
value raises ``FloatingPointError`` naming ``{debug_tag}.forward`` or
``.inverse``.  The tag is a plain attribute: the module tree, the state
dict and the checkpoint's structure stay as they are.
"""
from __future__ import annotations

import itertools
from typing import Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

# > 0 while a rematerialized forward is recomputed in the backward pass
_REPLAYS = 0


def replaying() -> bool:
    """True while a rematerialized forward is recomputed: a layer then
    leaves its buffers as the first pass left them."""
    return _REPLAYS > 0


def rematerialized(fn, x: torch.Tensor, generator: Optional[torch.Generator] = None):
    """``fn(x)`` under ``torch.utils.checkpoint`` (non-reentrant).  Its
    recompute runs under ``replaying()`` with ``generator`` set back to
    the state it had before the first pass, then to the state the
    recompute found, so it draws what the first pass drew and moves no
    buffer and no generator.  Without grad it is ``fn(x)``."""
    if not torch.is_grad_enabled():
        return fn(x)
    before = generator.get_state() if generator is not None else None
    passes = []

    def run(x):
        passes.append(None)
        if len(passes) == 1:
            return fn(x)
        global _REPLAYS
        after = generator.get_state() if generator is not None else None
        if generator is not None:
            generator.set_state(before)
        _REPLAYS += 1
        try:
            return fn(x)
        finally:
            _REPLAYS -= 1
            if generator is not None:
                generator.set_state(after)

    return checkpoint(run, x, use_reentrant=False)


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
    debug_tag: Optional[str] = None

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


def check_finite(tag: str, out):
    """``out`` = (x, logdet), or raise ``FloatingPointError`` naming
    ``tag`` when either holds a non-finite value."""
    bad_x = not bool(torch.isfinite(out[0]).all())
    bad_ld = not bool(torch.isfinite(out[1]).all())
    if bad_x or bad_ld:
        raise FloatingPointError(f"non-finite output in {tag}: tensor_bad={bad_x} "
                                 f"logdet_bad={bad_ld}")
    return out


def call_forward(layer: Bijector, x: torch.Tensor, probes=None,
                 generator: Optional[torch.Generator] = None):
    """``layer(x)`` with the probes and the generator it takes (probed
    when the layer has a ``debug_tag``)."""
    kw = {}
    if layer.takes_probes:
        kw["probes"] = probes
    if layer.takes_generator:
        kw["generator"] = generator
    if layer.debug_tag is not None:
        return check_finite(f"{layer.debug_tag}.forward", layer(x, **kw))
    return layer(x, **kw)


def call_inverse(layer: Bijector, y: torch.Tensor,
                 generator: Optional[torch.Generator] = None, probes=None):
    """``layer.inverse(y)`` with the probes and the generator it takes
    (probed when the layer has a ``debug_tag``)."""
    kw = {}
    if layer.takes_probes:
        kw["probes"] = probes
    if layer.inverse_takes_generator:
        kw["generator"] = generator
    if layer.debug_tag is not None:
        return check_finite(f"{layer.debug_tag}.inverse", layer.inverse(y, **kw))
    return layer.inverse(y, **kw)


class _Sequence(Bijector):
    """What ``Chain`` and ``ScannedChain`` share: ``parts`` run in order
    (forward, ``dd_init``) or reversed (inverse), per-part logdets summed
    starting from zeros; the ``probes`` of either direction go to every
    part that takes them (one probe set for every block: ResFlow's serving
    semantics), and the ``generator`` (both directions, and ``dd_init``)
    to every part that takes one, each drawing from it in turn.
    ``remat=True`` rematerializes each part's forward."""

    takes_probes = True
    takes_generator = True
    inverse_takes_generator = True

    def forward(self, x, probes=None, generator=None):
        logdet = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
        for part in self.parts:
            if self.remat:
                x, ld = rematerialized(
                    lambda x, part=part: call_forward(part, x, probes, generator), x, generator)
            else:
                x, ld = call_forward(part, x, probes, generator)
            logdet = logdet + ld
        return x, logdet

    def inverse(self, y, generator=None, probes=None):
        logdet = torch.zeros(y.shape[0], dtype=torch.float32, device=y.device)
        for part in reversed(self.parts):
            y, ld = call_inverse(part, y, generator, probes)
            logdet = logdet + ld
        return y, logdet

    def dd_init(self, x, generator=None):
        for part in self.parts:
            x = part.dd_init(x, generator)
        return x


class Chain(_Sequence):
    """Sequential composition of ``layers`` (``_Sequence``); ``remat=True``
    rematerializes each layer's forward (``rematerialized``)."""

    def __init__(self, layers: Sequence[Bijector], remat: bool = False):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.remat = remat

    @property
    def parts(self):
        return self.layers


def _static_desc(obj):
    """What makes two modules interchangeable in a ``ScannedChain``: their
    classes, plain attributes, parameter and buffer shapes and dtypes
    (not their values) and children, recursively (``nf_tpu``'s
    ``_static_desc``, whose scan traces block 0 alone)."""
    if isinstance(obj, nn.Module):
        attrs = tuple(sorted((k, _static_desc(v)) for k, v in vars(obj).items()
                             if not k.startswith("_") and k != "training"))
        tensors = tuple((n, tuple(t.shape), str(t.dtype)) for n, t in
                        itertools.chain(obj.named_parameters(recurse=False),
                                        obj.named_buffers(recurse=False)))
        children = tuple((n, _static_desc(m)) for n, m in obj.named_children())
        return type(obj).__name__, attrs, tensors, children
    if isinstance(obj, torch.Tensor):
        return "tensor", tuple(obj.shape), str(obj.dtype)
    if isinstance(obj, (int, float, bool, str, bytes, type(None), torch.dtype,
                        torch.device)):
        return obj
    if isinstance(obj, (tuple, list)):
        return tuple(_static_desc(o) for o in obj)
    if isinstance(obj, dict):
        return tuple(sorted((k, _static_desc(v)) for k, v in obj.items()))
    if callable(obj):
        return getattr(obj, "__qualname__", type(obj).__name__)
    return type(obj).__name__


class ScannedChain(_Sequence):
    """``nf_tpu``'s ``ScannedChain``: blocks of one static configuration
    run in order (forward, ``dd_init``) or reversed (inverse).  Each block
    stays a module of its own; ``nf_tpu``'s stacking of their variables on
    a leading block axis happens only at the variable boundary
    (``convert``).  ``remat=True`` rematerializes each block's forward as
    a whole.  It is no ``Chain``: the fused-stack matchers, which read a
    ``Chain``'s layers, do not look inside it, as in ``nf_tpu``."""

    def __init__(self, blocks: Sequence[Bijector], remat: bool = False):
        super().__init__()
        if not blocks:
            raise ValueError("ScannedChain needs at least one block")
        ref = _static_desc(blocks[0])
        for i, b in enumerate(blocks[1:], 1):
            if _static_desc(b) != ref:
                raise ValueError(
                    f"ScannedChain blocks must share static configuration "
                    f"(the scan traces only block 0), but block {i} differs "
                    f"from block 0. For alternating-parity couplings, pair "
                    f"layers so each block covers one full period (e.g. "
                    f"[norm, coupling(even), norm, coupling(odd)]).")
        self.blocks = nn.ModuleList(blocks)
        self.remat = remat

    @property
    def parts(self):
        return self.blocks


def scan_repeated(layers: Sequence[Bijector], period: int,
                  remat: bool = False) -> Bijector:
    """``nf_tpu``'s ``scan_repeated``: fold ``layers``, whose structure
    repeats every ``period`` layers, into a ``ScannedChain`` of
    ``Chain`` blocks, with a plain tail ``Chain([scanned] + tail)`` for a
    remainder; fewer than two full blocks give ``Chain(layers, remat)``."""
    n_blocks = len(layers) // period
    if n_blocks < 2:
        return Chain(layers, remat=remat)
    blocks = [Chain(layers[i * period:(i + 1) * period]) for i in range(n_blocks)]
    scanned = ScannedChain(blocks, remat=remat)
    tail = list(layers[n_blocks * period:])
    if tail:
        return Chain([scanned] + tail, remat=False)
    return scanned


class Inverted(Bijector):
    """Swap forward and inverse of a wrapped bijector."""

    def __init__(self, inner: Bijector):
        super().__init__()
        self.inner = inner

    def forward(self, x):
        return self.inner.inverse(x)

    def inverse(self, y):
        return self.inner(y)
