"""Primitive conditioner layers (counterpart of ``nf_tpu/nets/layers.py``):
dense and NHWC conv with optional weight norm, and standard (non-flow)
batch norm.

Layout: weights are PyTorch's ``(out, in)`` and ``(out, in, kh, kw)``,
where ``nf_tpu`` keeps ``(in, out)`` and ``(kh, kw, in, out)``.  The weight
norm is the same parameterization: ``g`` holds one norm per input feature
(dense, ``(in,)``) or per (input channel, tap) (conv, ``(in, kh, kw)``;
``nf_tpu``'s ``(kh, kw, in)``), the norm taken over the out axis (dim 0
here) and the eps added to the norm, ``w = v * g / (||v|| + 1e-5)``.

``compute_dtype`` (``"bfloat16"``, ``nf_tpu``'s mixed precision): ``Dense``
and ``Conv2d`` form the weight-norm weight in f32, then cast the weight,
the input and the bias to bf16, and take the product and the bias add in
bf16; ``BatchNormNet`` takes its statistics in f32 and returns its input's
dtype.  Master parameters and running statistics stay f32.  In f32 the
products go through ``ops/precision.py`` (``matmul_precision``).
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.bijector import replaying
from ..ops import precision as pm
from ..parallel.distributed import all_reduce_sum
from .core import Net

_WN_EPS = 1.0e-5


def _weight_normed(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """v * g / (||v|| + eps), the norm over the out axis (dim 0)."""
    return v * (g / (torch.linalg.vector_norm(v, dim=0) + _WN_EPS))[None]


def as_dtype(compute_dtype) -> Optional[torch.dtype]:
    """``compute_dtype`` as a torch dtype; None (or float32) for f32."""
    if compute_dtype in (None, "float32", torch.float32):
        return None
    return getattr(torch, compute_dtype) if isinstance(compute_dtype, str) else compute_dtype


def uniform(generator: torch.Generator, shape, bound: float, device) -> torch.Tensor:
    """U(-bound, bound) drawn from ``generator`` on its own device, then
    moved to ``device``."""
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=torch.float32)
    return ((2.0 * u - 1.0) * bound).to(device)


class Dense(Net):
    """y = x @ W.T + b with optional weight-norm parameterization."""

    def __init__(self, in_features: int, out_features: int,
                 weight_norm: bool = True, device=None, compute_dtype=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight_norm = weight_norm
        self.compute_dtype = as_dtype(compute_dtype)
        kw = dict(device=device, dtype=torch.float32)
        if weight_norm:
            self.g = nn.Parameter(torch.ones(in_features, **kw))
            self.v = nn.Parameter(torch.zeros(out_features, in_features, **kw))
        else:
            self.w = nn.Parameter(torch.zeros(out_features, in_features, **kw))
        self.b = nn.Parameter(torch.zeros(out_features, **kw))

    @torch.no_grad()
    def init(self, generator):
        bound = math.sqrt(1.0 / self.in_features)
        dev = self.b.device
        w = uniform(generator, (self.out_features, self.in_features), bound, dev)
        self.b.copy_(uniform(generator, (self.out_features,), bound, dev))
        if self.weight_norm:
            g = torch.linalg.vector_norm(w, dim=0)
            self.g.copy_(g)
            self.v.copy_(w / (g[None, :] + _WN_EPS))
        else:
            self.w.copy_(w)

    def weight(self) -> torch.Tensor:
        """The effective (out, in) weight."""
        return _weight_normed(self.v, self.g) if self.weight_norm else self.w

    def forward(self, x):
        d = self.compute_dtype
        if d is None:
            return pm.linear(x, self.weight(), self.b)
        return F.linear(x.to(d), self.weight().to(d)) + self.b.to(d)


class Conv2d(Net):
    """NHWC conv, 'SAME' padding, stride 1, with optional weight norm.

    The input is seen as NCHW through a permute (a channels-last view,
    no copy in PyTorch) and the output permuted back to NHWC.  The f32
    kernel cuDNN picks on an H100 is an NCHW one, so cuDNN converts the
    layout around it (PERF.md)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 weight_norm: bool = True, device=None, compute_dtype=None):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = kernel_size
        self.weight_norm = weight_norm
        self.compute_dtype = as_dtype(compute_dtype)
        k = kernel_size
        kw = dict(device=device, dtype=torch.float32)
        if weight_norm:
            self.g = nn.Parameter(torch.ones(in_channels, k, k, **kw))
            self.v = nn.Parameter(torch.zeros(out_channels, in_channels, k, k, **kw))
        else:
            self.w = nn.Parameter(torch.zeros(out_channels, in_channels, k, k, **kw))
        self.b = nn.Parameter(torch.zeros(out_channels, **kw))

    @torch.no_grad()
    def init(self, generator):
        """Kaiming-uniform with fan_in = in * k * k, as ``nf_tpu``."""
        k = self.kernel_size
        bound = math.sqrt(1.0 / (self.in_channels * k * k))
        dev = self.b.device
        w = uniform(generator, (self.out_channels, self.in_channels, k, k), bound, dev)
        self.b.copy_(uniform(generator, (self.out_channels,), bound, dev))
        if self.weight_norm:
            g = torch.linalg.vector_norm(w, dim=0)
            self.g.copy_(g)
            self.v.copy_(w / (g[None] + _WN_EPS))
        else:
            self.w.copy_(w)

    def weight(self) -> torch.Tensor:
        """The effective (out, in, kh, kw) weight."""
        return _weight_normed(self.v, self.g) if self.weight_norm else self.w

    def forward(self, x):
        d = self.compute_dtype
        if d is None:
            y = pm.conv2d(x.permute(0, 3, 1, 2), self.weight(), self.b, padding="same")
            return y.permute(0, 2, 3, 1)
        y = F.conv2d(x.to(d).permute(0, 3, 1, 2), self.weight().to(d), padding="same")
        return y.permute(0, 2, 3, 1) + self.b.to(d)


class BatchNormNet(Net):
    """Standard batch norm over all-but-channel axes (channel last).

    Statistics are taken in f32 whatever the input's dtype, and the output
    has the input's.  Training normalizes by the batch mean and the BIASED batch variance
    and moves the running statistics by ``momentum`` toward them
    (detached), as ``nf_tpu`` does; ``F.batch_norm`` would move
    ``running_var`` toward the unbiased variance.  Under a mesh
    (``global_batch``) both are the statistics of all ranks' batches, the
    variance biased over the global count, as ``nf_tpu``'s over a sharded
    batch.  Eval normalizes by the running statistics.  Both use
    ``rsqrt(var + eps)``."""

    def __init__(self, num_features: int, momentum: float = 0.1,
                 eps: float = 1.0e-5, device=None):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.eps = eps
        kw = dict(device=device, dtype=torch.float32)
        self.gamma = nn.Parameter(torch.ones(num_features, **kw))
        self.beta = nn.Parameter(torch.zeros(num_features, **kw))
        self.register_buffer("running_mean", torch.zeros(num_features, **kw))
        self.register_buffer("running_var", torch.ones(num_features, **kw))

    @torch.no_grad()
    def init(self, generator):
        self.gamma.fill_(1.0)
        self.beta.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x):
        xf = x.to(torch.float32)
        if self.training:
            mean, var, centered = batch_moments(xf)
            update_running(self, mean, var)
        else:
            var, centered = self.running_var, xf - self.running_mean
        y = centered * torch.rsqrt(var + self.eps)
        return (y * self.gamma + self.beta).to(x.dtype)


# the mesh whose ranks' batches make one batch, while a Trainer steps
_GLOBAL_BATCH = None


@contextlib.contextmanager
def global_batch(mesh):
    """Within it, ``batch_moments`` takes its statistics over the batches
    of all of ``mesh``'s ranks (nf_tpu's mean over a batch sharded on its
    mesh); ``mesh=None`` changes nothing."""
    global _GLOBAL_BATCH
    outer, _GLOBAL_BATCH = _GLOBAL_BATCH, mesh
    try:
        yield
    finally:
        _GLOBAL_BATCH = outer


def batch_moments(x: torch.Tensor):
    """Per-channel (last axis) mean and biased variance over all other
    axes, and x - mean (computed once: autograd keeps one copy of it).

    Within ``global_batch(mesh)``, over every rank's batch: the local
    mean is summed over the ranks by an all-reduce that carries the
    gradient and divided by the world size (the ranks' batches are of one
    size), then the local mean of the squared deviations from that global
    mean the same way: two all-reduces forward and two backward, so the
    gradient flows through the statistics as in one process over the
    whole batch, and one rank computes bit for bit what one process does
    without a mesh."""
    axes = tuple(range(x.dim() - 1))
    mesh = _GLOBAL_BATCH
    if mesh is None:
        mean = x.mean(dim=axes)
        centered = x - mean
        return mean, (centered * centered).mean(dim=axes), centered
    mean = all_reduce_sum(x.mean(dim=axes), mesh.group) / mesh.world
    centered = x - mean
    var = all_reduce_sum((centered * centered).mean(dim=axes), mesh.group) / mesh.world
    return mean, var, centered


@torch.no_grad()
def update_running(module, mean: torch.Tensor, var: torch.Tensor) -> None:
    """running <- (1 - momentum) * running + momentum * batch, in place;
    nothing while a rematerialized forward is recomputed."""
    if replaying():
        return
    m = module.momentum
    module.running_mean.copy_((1 - m) * module.running_mean + m * mean)
    module.running_var.copy_((1 - m) * module.running_var + m * var)
