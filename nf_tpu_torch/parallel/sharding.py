"""Data-parallel placement and reduction (counterpart of
``nf_tpu/parallel/sharding.py``).

nf_tpu's ``replicate`` and ``shard_batch`` place arrays over its mesh and
XLA inserts the gradient all-reduce.  Here every rank holds the whole
model, so:

* ``replicate`` broadcasts rank 0's parameters and buffers to every rank
  (one broadcast per dtype; a bool buffer travels as uint8);
* ``shard_batch`` takes this rank's rows of a global batch, the
  contiguous block nf_tpu's ``P('data')`` sharding gives a device;
* ``average_gradients`` sums every gradient over the ranks in ONE
  all-reduce of a flat buffer and divides by the world size; a parameter
  whose ``.grad`` is None contributes zeros, so every rank reduces the
  same buffer, and keeps its None;
* ``global_mean`` averages a value (the loss) over the ranks on the
  device, with no host read.

Ranks hold equal batch shards, so the mean of their means is the global
mean.  ``tp_shardings`` (tensor parallelism) is not ported.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Iterable

import torch

from .distributed import all_reduce, broadcast
from .mesh import Mesh


@torch.no_grad()
def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Make every rank's parameters and buffers rank 0's, in place."""
    groups = defaultdict(list)
    for t in list(module.parameters()) + list(module.buffers()):
        groups[t.dtype].append(t)
    for dtype, tensors in groups.items():
        wire = torch.uint8 if dtype == torch.bool else dtype
        flat = torch.cat([t.detach().reshape(-1).to(wire) for t in tensors])
        broadcast(flat, 0, mesh.group)
        offset = 0
        for t in tensors:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view(t.shape).to(dtype))
            offset += n
    return module


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of ``batch`` (its leading axis split into ``world``
    equal contiguous blocks)."""
    n = batch.shape[0]
    if n % mesh.world:
        raise ValueError(f"a batch of {n} rows does not split over {mesh.world} ranks")
    b = n // mesh.world
    return batch[mesh.rank * b:(mesh.rank + 1) * b]


@torch.no_grad()
def average_gradients(params: Iterable[torch.Tensor], mesh: Mesh) -> None:
    """Every ``.grad`` replaced by its mean over the ranks."""
    params = list(params)
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    all_reduce(flat, mesh.group)
    flat /= mesh.world
    offset = 0
    for p in params:
        n = p.numel()
        if p.grad is not None:
            p.grad.copy_(flat[offset:offset + n].view(p.shape))
        offset += n


@torch.no_grad()
def global_mean(value: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean of ``value`` over the ranks, on the device."""
    out = value.detach().clone()
    return all_reduce(out, mesh.group) / mesh.world
