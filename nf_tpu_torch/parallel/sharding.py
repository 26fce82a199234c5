"""Placement and reduction over the mesh (counterpart of
``nf_tpu/parallel/sharding.py``).

nf_tpu's ``replicate``, ``shard_batch`` and ``shard_train_state`` place
arrays over its mesh and XLA inserts the collectives.  Here every rank is
a process, so:

* ``replicate`` broadcasts rank 0's parameters and buffers to every rank
  (one broadcast per dtype; a bool buffer travels as uint8);
* ``shard_batch`` takes this rank's rows of its host's batch, the
  contiguous block nf_tpu's ``P('data')`` sharding gives a device of that
  host;
* ``sum_gradients`` sums every gradient over the data group in ONE
  all-reduce of a flat buffer (each rank's loss is its share of the
  global mean, so the sum is the one process's gradient).  A parameter
  whose ``.grad`` is None contributes zeros, so every rank reduces the
  same buffer, and keeps its None;
* ``global_mean`` averages a value (the loss) over the data group on the
  device, with no host read.

Ranks hold equal batch shards, so the mean of their means is the global
mean.

Tensor parallelism: ``tp_shardings`` applies nf_tpu's rule to every leaf
of nf_tpu's ``{'params', 'state'}`` tree as nf_tpu shapes it
(``convert.variable_tree``): a leaf with 2 or more dimensions, at least
``min_size`` elements and a last dimension that divides over the model
axis is split along that dimension, every other leaf is replicated.  The
port's axis that holds nf_tpu's last one comes from the same map
(dimension 0 of a Dense ``(out, in)`` weight or an OIHW conv kernel).
``shard_train_state`` keeps this rank's slice of every such tensor in
place (the same ``Parameter``, so the optimizer's moments follow it); a
forward and its backward then run inside ``TensorParallel.gathered``,
which all-gathers each full weight over the model group just before the
step, and whose backward keeps this rank's slice of the full gradient:
every rank of a model group computes the same loss on the same rows, so
no sum is needed.  Activations stay replicated over the model axis, so
``with_model_sharding`` is the identity.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

import torch

from .distributed import all_gather, all_reduce, broadcast
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
        broadcast(flat, 0)
        offset = 0
        for t in tensors:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view(t.shape).to(dtype))
            offset += n
    return module


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of its host's ``batch`` (the leading axis split into
    the host's ``host_data`` equal contiguous blocks)."""
    n = batch.shape[0]
    parts = mesh.host_data
    if n % parts:
        raise ValueError(f"a batch of {n} rows does not split over {parts} ranks")
    b = n // parts
    i = mesh.host_data_index
    return batch[i * b:(i + 1) * b]


@torch.no_grad()
def sum_gradients(params: Iterable[torch.Tensor], mesh: Mesh) -> None:
    """Every ``.grad`` replaced by its sum over the data group."""
    params = list(params)
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    all_reduce(flat, mesh.group)
    offset = 0
    for p in params:
        n = p.numel()
        if p.grad is not None:
            p.grad.copy_(flat[offset:offset + n].view(p.shape))
        offset += n


@torch.no_grad()
def global_mean(value: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean of ``value`` over the data group, on the device."""
    out = value.detach().clone()
    return all_reduce(out, mesh.group) / mesh.data_size


# ------------------------------------------------------- tensor parallelism
def _split_dim(leaf) -> int:
    """The port tensor's axis that holds nf_tpu's last axis of ``leaf``."""
    ndim = leaf.tensors[0].dim()
    return leaf.perm[-1] if leaf.perm is not None else ndim - 1


def _rule(leaf, n_model: int, min_size: int) -> Optional[int]:
    """nf_tpu's ``tp_shardings`` rule on ``leaf`` as nf_tpu shapes it: the
    port's axis to split, or None to replicate."""
    shape = leaf.shape
    size = 1
    for s in shape:
        size *= s
    if len(shape) >= 2 and n_model > 1 and shape[-1] % n_model == 0 and size >= min_size:
        return _split_dim(leaf)
    return None


def tp_shardings(module, mesh: Mesh, min_size: int = 1024) -> Dict[str, Optional[int]]:
    """nf_tpu's tensor-parallel rule over ``module``'s variables: for each
    leaf of nf_tpu's ``{'params', 'state'}`` tree (keyed by
    ``jax.tree_util.keystr`` of its path), the port's axis along which its
    tensors split over the model axis, or None where it is replicated.
    The optimizer's moments follow their parameters."""
    from ..convert import leaves, variable_tree

    return {path: _rule(leaf, mesh.model, min_size)
            for path, leaf in leaves(variable_tree(module))}


class _Gather(torch.autograd.Function):
    """The full tensor from the model group's slices; the backward keeps
    this rank's slice of the full gradient (every rank of the group holds
    the same full gradient)."""

    @staticmethod
    def forward(ctx, shard, dim, index, parts, group):
        ctx.dim, ctx.index, ctx.parts = dim, index, parts
        return all_gather(shard.detach(), dim, group)

    @staticmethod
    def backward(ctx, grad):
        return grad.chunk(ctx.parts, ctx.dim)[ctx.index].contiguous(), None, None, None, None


@dataclass
class _Entry:
    owner: torch.nn.Module
    name: str
    parameter: bool
    dim: int
    tensor: torch.Tensor      # this rank's slice, in place of the full tensor


class TensorParallel:
    """The sharded tensors of a module over ``mesh``'s model group."""

    def __init__(self, mesh: Mesh, entries: List[_Entry]):
        self.mesh = mesh
        self.entries = entries
        self.dims = {id(e.tensor): e.dim for e in entries}

    def gather(self, shard: torch.Tensor, dim: int) -> torch.Tensor:
        """The full tensor of ``shard`` (no gradient)."""
        return all_gather(shard.detach(), dim, self.mesh.model_group)

    def slice_of(self, full: torch.Tensor, dim: int) -> torch.Tensor:
        return full.chunk(self.mesh.model, dim)[self.mesh.model_index]

    @contextlib.contextmanager
    def gathered(self):
        """Within it every sharded tensor reads as the full one: a
        parameter through a gather that carries the gradient back to its
        slice, a buffer as a full copy whose slice is written back after
        (a forward may move it)."""
        m = self.mesh
        swapped = []
        try:
            for e in self.entries:
                if e.parameter:
                    full = _Gather.apply(e.tensor, e.dim, m.model_index, m.model,
                                         m.model_group)
                    e.owner._parameters[e.name] = full
                else:
                    full = self.gather(e.tensor, e.dim)
                    e.owner._buffers[e.name] = full
                swapped.append(e)
            yield
        finally:
            for e in swapped:
                if e.parameter:
                    e.owner._parameters[e.name] = e.tensor
                else:
                    with torch.no_grad():
                        e.tensor.copy_(self.slice_of(e.owner._buffers[e.name], e.dim))
                    e.owner._buffers[e.name] = e.tensor


@torch.no_grad()
def shard_train_state(module, mesh: Mesh, min_size: int = 1024) -> Optional[TensorParallel]:
    """Keep this rank's slice of every tensor ``tp_shardings`` splits, in
    place, and record them on ``module`` (``module.tensor_parallel``);
    returns that record, or None when nothing splits.  Call it before the
    optimizer holds state: its moments then take the slices' shapes."""
    from ..convert import leaves, variable_tree

    split = {}
    for _, leaf in leaves(variable_tree(module)):
        dim = _rule(leaf, mesh.model, min_size)
        if dim is not None:
            for t in leaf.tensors:
                split[id(t)] = dim
    entries = []
    for mod in module.modules():
        for kind, table in ((True, mod._parameters), (False, mod._buffers)):
            for name, t in table.items():
                if t is not None and id(t) in split:
                    dim = split.pop(id(t))
                    t.data = t.data.chunk(mesh.model, dim)[mesh.model_index].clone()
                    entries.append(_Entry(mod, name, kind, dim, t))
    tp = TensorParallel(mesh, entries) if entries else None
    module.tensor_parallel = tp
    return tp


def gathered(module):
    """``module.tensor_parallel.gathered()``, or nothing without one."""
    tp = getattr(module, "tensor_parallel", None)
    return tp.gathered() if tp is not None else contextlib.nullcontext()


def with_model_sharding(x, mesh_axis: str = "model", dim: int = -1):
    """nf_tpu tags an intermediate for sharding along the model axis (and
    calls it nowhere).  Here activations are replicated over the model
    axis and only the weights are split, so this is the identity."""
    return x
