"""Process-group start-up and the collectives the trainer counts
(counterpart of ``nf_tpu/parallel/distributed.py``).

One process drives one device.  ``init_distributed`` forms the
``torch.distributed`` group from torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``) or
from an explicit ``init_method`` (``tcp://host:port``, ``file://path``):
NCCL on the card, each process on card ``LOCAL_RANK``; gloo for
``run.platform=cpu``.  Without that environment and without an
``init_method`` it does nothing, so a single process runs as before.

``COLLECTIVES`` counts the collectives this process issued: ``all_reduce``,
``broadcast`` and ``all_gather``, and ``all_reduce_sum``'s (one all-reduce
in its forward, one in its backward).

The host: torchrun's ``LOCAL_WORLD_SIZE`` ranks share one (every rank, when
it is unset), node ``RANK // LOCAL_WORLD_SIZE`` of ``WORLD_SIZE //
LOCAL_WORLD_SIZE``.  The ranks of one host act as nf_tpu's one process on
that host: they draw one data stream and one set of noise.

``global_batch(mesh)`` marks a training step: within it the batch norms
reduce over the mesh's data group, the adaptive ODE solvers agree on their
steps, and the layers that draw noise per sample draw the host's rows and
keep this rank's (``draw_rows``).
"""
from __future__ import annotations

import contextlib
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import platform_device

COLLECTIVES = {"all_reduce": 0, "broadcast": 0, "all_gather": 0}

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(platform: Optional[str] = None, init_method: Optional[str] = None,
                     rank: Optional[int] = None, world_size: Optional[int] = None) -> bool:
    """Form the process group; returns True when one is formed (now or
    before).  ``platform`` is ``run.platform``: None or "cuda" NCCL on the
    card, "cpu" gloo.  ``rank`` and ``world_size`` default to ``RANK`` and
    ``WORLD_SIZE``."""
    if dist.is_initialized():
        return True
    env = os.environ
    if init_method is None and not all(k in env for k in TORCHRUN_ENV):
        return False
    rank = int(env["RANK"]) if rank is None else rank
    world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
    if platform_device(platform) is None:
        if not torch.cuda.is_available():
            raise RuntimeError("run.platform names the card and no CUDA device is "
                               "available; pass run.platform=cpu for a gloo group")
        torch.cuda.set_device(int(env.get("LOCAL_RANK", "0")))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size)
    return True


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_host0() -> bool:
    return rank() == 0


def local_world_size() -> int:
    """The ranks on this rank's host: ``LOCAL_WORLD_SIZE``, or the whole
    world when it is unset."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size()))
    if local < 1 or world_size() % local:
        raise ValueError(f"LOCAL_WORLD_SIZE={local} does not divide the world of "
                         f"{world_size()} ranks")
    return local


def node() -> int:
    """This rank's host, ``RANK // LOCAL_WORLD_SIZE``."""
    return rank() // local_world_size()


def nodes() -> int:
    """The hosts, ``WORLD_SIZE // LOCAL_WORLD_SIZE``."""
    return world_size() // local_world_size()


def barrier() -> None:
    """A sync point across ranks (e.g. before reading a checkpoint)."""
    if world_size() > 1:
        dist.barrier()


def host_seed(seed: int, node_: Optional[int] = None) -> int:
    """``host_key``'s counterpart: the host folded into ``seed``, a
    distinct seed per host (``node()`` by default)."""
    n = node() if node_ is None else node_
    return int(np.random.SeedSequence((seed, n)).generate_state(1)[0])


def all_gather(tensor: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The ranks' tensors of ``group`` concatenated along ``dim``, in rank
    order, counted."""
    COLLECTIVES["all_gather"] += 1
    parts = [torch.empty_like(tensor) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, tensor.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def all_reduce(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """In-place sum over the ranks of ``group``, counted."""
    COLLECTIVES["all_reduce"] += 1
    dist.all_reduce(tensor, group=group)
    return tensor


def broadcast(tensor: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """In-place broadcast from rank ``src``, counted."""
    COLLECTIVES["broadcast"] += 1
    dist.broadcast(tensor, src=src, group=group)
    return tensor


class _AllReduceSum(torch.autograd.Function):
    """y = the sum over the ranks of x, on every rank; the gradient of x is
    the sum over the ranks of the gradient of y, as each rank's loss reads
    y."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(memory_format=torch.contiguous_format), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks, with its gradient: one all-reduce
    forward, one backward."""
    return _AllReduceSum.apply(x, group)


# the mesh of the training step under way (``global_batch``)
_BATCH_MESH = None


@contextlib.contextmanager
def global_batch(mesh):
    """Within it the ranks' batches of ``mesh`` make one batch (nf_tpu's
    batch sharded on its mesh); ``mesh=None`` changes nothing."""
    global _BATCH_MESH
    outer, _BATCH_MESH = _BATCH_MESH, mesh
    try:
        yield
    finally:
        _BATCH_MESH = outer


def batch_mesh():
    """The mesh of ``global_batch``, or None outside one."""
    return _BATCH_MESH


def draw_rows(shape, generator: torch.Generator, axis: int = 0) -> torch.Tensor:
    """Standard normals of ``shape`` on the generator's device, float32:
    within ``global_batch``, this rank's rows (along ``axis``) of one draw
    at the host's batch (``mesh.host_data`` times the rows), so the ranks
    of a host draw what one process draws for the host's batch."""
    mesh = _BATCH_MESH
    if mesh is None or mesh.host_data == 1:
        return torch.randn(tuple(shape), generator=generator, device=generator.device,
                           dtype=torch.float32)
    shape = list(shape)
    n, i = shape[axis], mesh.host_data_index
    shape[axis] = n * mesh.host_data
    v = torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)
    return v.narrow(axis, i * n, n).contiguous()
