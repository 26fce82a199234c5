"""Process-group start-up and the collectives the trainer counts
(counterpart of ``nf_tpu/parallel/distributed.py``).

One process drives one device.  ``init_distributed`` forms the
``torch.distributed`` group from torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``) or
from an explicit ``init_method`` (``tcp://host:port``, ``file://path``):
NCCL on the card, each process on card ``LOCAL_RANK``; gloo for
``run.platform=cpu``.  Without that environment and without an
``init_method`` it does nothing, so a single process runs as before.

``COLLECTIVES`` counts the collectives this process issued: ``all_reduce``
and ``broadcast``, and ``all_reduce_sum``'s (one all-reduce in its
forward, one in its backward).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import platform_device

COLLECTIVES = {"all_reduce": 0, "broadcast": 0}

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


def barrier() -> None:
    """A sync point across ranks (e.g. before reading a checkpoint)."""
    if world_size() > 1:
        dist.barrier()


def host_seed(seed: int, rank_: Optional[int] = None) -> int:
    """``host_key``'s counterpart: the rank folded into ``seed``, a
    distinct seed per rank."""
    r = rank() if rank_ is None else rank_
    return int(np.random.SeedSequence((seed, r)).generate_state(1)[0])


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
