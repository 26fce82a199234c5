"""The data-parallel mesh (counterpart of ``nf_tpu/parallel/mesh.py``).

nf_tpu's mesh spreads one process's devices over a ('data', 'model')
grid.  Here one process drives one device, so the mesh is a small handle
on the process group: this process's rank, the world size, its device and
the group.  ``Trainer(mesh=...)`` takes it.  The 'model' axis (tensor
parallelism) is not ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    rank: int
    world: int
    device: torch.device
    group: Optional[Any] = None   # None: the default process group


def make_mesh(group=None) -> Mesh:
    """The mesh over ``group`` (default: the whole process group, which
    ``init_distributed`` forms): the card for NCCL, the CPU for gloo."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_distributed first")
    if dist.get_backend(group) == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    return Mesh(dist.get_rank(group), dist.get_world_size(group), device, group)
