"""The ('data', 'model') mesh (counterpart of ``nf_tpu/parallel/mesh.py``).

nf_tpu's mesh spreads one process's devices over a ('data', 'model')
grid, ``np.array(devices).reshape(n // m, m)``.  Here one process drives
one device, and ranks take the devices' places: rank r is data index
``r // m`` and model index ``r % m``.  The ``Mesh`` is a handle on the
process group: this rank, the world, its device, the data group (the
ranks of its model index, over which gradients and batch statistics are
reduced) and the model group (the ranks of its data index, over which a
tensor-parallel leaf is split, ``parallel/sharding.py``), and the host
(``LOCAL_WORLD_SIZE`` ranks a host).  ``Trainer(mesh=...)`` takes it.

The ranks of one host act as nf_tpu's one process on it: they draw the
host's data stream and one set of noise, seeded from the host
(``Trainer.step_seed``), and each keeps its rows of the host's batch
(``shard_batch``, ``distributed.draw_rows``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

from .distributed import local_world_size


@dataclass(frozen=True)
class Mesh:
    rank: int
    world: int
    device: torch.device
    group: Optional[Any] = None        # the data group; None: the whole process group
    model: int = 1                     # ranks on the model axis
    model_group: Optional[Any] = None  # None: this rank alone (model == 1)
    local_world: Optional[int] = None  # ranks a host; None: every rank on one host

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def data_size(self) -> int:
        return self.world // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def _local(self) -> int:
        return self.world if self.local_world is None else self.local_world

    @property
    def node(self) -> int:
        """This rank's host."""
        return self.rank // self._local

    @property
    def nodes(self) -> int:
        return self.world // self._local

    @property
    def host_data(self) -> int:
        """Data indices on this host: the shards of the host's batch."""
        return self._local // self.model

    @property
    def host_data_index(self) -> int:
        """This rank's shard of the host's batch."""
        return (self.rank % self._local) // self.model


def make_mesh(model_axis: int = 1) -> Mesh:
    """The mesh over the whole process group (which ``init_distributed``
    forms), ``model_axis`` ranks on the model axis: the card for NCCL, the
    CPU for gloo.  Every rank makes every data and model group, in one
    order.  Raises ``ValueError`` when the world does not split into
    ``model_axis`` columns, or a host into whole model groups."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_distributed first")
    rank, world = dist.get_rank(), dist.get_world_size()
    local = local_world_size()
    if model_axis < 1 or world % model_axis:
        raise ValueError(f"{world} ranks not divisible by model_axis={model_axis}")
    if local % model_axis:
        raise ValueError(f"{local} ranks a host not divisible by model_axis={model_axis}")
    if dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    data_group = model_group = None
    if model_axis > 1:
        grid = [[d * model_axis + m for m in range(model_axis)]
                for d in range(world // model_axis)]
        for m in range(model_axis):
            g = dist.new_group([row[m] for row in grid])
            if rank % model_axis == m:
                data_group = g
        for row in grid:
            g = dist.new_group(row)
            if rank in row:
                model_group = g
    return Mesh(rank, world, device, data_group, model_axis, model_group,
                None if local == world else local)
