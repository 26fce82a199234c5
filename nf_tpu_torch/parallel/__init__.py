from .distributed import (COLLECTIVES, barrier, host_seed, init_distributed,  # noqa: F401
                          is_host0)
from .mesh import Mesh, make_mesh  # noqa: F401
from .sharding import average_gradients, global_mean, replicate, shard_batch  # noqa: F401
