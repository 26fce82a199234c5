from .distributed import (COLLECTIVES, barrier, global_batch, host_seed,  # noqa: F401
                          init_distributed, is_host0, local_world_size, node, nodes)
from .mesh import Mesh, make_mesh  # noqa: F401
from .sharding import (TensorParallel, gathered, global_mean, replicate,  # noqa: F401
                       shard_batch, shard_train_state, sum_gradients, tp_shardings,
                       with_model_sharding)
