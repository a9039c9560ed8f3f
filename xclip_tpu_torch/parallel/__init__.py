"""The distributed layer — the counterpart of `xclip_tpu.parallel`: the
mesh of ranks, the placements and the tensor-parallel sharding rules,
with JAX's names and meanings (`replicated` is the placement whole on
every rank). The collectives of the data-parallel loss and of the
tensor-parallel layers are in `parallel.collectives`; the train step's
gradient all-reduce, `shard_batch` and `shard_state` in `train/trainer.py`.
"""

from .mesh import create_mesh, data_sharding, replicated
from .sharding import (opt_state_shardings, param_shardings, param_spec,
                       shard_params)

__all__ = ["create_mesh", "data_sharding", "replicated", "opt_state_shardings",
           "param_shardings", "param_spec", "shard_params"]
