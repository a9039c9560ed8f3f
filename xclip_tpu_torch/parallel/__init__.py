"""Data parallelism over `torch.distributed` — the counterpart of the
collectives the JAX package's loss runs under `axis_name`
(`parallel/collectives.py`). The train step's gradient all-reduce and
`shard_batch` are in `train/trainer.py`."""

from .collectives import (all_gather, all_reduce_sum_, axis_index, axis_size,
                          pmean, psum, replicated)

__all__ = ["all_gather", "all_reduce_sum_", "axis_index", "axis_size",
           "pmean", "psum", "replicated"]
