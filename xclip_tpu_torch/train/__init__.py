"""Training — the counterpart of `xclip_tpu.train`: the train step and its
optimizer, the placement of a state on a mesh (`shard_state`,
`shard_batch`), checkpoints and resume, recovery and metrics logging.
JAX's `TrainState` and `create_train_state` have no counterpart: the
port's state is the model and its optimizer."""

from .checkpoint import restore_checkpoint, save_checkpoint
from .logging import MetricsLogger
from .resilience import CheckpointManager, run_with_recovery, supervise
from .trainer import (AdamW, default_optimizer, make_train_step, shard_batch,
                      shard_state, warmup_cosine_lr)

__all__ = ["AdamW", "default_optimizer", "make_train_step", "shard_batch",
           "shard_state", "warmup_cosine_lr", "restore_checkpoint",
           "save_checkpoint", "MetricsLogger", "CheckpointManager",
           "run_with_recovery", "supervise"]
