"""Training — the counterpart of `xclip_tpu.train`: the train step and its
optimizer, checkpoints and resume, recovery and metrics logging."""

from .checkpoint import restore_checkpoint, save_checkpoint
from .logging import MetricsLogger
from .resilience import CheckpointManager, run_with_recovery, supervise
from .trainer import (AdamW, default_optimizer, make_train_step,
                      warmup_cosine_lr)

__all__ = ["AdamW", "default_optimizer", "make_train_step",
           "warmup_cosine_lr", "restore_checkpoint", "save_checkpoint",
           "MetricsLogger", "CheckpointManager", "run_with_recovery",
           "supervise"]
