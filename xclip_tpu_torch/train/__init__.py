"""Training — the counterpart of `xclip_tpu.train` (the train step and its
optimizer; checkpoints are ROADMAP.md Queue 1, checkpoints)."""

from .trainer import (AdamW, default_optimizer, make_train_step,
                      warmup_cosine_lr)

__all__ = ["AdamW", "default_optimizer", "make_train_step",
           "warmup_cosine_lr"]
