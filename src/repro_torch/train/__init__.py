"""repro_torch.train — optimizer and train step (one device; a mesh's
"pod" axis runs the reference's int8 cross-pod sync, its pods one after
another)."""

from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update, cosine_lr
from repro_torch.train.step import TrainStepConfig, make_train_step

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "cosine_lr",
    "TrainStepConfig",
    "make_train_step",
]
