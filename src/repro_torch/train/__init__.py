"""repro_torch.train — optimizer and train step (one device; the sharded
and int8 cross-pod paths of ``repro.train`` come with the substrate
slice)."""

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
