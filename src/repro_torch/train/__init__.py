"""Training substrate: AdamW, the trainer (checkpoints, preemption,
stragglers), checkpointing."""
from . import checkpoint
from .adamw import AdamW, AdamWState, cosine_schedule, global_norm
from .trainer import Trainer, TrainConfig, TrainEvent, make_train_step

__all__ = ["AdamW", "AdamWState", "cosine_schedule", "global_norm",
           "Trainer", "TrainConfig", "TrainEvent", "make_train_step",
           "checkpoint"]
