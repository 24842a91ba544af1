"""Training: optimizers, the train step and checkpoints.

Port of ``src/repro/train``: ``optim.py`` (AdamW with fp32 or int8
moments, SGD, the cosine schedule), ``step.py`` (``build_train_step``) and
``checkpoint.py`` (``CheckpointManager``, the reference's on-disk format).
"""
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optim import adamw, sgd
from repro_torch.train.step import build_train_step

__all__ = ["adamw", "sgd", "build_train_step", "CheckpointManager"]
