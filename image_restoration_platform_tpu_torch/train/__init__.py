"""Training of the port: synthetic data, the train step, the entry point."""

from .data import DataConfig, synthetic_batch
from .trainer import Trainer, TrainConfig, make_train_step

__all__ = ["synthetic_batch", "DataConfig", "Trainer", "TrainConfig", "make_train_step"]
