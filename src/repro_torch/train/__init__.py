"""The training path of the port (the port of `repro.train`)."""

from .train_step import TrainState, make_train_step, init_train_state
from .trainer import Trainer, TrainerConfig
