"""The training path of the port (the port of `repro.train`)."""

from .train_step import (TrainState, distribute_train_state,
                         init_train_state, make_train_step)
from .trainer import Trainer, TrainerConfig
