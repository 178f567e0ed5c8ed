"""Training loop substrate: step factory, state, config."""
from .step import (TrainConfig, init_train_state, make_train_step,
                   resolve_numerics, train_state_specs)

__all__ = ["TrainConfig", "init_train_state", "make_train_step",
           "resolve_numerics", "train_state_specs"]
