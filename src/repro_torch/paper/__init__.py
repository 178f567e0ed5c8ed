"""The paper's experiments (MLP, Sec. 4-5) on PyTorch."""
from .datasets import PRESETS, load, synthetic, train_val_split
from .mlp import (ALPHA, BACKENDS, HIDDEN, LNSMLP, FloatMLP, FxpMLP,
                  MLPConfig, make_mlp, params_from_numpy, params_to_numpy)
from .training import RunResult, evaluate, run_experiment

__all__ = ["PRESETS", "load", "synthetic", "train_val_split", "ALPHA",
           "BACKENDS", "HIDDEN", "LNSMLP", "FloatMLP", "FxpMLP", "MLPConfig",
           "make_mlp", "params_from_numpy", "params_to_numpy", "RunResult",
           "evaluate", "run_experiment"]
