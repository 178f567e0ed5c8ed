"""Optimizers (plain functions over the parameter tree) and the log-int8
gradient compression."""
from .compression import (compress_int8_log, decompress_int8_log,
                          fake_compress_roundtrip)
from .optimizers import (AdamWConfig, OptimizerConfig, SGDConfig, adamw_init,
                         adamw_update, adamw_update_, make_optimizer,
                         sgd_init, sgd_update, sgd_update_)

__all__ = ["AdamWConfig", "OptimizerConfig", "SGDConfig", "adamw_init",
           "adamw_update", "adamw_update_", "make_optimizer", "sgd_init",
           "sgd_update", "sgd_update_",
           "compress_int8_log", "decompress_int8_log",
           "fake_compress_roundtrip"]
