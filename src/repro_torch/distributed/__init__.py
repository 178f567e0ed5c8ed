"""Data-parallel LNS training on ``torch.distributed`` with the
deterministic ⊞ gradient reduce (``lns_reduce``) and its model
(``lns_dp``)."""
from .lns_dp import (DPConfig, LNSDataParallelMLP, make_data_mesh,
                     reference_train_step,
                     run_device_count_invariance_check)
from .lns_reduce import (REDUCE_MODES, combine_partials,
                         combine_partials_many,
                         deterministic_boxplus_allreduce,
                         float_psum_allreduce, gather_partials,
                         group_by_arithmetic)

__all__ = ["DPConfig", "LNSDataParallelMLP", "make_data_mesh",
           "reference_train_step",
           "run_device_count_invariance_check",
           "REDUCE_MODES",
           "combine_partials", "combine_partials_many",
           "deterministic_boxplus_allreduce", "float_psum_allreduce",
           "gather_partials", "group_by_arithmetic"]
