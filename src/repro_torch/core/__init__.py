"""Log-domain (LNS) arithmetic on PyTorch tensors, and the linear
fixed-point baseline (``linear_fixed``)."""
from . import f32
from .activations import (beta_code, llrelu, llrelu_grad,
                          llrelu_grad_from_sign)
from .arithmetic import (bias_add, boxabs_max, boxdiv, boxdot, boxminus,
                         boxneg, boxplus, boxsum, boxsum_partials,
                         lns_affine, lns_matmul, matmul_dhist)
from .conversions import code_to_lns, lns_value_to_code
from .delta import (DELTA_BITSHIFT, DELTA_DEFAULT, DELTA_EXACT, DELTA_SOFTMAX,
                    DeltaEngine, DeltaSpec, cached_engine, delta_minus_float,
                    delta_plus_float)
from .formats import (FORMATS, FXP12, FXP16, LNS12, LNS16, LNS21,
                      FixedPointFormat, LNSFormat, required_log_width)
from .initializers import (encode_init, he_sigma, linear_normal_init,
                           log_density_normal, log_normal_init)
from .lns import (LNSArray, LNSMatmulBackend, convert_format, decode, encode,
                  from_parts, quantization_bound, scalar, zeros)
from .plan import NumericsPlan, PlanRule, get_plan, plan_diff
from .sgd import (LogSGDConfig, UpdateEpilogue, apply_update,
                  apply_update_codes, init_momentum)
from .softmax import ce_grad_init, ce_loss_readout, log_softmax_lns
from .spec import (ALIASES, BLOCK_MODES, INTERPRET_MODES, METRICS_MODES,
                   REDUCE_MODES, REDUCE_SCHEDULES, LNSRuntime, NumericsSpec,
                   ReduceSpec, parse_blocks, resolve_blocks_arg,
                   resolve_kernel_args)
