"""Log-domain (LNS) arithmetic on PyTorch tensors."""
from . import f32
from .activations import beta_code, llrelu, llrelu_grad_from_sign
from .arithmetic import (bias_add, boxabs_max, boxdot, boxminus, boxneg,
                         boxplus, boxsum, boxsum_partials, lns_matmul)
from .conversions import lns_value_to_code
from .delta import (DELTA_BITSHIFT, DELTA_DEFAULT, DELTA_EXACT, DELTA_SOFTMAX,
                    DeltaEngine, DeltaSpec, cached_engine)
from .formats import FORMATS, LNS12, LNS16, LNS21, LNSFormat
from .initializers import he_sigma, log_density_normal, log_normal_init
from .lns import (LNSArray, LNSMatmulBackend, convert_format, decode, encode,
                  scalar, zeros)
from .plan import NumericsPlan, PlanRule
from .sgd import (LogSGDConfig, UpdateEpilogue, apply_update,
                  apply_update_codes, init_momentum)
from .softmax import ce_grad_init, ce_loss_readout, log_softmax_lns
from .spec import ALIASES, NumericsSpec, ReduceSpec
