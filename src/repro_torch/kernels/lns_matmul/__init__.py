"""The ⊞-MAC and ⊞-SGD kernels, their plain PyTorch versions and oracles."""
from .lns_matmul import (FwdEpilogue, lns_matmul, lns_matmul_dw,
                         lns_matmul_dw_partials, lns_matmul_dw_update,
                         lns_matmul_dx, lns_matmul_fused, mac_cuda, mac_plain)
from .ops import (lns_fused_update_kernel, lns_matmul_dw_kernel,
                  lns_matmul_dw_partials_kernel, lns_matmul_dw_update_kernel,
                  lns_matmul_dx_kernel, lns_matmul_fused_kernel,
                  lns_matmul_kernel, lns_matmul_trainable)
from .ref import (lns_matmul_dw_partials_ref, lns_matmul_dw_ref,
                  lns_matmul_dw_update_ref, lns_matmul_dx_ref,
                  lns_matmul_fused_ref, lns_matmul_ref)
from .update import lns_fused_update, update_cuda, update_plain

#: The kernel wrappers of this package; ``repro_torch.kernels`` holds the
#: registry of every kernel's launch counter.
KERNEL_WRAPPERS = {
    "lns_matmul_fused": lns_matmul_fused,
    "lns_matmul_dx": lns_matmul_dx,
    "lns_matmul_dw_update": lns_matmul_dw_update,
    "lns_fused_update": lns_fused_update,
    "lns_matmul": lns_matmul,
    "lns_matmul_dw": lns_matmul_dw,
    "lns_matmul_dw_partials": lns_matmul_dw_partials,
}

__all__ = ["FwdEpilogue", "KERNEL_WRAPPERS",
           "lns_matmul", "lns_matmul_fused", "lns_matmul_dx",
           "lns_matmul_dw", "lns_matmul_dw_partials", "lns_matmul_dw_update",
           "lns_fused_update", "mac_plain", "mac_cuda", "update_plain",
           "update_cuda",
           "lns_matmul_kernel", "lns_matmul_fused_kernel",
           "lns_matmul_dx_kernel", "lns_matmul_dw_kernel",
           "lns_matmul_dw_partials_kernel", "lns_matmul_dw_update_kernel",
           "lns_fused_update_kernel", "lns_matmul_trainable",
           "lns_matmul_ref", "lns_matmul_fused_ref", "lns_matmul_dx_ref",
           "lns_matmul_dw_ref", "lns_matmul_dw_partials_ref",
           "lns_matmul_dw_update_ref"]
