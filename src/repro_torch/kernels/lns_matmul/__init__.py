from .lns_matmul import (FwdEpilogue, lns_matmul_dw_update, lns_matmul_dx,
                         lns_matmul_fused, mac_cuda, mac_plain)
from .ops import (lns_fused_update_kernel, lns_matmul_dw_update_kernel,
                  lns_matmul_dx_kernel, lns_matmul_fused_kernel)
from .ref import (lns_matmul_dw_update_ref, lns_matmul_dx_ref,
                  lns_matmul_fused_ref)
from .update import lns_fused_update, update_cuda, update_plain

#: The kernel wrappers whose ``launches`` count the CUDA launches.
KERNEL_WRAPPERS = {
    "lns_matmul_fused": lns_matmul_fused,
    "lns_matmul_dx": lns_matmul_dx,
    "lns_matmul_dw_update": lns_matmul_dw_update,
    "lns_fused_update": lns_fused_update,
}


def launch_counts() -> dict:
    """CUDA launches per kernel wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


__all__ = ["FwdEpilogue", "KERNEL_WRAPPERS", "launch_counts",
           "reset_launch_counts",
           "lns_matmul_fused", "lns_matmul_dx", "lns_matmul_dw_update",
           "lns_fused_update", "mac_plain", "mac_cuda", "update_plain",
           "update_cuda",
           "lns_matmul_fused_kernel", "lns_matmul_dx_kernel",
           "lns_matmul_dw_update_kernel", "lns_fused_update_kernel",
           "lns_matmul_fused_ref", "lns_matmul_dx_ref",
           "lns_matmul_dw_update_ref"]
