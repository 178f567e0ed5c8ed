"""The row-wise sequential ⊞-reduce kernel, its plain version and oracle."""
from .lns_boxsum import (boxsum_cuda, boxsum_many_cuda, boxsum_plain,
                         lns_boxsum, lns_boxsum_many)
from .ops import dp_combine_blocks, lns_boxsum_kernel
from .ref import lns_boxsum_ref

#: The kernel wrappers of this package (see ``repro_torch.kernels``).
KERNEL_WRAPPERS = {"lns_boxsum": lns_boxsum}

__all__ = ["KERNEL_WRAPPERS", "boxsum_cuda", "boxsum_many_cuda",
           "dp_combine_blocks",
           "boxsum_plain", "lns_boxsum", "lns_boxsum_kernel",
           "lns_boxsum_many", "lns_boxsum_ref"]
