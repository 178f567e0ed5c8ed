"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``KERNEL_WRAPPERS`` is the one registry of the kernels' launch counters:
each wrapper adds one to its ``launches`` where it launches its kernel on
a CUDA tensor, and nowhere else.  ``autotune`` chooses the one launch
parameter the kernels read, the tiled ⊞-MAC's rows per block, for
``blocks=auto``.
"""
from . import autotune, lns_boxsum, lns_matmul

KERNEL_WRAPPERS = {**lns_matmul.KERNEL_WRAPPERS,
                   **lns_boxsum.KERNEL_WRAPPERS}


def launch_counts() -> dict:
    """CUDA launches per kernel wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


__all__ = ["KERNEL_WRAPPERS", "autotune", "launch_counts",
           "reset_launch_counts", "lns_boxsum", "lns_matmul"]
