"""The device rule of the port's entry points: ``"cuda"`` by default,
which needs a card; ``"cpu"`` runs the kernels' plain versions."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for a card that is not
    there and for any other device type."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} needs a CUDA card and none is "
            f"available; pass device='cpu' for the plain PyTorch lane")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device
