"""The device an entry point runs on: the card unless the caller asks for
another. Asking for CUDA where there is none raises; nothing falls back to
the CPU."""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}; have cuda and cpu")
    if dev.type == "cuda" and dev.index is None:
        # the index tensors report, so that devices compare equal
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def on_cuda(t: torch.Tensor) -> bool:
    """Whether ``t`` takes a CUDA kernel (True) or a plain version (False)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}; have cpu and cuda")
