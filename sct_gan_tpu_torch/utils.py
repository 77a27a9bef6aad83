"""Small helpers shared by the port's entry points."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device an entry point runs on. The card is the default; a CUDA
    device without a card raises instead of falling back to the CPU, which
    runs only when the caller asks for it (``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r}: no CUDA card is available; pass "
            f"device='cpu' to run the plain PyTorch versions on the CPU")
    return dev
