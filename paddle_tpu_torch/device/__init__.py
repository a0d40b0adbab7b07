"""Device policy of the port.

Entry points (the model constructor, the serving engine through its model,
``chip_smoke.py``) run on the CUDA card unless the caller asks for the CPU
with ``device="cpu"``. A machine without CUDA gets an error, never a quiet
CPU run. Kernel wrappers follow their tensors: a CPU tensor takes the plain
PyTorch version, a CUDA tensor launches the kernel or raises.

``device.peaks`` holds the card's peak compute and memory rates, the
roofline the program ledger measures against.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["get_device"]


def get_device(device: Optional[Union[str, torch.device]] = None
               ) -> torch.device:
    """Resolve an entry point's ``device`` argument: ``None`` means the
    CUDA card. Raises when CUDA is asked for (explicitly or by default)
    and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be a cuda or cpu device, got {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device unless the caller "
            "passes device='cpu', and torch sees no CUDA device here")
    return dev
