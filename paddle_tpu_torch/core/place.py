"""Places and the current device of the tensor surface.

Port of ``paddle_tpu/core/place.py``. A place is a ``torch.device``:
``CPUPlace()`` is ``torch.device("cpu")`` and ``CUDAPlace(i)`` is
``torch.device("cuda", i)``, so a place goes wherever torch takes a device.

The current place is process-wide, as paddle's is, and defaults to the CUDA
card. ``set_device("gpu")``, ``"gpu:i"`` or ``"cuda:i"`` select a card and
``set_device("cpu")`` the CPU; there is no TPU or XPU here, so those names
raise ``ValueError``. :func:`resolve_device` turns an entry point's
``device`` argument into a ``torch.device``: an explicit device wins,
``None`` means the current place, and a CUDA place on a machine without
CUDA raises ``RuntimeError`` instead of running on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["Place", "CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "TPUPlace",
           "set_device", "get_device", "resolve_device", "device_count",
           "is_compiled_with_cuda", "is_compiled_with_tpu"]

# every place is a torch.device
Place = torch.device

_NO_CUDA = ("paddle_tpu_torch runs on a CUDA device unless the caller passes "
            "device='cpu' (or calls set_device('cpu')), and torch sees no "
            "CUDA device here")


def CPUPlace(index: int = 0) -> torch.device:
    """The host: ``torch.device("cpu")`` (the index is paddle's, unused)."""
    return torch.device("cpu")


def CUDAPlace(index: int = 0) -> torch.device:
    """CUDA card ``index``: ``torch.device("cuda", index)``."""
    return torch.device("cuda", int(index))


def CUDAPinnedPlace() -> torch.device:
    """Paddle's pinned host memory place: host memory, a CPU place."""
    return torch.device("cpu")


def TPUPlace(index: int = 0):
    """Kept for its name: the port runs on CUDA cards and the CPU."""
    raise ValueError("TPUPlace: the PyTorch port has no TPU; use "
                     "CUDAPlace(i) or set_device('gpu')")


def _parse(device) -> torch.device:
    """A paddle device name (``"gpu"``, ``"gpu:1"``, ``"cuda:0"``,
    ``"cpu"``) or a ``torch.device`` as a ``torch.device``."""
    if isinstance(device, torch.device):
        dev = device
    else:
        name = str(device).strip().lower()
        kind, _, idx = name.partition(":")
        if kind in ("tpu", "xpu", "npu", "ipu", "mlu"):
            raise ValueError(f"set_device: no {kind} device in the PyTorch "
                             f"port; use 'gpu', 'gpu:i' or 'cpu'")
        if kind == "gpu":
            kind = "cuda"
        dev = torch.device(kind if not idx else f"{kind}:{int(idx)}")
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.type != "cuda":
        raise ValueError(f"device must be a cuda or cpu device, got {dev}")
    return dev


# None: the CUDA card, checked where it is used
_current = [None]


def set_device(device: Union[str, torch.device]) -> torch.device:
    """paddle.set_device parity: make ``device`` the current place of the
    process and return it."""
    _current[0] = _parse(device)
    return _current[0]


def _current_place() -> torch.device:
    dev = _current[0] if _current[0] is not None else torch.device("cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(_NO_CUDA)
    return dev


def get_device() -> str:
    """paddle.get_device parity: ``"gpu:i"`` or ``"cpu:0"``; raises
    without CUDA unless the place is the CPU."""
    dev = _current_place()
    if dev.type == "cpu":
        return "cpu:0"
    return f"gpu:{dev.index if dev.index is not None else 0}"


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """Resolve an entry point's ``device`` argument: an explicit device
    wins, ``None`` means the current place (the CUDA card unless
    :func:`set_device` said otherwise). Raises when CUDA is asked for and
    none is available."""
    if device is None:
        return _current_place()
    dev = _parse(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(_NO_CUDA)
    return dev


def device_count() -> int:
    """The number of CUDA cards torch sees."""
    return torch.cuda.device_count()


def is_compiled_with_cuda() -> bool:
    """True when this torch was built with CUDA."""
    return torch.backends.cuda.is_built()


def is_compiled_with_tpu() -> bool:
    return False
