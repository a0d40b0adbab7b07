"""Device policy of the port and paddle's ``paddle.device`` API.

Entry points (the model constructor, the serving engine through its model,
the tensor surface's creation ops, ``chip_smoke.py``) run on the CUDA card
unless the caller asks for the CPU, with ``device="cpu"`` or with
``set_device("cpu")``. A machine without CUDA gets an error, never a quiet
CPU run. Kernel wrappers follow their tensors: a CPU tensor takes the plain
PyTorch version, a CUDA tensor launches the kernel or raises.

:func:`resolve_device` resolves an entry point's ``device`` argument;
:func:`get_device` and :func:`set_device` have paddle's meaning (port of
``paddle_tpu/device/__init__.py`` over ``torch.cuda``). ``device.peaks``
holds the card's peak compute and memory rates, the roofline the program
ledger measures against.
"""
from __future__ import annotations

import torch

from ..core.place import (CPUPlace, CUDAPinnedPlace, CUDAPlace, TPUPlace,
                          device_count, get_device, is_compiled_with_cuda,
                          is_compiled_with_tpu, resolve_device, set_device)
from . import cuda, peaks, xpu
from .cuda import Event, Stream, current_stream, stream_guard

__all__ = ["get_device", "set_device", "get_all_device_type", "peaks",
           "get_all_custom_device_type", "get_available_device",
           "get_available_custom_device", "is_compiled_with_cuda",
           "is_compiled_with_tpu", "is_compiled_with_xpu",
           "is_compiled_with_cinn", "is_compiled_with_rocm", "cuda", "xpu",
           "synchronize", "XPUPlace", "IPUPlace", "Stream", "Event",
           "current_stream", "stream_guard", "set_stream",
           "get_cudnn_version"]


def get_cudnn_version():
    """cuDNN's version number, or None where torch has no cuDNN."""
    return torch.backends.cudnn.version()


def set_stream(stream=None):
    """Make ``stream`` the current CUDA stream; returns it."""
    stream = stream or current_stream()
    torch.cuda.set_stream(stream)
    return stream


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_cinn() -> bool:
    """True, as the reference's answer to "is the optional tensor-compiler
    path built in": ``jit.to_static`` compiles through ``torch.compile``
    (inductor), which plays CINN's role, as XLA does in the JAX
    package."""
    return True


def is_compiled_with_rocm() -> bool:
    return torch.version.hip is not None


def is_compiled_with_ipu() -> bool:
    return False


def get_all_device_type():
    return ["cpu"] + (["gpu"] if torch.cuda.is_available() else [])


def get_all_custom_device_type():
    return []


def get_available_device():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return ["cpu"] + [f"gpu:{i}" for i in range(n)]


def get_available_custom_device():
    return []


def synchronize(device=None):
    """Block until the queued work of ``device`` (default: the current
    place) finishes; the CPU's work is done when its ops return."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class XPUPlace:
    def __init__(self, dev_id=0):
        raise RuntimeError("XPU is not available in the PyTorch port")


class IPUPlace:
    def __init__(self, dev_id=0):
        raise RuntimeError("IPU is not available in the PyTorch port")
