"""paddle.device.cuda over ``torch.cuda`` (port of
``paddle_tpu/device/cuda/__init__.py``): streams, events, synchronization,
the caching allocator's counters and the device properties. ``device``
arguments take paddle's names (``"gpu:0"``), an index or a
``torch.device``."""
from __future__ import annotations

import torch

__all__ = ["Stream", "Event", "current_stream", "synchronize",
           "device_count", "empty_cache", "max_memory_allocated",
           "max_memory_reserved", "memory_allocated", "memory_reserved",
           "stream_guard", "get_device_properties", "get_device_name",
           "get_device_capability"]

Stream = torch.cuda.Stream
Event = torch.cuda.Event
# paddle.device.cuda.stream_guard(stream): run the block on ``stream``
stream_guard = torch.cuda.stream


def _dev(device):
    if device is None or isinstance(device, int):
        return device
    from ...core.place import _parse

    return _parse(device)


def device_count() -> int:
    return torch.cuda.device_count()


def current_stream(device=None) -> torch.cuda.Stream:
    return torch.cuda.current_stream(_dev(device))


def synchronize(device=None):
    torch.cuda.synchronize(_dev(device))


def empty_cache():
    torch.cuda.empty_cache()


def memory_allocated(device=None) -> int:
    return torch.cuda.memory_allocated(_dev(device))


def max_memory_allocated(device=None) -> int:
    return torch.cuda.max_memory_allocated(_dev(device))


def memory_reserved(device=None) -> int:
    return torch.cuda.memory_reserved(_dev(device))


def max_memory_reserved(device=None) -> int:
    return torch.cuda.max_memory_reserved(_dev(device))


def get_device_name(device=None) -> str:
    return torch.cuda.get_device_name(_dev(device))


def get_device_capability(device=None):
    return torch.cuda.get_device_capability(_dev(device))


def get_device_properties(device=None):
    return torch.cuda.get_device_properties(_dev(device))
