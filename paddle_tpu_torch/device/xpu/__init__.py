"""paddle.device.xpu parity: gated, the port has no XPU."""

__all__ = ["synchronize"]


def synchronize(device=None):
    raise RuntimeError("XPU is not available in the PyTorch port")
