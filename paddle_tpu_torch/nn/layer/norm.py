"""RMSNorm layer (port of ``paddle_tpu/nn/layer/norm.py::RMSNorm``).

It always goes through K1 (``ops.fused_kernels.rms_norm``): the Triton
kernel on the card, its plain version on the CPU. Both follow the TPU
kernel's math (fp32 throughout, one cast at the end), not the reference
layer's off-TPU branch, which casts ``rsqrt`` to the input dtype before the
multiply.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops.fused_kernels import rms_norm

__all__ = ["RMSNorm"]


class RMSNorm(nn.Module):
    def __init__(self, hidden_size: int, epsilon: float = 1e-6, *,
                 device=None, dtype=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = nn.Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self._epsilon)

    def extra_repr(self) -> str:
        return f"{self.weight.shape[0]}, epsilon={self._epsilon}"
