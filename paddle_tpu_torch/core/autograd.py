"""Gradient-mode switches of the tensor surface.

Port of the user API of ``paddle_tpu/core/autograd.py`` (:43-83). The rest
of that module is the JAX package's eager tape (``GradNode``,
``apply_op``, ``run_backward``); torch's autograd is the port's tape, so
these names are torch's own switches: thread-local, usable as context
managers and as decorators.
"""
from __future__ import annotations

import torch

__all__ = ["no_grad", "enable_grad", "set_grad_enabled", "is_grad_enabled"]

no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled
is_grad_enabled = torch.is_grad_enabled
