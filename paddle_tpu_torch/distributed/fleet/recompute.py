"""Activation recomputation (port of
``paddle_tpu/distributed/fleet/recompute/recompute.py::recompute``).

The reference wraps the function in ``jax.checkpoint``; here it is
``torch.utils.checkpoint.checkpoint`` in its non-reentrant form, which
keeps only the function's inputs, reruns it during the backward, and lets
parameters the function closes over (an ``nn.Module``'s) receive their
gradients. Dropout replays exactly without any RNG state: the port's
attention dropout is a hash of an explicit seed argument, so the rerun
draws the same mask by construction.
"""
from __future__ import annotations

from torch.utils.checkpoint import checkpoint

__all__ = ["recompute"]


def recompute(function, *args, **kwargs):
    """``function(*args, **kwargs)`` with its activations recomputed in the
    backward instead of kept."""
    return checkpoint(function, *args, use_reentrant=False, **kwargs)
