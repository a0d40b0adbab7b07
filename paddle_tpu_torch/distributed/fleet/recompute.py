"""Activation recomputation (port of
``paddle_tpu/distributed/fleet/recompute/recompute.py::recompute``).

The reference wraps the function in ``jax.checkpoint``; here it is
``torch.utils.checkpoint.checkpoint`` in its non-reentrant form, which
keeps only the function's inputs, reruns it during the backward, and lets
parameters the function closes over (an ``nn.Module``'s) receive their
gradients. Dropout replays exactly without any RNG state: the port's
attention dropout is a hash of an explicit seed argument, so the rerun
draws the same mask by construction. The rerun happens in the backward,
outside any ``amp.auto_cast`` block the forward ran in, so it runs under
the AMP policy the forward saw (``framework.amp_state.policy_restored``),
as JAX's trace of the checkpointed function does.
"""
from __future__ import annotations

import contextlib

from torch.utils.checkpoint import checkpoint

from ...framework.amp_state import policy, policy_restored

__all__ = ["recompute", "amp_contexts"]


def amp_contexts(inner=None):
    """A ``context_fn`` for ``torch.utils.checkpoint``: the recomputation
    runs under the AMP policy of the forward that called it (and inside
    ``inner()``'s contexts, e.g. a selective-checkpoint policy's)."""
    fwd, rec = inner() if inner else (contextlib.nullcontext(),
                                      contextlib.nullcontext())
    saved = policy()

    @contextlib.contextmanager
    def recompute_ctx():
        with policy_restored(saved), rec:
            yield

    return fwd, recompute_ctx()


def recompute(function, *args, **kwargs):
    """``function(*args, **kwargs)`` with its activations recomputed in the
    backward instead of kept."""
    return checkpoint(function, *args, use_reentrant=False,
                      context_fn=amp_contexts, **kwargs)
