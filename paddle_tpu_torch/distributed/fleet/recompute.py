"""Activation recomputation (port of
``paddle_tpu/distributed/fleet/recompute/recompute.py::recompute``).

The reference wraps the function in ``jax.checkpoint``; here it is
``torch.utils.checkpoint.checkpoint`` in its non-reentrant form, which
keeps only the function's inputs, reruns it during the backward, and lets
parameters the function closes over (an ``nn.Module``'s) receive their
gradients. The rerun happens in the backward, outside any
``amp.auto_cast`` block the forward ran in, so it runs under the AMP
policy the forward saw (``framework.amp_state.policy_restored``), as JAX's
trace of the checkpointed function does. It also draws from the port's
generator (``core.random.default_generator``) as the forward did: the
generator's state is taken at the forward and set for the rerun, then put
back, so ``F.dropout`` and ``F.flash_attention``'s drawn dropout seed give
the forward's masks again (torch's own checkpoint does this for torch's
global generators only). A model that passes its attention dropout seed
explicitly (``models/llama.py``) draws nothing there.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint

from ...core.random import default_generator
from ...framework.amp_state import policy, policy_restored

__all__ = ["recompute", "amp_contexts"]


def amp_contexts(inner=None):
    """A ``context_fn`` for ``torch.utils.checkpoint``: the recomputation
    runs under the AMP policy of the forward that called it and from the
    port generator's state at that forward (and inside ``inner()``'s
    contexts, e.g. a selective-checkpoint policy's)."""
    fwd, rec = inner() if inner else (contextlib.nullcontext(),
                                      contextlib.nullcontext())
    saved = policy()
    rng = default_generator.get_state()

    @contextlib.contextmanager
    def recompute_ctx():
        now = default_generator.get_state()
        default_generator.set_state(rng)
        try:
            with policy_restored(saved), rec:
                yield
        finally:
            default_generator.set_state(now)

    return fwd, recompute_ctx()


def recompute(function, *args, **kwargs):
    """``function(*args, **kwargs)`` with its activations recomputed in the
    backward instead of kept. While compiling (``jit.to_static``,
    ``torch.compile``) it is the plain non-reentrant checkpoint: the
    compiler records the region once, so its recomputation replays the
    traced ops under the AMP policy the trace saw, and the random draws of
    a compiled program come from the seed it is given, not from the
    generator's state (``core.random.traced_uniform``)."""
    if torch.compiler.is_compiling():
        return checkpoint(function, *args, use_reentrant=False, **kwargs)
    return checkpoint(function, *args, use_reentrant=False,
                      context_fn=amp_contexts, **kwargs)
