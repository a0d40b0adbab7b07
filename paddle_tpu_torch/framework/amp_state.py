"""Autocast and nan/inf-check state (port of ``paddle_tpu/core/amp_state.py``).

The reference casts at its single eager dispatcher (``apply_op``), by the
op's name: black-list ops to fp32, white-list ops to the AMP dtype and,
under O2, every other op to the AMP dtype too. The port has no dispatcher:
its ops are plain torch calls and ``autograd.Function`` s over kernel
launches, which ``torch.autocast`` does not see. So each op of the port that
the training path enters calls :func:`cast_inputs` with the reference's op
name (``linear``, ``embedding``, ``flash_attention``, ``rms_norm``,
``fused_rope``, ``tied_lm_head``, ``c_softmax_with_cross_entropy``,
``lm_loss_mean`` and the losses' own names) and :func:`check_outputs` on
what it returns. Casts are ``Tensor.to``, so gradients flow back to each
input in its own dtype, as the reference's cast inside the differentiated
function gives them.

Off (the default) each call costs one attribute read of a thread-local:
no mode is pushed, nothing is launched. A check never runs while a CUDA
graph is being captured, so the engines' captured decode programs hold no
check even when ``FLAGS_check_nan_inf`` is on.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional, Set

import torch

from .flags import get_flags

__all__ = ["AmpState", "amp_state", "cast_dtype_for", "cast_inputs",
           "check_outputs", "policy", "policy_restored"]

_FLOATS = (torch.float32, torch.float16, torch.bfloat16)


class AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.level = "O0"            # O0 off / O1 white-list / O2 everything
        self.dtype = torch.bfloat16
        self.white: Set[str] = set()
        self.black: Set[str] = set()
        # nan/inf sentry (FLAGS_check_nan_inf / amp.debugging's checker)
        self.check_nan_inf = bool(
            get_flags("FLAGS_check_nan_inf")["FLAGS_check_nan_inf"])
        self.checker: Optional[Callable] = None   # callable(op_name, outs)


amp_state = AmpState()


def policy():
    """The calling thread's cast policy, to restore later."""
    st = amp_state
    return (st.enabled, st.level, st.dtype, st.white, st.black)


@contextlib.contextmanager
def policy_restored(saved):
    """Run a block under a policy taken by :func:`policy` (``auto_cast``
    sets its own; activation recomputation reruns a forward in the
    backward, outside the ``auto_cast`` block that ran it first), then
    restore the one before."""
    st = amp_state
    prev = policy()
    (st.enabled, st.level, st.dtype, st.white, st.black) = saved
    try:
        yield
    finally:
        (st.enabled, st.level, st.dtype, st.white, st.black) = prev


def cast_dtype_for(op_name: Optional[str]) -> Optional[torch.dtype]:
    """The dtype the active policy casts ``op_name``'s inputs to, or None."""
    st = amp_state
    if not st.enabled or op_name is None:
        return None
    if op_name in st.black:
        return torch.float32
    if st.level == "O2" or op_name in st.white:
        return st.dtype
    return None


def cast_inputs(op_name: str, *tensors):
    """``tensors`` under the active policy: floating tensors of another
    floating dtype cast to the op's dtype, everything else (None, integer
    tensors, numbers) as it is. Returns a tuple."""
    if not amp_state.enabled:
        return tensors
    dt = cast_dtype_for(op_name)
    if dt is None:
        return tensors
    return tuple(t.to(dt) if isinstance(t, torch.Tensor)
                 and t.dtype in _FLOATS and t.dtype != dt else t
                 for t in tensors)


def check_outputs(op_name: str, *outs) -> None:
    """The post-op sentry: hand the floating outputs to the installed
    checker, then, under ``FLAGS_check_nan_inf``, raise on any nan or inf
    (one host read per output)."""
    st = amp_state
    if not (st.check_nan_inf or st.checker is not None):
        return
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        return
    leaves = [o for o in outs if isinstance(o, torch.Tensor)
              and o.is_floating_point()]
    if not leaves:
        return
    if st.checker is not None:
        st.checker(op_name, leaves)
    if st.check_nan_inf:
        for o in leaves:
            bad = int((~torch.isfinite(o.detach())).sum())
            if bad:
                raise RuntimeError(
                    f"Operator {op_name} output contains {bad} Nan/Inf "
                    f"element(s) (FLAGS_check_nan_inf)")
