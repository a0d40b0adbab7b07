"""The AMP seam of the ``nn.functional`` ops: the reference casts at its
dispatcher by op name; each op here is wrapped by :func:`amp_op` with the
reference's name, which casts its positional tensor arguments by the
active policy and checks its outputs under ``FLAGS_check_nan_inf``
(``framework.amp_state``). With AMP and the check off, a call costs two
attribute reads. Each such op is also one op of the record point
(``core/dispatch.py``) under the same name: one span for the op hook, one
node of a program being recorded."""
from __future__ import annotations

import functools

from ...core import dispatch
from ...framework.amp_state import amp_state, cast_inputs, check_outputs


def amp_op(op_name: str):
    def wrap(fn):
        @functools.wraps(fn)
        def op(*args, **kwargs):
            if amp_state.enabled:
                args = cast_inputs(op_name, *args)
            out = fn(*args, **kwargs)
            if amp_state.check_nan_inf or amp_state.checker is not None:
                check_outputs(op_name,
                              *(out if isinstance(out, tuple) else (out,)))
            return out
        return dispatch.op(op_name)(op)
    return wrap
