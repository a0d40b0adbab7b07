"""Static-graph AMP (port of ``paddle_tpu/static/amp.py``; reference
python/paddle/static/amp: decorator.py ``decorate``, fp16_lists
``CustomOpLists`` / ``AutoMixedPrecisionLists``, fp16_utils ``fp16_guard``
/ ``cast_model_to_fp16`` / ``cast_parameters_to_fp16``).

The reference rewrites the static program with cast ops; here the same
rewrite runs over the recorded Program: each node of a white-listed op
(the matmul class, plus the custom white list, less the custom black
list) casts its floating inputs to the low dtype and its floating outputs
back to fp32, the JAX package's AMP pass (``distributed/passes``
``AMPPass``). bf16 is the default low precision; the decorated optimizer
keeps the reference's scaler-shaped surface with scale 1.
"""
from __future__ import annotations

import contextlib
from typing import Iterable, Optional

import torch
from torch.utils import _pytree as pytree

__all__ = ["decorate", "CustomOpLists", "AutoMixedPrecisionLists",
           "fp16_guard", "bf16_guard", "cast_model_to_fp16",
           "cast_model_to_bf16", "cast_parameters_to_fp16",
           "cast_parameters_to_bf16"]

# the ops the pass casts by default (the JAX package's _MATMUL_OPS)
_MATMUL_OPS = ("matmul", "linear", "mul", "conv2d")
_FLOATS = (torch.float16, torch.bfloat16, torch.float32, torch.float64)


class AutoMixedPrecisionLists:
    """Op allow/deny lists (reference fp16_lists.AutoMixedPrecisionLists):
    white ops run in low precision, black ops stay fp32."""

    def __init__(self, custom_white_list: Optional[Iterable[str]] = None,
                 custom_black_list: Optional[Iterable[str]] = None,
                 custom_black_varnames=None, dtype: str = "float16"):
        from ..amp.amp_lists import black_list, white_list

        self.white_list = set(white_list(dtype)) | {
            str(n).lower() for n in (custom_white_list or ())}
        self.black_list = (set(black_list(dtype)) | {
            str(n).lower() for n in (custom_black_list or ())})
        self.white_list -= self.black_list
        self.dtype = dtype


CustomOpLists = AutoMixedPrecisionLists


_in_guard = [False]


@contextlib.contextmanager
def fp16_guard():
    """Marks a region whose ops are amp-eligible (reference
    fp16_utils.fp16_guard). Recording captures ops either way; the guard is
    kept for script parity."""
    _in_guard[0] = True
    try:
        yield
    finally:
        _in_guard[0] = False


bf16_guard = fp16_guard


def _low(dtype: str) -> torch.dtype:
    return torch.bfloat16 if dtype in ("bfloat16", "bf16") \
        else torch.float16


def _cast_fn(fn, dt):
    def cast_fn(*flat):
        lo = [x.to(dt) if isinstance(x, torch.Tensor)
              and x.dtype in _FLOATS else x for x in flat]
        return pytree.tree_map(
            lambda o: o.to(torch.float32) if isinstance(o, torch.Tensor)
            and o.dtype in _FLOATS else o, fn(*lo))

    return cast_fn


def _cast_program(program, dtype: str, amp_lists=None):
    from .program import StaticNode

    dt = _low(dtype)
    white = set(_MATMUL_OPS)
    if amp_lists is not None:
        white |= {str(n).lower() for n in amp_lists.white_list}
        # a black-listed op is not cast even if it is in the default
        # matmul set: the user marked it numerically unsafe
        white -= {str(n).lower() for n in amp_lists.black_list}
    nodes = []
    for node in program.nodes:
        if (node.name or "").lower() not in white:
            nodes.append(node)
            continue
        nodes.append(StaticNode(fn=_cast_fn(node.fn, dt), in_ids=node.in_ids,
                                const_args=node.const_args,
                                out_ids=node.out_ids, name=node.name))
    out = program.clone()
    out.nodes = nodes
    return out


def cast_model_to_fp16(program, amp_lists=None, use_fp16_guard: bool = True,
                       dest_type=None):
    """Rewrite the program's white-list ops to fp16 compute (reference
    fp16_utils.cast_model_to_fp16); returns the transformed program."""
    return _cast_program(program, "float16", amp_lists)


def cast_model_to_bf16(program, amp_lists=None, use_bf16_guard: bool = True):
    return _cast_program(program, "bfloat16", amp_lists)


def cast_parameters_to_fp16(place=None, program=None, scope=None,
                            to_fp16_var_names=None):
    """Cast the stored params to fp16 (reference fp16_utils): the scope's
    tensors and the parameter objects change dtype in place."""
    _cast_params(program, scope, torch.float16, to_fp16_var_names)


def cast_parameters_to_bf16(place=None, program=None, scope=None,
                            to_bf16_var_names=None):
    _cast_params(program, scope, torch.bfloat16, to_bf16_var_names)


def _cast_params(program, scope, dt, names):
    from .program import default_main_program, global_scope

    program = program or default_main_program()
    scope = scope or global_scope()
    targets = set(names) if names else None
    for name in program.param_vars:
        if targets is not None and name not in targets:
            continue
        for t in (scope.var(name), program.param_objs.get(name)):
            if isinstance(t, torch.Tensor) and t.dtype in _FLOATS:
                t.data = t.data.to(dt)


class _DecoratedOptimizer:
    """Optimizer wrapper (reference decorator.OptimizerWithMixedPrecision):
    minimize() casts the program through the AMP pass first; the scaler
    surface is identity (bf16 needs no loss scaling)."""

    def __init__(self, optimizer, amp_lists=None, level="O1",
                 dtype="bfloat16", init_loss_scaling=1.0, **kw):
        self._opt = optimizer
        self._amp_lists = amp_lists
        self._dtype = dtype
        self._level = level
        self.program = None   # the casted program minimize() produced

    def __getattr__(self, item):
        return getattr(self._opt, item)

    def get_loss_scaling(self):
        return 1.0

    def amp_init(self, place=None, scope=None, test_program=None,
                 use_fp16_test=False):
        # only pure (O2) fp16 casts the stored params; O1 keeps fp32
        # masters (reference decorator amp_init)
        if self._level == "O2" and self._dtype in ("float16", "fp16"):
            cast_parameters_to_fp16(place, scope=scope)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from .program import (default_main_program, program_guard,
                              static_state)

        prog = default_main_program()
        casted = _cast_program(prog, self._dtype, self._amp_lists)
        # the reference rewrites the program in place; here the casted
        # clone becomes the default main program (exe.run(None) runs it)
        # and is exposed as .program. Call minimize OUTSIDE a
        # program_guard, or run .program explicitly: a guard's exit
        # restores the program before the cast.
        with program_guard(casted, startup_program or
                           static_state.startup_program):
            out = self._opt.minimize(loss)
        static_state.main_program = casted
        self.program = casted
        return out


def decorate(optimizer, amp_lists=None, init_loss_scaling=2 ** 15,
             incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
             incr_ratio=2.0, decr_ratio=0.8, use_dynamic_loss_scaling=None,
             use_amp_guard=None, level="O1", dtype="bfloat16",
             use_pure_fp16=False, use_fp16_guard=None, master_weight=None,
             use_promote=False):
    """reference static/amp/decorator.py decorate."""
    if use_pure_fp16:
        dtype = "float16"
        level = "O2"   # pure fp16 is O2: amp_init casts stored params
    return _DecoratedOptimizer(optimizer, amp_lists, level, dtype,
                               init_loss_scaling)
