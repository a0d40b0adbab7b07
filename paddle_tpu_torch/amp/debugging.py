"""AMP numerical debugging (port of ``paddle_tpu/amp/debugging.py``).

The reference collects per-op statistics and checks for nan/inf through a
hook in its single eager dispatcher. The port has no dispatcher (a
``TorchDispatchMode`` would see aten ops but not the kernel launches), so
the hook is ``framework.amp_state.checker``, which the port's ops call on
their own outputs (``check_outputs``) when a checker is installed or
``FLAGS_check_nan_inf`` is on, and nowhere else: nothing is installed by
default, and nothing runs while a CUDA graph is captured.
"""
from __future__ import annotations

import contextlib
from enum import Enum
from typing import Dict, List, Optional

import torch

from ..framework.amp_state import amp_state

__all__ = ["DebugMode", "TensorCheckerConfig", "enable_tensor_checker",
           "disable_tensor_checker", "check_numerics",
           "enable_operator_stats_collection",
           "disable_operator_stats_collection", "collect_operator_stats"]


class DebugMode(Enum):
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL_FOR_OVERFLOW = 2
    CHECK_ALL = 3


class TensorCheckerConfig:
    def __init__(self, enable: bool = False,
                 debug_mode: DebugMode = DebugMode.CHECK_NAN_INF_AND_ABORT,
                 output_dir: Optional[str] = None, checked_op_list=None,
                 skipped_op_list=None, debug_step=None,
                 stack_height_limit=1):
        self.enable = enable
        self.debug_mode = debug_mode
        self.output_dir = output_dir
        self.checked_op_list = set(checked_op_list or [])
        self.skipped_op_list = set(skipped_op_list or [])
        self.debug_step = debug_step
        self.stack_height_limit = stack_height_limit
        self._found: List[str] = []

    def _check(self, op_name: str, leaves):
        if self.checked_op_list and op_name not in self.checked_op_list:
            return
        if op_name in self.skipped_op_list:
            return
        for o in leaves:
            o = o.detach()
            n_nan = int(torch.isnan(o).sum())
            n_inf = int(torch.isinf(o).sum())
            if n_nan or n_inf:
                msg = (f"[nan_inf] op={op_name} shape={tuple(o.shape)} "
                       f"dtype={o.dtype} num_nan={n_nan} num_inf={n_inf}")
                self._found.append(msg)
                if self.debug_mode == DebugMode.CHECK_NAN_INF_AND_ABORT:
                    raise RuntimeError(msg)
                print(msg)


_active_config: Optional[TensorCheckerConfig] = None


def enable_tensor_checker(checker_config: TensorCheckerConfig):
    """Install the config's per-op checker (when it is enabled)."""
    global _active_config
    _active_config = checker_config
    if checker_config.enable:
        amp_state.checker = checker_config._check


def disable_tensor_checker():
    global _active_config
    _active_config = None
    amp_state.checker = None


def check_numerics(tensor, op_type: str = "", var_name: str = "",
                   debug_mode: DebugMode = DebugMode.CHECK_NAN_INF_AND_ABORT):
    """One scan of ``tensor``: returns (num_nan, num_inf, num_zero) as
    0-d tensors; raises on nan or inf under CHECK_NAN_INF_AND_ABORT."""
    v = torch.as_tensor(tensor).detach()
    n_nan = torch.isnan(v).sum()
    n_inf = torch.isinf(v).sum()
    n_zero = (v == 0).sum()
    if debug_mode == DebugMode.CHECK_NAN_INF_AND_ABORT and (
            int(n_nan) or int(n_inf)):
        raise RuntimeError(
            f"check_numerics: {op_type}:{var_name} has nan={int(n_nan)} "
            f"inf={int(n_inf)}")
    return n_nan, n_inf, n_zero


# -- operator stats ------------------------------------------------------------

_op_stats: Optional[Dict[str, Dict[str, int]]] = None
_prev_checker = None


def enable_operator_stats_collection():
    """Count each op's calls by output dtype. Chains with (and restores)
    a checker installed by enable_tensor_checker."""
    global _op_stats, _prev_checker
    _op_stats = {}
    _prev_checker = amp_state.checker

    def _collect(op_name, leaves):
        for o in leaves:
            key = str(o.dtype).replace("torch.", "")
            d = _op_stats.setdefault(op_name, {})
            d[key] = d.get(key, 0) + 1
        if _prev_checker is not None:
            _prev_checker(op_name, leaves)

    amp_state.checker = _collect


def disable_operator_stats_collection():
    global _op_stats, _prev_checker
    amp_state.checker = _prev_checker
    _prev_checker = None
    stats, _op_stats = _op_stats, None
    if stats:
        print("<" + "-" * 20 + " op list " + "-" * 20 + ">")
        print(f"{'Op Name':<40} {'calls by dtype'}")
        for op, by_dtype in sorted(stats.items()):
            print(f"{op:<40} {by_dtype}")
    return stats


@contextlib.contextmanager
def collect_operator_stats():
    enable_operator_stats_collection()
    try:
        yield
    finally:
        disable_operator_stats_collection()
