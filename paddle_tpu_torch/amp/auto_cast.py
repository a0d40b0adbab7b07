"""Autocast context and model decoration (port of
``paddle_tpu/amp/auto_cast.py``: ``auto_cast``, ``amp_guard``,
``decorate``).

``auto_cast`` sets the thread-local policy of ``framework/amp_state.py``,
which the port's ops read where they are entered: black-list ops compute
in fp32, white-list ops in the AMP dtype (bf16 by default, fp16 on
request), and under O2 every other op in the AMP dtype too. ``decorate``
at O2 casts a model's floating parameters and buffers to the AMP dtype in
place, leaving the norm layers (the port's ``RMSNorm`` among them, by class
name as the reference matches them) and excluded layers in fp32.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
from torch import nn

from ..framework.amp_state import policy, policy_restored
from . import amp_lists

__all__ = ["auto_cast", "amp_guard", "decorate", "amp_decorate"]

_NORM_LAYERS = ("LayerNorm", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
                "BatchNorm3D", "InstanceNorm1D", "InstanceNorm2D",
                "InstanceNorm3D", "GroupNorm", "SyncBatchNorm", "RMSNorm")

_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float16": torch.float16, "fp16": torch.float16,
           "half": torch.float16}


def _resolve_dtype(dtype) -> torch.dtype:
    d = dtype or "bfloat16"
    d = _DTYPES.get(d, d) if isinstance(d, str) else d
    if d not in (torch.float16, torch.bfloat16):
        raise ValueError(f"amp dtype must be float16/bfloat16, got {dtype}")
    return d


@contextlib.contextmanager
def auto_cast(enable: bool = True,
              custom_white_list: Optional[Sequence] = None,
              custom_black_list: Optional[Sequence] = None,
              level: str = "O1", dtype: str = "bfloat16",
              use_promote: bool = True):
    """Cast the port's ops by the lists inside the block (a nested
    ``auto_cast(enable=False)`` turns AMP off for its own block)."""
    if level not in ("O0", "O1", "O2"):
        raise ValueError(f"level should be O0/O1/O2, got {level}")
    if not enable or level == "O0":
        new = (False, "O0") + policy()[2:]
    else:
        d = _resolve_dtype(dtype)
        white = set(amp_lists.white_list(str(d)))
        black = set(amp_lists.black_list(str(d)))
        if custom_white_list:
            white |= set(custom_white_list)
            black -= set(custom_white_list)
        if custom_black_list:
            black |= set(custom_black_list)
            white -= set(custom_black_list)
        new = (True, level, d, white, black)
    with policy_restored(new):
        yield


amp_guard = auto_cast  # legacy alias (paddle.fluid.dygraph.amp_guard)


def decorate(models, optimizers=None, level: str = "O2",
             dtype: str = "bfloat16", master_weight=None, save_dtype=None,
             master_grad: bool = False, excluded_layers=None):
    """At O2 cast every model's floating parameters and buffers to the AMP
    dtype in place (norm layers and ``excluded_layers``, classes or
    instances, stay as they are); O1 leaves the models alone. Returns the
    models (and the optimizers when given), as the reference does."""
    if level not in ("O1", "O2"):
        raise ValueError(f"level should be O1 or O2, got {level}")
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        d = _resolve_dtype(dtype)
        ex = excluded_layers or ()
        if not isinstance(ex, (list, tuple)):
            ex = (ex,)
        ex_types = tuple(e for e in ex if isinstance(e, type))
        ex_ids = {id(e) for e in ex if not isinstance(e, type)}
        for m in model_list:
            _cast_model(m, d, ex_types, ex_ids)
            m._casted_by_pure_fp16 = True
    if optimizers is None:
        return model_list[0] if single else model_list
    return (model_list[0] if single else model_list), optimizers


amp_decorate = decorate


@torch.no_grad()
def _cast_model(layer: nn.Module, dtype, excluded_types=(),
                excluded_ids=frozenset()):
    keep = (type(layer).__name__ in _NORM_LAYERS
            or (excluded_types and isinstance(layer, excluded_types))
            or id(layer) in excluded_ids)
    if not keep:
        for t in list(layer._parameters.values()) + list(
                layer._buffers.values()):
            if t is not None and t.is_floating_point():
                t.data = t.data.to(dtype)
    for sub in layer.children():
        _cast_model(sub, dtype, excluded_types, excluded_ids)
