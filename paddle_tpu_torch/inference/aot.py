"""AOT export and import of programs (the ``*.pdmodel`` analog; port of
``paddle_tpu/inference/aot.py``).

The JAX package serializes a lowered ``jax.jit`` as StableHLO through
``jax.export``; here a program is a ``torch.export`` ``ExportedProgram``,
written and read with ``torch.export.save`` / ``load`` (a ``.pt2``
archive). A program that calls the kernels holds ``paddle_tpu::`` library
ops: this module imports ``paddle_tpu_torch.ops``, which registers them,
before it loads one. Reference analog: AnalysisPredictor loading a
ProgramDesc + params (inference/api/analysis_predictor.h:148).
"""
from __future__ import annotations

import io
from typing import Callable

import torch

from .. import ops as _ops  # noqa: F401  (registers the paddle_tpu:: ops)

__all__ = ["export_fn", "save_exported", "load_exported",
           "serialize_exported"]


class _Fn(torch.nn.Module):
    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_fn(fn: Callable, *example_args, dynamic_shapes=None):
    """``torch.export`` of ``fn`` (a function or a module) at the example
    arguments' shapes (``dynamic_shapes`` as ``torch.export.export`` takes
    them). Returns the ``ExportedProgram``; call it through ``.module()``."""
    mod = fn if isinstance(fn, torch.nn.Module) else _Fn(fn)
    return torch.export.export(mod, tuple(example_args),
                               dynamic_shapes=dynamic_shapes, strict=False)


def serialize_exported(exported) -> bytes:
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    return buf.getvalue()


def save_exported(exported, path: str):
    torch.export.save(exported, path)


def load_exported(path: str):
    return torch.export.load(path)
