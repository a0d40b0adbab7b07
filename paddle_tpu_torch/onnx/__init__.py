"""paddle.onnx counterpart (port of ``paddle_tpu/onnx/__init__.py``;
reference python/paddle/onnx/export.py, which delegates to paddle2onnx).

``export`` writes the port's AOT artifact, the ``jit.save`` pair
``<path>.pt2`` + ``<path>.pdiparams`` (loadable through
``inference.create_predictor``), so the call site keeps working, and warns
every time that it is not a ``.onnx`` file: ONNX conversion needs the
paddle2onnx toolchain, which works on the reference's program protos.
"""
from __future__ import annotations

import warnings

__all__ = ["export"]


def export(layer, path, input_spec=None, opset_version=9, **configs):
    """Reference export.py:24. Writes the framework's AOT artifact; raises
    without ``input_spec`` and where the model cannot be exported."""
    if input_spec is None:
        raise ValueError(
            "export requires input_spec (a list of paddle_tpu_torch.static."
            "InputSpec) to trace the model")
    warnings.warn(
        "paddle_tpu_torch.onnx.export writes the torch.export AOT artifact "
        "(<path>.pt2 + <path>.pdiparams, loadable via paddle_tpu_torch."
        "inference.create_predictor), NOT a .onnx file; ONNX conversion "
        "requires the paddle2onnx toolchain operating on reference program "
        "protos.", stacklevel=2)
    from .. import jit

    jit.save(layer, path, input_spec=input_spec)
    return path
