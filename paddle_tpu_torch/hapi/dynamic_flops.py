"""``paddle.flops`` (port of ``paddle_tpu/hapi/dynamic_flops.py``): the
FLOPs of one forward, summed over the leaf layers by forward-post hooks
with the reference's rules: 2 FLOPs a multiply-add for ``Linear`` and the
convolutions (no bias), the output's size for six activations and three
pools, 5 times it for a norm layer, 0 for anything else unless
``custom_ops`` maps its type to a counting function."""
from __future__ import annotations

import math

import torch

from .model_summary import _leaves, dummy_inputs

__all__ = ["flops"]


def _out_shape(out):
    o = out[0] if isinstance(out, (list, tuple)) else out
    return tuple(o.shape) if isinstance(o, torch.Tensor) else ()


def _count(layer, inp, out) -> int:
    name = type(layer).__name__
    oshape = _out_shape(out)
    if not oshape:
        return 0
    n_out = math.prod(oshape)
    if name == "Linear":
        return 2 * n_out * int(layer.weight.shape[0])
    if name.startswith("Conv"):
        # weight [out_c, in_c / groups, *kernel]
        return n_out * 2 * math.prod(layer.weight.shape[1:])
    if name in ("ReLU", "GELU", "Sigmoid", "Tanh", "Softmax", "SiLU"):
        return n_out
    if "Norm" in name:
        return 5 * n_out
    if name in ("AvgPool2D", "MaxPool2D", "AdaptiveAvgPool2D"):
        return n_out
    return 0


def flops(net, input_size=None, inputs=None, custom_ops=None,
          print_detail=False) -> int:
    """FLOPs of one forward of ``net`` on ``inputs``, or on float32 zeros
    of ``input_size`` on the net's device."""
    total = [0]
    custom_ops = custom_ops or {}
    hooks = []
    for _, sub in _leaves(net):
        def hook(layer, i, o):
            fn = custom_ops.get(type(layer))
            total[0] += int(fn(layer, i, o)) if fn else _count(layer, i, o)

        hooks.append(sub.register_forward_hook(hook))
    try:
        if inputs is not None:
            xs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
            net(*xs)
        else:
            net(*dummy_inputs(net, [input_size], [None]))
    finally:
        for h in hooks:
            h.remove()
    if print_detail:
        print(f"Total FLOPs: {total[0]:,}")
    return total[0]
