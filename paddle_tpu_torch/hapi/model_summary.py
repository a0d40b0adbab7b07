"""``paddle.summary`` (port of ``paddle_tpu/hapi/model_summary.py``): a
table of the leaf layers with their output shapes and parameter counts,
read by forward-post hooks over one forward."""
from __future__ import annotations

import torch

from ..core.dtype import convert_dtype
from ..core.place import _current_place

__all__ = ["summary"]


def _leaves(layer, prefix=""):
    """(dotted name, layer) of every leaf sublayer, in definition order."""
    for name, sub in layer.named_children():
        full = f"{prefix}{name}"
        if any(True for _ in sub.children()):
            yield from _leaves(sub, full + ".")
        else:
            yield full, sub


def _device(net) -> torch.device:
    """Where the dummy inputs go: the net's device, else the current
    place."""
    for t in net.parameters():
        return t.device
    for t in net.buffers():
        return t.device
    return _current_place()


def dummy_inputs(net, sizes, dtypes):
    """Zeros of each size (None and -1 read as 1) in each dtype (float32
    where None) on the net's device."""
    dev = _device(net)
    out = []
    for s, dt in zip(sizes, dtypes):
        s = tuple(1 if d in (None, -1) else int(d) for d in s)
        out.append(torch.zeros(s, dtype=convert_dtype(dt or "float32"),
                               device=dev))
    return out


def summary(net, input_size=None, dtypes=None, input=None):
    """Prints the per-layer table; returns ``{'total_params',
    'trainable_params'}``."""
    rows = []
    hooks = []
    for full, sub in _leaves(net):
        def hook(layer, inp, out, _full=full):
            o = out[0] if isinstance(out, (list, tuple)) else out
            shape = (tuple(o.shape) if isinstance(o, torch.Tensor)
                     else None)
            n = sum(p.numel() for p in layer.parameters())
            rows.append((_full, type(layer).__name__, shape, n))

        hooks.append(sub.register_forward_hook(hook))
    try:
        if input is not None:
            x = input if isinstance(input, (list, tuple)) else [input]
            net(*x)
        elif input_size is not None:
            sizes = (input_size if isinstance(input_size, list)
                     else [input_size])
            dts = (dtypes if isinstance(dtypes, (list, tuple))
                   else [dtypes] * len(sizes))
            net(*dummy_inputs(net, sizes, dts))
    finally:
        for h in hooks:
            h.remove()

    total = sum(p.numel() for p in net.parameters())
    trainable = sum(p.numel() for p in net.parameters() if p.requires_grad)
    w = 76
    print("-" * w)
    print(f"{'Layer (type)':<36}{'Output Shape':<24}{'Param #':>14}")
    print("=" * w)
    for name, cls, shape, n in rows:
        print(f"{name + ' (' + cls + ')':<36}{str(shape):<24}{n:>14,}")
    print("=" * w)
    print(f"Total params: {total:,}")
    print(f"Trainable params: {trainable:,}")
    print(f"Non-trainable params: {total - trainable:,}")
    print("-" * w)
    return {"total_params": total, "trainable_params": trainable}
