"""Convolutions (port of ``paddle_tpu/nn/functional/conv.py``).

The reference lowers each call to one ``lax.conv_general_dilated``; here
each is one ``torch.nn.functional.conv{1,2,3}d`` or ``conv_transpose*d``
(cuDNN on the card), as a plain matrix product stays ``torch.matmul``:
the reference routes no convolution to a Pallas kernel.

- Weights are paddle's ``[out, in / groups, *k]`` (a transpose:
  ``[in, out / groups, *k]``), which is torch's layout as it is.
- ``padding`` is an int, a list of ``nd`` or ``2 * nd`` values (``[lo0,
  hi0, lo1, hi1, ...]``) or ``"SAME"`` / ``"VALID"``, resolved as the
  reference resolves it. ``"SAME"`` pads XLA's way: ``ceil(n / stride)``
  outputs, the total pad split with the odd element at the end; uneven
  pads go through ``F.pad`` before an unpadded convolution.
- Channel-last formats (``NLC``, ``NHWC``, ``NDHWC``) are permuted to
  channel-first around the call and back.
- A transpose is the reference's input-dilated convolution: torch's
  unpadded transpose gives the full output, from which the pads
  ``(lo, hi - output_padding)`` are cut (or zeros added where
  ``output_padding`` reaches past it). ``output_size`` is taken and not
  used, as in the reference.

fp32 policy: fp32 convolutions run as cuDNN runs them under the process's
``torch.backends.cudnn.allow_tf32`` (on by default: the tensor cores in
TF32, 10 mantissa bits for the products, fp32 sums), which is also the
default of Paddle's own GPU build. The port sets no torch flag; a caller
who wants IEEE fp32 products turns that flag off. On the CPU the products
are fp32. bf16 and fp16 convolutions are unaffected.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ._op import amp_op

__all__ = [
    "conv1d", "conv2d", "conv3d",
    "conv1d_transpose", "conv2d_transpose", "conv3d_transpose",
]

_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}
_CONV_T = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
           3: TF.conv_transpose3d}


def _ntuple(v, n):
    if isinstance(v, (list, tuple)):
        if len(v) == 1:
            return tuple(int(v[0]) for _ in range(n))
        return tuple(int(x) for x in v)
    return tuple(int(v) for _ in range(n))


def _resolve_padding(padding, nd):
    """paddle padding: int | list | 'SAME' | 'VALID' -> [(lo, hi)] per
    spatial dim, or the upper-cased string."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, (list, tuple)):
        p = [int(x) for x in padding]
        if len(p) == nd:
            return [(x, x) for x in p]
        if len(p) == 2 * nd:
            return [(p[2 * i], p[2 * i + 1]) for i in range(nd)]
        if len(p) == 1:
            return [(p[0], p[0])] * nd
    return [(int(padding), int(padding))] * nd


def same_pads(sizes, kernel, strides, dilations):
    """XLA's "SAME": ``ceil(n / s)`` outputs per dim, the total pad split
    ``(total // 2, total - total // 2)``."""
    pads = []
    for n, k, s, d in zip(sizes, kernel, strides, dilations):
        eff = (k - 1) * d + 1
        out = -(-n // s)
        total = max((out - 1) * s + eff - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _torch_pad(pads):
    """[(lo, hi)] per spatial dim -> ``F.pad``'s last-dim-first list."""
    return [p for lo, hi in reversed(pads) for p in (lo, hi)]


def _to_channel_first(x, channel_last):
    return x.movedim(-1, 1) if channel_last else x


def _from_channel_first(x, channel_last):
    return x.movedim(1, -1) if channel_last else x


def _conv(x, weight, bias, stride, padding, dilation, groups, nd,
          data_format):
    channel_last = not data_format.startswith("NC")
    strides = _ntuple(stride, nd)
    dilations = _ntuple(dilation, nd)
    v = _to_channel_first(x, channel_last)
    pads = _resolve_padding(padding, nd)
    if pads == "SAME":
        pads = same_pads(v.shape[2:], weight.shape[2:], strides, dilations)
    elif pads == "VALID":
        pads = [(0, 0)] * nd
    if all(lo == hi for lo, hi in pads):
        sym = [lo for lo, _ in pads]
    else:
        v = TF.pad(v, _torch_pad(pads))
        sym = [0] * nd
    out = _CONV[nd](v, weight, bias, strides, sym, dilations, groups)
    return _from_channel_first(out, channel_last)


@amp_op("conv1d")
def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    fmt = "NCW" if data_format in ("NCL", "NCW") else "NWC"
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1, fmt)


@amp_op("conv2d")
def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2,
                 data_format)


@amp_op("conv3d")
def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 3,
                 data_format)


def _conv_transpose(x, weight, bias, stride, padding, output_padding, groups,
                    dilation, nd, data_format):
    channel_last = not data_format.startswith("NC")
    strides = _ntuple(stride, nd)
    dilations = _ntuple(dilation, nd)
    out_pad = (_ntuple(output_padding, nd) if output_padding is not None
               else (0,) * nd)
    kdims = weight.shape[2:]
    pads = _resolve_padding(padding, nd)
    if pads == "SAME":
        pads = []
        for k, s, d in zip(kdims, strides, dilations):
            eff = (k - 1) * d + 1
            total = eff - s if eff > s else 0
            pads.append((total // 2, total - total // 2))
    elif pads == "VALID":
        pads = [(0, 0)] * nd
    v = _to_channel_first(x, channel_last)
    full = _CONV_T[nd](v, weight, None, strides, 0, 0, groups, dilations)
    # cut (lo, hi - output_padding) from the full output; a negative cut
    # at the end is that many zeros, the output padding past the input
    index = [slice(None), slice(None)]
    grow = []
    for i, (lo, hi) in enumerate(pads):
        n = full.shape[2 + i]
        end = n - hi + out_pad[i]
        index.append(slice(lo, min(end, n)))
        grow.append(max(end - n, 0))
    out = full[tuple(index)]
    if any(grow):
        out = TF.pad(out, _torch_pad([(0, g) for g in grow]))
    if bias is not None:
        out = out + bias.reshape([1, -1] + [1] * nd)
    return _from_channel_first(out, channel_last)


@amp_op("conv1d_transpose")
def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    fmt = "NCW" if data_format in ("NCL", "NCW") else "NWC"
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           groups, dilation, 1, fmt)


@amp_op("conv2d_transpose")
def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           groups, dilation, 2, data_format)


@amp_op("conv3d_transpose")
def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           groups, dilation, 3, data_format)
