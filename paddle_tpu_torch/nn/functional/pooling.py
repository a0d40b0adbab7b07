"""Pooling (port of ``paddle_tpu/nn/functional/pooling.py``).

The reference pools with ``lax.reduce_window`` over explicitly padded
windows; the port builds the same pads and pools with torch's
``max_pool*d`` / ``avg_pool*d``:

- Pads are an int, a list of ``nd`` or ``2 * nd`` values, or ``"SAME"`` /
  ``"VALID"`` (XLA's rule, as the convolutions'). ``ceil_mode`` extends
  each end pad by ``(stride - rem) % stride`` where ``rem = (n + lo + hi -
  k) % stride``, the reference's rule: it does not drop a last window that
  starts in the padding, as torch's ``ceil_mode`` would.
- Pads equal at both ends of every dim and at most half the window go to
  torch's pooling as they are (its implicit padding is -inf for max, and
  ``count_include_pad`` picks the divisor). Other pads (``ceil_mode``'s
  extension, XLA's uneven "SAME") are applied with ``F.pad`` first, -inf
  for max and 0 for avg, and torch pools without padding. So are avg
  pads of an input not in torch's contiguous layout (a channel-last
  ``data_format``): torch's CUDA ``avg_pool2d`` backward on a
  channels-last tensor with implicit padding gives wrong input gradients
  (every element off, on an H100 with torch 2.11; unpadded it is right).
- Avg divides by the window size, by ``divisor_override``, or with
  ``exclusive`` (the default) by the count of real elements in the window
  (with ``F.pad``'s pads, pooled ones, as the reference counts them); with
  a string padding ``exclusive`` divides by the window size, as the
  reference does. A ``ceil_mode`` window of padding alone counts 0 real
  elements and gives 0 / 0 = NaN, as in the reference.
- ``return_mask`` gives flat spatial indices into the input (``-1`` for a
  window of padding alone), computed over the pads without ``ceil_mode``
  as the reference computes them. Tie rule: the first maximal element of a
  window in row-major window order, the one the reference's ``av >= bv``
  select keeps (``torch.argmax`` returns the first maximum on the CPU and
  on the card).
- Adaptive pooling: the windows ``[floor(i n / m), ceil((i + 1) n / m))``
  of the reference (and of torch's adaptive pooling); the max forms give
  ``(out, None)`` with ``return_mask``, as the reference does.
- ``max_unpool*d`` scatters each value to its flat index in a zero output
  of ``output_size`` or ``(n - 1) s - 2 p + k`` per dim (channel-first).
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ._op import amp_op
from .conv import (_from_channel_first, _ntuple, _to_channel_first,
                   _torch_pad, same_pads)

__all__ = [
    "avg_pool1d", "avg_pool2d", "avg_pool3d",
    "max_pool1d", "max_pool2d", "max_pool3d",
    "adaptive_avg_pool1d", "adaptive_avg_pool2d", "adaptive_avg_pool3d",
    "adaptive_max_pool1d", "adaptive_max_pool2d", "adaptive_max_pool3d",
    "max_unpool1d", "max_unpool2d", "max_unpool3d",
]

_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_AVG = {1: TF.avg_pool1d, 2: TF.avg_pool2d, 3: TF.avg_pool3d}
_HALF = (torch.bfloat16, torch.float16)
_ADAPTIVE = {("avg", 1): TF.adaptive_avg_pool1d,
             ("avg", 2): TF.adaptive_avg_pool2d,
             ("avg", 3): TF.adaptive_avg_pool3d,
             ("max", 1): TF.adaptive_max_pool1d,
             ("max", 2): TF.adaptive_max_pool2d,
             ("max", 3): TF.adaptive_max_pool3d}


def _window_pads(padding, nd, ksize, strides, in_shape, ceil_mode):
    """[(lo, hi)] per spatial dim: the reference's ``_window_pads`` with
    the strings resolved (XLA's "SAME"; "VALID" is none)."""
    if isinstance(padding, str):
        if padding.upper() == "SAME":
            return same_pads(in_shape, ksize, strides, (1,) * nd), True
        return [(0, 0)] * nd, True
    if isinstance(padding, (list, tuple)) and len(padding) == 2 * nd:
        pl = [int(x) for x in padding]
        pads = [(pl[2 * i], pl[2 * i + 1]) for i in range(nd)]
    else:
        pads = [(x, x) for x in _ntuple(padding, nd)]
    if ceil_mode:
        new = []
        for i, (lo, hi) in enumerate(pads):
            rem = (in_shape[i] + lo + hi - ksize[i]) % strides[i]
            new.append((lo, hi + ((strides[i] - rem) % strides[i]
                                  if rem else 0)))
        pads = new
    return pads, False


def _channel_first(x, data_format):
    return _to_channel_first(x, not data_format.startswith("NC"))


def _back(x, data_format):
    return _from_channel_first(x, not data_format.startswith("NC"))


def _pool(x, ksize, strides, padding, nd, data_format, kind,
          ceil_mode=False, exclusive=True, divisor_override=None):
    k = _ntuple(ksize, nd)
    s = _ntuple(strides if strides is not None else ksize, nd)
    v = _channel_first(x, data_format)
    pads, was_str = _window_pads(padding, nd, k, s, v.shape[2:], ceil_mode)
    even = all(lo == hi and 2 * lo <= kk for (lo, hi), kk in zip(pads, k))
    tpad = _torch_pad(pads)
    if kind == "max":
        if even:
            return _back(_MAX[nd](v, k, s, [lo for lo, _ in pads]),
                         data_format)
        fill = (float("-inf") if v.is_floating_point()
                else torch.iinfo(v.dtype).min)
        out = _MAX[nd](TF.pad(v, tpad, value=fill), k, s)
        return _back(out, data_format)
    if nd == 3 and v.device.type == "cpu" and v.dtype in _HALF:
        # torch's CPU avg_pool3d has no 16-bit kernel: pool in fp32 and
        # round once, as the card's kernel does
        return _back(_pool(v.float(), k, s, padding, nd, "NCDHW", kind,
                           ceil_mode, exclusive, divisor_override)
                     .to(v.dtype), data_format)
    exclusive = exclusive and not was_str and divisor_override is None
    if even and v.is_contiguous():
        out = _AVG[nd](v, k, s, [lo for lo, _ in pads],
                       count_include_pad=not exclusive)
    else:
        out = _AVG[nd](TF.pad(v, tpad), k, s)
        if exclusive:
            ones = torch.ones((1, 1) + tuple(v.shape[2:]), dtype=v.dtype,
                              device=v.device)
            out = out / _AVG[nd](TF.pad(ones, tpad), k, s)
    if divisor_override is not None:
        size = 1
        for kk in k:
            size *= kk
        out = out * (size / divisor_override)
    return _back(out, data_format)


@amp_op("avg_pool1d")
def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    return _pool(x, kernel_size, stride, padding, 1, "NCW", "avg", ceil_mode,
                 exclusive)


@amp_op("avg_pool2d")
def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 2, data_format, "avg",
                 ceil_mode, exclusive, divisor_override)


@amp_op("avg_pool3d")
def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 3, data_format, "avg",
                 ceil_mode, exclusive, divisor_override)


def _max_pool(x, kernel_size, stride, padding, return_mask, ceil_mode, nd,
              data_format):
    out = _pool(x, kernel_size, stride, padding, nd, data_format, "max",
                ceil_mode)
    if return_mask:
        return out, _max_mask(x, kernel_size, stride, padding, nd,
                              data_format)
    return out


@amp_op("max_pool1d")
def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None):
    return _max_pool(x, kernel_size, stride, padding, return_mask, ceil_mode,
                     1, "NCW")


@amp_op("max_pool2d")
def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    return _max_pool(x, kernel_size, stride, padding, return_mask, ceil_mode,
                     2, data_format)


@amp_op("max_pool3d")
def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _max_pool(x, kernel_size, stride, padding, return_mask, ceil_mode,
                     3, data_format)


def _max_mask(x, ksize, strides, padding, nd, data_format):
    """Flat spatial index of each window's first maximum (int32, the
    reference's dtype), over the pads without ``ceil_mode``; ``-1`` where
    the window holds padding alone."""
    k = _ntuple(ksize, nd)
    s = _ntuple(strides if strides is not None else ksize, nd)
    v = _channel_first(x, data_format).detach()
    sp = tuple(v.shape[2:])
    pads, _ = _window_pads(padding, nd, k, s, sp, False)
    tpad = _torch_pad(pads)
    fill = (float("-inf") if v.is_floating_point()
            else torch.iinfo(v.dtype).min)
    vals = TF.pad(v, tpad, value=fill)
    n_sp = 1
    for d in sp:
        n_sp *= d
    idx = torch.arange(n_sp, device=v.device).reshape((1, 1) + sp)
    idx = TF.pad(idx, tpad, value=-1)
    for i in range(nd):                         # windows on new last dims
        vals = vals.unfold(2 + i, k[i], s[i])
        idx = idx.unfold(2 + i, k[i], s[i])
    lead = vals.shape[:2 + nd]
    pick = vals.reshape(lead + (-1,)).argmax(-1, keepdim=True)
    flat = idx.reshape(idx.shape[:2 + nd] + (-1,)).expand(lead + (-1,))
    mask = flat.gather(-1, pick).squeeze(-1).to(torch.int32)
    return _back(mask, data_format)


def _adaptive_pool(x, output_size, nd, data_format, kind):
    out_sp = _ntuple(output_size, nd)
    v = _channel_first(x, data_format)
    out_sp = tuple(v.shape[2 + i] if o is None or o < 0 else o
                   for i, o in enumerate(out_sp))
    out = _ADAPTIVE[(kind, nd)](v, out_sp)
    return _back(out, data_format)


@amp_op("adaptive_avg_pool1d")
def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive_pool(x, output_size, 1, "NCW", "avg")


@amp_op("adaptive_avg_pool2d")
def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive_pool(x, output_size, 2, data_format, "avg")


@amp_op("adaptive_avg_pool3d")
def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_pool(x, output_size, 3, data_format, "avg")


@amp_op("adaptive_max_pool1d")
def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    out = _adaptive_pool(x, output_size, 1, "NCW", "max")
    return (out, None) if return_mask else out


@amp_op("adaptive_max_pool2d")
def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    out = _adaptive_pool(x, output_size, 2, "NCHW", "max")
    return (out, None) if return_mask else out


@amp_op("adaptive_max_pool3d")
def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    out = _adaptive_pool(x, output_size, 3, "NCDHW", "max")
    return (out, None) if return_mask else out


def _max_unpool(x, indices, kernel_size, stride, padding, nd, output_size):
    k = _ntuple(kernel_size, nd)
    s = _ntuple(stride if stride is not None else kernel_size, nd)
    n, c = x.shape[0], x.shape[1]
    in_sp = x.shape[2:]
    if output_size is not None:
        out_sp = tuple(int(o) for o in output_size)[-nd:]
    else:
        p = _ntuple(padding, nd)
        out_sp = tuple((in_sp[i] - 1) * s[i] - 2 * p[i] + k[i]
                       for i in range(nd))
    flat_out = 1
    for o in out_sp:
        flat_out *= o
    idx = torch.as_tensor(indices, device=x.device).long().reshape(n, c, -1)
    out = x.new_zeros((n, c, flat_out)).scatter(2, idx, x.reshape(n, c, -1))
    return out.reshape((n, c) + out_sp)


@amp_op("max_unpool1d")
def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    return _max_unpool(x, indices, kernel_size, stride, padding, 1,
                       output_size)


@amp_op("max_unpool2d")
def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    return _max_unpool(x, indices, kernel_size, stride, padding, 2,
                       output_size)


@amp_op("max_unpool3d")
def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    return _max_unpool(x, indices, kernel_size, stride, padding, 3,
                       output_size)
