"""Common functions (port of ``paddle_tpu/nn/functional/common.py``):
``linear`` and ``bilinear``, the dropouts, ``embedding``, ``one_hot``,
``pad``, ``interpolate`` / ``upsample``, the pixel and channel shuffles,
``unfold`` / ``fold``, ``label_smooth``, ``cosine_similarity`` and
``class_center_sample``.

- ``linear`` is ``x @ W + b`` with ``W`` of shape ``[in, out]`` (paddle's
  layout, which the port keeps so weights carry across unchanged); it is
  not ``torch.nn.functional.linear``, whose weight is ``[out, in]``.
- The dropouts and ``class_center_sample`` draw from the port's generator
  for the input's device (``core.random``): the reference's semantics, not
  its threefry numbers.
- ``embedding`` zeroes the rows of ``padding_idx`` in the output, so that
  row of the table gets no gradient, as the reference's does.
- ``interpolate`` resizes separably along each spatial axis with the
  reference's source coordinates: nearest (floor, or rounded with
  ``align_corners``), linear taps with half-pixel centres (edge-clamped,
  as the reference's ``jax.image.resize`` without antialiasing) or corner
  alignment, bicubic with Keys' a = -0.75, and area as adaptive box means.
  ``align_mode`` is accepted and unused, as in the reference.
"""
from __future__ import annotations


import numpy as np
import torch
import torch.nn.functional as F

from ...core.random import default_generator, uniform
from ._op import amp_op

__all__ = [
    "linear", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
    "embedding", "one_hot", "pad", "zeropad2d", "interpolate", "upsample",
    "bilinear", "cosine_similarity", "pixel_shuffle", "pixel_unshuffle",
    "channel_shuffle", "label_smooth", "class_center_sample", "unfold", "fold",
]


@amp_op("linear")
def linear(x, weight, bias=None, name=None):
    """y = x @ W + b, W [in, out]."""
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def _keep_mask(x, p, shape):
    u = uniform(shape, x.device)
    return u < (1.0 - p)


@amp_op("dropout")
def dropout(x, p=0.5, axis=None, training: bool = True,
            mode: str = "upscale_in_train", name=None):
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    mask = _keep_mask(x, p, shape)
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(mask, kept, torch.zeros((), dtype=x.dtype,
                                               device=x.device)).to(x.dtype)


def dropout2d(x, p=0.5, training: bool = True, data_format: str = "NCHW",
              name=None):
    ax = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, axis=ax, training=training)


def dropout3d(x, p=0.5, training: bool = True, data_format: str = "NCDHW",
              name=None):
    ax = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, axis=ax, training=training)


@amp_op("alpha_dropout")
def alpha_dropout(x, p=0.5, training: bool = True, name=None):
    if not training or p == 0.0:
        return x
    alpha, scale = 1.6732632423543772, 1.0507009873554805
    alpha_p = -alpha * scale
    keep = 1.0 - p
    a = (keep + alpha_p ** 2 * keep * (1 - keep)) ** -0.5
    b = -a * alpha_p * (1 - keep)
    mask = _keep_mask(x, p, x.shape)
    dropped = torch.full((), alpha_p, dtype=x.dtype, device=x.device)
    return (a * torch.where(mask, x, dropped) + b).to(x.dtype)


@amp_op("embedding")
def embedding(x, weight, padding_idx=None, sparse: bool = False, name=None):
    """Rows of ``weight`` at ``x``; rows at ``padding_idx`` are zeros."""
    ids = x.long()
    out = F.embedding(ids, weight)
    if padding_idx is not None:
        pid = (padding_idx if padding_idx >= 0
               else weight.shape[0] + padding_idx)
        out = out.masked_fill((ids == pid)[..., None], 0.0)
    return out


def one_hot(x, num_classes, name=None):
    return F.one_hot(x.long(), num_classes).to(torch.float32)


def _pad_width(pads, ndim, data_format):
    """Per-dim (before, after) pairs. Paddle lists pairs from the LAST
    spatial dim backwards, or one pair per dim from the first when it gives
    2 * ndim numbers."""
    if len(pads) == 2 * ndim:
        return [(pads[2 * i], pads[2 * i + 1]) for i in range(ndim)]
    spatial = (list(range(2, ndim)) if data_format.startswith("NC")
               else list(range(1, ndim - 1)))
    pw = [(0, 0)] * ndim
    for i in range(len(pads) // 2):
        pw[spatial[-(i + 1)]] = (pads[2 * i], pads[2 * i + 1])
    return pw


def _pad_index(n, before, after, mode, device):
    i = torch.arange(-before, n + after, device=device)
    if mode == "reflect":
        i = i.abs()
        return torch.where(i > n - 1, 2 * (n - 1) - i, i)
    if mode == "replicate":
        return i.clamp(0, n - 1)
    return i % n                                   # circular


@amp_op("pad")
def pad(x, pad, mode: str = "constant", value: float = 0.0,
        data_format: str = "NCHW", pad_from_left_axis: bool = False,
        name=None):
    pads = [int(p) for p in (pad.tolist() if isinstance(pad, torch.Tensor)
                             else pad)]
    pw = _pad_width(pads, x.dim(), data_format)
    if mode == "constant":
        flat = [p for pair in reversed(pw) for p in pair]
        return F.pad(x, flat, mode="constant", value=value)
    if mode not in ("reflect", "replicate", "circular"):
        raise ValueError(f"unknown pad mode {mode!r}")
    out = x
    for d, (lo, hi) in enumerate(pw):
        if lo or hi:
            out = out.index_select(d, _pad_index(x.shape[d], lo, hi, mode,
                                                 x.device))
    return out


def zeropad2d(x, padding, data_format: str = "NCHW", name=None):
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)


@amp_op("label_smooth")
def label_smooth(label, prior_dist=None, epsilon: float = 0.1, name=None):
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * torch.as_tensor(
            prior_dist, device=label.device)
    return (1 - epsilon) * label + epsilon / label.shape[-1]


@amp_op("cosine_similarity")
def cosine_similarity(x1, x2, axis: int = 1, eps: float = 1e-8):
    dot = (x1 * x2).sum(dim=axis)
    na = (x1 * x1).sum(dim=axis).sqrt()
    nb = (x2 * x2).sum(dim=axis).sqrt()
    return dot / torch.clamp(na * nb, min=eps)


@amp_op("bilinear")
def bilinear(x1, x2, weight, bias=None, name=None):
    """out[b, o] = x1[b] W[o] x2[b] + bias[o], W [out, in1, in2]."""
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


def pixel_shuffle(x, upscale_factor: int, data_format: str = "NCHW",
                  name=None):
    r = upscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        v = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return v.reshape(n, c // (r * r), h * r, w * r)
    n, h, w, c = x.shape
    v = x.reshape(n, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return v.reshape(n, h * r, w * r, c // (r * r))


def pixel_unshuffle(x, downscale_factor: int, data_format: str = "NCHW",
                    name=None):
    r = downscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        v = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
        return v.reshape(n, c * r * r, h // r, w // r)
    n, h, w, c = x.shape
    v = x.reshape(n, h // r, r, w // r, r, c).permute(0, 1, 3, 2, 4, 5)
    return v.reshape(n, h // r, w // r, c * r * r)


def channel_shuffle(x, groups: int, data_format: str = "NCHW", name=None):
    if data_format == "NCHW":
        n, c, h, w = x.shape
        v = x.reshape(n, groups, c // groups, h, w).permute(0, 2, 1, 3, 4)
        return v.reshape(n, c, h, w)
    n, h, w, c = x.shape
    v = x.reshape(n, h, w, groups, c // groups).permute(0, 1, 2, 4, 3)
    return v.reshape(n, h, w, c)


def _cubic_weight(t, a=-0.75):
    at = t.abs()
    return torch.where(
        at <= 1.0, (a + 2.0) * at ** 3 - (a + 3.0) * at ** 2 + 1.0,
        torch.where(at < 2.0,
                    a * at ** 3 - 5.0 * a * at ** 2 + 8.0 * a * at - 4.0 * a,
                    torch.zeros_like(at)))


def _spatial_axes(x, channel_last):
    return list(range(1, x.dim() - 1)) if channel_last else \
        list(range(2, x.dim()))


def _adaptive_mean(x, out_sp, channel_last):
    """Separable adaptive box means: out[i] averages the source interval
    [floor(i * in / out), ceil((i + 1) * in / out))."""
    out = x
    for ax, outsz in zip(_spatial_axes(x, channel_last), out_sp):
        insz = x.shape[ax]
        i = torch.arange(outsz, device=x.device)
        lo = torch.div(i * insz, outsz, rounding_mode="floor")
        hi = -torch.div(-(i + 1) * insz, outsz, rounding_mode="floor")
        c = torch.cumsum(out.float(), dim=ax)
        c = torch.cat([torch.zeros_like(c.narrow(ax, 0, 1)), c], dim=ax)
        sums = c.index_select(ax, hi) - c.index_select(ax, lo)
        wsh = [1] * out.dim()
        wsh[ax] = outsz
        out = (sums / (hi - lo).float().reshape(wsh)).to(x.dtype)
    return out


def _resize_gather(x, out_sp, kind, align_corners, channel_last):
    """Separable gather resize: 'nearest', 'linear' (2 taps) or 'cubic'
    (4 taps). Linear without corner alignment clamps its source coordinate
    at 0, which is the edge renormalization of the reference's
    ``jax.image.resize``; cubic does not, as the reference's does not."""
    out = x
    for ax, outsz in zip(_spatial_axes(x, channel_last), out_sp):
        insz = x.shape[ax]
        i = torch.arange(outsz, dtype=torch.float32, device=x.device)
        if kind == "nearest":
            if align_corners and outsz > 1:
                src = torch.round(i * (insz - 1) / (outsz - 1))
            else:
                src = torch.floor(i * (insz / outsz))
            out = out.index_select(ax, src.long().clamp(0, insz - 1))
            continue
        if align_corners:
            src = (i * (insz - 1) / (outsz - 1) if outsz > 1
                   else torch.zeros_like(i))
        else:
            src = (i + 0.5) * (insz / outsz) - 0.5
            if kind == "linear":
                src = src.clamp(min=0.0)
        base = torch.floor(src)
        frac = src - base
        wsh = [1] * out.dim()
        wsh[ax] = outsz
        acc = None
        for k in ((0, 1) if kind == "linear" else (-1, 0, 1, 2)):
            idx = (base.long() + k).clamp(0, insz - 1)
            if kind == "linear":
                w = (1.0 - frac) if k == 0 else frac
            else:
                w = _cubic_weight(frac - k)
            term = out.index_select(ax, idx) * w.reshape(wsh).to(x.dtype)
            acc = term if acc is None else acc + term
        out = acc
    return out


def _scalar(v):
    return v.item() if isinstance(v, torch.Tensor) else v


@amp_op("interpolate")
def interpolate(x, size=None, scale_factor=None, mode: str = "nearest",
                align_corners: bool = False, align_mode: int = 0,
                data_format: str = "NCHW", name=None):
    mode = mode.lower()
    if mode not in ("nearest", "bilinear", "trilinear", "bicubic", "linear",
                    "area"):
        raise ValueError(f"unknown interpolate mode {mode!r}")
    channel_last = not data_format.startswith("NC")
    spatial = [x.shape[a] for a in _spatial_axes(x, channel_last)]
    if size is not None:
        sizes = size if isinstance(size, (list, tuple)) else [size]
        out_sp = [int(_scalar(s)) for s in sizes]
    else:
        sf = (scale_factor if isinstance(scale_factor, (list, tuple))
              else [scale_factor] * len(spatial))
        out_sp = [int(s * float(_scalar(f))) for s, f in zip(spatial, sf)]
    if mode == "nearest":
        return _resize_gather(x, out_sp, "nearest", align_corners,
                              channel_last)
    if mode == "area":
        return _adaptive_mean(x, out_sp, channel_last)
    kind = "cubic" if mode == "bicubic" else "linear"
    return _resize_gather(x, out_sp, kind, align_corners, channel_last)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def _pair(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


def _pads4(paddings):
    """[ph, pw] or [p0, p1, p2, p3] as (top, left, bottom, right), the
    reference's reading."""
    p = list(paddings) if isinstance(paddings, (list, tuple)) \
        else [paddings] * 2
    if len(p) == 2:
        p = [p[0], p[1], p[0], p[1]]
    return [int(v) for v in p]


@amp_op("unfold")
def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: [N, C, H, W] -> [N, C * kh * kw, L]."""
    p = _pads4(paddings)
    v = F.pad(x, (p[1], p[3], p[0], p[2]))
    return F.unfold(v, _pair(kernel_sizes), dilation=_pair(dilations),
                    stride=_pair(strides))


@amp_op("fold")
def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, the adjoint of :func:`unfold`: summed into the padded image,
    then cropped."""
    out_sz = _pair(output_sizes)
    p = _pads4(paddings)
    full = F.fold(x, (out_sz[0] + p[0] + p[2], out_sz[1] + p[1] + p[3]),
                  _pair(kernel_sizes), dilation=_pair(dilations),
                  stride=_pair(strides))
    return full[..., p[0]:p[0] + out_sz[0], p[1]:p[1] + out_sz[1]]


def class_center_sample(label, num_classes, num_samples, group=None):
    """PartialFC class-center sampling: every positive class in ``label``
    kept, topped up with uniformly sampled negatives to ``num_samples``,
    labels remapped into the sorted sampled set. Returns ``(remapped_label,
    sampled_class_center)`` on ``label``'s device. Eager: the output size
    depends on the data."""
    dev = label.device if isinstance(label, torch.Tensor) else \
        torch.device("cpu")
    lv = (label.detach().cpu().numpy() if isinstance(label, torch.Tensor)
          else np.asarray(label))
    pos = np.unique(lv)
    if pos.size >= num_samples:
        sampled = pos
    else:
        neg_pool = np.setdiff1d(np.arange(num_classes, dtype=pos.dtype), pos,
                                assume_unique=True)
        perm = torch.randperm(neg_pool.size, generator=default_generator
                              .generator("cpu")).numpy()
        extra = neg_pool[perm[: num_samples - pos.size]]
        sampled = np.sort(np.concatenate([pos, extra]))
    remapped = np.searchsorted(sampled, lv).astype(lv.dtype)
    return (torch.as_tensor(remapped, device=dev),
            torch.as_tensor(sampled, device=dev))
