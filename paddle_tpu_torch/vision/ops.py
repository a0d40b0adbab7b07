"""``paddle.vision.ops``, the detection operators (port of
``paddle_tpu/vision/ops.py``).

The rules are the reference's, which differ from upstream Paddle's CUDA
kernels in places:

- Bilinear sampling (``roi_align``, ``deform_conv2d``) clamps each sample
  point into ``[0, H - 1] x [0, W - 1]`` and reads the image there; it does
  not read zeros outside. ``roi_align``'s ``sampling_ratio <= 0`` means a
  fixed 2 x 2 samples a bin (upstream: ``ceil(roi_h / out_h)``).
- The RoI family maps RoIs to images through ``boxes_num``: RoI ``i``
  belongs to the last image whose first RoI is at or before ``i``.
- The gradient reaches ``x`` through the gathers (and ``deform_conv2d``'s
  offsets and mask through the bilinear weights); ``roi_pool``'s max and
  ``psroi_pool``'s average are differentiable in ``x``. A max shares its
  gradient evenly among tied elements, as the reference's does.

The RoI family, ``box_coder``, ``yolo_box``, ``yolo_loss`` and
``deform_conv2d`` are torch ops on the device of their inputs, each under
:func:`amp_op` with the reference's op name. The selections the reference
runs on the host in numpy stay there (``matrix_nms``,
``distribute_fpn_proposals``, ``generate_proposals``' ordering and
decoding, ``prior_box``); ``nms`` computes its IoU matrix and thresholds
it on the device of ``boxes`` and reads that one boolean matrix back for
the greedy sweep. Results go to the device of the inputs; ``prior_box``'s
grid and ``read_file``'s bytes go to the current place. Ordering: the
reference orders scores with numpy's ``argsort`` (an unstable sort); the
port sorts stably, so among equal scores the lower index comes first. On
scores without ties the two orders are the same.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.place import _current_place
from ..nn import Layer
from ..nn.functional._op import amp_op

__all__ = ["yolo_loss", "yolo_box", "prior_box", "box_coder",
           "deform_conv2d", "DeformConv2D", "distribute_fpn_proposals",
           "generate_proposals", "read_file", "decode_jpeg", "psroi_pool",
           "PSRoIPool", "roi_pool", "RoIPool", "roi_align", "RoIAlign",
           "nms", "matrix_nms"]

# elements of one gathered chunk of the RoI family (a chunk of RoIs times
# their sample points times the channels): bounds the temporaries at
# about 256 MB a corner in fp32
_CHUNK_ELEMS = 1 << 26


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _host(t, dtype):
    """A tensor, array or list as a numpy array of ``dtype``."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype)


def _device_of(*ts):
    for t in ts:
        if isinstance(t, torch.Tensor):
            return t.device
    return _current_place()


# ---------------------------------------------------------------------------
# RoI family
# ---------------------------------------------------------------------------


def _roi_to_batch(boxes, boxes_num):
    """Image index for each RoI from per-image counts."""
    bn = boxes_num.to(boxes.device).long()
    starts = torch.cumsum(bn, 0) - bn
    ar = torch.arange(boxes.shape[0], device=boxes.device)
    return (ar[:, None] >= starts[None, :]).long().sum(1) - 1


def _clip(v, lo=None, hi=None):
    """``jnp.clip`` / ``jnp.maximum`` / ``jnp.minimum`` with their
    gradient: a value on a bound passes half (``torch.clamp`` would pass
    all of it)."""
    if lo is not None:
        v = torch.maximum(v, v.new_tensor(lo))
    if hi is not None:
        v = torch.minimum(v, v.new_tensor(hi))
    return v


def _bilinear_weights(v, size):
    """Clamped sample coordinates ``v`` on an axis of ``size``: the two
    neighbours' indices and the fraction toward the second."""
    v = _clip(v, 0.0, size - 1.0)
    v0 = torch.floor(v).long()
    v1 = (v0 + 1).clamp(max=size - 1)
    return v0, v1, v - v0


def _roi_chunks(n_rois, per_roi):
    step = max(1, _CHUNK_ELEMS // max(per_roi, 1))
    return range(0, n_rois, step), step


def _roi_align_chunk(xt, b, box, oh, ow, spatial_scale, ratio, aligned):
    """xt [N, H, W, C]; b [R]; box [R, 4] -> [R, C, oh, ow]."""
    H, W = xt.shape[1], xt.shape[2]
    off = 0.5 if aligned else 0.0
    x1 = box[:, 0] * spatial_scale - off
    y1 = box[:, 1] * spatial_scale - off
    x2 = box[:, 2] * spatial_scale - off
    y2 = box[:, 3] * spatial_scale - off
    lo = 1e-4 if aligned else 1.0
    rw = torch.clamp(x2 - x1, min=lo)
    rh = torch.clamp(y2 - y1, min=lo)
    bin_h = rh / oh
    bin_w = rw / ow
    dev = xt.device
    fr = torch.arange(ratio, device=dev, dtype=box.dtype)
    # the sample points of each bin: [R, out, ratio] flattened a row
    iy = (torch.arange(oh, device=dev, dtype=box.dtype)[None, :, None]
          * bin_h[:, None, None] + y1[:, None, None]
          + (fr[None, None, :] + 0.5) * bin_h[:, None, None] / ratio)
    ix = (torch.arange(ow, device=dev, dtype=box.dtype)[None, :, None]
          * bin_w[:, None, None] + x1[:, None, None]
          + (fr[None, None, :] + 0.5) * bin_w[:, None, None] / ratio)
    y0, y1_, fy = _bilinear_weights(iy.reshape(len(b), -1), H)
    x0, x1_, fx = _bilinear_weights(ix.reshape(len(b), -1), W)
    bb = b[:, None, None]
    Y0, Y1 = y0[:, :, None], y1_[:, :, None]
    X0, X1 = x0[:, None, :], x1_[:, None, :]
    fy = fy[:, :, None, None].to(xt.dtype)
    fx = fx[:, None, :, None].to(xt.dtype)
    vals = (xt[bb, Y0, X0] * (1 - fy) * (1 - fx)
            + xt[bb, Y0, X1] * (1 - fy) * fx
            + xt[bb, Y1, X0] * fy * (1 - fx)
            + xt[bb, Y1, X1] * fy * fx)          # [R, oh*r, ow*r, C]
    R, C = len(b), xt.shape[3]
    vals = vals.reshape(R, oh, ratio, ow, ratio, C).mean(dim=(2, 4))
    return vals.permute(0, 3, 1, 2)


@amp_op("roi_align")
def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    """RoIAlign. x [N, C, H, W]; boxes [R, 4] (x1, y1, x2, y2 in input
    coordinates); boxes_num [N] -> [R, C, oh, ow]. Each bin averages
    ``ratio x ratio`` clamped bilinear samples (``ratio`` 2 where
    ``sampling_ratio <= 0``)."""
    oh, ow = _pair(output_size)
    ratio = sampling_ratio if sampling_ratio > 0 else 2
    b = _roi_to_batch(boxes, boxes_num)
    xt = x.permute(0, 2, 3, 1)
    starts, step = _roi_chunks(boxes.shape[0],
                               oh * ow * ratio * ratio * x.shape[1])
    parts = [_roi_align_chunk(xt, b[s:s + step], boxes[s:s + step], oh, ow,
                              spatial_scale, ratio, aligned)
             for s in starts]
    if not parts:
        return x.new_zeros((0, x.shape[1], oh, ow))
    return torch.cat(parts, 0)


class RoIAlign(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self._output_size = output_size
        self._spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_align(x, boxes, boxes_num, self._output_size,
                         self._spatial_scale)


def _segment_max(src, index, n, dim):
    """Max of ``src`` over the positions of each of ``n`` bins along
    ``dim`` (``index`` gives a position's bin, ``n`` for none); an empty
    bin holds -inf."""
    shape = list(src.shape)
    shape[dim] = n + 1
    out = src.new_full(shape, -math.inf)
    out = out.scatter_reduce(dim, index.expand_as(src), src, "amax",
                             include_self=False)
    return out.narrow(dim, 0, n)


@amp_op("roi_pool")
def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0, name=None):
    """RoIPool: the max over each quantized bin (rounded box corners, bins
    of ``floor((p - start) * out / extent)``); an empty bin gives 0."""
    oh, ow = _pair(output_size)
    N, C, H, W = x.shape
    b = _roi_to_batch(boxes, boxes_num)
    q = torch.round(boxes * spatial_scale).to(torch.int64)
    x1, y1, x2, y2 = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    rh = torch.clamp(y2 - y1 + 1, min=1)
    rw = torch.clamp(x2 - x1 + 1, min=1)
    ys = torch.arange(H, device=x.device)
    xs = torch.arange(W, device=x.device)
    bin_y = torch.div((ys[None] - y1[:, None]) * oh, rh[:, None],
                      rounding_mode="floor").clamp(0, oh - 1)
    bin_x = torch.div((xs[None] - x1[:, None]) * ow, rw[:, None],
                      rounding_mode="floor").clamp(0, ow - 1)
    in_y = (ys[None] >= y1[:, None]) & (ys[None] <= y2[:, None])
    in_x = (xs[None] >= x1[:, None]) & (xs[None] <= x2[:, None])
    bin_y = torch.where(in_y, bin_y, oh)               # [R, H]; oh: none
    bin_x = torch.where(in_x, bin_x, ow)               # [R, W]
    starts, step = _roi_chunks(boxes.shape[0], C * H * W)
    parts = []
    for s in starts:
        feat = x[b[s:s + step]]                        # [r, C, H, W]
        r = feat.shape[0]
        rows = _segment_max(feat, bin_y[s:s + step].view(r, 1, H, 1),
                            oh, 2)                     # [r, C, oh, W]
        out = _segment_max(rows, bin_x[s:s + step].view(r, 1, 1, W),
                           ow, 3)                      # [r, C, oh, ow]
        parts.append(torch.where(torch.isfinite(out), out,
                                 out.new_zeros(())))
    if not parts:
        return x.new_zeros((0, C, oh, ow))
    return torch.cat(parts, 0)


class RoIPool(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self._output_size = output_size
        self._spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_pool(x, boxes, boxes_num, self._output_size,
                        self._spatial_scale)


@amp_op("psroi_pool")
def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
               name=None):
    """Position-sensitive RoI pooling: input channels C = out_c * oh * ow;
    bin (i, j) averages its own channel group over the positions of the
    spatial bin (an empty bin gives 0)."""
    oh, ow = _pair(output_size)
    N, C, H, W = x.shape
    out_c = C // (oh * ow)
    b = _roi_to_batch(boxes, boxes_num)
    bx = boxes.to(torch.float32)
    x1 = bx[:, 0] * spatial_scale
    y1 = bx[:, 1] * spatial_scale
    rw = torch.clamp((bx[:, 2] - bx[:, 0]) * spatial_scale, min=0.1)
    rh = torch.clamp((bx[:, 3] - bx[:, 1]) * spatial_scale, min=0.1)
    bh, bw = rh / oh, rw / ow
    ys = torch.arange(H, device=x.device, dtype=torch.float32)
    xs = torch.arange(W, device=x.device, dtype=torch.float32)
    iy = torch.clamp(torch.floor((ys[None] - y1[:, None]) / bh[:, None]),
                     0, oh - 1)
    ix = torch.clamp(torch.floor((xs[None] - x1[:, None]) / bw[:, None]),
                     0, ow - 1)
    ar_h = torch.arange(oh, device=x.device, dtype=torch.float32)
    ar_w = torch.arange(ow, device=x.device, dtype=torch.float32)
    my = ((iy[:, :, None] == ar_h) & (ys[None, :, None] >= y1[:, None, None])
          & (ys[None, :, None] <= (y1 + rh)[:, None, None]))   # [R, H, oh]
    mx = ((ix[:, :, None] == ar_w) & (xs[None, :, None] >= x1[:, None, None])
          & (xs[None, :, None] <= (x1 + rw)[:, None, None]))   # [R, W, ow]
    den = torch.clamp(my.sum(1).to(x.dtype)[:, :, None]
                      * mx.sum(1).to(x.dtype)[:, None, :], min=1.0)
    feat = x.reshape(N, out_c, oh, ow, H, W)
    out = x.new_zeros((boxes.shape[0], out_c, oh, ow))
    for n in range(N):
        sel = torch.nonzero(b == n).flatten()
        if sel.numel() == 0:
            continue
        # sum over w inside bin j, then over h inside bin i
        cols = torch.einsum("cijhw,rwj->rcijh", feat[n],
                            mx[sel].to(x.dtype))
        num = torch.einsum("rcijh,rhi->rcij", cols, my[sel].to(x.dtype))
        out = out.index_put((sel,), num / den[sel][:, None])
    return out


class PSRoIPool(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self._output_size = output_size
        self._spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return psroi_pool(x, boxes, boxes_num, self._output_size,
                          self._spatial_scale)


# ---------------------------------------------------------------------------
# NMS family
# ---------------------------------------------------------------------------


def _iou_matrix(boxes):
    """IoU of every pair of boxes [n, 4], a torch tensor (on its device) or
    a numpy array, in the reference's arithmetic."""
    if isinstance(boxes, torch.Tensor):
        def pos(v):
            return torch.clamp(v, min=0.0)
        lo, hi = torch.maximum, torch.minimum
    else:
        def pos(v):
            return np.maximum(v, 0)
        lo, hi = np.maximum, np.minimum
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = pos(x2 - x1) * pos(y2 - y1)
    xx1 = lo(x1[:, None], x1[None, :])
    yy1 = lo(y1[:, None], y1[None, :])
    xx2 = hi(x2[:, None], x2[None, :])
    yy2 = hi(y2[:, None], y2[None, :])
    inter = pos(xx2 - xx1) * pos(yy2 - yy1)
    union = area[:, None] + area[None, :] - inter
    if isinstance(boxes, torch.Tensor):
        return inter / torch.clamp(union, min=1e-10)
    return inter / np.maximum(union, 1e-10)


def _descending(s):
    """Indices of ``s`` (numpy) by descending score; stable, so equal
    scores keep their index order."""
    return np.argsort(-s, kind="stable")


def _greedy_keep(order, over):
    """The reference's sweep: in ``order``, keep a box that no kept box
    suppressed, then suppress what ``over`` (an [n, n] boolean matrix)
    marks in its row."""
    keep = []
    suppressed = np.zeros(over.shape[0], bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        suppressed |= over[i]
        suppressed[i] = True
    return np.asarray(keep, np.int64)


def _nms_keep(boxes, iou_threshold, scores=None, category_idxs=None):
    """Kept indices (numpy int64, in score order) of ``boxes`` [n, 4], a
    float32 tensor on any device: the IoU matrix and its threshold on that
    device, the boolean matrix read back once, the sweep on the host."""
    n = boxes.shape[0]
    s = (np.arange(n)[::-1].astype(np.float32) if scores is None
         else _host(scores, np.float32))
    order = _descending(s)
    over = _iou_matrix(boxes) > iou_threshold
    if category_idxs is not None:
        cats = torch.as_tensor(category_idxs, device=boxes.device)
        over &= cats[:, None] == cats[None, :]
    return _greedy_keep(order, over.cpu().numpy())


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None, name=None):
    """Hard NMS: the kept indices (int64, on the device of ``boxes``) in
    descending score order (index order without ``scores``); with
    ``category_idxs`` a box suppresses only boxes of its category."""
    dev = _device_of(boxes)
    b = torch.as_tensor(boxes, device=dev).to(torch.float32)
    keep = _nms_keep(b, iou_threshold, scores, category_idxs)
    if top_k is not None:
        keep = keep[:top_k]
    return torch.from_numpy(keep).to(dev)


def matrix_nms(bboxes, scores, score_threshold, post_threshold,
               nms_top_k, keep_top_k, use_gaussian=False, gaussian_sigma=2.0,
               background_label=0, normalized=True, return_index=False,
               return_rois_num=True, name=None):
    """Matrix NMS (SOLOv2): each box's score decays by its worst overlap
    with a higher-scored box of its class, compensated by that box's own
    worst overlap; boxes above ``post_threshold`` are kept, up to
    ``keep_top_k`` an image. On the host, as the reference; the rows
    [label, score, x1, y1, x2, y2], the indices and the per-image counts go
    to the device of ``bboxes``."""
    dev = _device_of(bboxes, scores)
    b = _host(bboxes, np.float32)
    sc = _host(scores, np.float32)
    outs, idxs, nums = [], [], []
    for n in range(b.shape[0]):
        per_img, per_idx = [], []
        for c in range(sc.shape[1]):
            if c == background_label:
                continue
            s = sc[n, c]
            sel = np.nonzero(s > score_threshold)[0]
            if sel.size == 0:
                continue
            order = sel[_descending(s[sel])][:nms_top_k]
            boxes_c = b[n, order]
            scores_c = s[order]
            iou = np.triu(_iou_matrix(boxes_c), k=1)
            max_iou = iou.max(axis=0, initial=0.0)
            if use_gaussian:
                decay = np.exp(-(iou ** 2 - max_iou[:, None] ** 2)
                               / gaussian_sigma).min(axis=0, initial=1.0)
            else:
                decay = ((1 - iou) / np.maximum(1 - max_iou[:, None],
                                                1e-10)).min(axis=0,
                                                            initial=1.0)
            dec_scores = scores_c * decay
            for i in np.nonzero(dec_scores > post_threshold)[0]:
                per_img.append([c, dec_scores[i], *boxes_c[i]])
                per_idx.append(order[i])
        # the reference sorts the rows and cuts the indices unsorted
        per_img.sort(key=lambda r: -r[1])
        per_img = per_img[:keep_top_k]
        per_idx = per_idx[:keep_top_k]
        nums.append(len(per_img))
        outs.extend(per_img)
        idxs.extend(per_idx)
    out = torch.from_numpy(np.asarray(outs, np.float32).reshape(-1, 6)).to(
        dev)
    res = [out]
    if return_index:
        res.append(torch.from_numpy(np.asarray(idxs, np.int64)).to(dev))
    if return_rois_num:
        res.append(torch.from_numpy(np.asarray(nums, np.int32)).to(dev))
    return tuple(res) if len(res) > 1 else out


# ---------------------------------------------------------------------------
# Anchors / box coding / YOLO
# ---------------------------------------------------------------------------


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, min_max_aspect_ratios_order=False,
              name=None):
    """SSD prior (anchor) boxes [H, W, P, 4] (normalized corners) and their
    variances, for the feature map ``input`` over ``image`` (only their
    shapes are read), built on the host and placed on the current
    place."""
    H, W = input.shape[2], input.shape[3]
    img_h, img_w = image.shape[2], image.shape[3]
    step_w = steps[0] or img_w / W
    step_h = steps[1] or img_h / H
    ars = [1.0]
    for ar in aspect_ratios:
        if all(abs(ar - a) > 1e-6 for a in ars):
            ars.append(ar)
            if flip:
                ars.append(1.0 / ar)
    sizes = []
    for k, ms in enumerate(min_sizes):
        for ar in ars:
            sizes.append((ms * math.sqrt(ar), ms / math.sqrt(ar)))
        if max_sizes:
            bs = math.sqrt(ms * max_sizes[k])
            sizes.append((bs, bs))
    cx = (np.arange(W) + offset) * step_w
    cy = (np.arange(H) + offset) * step_h
    boxes = np.zeros((H, W, len(sizes), 4), np.float32)
    for p, (bw, bh) in enumerate(sizes):
        boxes[:, :, p, 0] = (cx[None, :] - bw / 2) / img_w
        boxes[:, :, p, 1] = (cy[:, None] - bh / 2) / img_h
        boxes[:, :, p, 2] = (cx[None, :] + bw / 2) / img_w
        boxes[:, :, p, 3] = (cy[:, None] + bh / 2) / img_h
    if clip:
        boxes = np.clip(boxes, 0.0, 1.0)
    var = np.broadcast_to(np.asarray(variance, np.float32),
                          boxes.shape).copy()
    dev = _current_place()
    return torch.from_numpy(boxes).to(dev), torch.from_numpy(var).to(dev)


@amp_op("box_coder")
def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              axis=0, name=None):
    """Encode boxes [R, 4] against priors [P, 4] into deltas [R, P, 4], or
    decode deltas [R, P, 4] at the priors (broadcast on ``axis``) into
    boxes. ``prior_box_var`` is [P, 4], or one [4] row for every prior in
    decoding."""
    pb, tb = prior_box, target_box
    pv = torch.as_tensor(prior_box_var, dtype=tb.dtype, device=tb.device)
    norm = 0.0 if box_normalized else 1.0
    pw = pb[..., 2] - pb[..., 0] + norm
    ph = pb[..., 3] - pb[..., 1] + norm
    pcx = pb[..., 0] + pw * 0.5
    pcy = pb[..., 1] + ph * 0.5
    if code_type == "encode_center_size":
        tw = tb[..., 2] - tb[..., 0] + norm
        th = tb[..., 3] - tb[..., 1] + norm
        tcx = tb[..., 0] + tw * 0.5
        tcy = tb[..., 1] + th * 0.5
        out = torch.stack([
            (tcx[:, None] - pcx[None, :]) / pw[None, :],
            (tcy[:, None] - pcy[None, :]) / ph[None, :],
            torch.log(tw[:, None] / pw[None, :]),
            torch.log(th[:, None] / ph[None, :])], dim=-1)
        return out / pv[None, :, :]
    d = tb * pv[None, :, :] if pv.ndim == 2 else tb * pv
    if axis == 0:
        pw_, ph_, pcx_, pcy_ = (v[None, :] for v in (pw, ph, pcx, pcy))
    else:
        pw_, ph_, pcx_, pcy_ = (v[:, None] for v in (pw, ph, pcx, pcy))
    cx = d[..., 0] * pw_ + pcx_
    cy = d[..., 1] * ph_ + pcy_
    w = torch.exp(d[..., 2]) * pw_
    h = torch.exp(d[..., 3]) * ph_
    return torch.stack([cx - w * 0.5, cy - h * 0.5,
                        cx + w * 0.5 - norm, cy + h * 0.5 - norm], -1)


@amp_op("yolo_box")
def yolo_box(x, img_size, anchors, class_num, conf_thresh, downsample_ratio,
             clip_bbox=True, name=None, scale_x_y=1.0, iou_aware=False,
             iou_aware_factor=0.5):
    """Decode a YOLOv3 head [N, na * (5 + classes), H, W] into boxes
    [N, na * H * W, 4] (image pixels) and scores [N, na * H * W, classes];
    a cell whose objectness is at most ``conf_thresh`` gives zeros.
    ``iou_aware`` is not implemented, as in the reference."""
    if iou_aware:
        raise NotImplementedError(
            "iou_aware yolo_box (extra per-anchor IoU channels) is not "
            "implemented; pass iou_aware=False")
    N, C, H, W = x.shape
    na = len(anchors) // 2
    an = torch.tensor(anchors, dtype=torch.float32,
                      device=x.device).reshape(na, 2)
    pred = x.reshape(N, na, 5 + class_num, H, W)
    ar_w = torch.arange(W, device=x.device)
    ar_h = torch.arange(H, device=x.device)
    gx = (torch.sigmoid(pred[:, :, 0]) * scale_x_y
          - (scale_x_y - 1) / 2 + ar_w[None, None, None, :])
    gy = (torch.sigmoid(pred[:, :, 1]) * scale_x_y
          - (scale_x_y - 1) / 2 + ar_h[None, None, :, None])
    in_w, in_h = W * downsample_ratio, H * downsample_ratio
    bw = torch.exp(pred[:, :, 2]) * an[None, :, 0, None, None] / in_w
    bh = torch.exp(pred[:, :, 3]) * an[None, :, 1, None, None] / in_h
    cx = gx / W
    cy = gy / H
    conf = torch.sigmoid(pred[:, :, 4])
    probs = torch.sigmoid(pred[:, :, 5:]) * conf[:, :, None]
    mask = (conf > conf_thresh).to(x.dtype)
    imgv = img_size.to(x.device)
    imw = imgv[:, 1].to(torch.float32)[:, None, None, None]
    imh = imgv[:, 0].to(torch.float32)[:, None, None, None]
    x1 = (cx - bw / 2) * imw
    y1 = (cy - bh / 2) * imh
    x2 = (cx + bw / 2) * imw
    y2 = (cy + bh / 2) * imh
    if clip_bbox:
        x1, x2 = (torch.minimum(_clip(v, 0.0), imw - 1) for v in (x1, x2))
        y1, y2 = (torch.minimum(_clip(v, 0.0), imh - 1) for v in (y1, y2))
    boxes = torch.stack([x1, y1, x2, y2], -1) * mask[..., None]
    boxes = boxes.permute(0, 1, 3, 4, 2).reshape(N, -1, 4)
    scores = (probs * mask[:, :, None]).permute(0, 1, 3, 4, 2)
    return boxes, scores.reshape(N, -1, class_num)


def _bce(logit, target):
    return (_clip(logit, 0.0) - logit * target
            + torch.log1p(torch.exp(-logit.abs())))


@amp_op("yolo_loss")
def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    """YOLOv3 training loss [N] of one head: coordinate, objectness and
    class terms over the ground truths (``gt_box`` [N, B, 4] as normalized
    cx, cy, w, h; a row of zero width is padding) whose best anchor by
    width-height IoU over the full anchor set is one of this head's.
    Predictions overlapping any ground truth above ``ignore_thresh`` add no
    objectness loss as negatives; ``gt_score`` weights objectness targets
    and class terms (mixup); ``use_label_smooth`` smooths the class
    targets by ``1 / class_num``."""
    N, C, H, W = x.shape
    dev = x.device
    na = len(anchor_mask)
    an_all = torch.tensor(anchors, dtype=torch.float32,
                          device=dev).reshape(-1, 2)
    mask_vec = torch.tensor(anchor_mask, device=dev)
    an = an_all[mask_vec]
    pred = x.reshape(N, na, 5 + class_num, H, W)
    in_w, in_h = W * downsample_ratio, H * downsample_ratio
    px = torch.sigmoid(pred[:, :, 0])
    py = torch.sigmoid(pred[:, :, 1])
    pw = pred[:, :, 2]
    ph = pred[:, :, 3]
    pobj = pred[:, :, 4]
    pcls = pred[:, :, 5:]

    gb = gt_box.to(dev)
    B = gb.shape[1]
    gcx, gcy = gb[..., 0], gb[..., 1]
    gw, gh = gb[..., 2], gb[..., 3]
    gi = torch.clamp((gcx * W).to(torch.int32), 0, W - 1).long()
    gj = torch.clamp((gcy * H).to(torch.int32), 0, H - 1).long()
    gwh = torch.stack([gw * in_w, gh * in_h], -1)               # [N, B, 2]
    inter = torch.minimum(gwh[:, :, None, :], an_all[None, None]).prod(-1)
    union = (gwh.prod(-1)[:, :, None] + an_all.prod(-1)[None, None]
             - inter)
    iou_a = inter / torch.clamp(union, min=1e-10)
    best = torch.argmax(iou_a, dim=-1)                          # [N, B]
    hit = best[..., None] == mask_vec[None, None]
    local = torch.argmax(hit.to(torch.int32), dim=-1)
    valid = hit.any(-1) & (gw > 0)

    tx = gcx * W - gi
    ty = gcy * H - gj
    tw = torch.log(_clip(gwh[..., 0], 1e-4) / an[local][..., 0])
    th = torch.log(_clip(gwh[..., 1], 1e-4) / an[local][..., 1])
    nidx = torch.arange(N, device=dev)[:, None].expand(N, B)

    def gather(p):
        return p[nidx, local, gj, gi]

    lw = 2.0 - gw * gh
    vz = valid.to(torch.float32)
    loss_xy = (vz * lw * ((gather(px) - tx) ** 2
                          + (gather(py) - ty) ** 2)).sum(-1)
    loss_wh = (vz * lw * ((gather(pw) - tw) ** 2
                          + (gather(ph) - th) ** 2)).sum(-1)
    gt_w = vz if gt_score is None else vz * gt_score.to(dev)
    flat = ((nidx * na + local) * H + gj) * W + gi
    obj_target = torch.zeros(N * na * H * W, device=dev).scatter_reduce(
        0, flat.reshape(-1), gt_w.reshape(-1).to(torch.float32), "amax",
        include_self=True).reshape(N, na, H, W)
    # the ignore mask: negatives whose predicted box overlaps any ground
    # truth above the threshold add no objectness loss
    pbx = (torch.sigmoid(pred[:, :, 0])
           + torch.arange(W, device=dev)[None, None, None, :]) / W
    pby = (torch.sigmoid(pred[:, :, 1])
           + torch.arange(H, device=dev)[None, None, :, None]) / H
    pbw = torch.exp(_clip(pw, -10.0, 10.0)) \
        * an[None, :, 0, None, None] / in_w
    pbh = torch.exp(_clip(ph, -10.0, 10.0)) \
        * an[None, :, 1, None, None] / in_h
    px1, px2 = pbx - pbw / 2, pbx + pbw / 2
    py1, py2 = pby - pbh / 2, pby + pbh / 2
    gx1 = (gcx - gw / 2)[:, None, None, None, :]
    gx2 = (gcx + gw / 2)[:, None, None, None, :]
    gy1 = (gcy - gh / 2)[:, None, None, None, :]
    gy2 = (gcy + gh / 2)[:, None, None, None, :]
    ix = torch.clamp(torch.minimum(px2[..., None], gx2)
                     - torch.maximum(px1[..., None], gx1), min=0)
    iy = torch.clamp(torch.minimum(py2[..., None], gy2)
                     - torch.maximum(py1[..., None], gy1), min=0)
    inter_a = ix * iy
    union_a = ((pbw * pbh)[..., None]
               + (gw * gh)[:, None, None, None, :] - inter_a)
    best_iou = torch.where((gw > 0)[:, None, None, None, :],
                           inter_a / torch.clamp(union_a, min=1e-10),
                           inter_a.new_zeros(())).amax(-1)
    noobj_w = (best_iou < ignore_thresh).to(torch.float32)
    obj_w = torch.where(obj_target > 0, noobj_w.new_ones(()), noobj_w)
    loss_obj = (obj_w * _bce(pobj, obj_target)).sum((1, 2, 3))
    smooth = 1.0 / class_num if use_label_smooth else 0.0
    onehot = (gt_label.to(dev)[..., None]
              == torch.arange(class_num, device=dev)).to(torch.float32)
    cls_t = onehot * (1 - smooth) + smooth / class_num
    pc = pcls[nidx, local, :, gj, gi]                        # [N, B, cls]
    loss_cls = (gt_w[..., None] * _bce(pc, cls_t)).sum((-1, -2))
    return loss_xy + loss_wh + loss_obj + loss_cls


# ---------------------------------------------------------------------------
# Deformable conv
# ---------------------------------------------------------------------------


@amp_op("deform_conv2d")
def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """Deformable convolution, v1 (``mask`` None) and v2: each tap of the
    kernel reads the zero-padded input at its offset-shifted position by
    clamped bilinear sampling (``offset`` [N, dg * KH * KW * 2, OH, OW],
    y before x for each tap), times the tap's ``mask`` value, and the
    columns contract with ``weight`` by groups."""
    st, pd, dl = _pair(stride), _pair(padding), _pair(dilation)
    N, C, H, W = x.shape
    OC, ICg, KH, KW = weight.shape
    dg = deformable_groups
    OH = (H + 2 * pd[0] - dl[0] * (KH - 1) - 1) // st[0] + 1
    OW = (W + 2 * pd[1] - dl[1] * (KW - 1) - 1) // st[1] + 1
    xp = torch.nn.functional.pad(x, (pd[1], pd[1], pd[0], pd[0]))
    Hp, Wp = xp.shape[2], xp.shape[3]
    dev = x.device
    oy = torch.arange(OH, device=dev) * st[0]
    ox = torch.arange(OW, device=dev) * st[1]
    ky = torch.arange(KH, device=dev) * dl[0]
    kx = torch.arange(KW, device=dev) * dl[1]
    base_y = oy[:, None, None, None] + ky[None, None, :, None]
    base_x = ox[None, :, None, None] + kx[None, None, None, :]
    off = offset.reshape(N, dg, KH * KW, 2, OH, OW)
    off_y = off[:, :, :, 0].reshape(N, dg, KH, KW, OH, OW).permute(
        0, 1, 4, 5, 2, 3)
    off_x = off[:, :, :, 1].reshape(N, dg, KH, KW, OH, OW).permute(
        0, 1, 4, 5, 2, 3)
    sy = base_y[None, None] + off_y            # [N, dg, OH, OW, KH, KW]
    sx = base_x[None, None] + off_x
    y0, y1, fy = _bilinear_weights(sy, Hp)
    x0, x1, fx = _bilinear_weights(sx, Wp)
    cpg = C // dg
    img = xp.reshape(N, dg, cpg, Hp * Wp)
    P = OH * OW * KH * KW

    def tap(yi, xi):
        idx = (yi * Wp + xi).reshape(N, dg, 1, P).expand(N, dg, cpg, P)
        return torch.gather(img, 3, idx).reshape(N, dg, cpg, OH, OW, KH, KW)

    fy = fy[:, :, None].to(x.dtype)
    fx = fx[:, :, None].to(x.dtype)
    cols = (tap(y0, x0) * (1 - fy) * (1 - fx)
            + tap(y0, x1) * (1 - fy) * fx
            + tap(y1, x0) * fy * (1 - fx)
            + tap(y1, x1) * fy * fx)           # [N, dg, cpg, OH, OW, KH, KW]
    if mask is not None:
        mk = mask.reshape(N, dg, KH, KW, OH, OW).permute(0, 1, 4, 5, 2, 3)
        cols = cols * mk[:, :, None]
    cols = cols.reshape(N, groups, C // groups, OH, OW, KH, KW)
    wv_g = weight.reshape(groups, OC // groups, ICg, KH, KW)
    out = torch.einsum("ngcxykl,gockl->ngoxy", cols, wv_g)
    out = out.reshape(N, OC, OH, OW)
    if bias is not None:
        out = out + bias[None, :, None, None]
    return out


class DeformConv2D(Layer):
    """The deformable convolution layer: ``weight`` [out, in / groups, KH,
    KW] and ``bias`` [out] (none with ``bias_attr=False``);
    ``forward(x, offset, mask=None)``."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        ks = _pair(kernel_size)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._deformable_groups = deformable_groups
        self._groups = groups
        self.weight = self.create_parameter(
            shape=[out_channels, in_channels // groups, ks[0], ks[1]],
            attr=weight_attr)
        self.bias = None if bias_attr is False else self.create_parameter(
            shape=[out_channels], attr=bias_attr, is_bias=True)

    def forward(self, x, offset, mask=None):
        return deform_conv2d(x, offset, self.weight, self.bias,
                             stride=self._stride, padding=self._padding,
                             dilation=self._dilation,
                             deformable_groups=self._deformable_groups,
                             groups=self._groups, mask=mask)


# ---------------------------------------------------------------------------
# FPN / proposals / files
# ---------------------------------------------------------------------------


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, pixel_offset=False,
                             rois_num=None, name=None):
    """Assign RoIs to FPN levels by scale (``floor(log2(sqrt(wh) /
    refer_scale)) + refer_level``, clipped to the levels), on the host as
    the reference: (the RoIs of each level, the index that restores the
    input order[, each level's per-image counts])."""
    dev = _device_of(fpn_rois)
    rois = _host(fpn_rois, np.float32)
    off = 1.0 if pixel_offset else 0.0
    w = np.maximum(rois[:, 2] - rois[:, 0] + off, 0)
    h = np.maximum(rois[:, 3] - rois[:, 1] + off, 0)
    scale = np.sqrt(w * h)
    lvl = np.floor(np.log2(scale / refer_scale + 1e-8)) + refer_level
    lvl = np.clip(lvl, min_level, max_level).astype(np.int64)
    if rois_num is not None:
        rn = _host(rois_num, np.int64)
        img_of = np.repeat(np.arange(len(rn)), rn)
    else:
        rn = np.asarray([len(rois)], np.int64)
        img_of = np.zeros(len(rois), np.int64)
    outs, idxs, nums = [], [], []
    for L in range(min_level, max_level + 1):
        sel = np.nonzero(lvl == L)[0]
        outs.append(torch.from_numpy(rois[sel]).to(dev))
        idxs.extend(sel.tolist())
        per_img = np.bincount(img_of[sel], minlength=len(rn))
        nums.append(torch.from_numpy(per_img.astype(np.int32)).to(dev))
    restore = np.argsort(np.asarray(idxs, np.int64))
    res = [outs, torch.from_numpy(restore).to(dev)]
    if rois_num is not None:
        res.append(nums)
    return tuple(res)


def generate_proposals(scores, bbox_deltas, img_size, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       pixel_offset=False, return_rois_num=False,
                       name=None):
    """RPN proposals: for each image, the ``pre_nms_top_n`` best anchors
    by score, their deltas decoded and clipped to the image, boxes under
    ``min_size`` dropped, then NMS at ``nms_thresh`` and the first
    ``post_nms_top_n`` kept. The ordering and decoding run on the host as
    the reference's; the NMS IoU on the device of ``scores``."""
    dev = _device_of(scores)
    sc = _host(scores, np.float32)
    bd = _host(bbox_deltas, np.float32)
    im = _host(img_size, np.float32)
    an = _host(anchors, np.float32).reshape(-1, 4)
    var = _host(variances, np.float32).reshape(-1, 4)
    all_rois, all_scores, nums = [], [], []
    for n in range(sc.shape[0]):
        s = sc[n].transpose(1, 2, 0).reshape(-1)
        d = bd[n].transpose(1, 2, 0).reshape(-1, 4)
        order = _descending(s)[:pre_nms_top_n]
        s, d, a, v = s[order], d[order], an[order], var[order]
        aw = a[:, 2] - a[:, 0]
        ah = a[:, 3] - a[:, 1]
        acx = a[:, 0] + aw / 2
        acy = a[:, 1] + ah / 2
        cx = v[:, 0] * d[:, 0] * aw + acx
        cy = v[:, 1] * d[:, 1] * ah + acy
        w = np.exp(np.minimum(v[:, 2] * d[:, 2], 10)) * aw
        h = np.exp(np.minimum(v[:, 3] * d[:, 3], 10)) * ah
        boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                         -1)
        boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, im[n, 1] - 1)
        boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, im[n, 0] - 1)
        ok = ((boxes[:, 2] - boxes[:, 0] >= min_size)
              & (boxes[:, 3] - boxes[:, 1] >= min_size))
        boxes, s = boxes[ok], s[ok]
        keep = _nms_keep(torch.from_numpy(boxes).to(dev), nms_thresh, s)
        keep = keep[:post_nms_top_n]
        all_rois.append(boxes[keep])
        all_scores.append(s[keep])
        nums.append(len(keep))
    rois = torch.from_numpy(np.concatenate(all_rois, 0)).to(dev)
    rscores = torch.from_numpy(np.concatenate(all_scores, 0)).to(dev)
    if return_rois_num:
        return rois, rscores, torch.from_numpy(
            np.asarray(nums, np.int32)).to(dev)
    return rois, rscores


def read_file(filename, name=None):
    """A file's bytes as a uint8 tensor on the current place."""
    with open(filename, "rb") as f:
        data = f.read()
    return torch.frombuffer(bytearray(data), dtype=torch.uint8).to(
        _current_place())


def decode_jpeg(x, mode="unchanged", name=None):
    """Decode JPEG bytes (a uint8 tensor) to a CHW uint8 tensor on the
    device of ``x``; the decoder is PIL's, on the host."""
    try:
        import io

        from PIL import Image
    except ImportError as e:
        raise ModuleNotFoundError(
            "decode_jpeg needs Pillow for host-side decoding") from e
    raw = bytes(_host(x, np.uint8).tobytes())
    img = Image.open(io.BytesIO(raw))
    if mode == "gray":
        img = img.convert("L")
    elif mode == "rgb":
        img = img.convert("RGB")
    arr = np.asarray(img)
    arr = arr[None] if arr.ndim == 2 else arr.transpose(2, 0, 1)
    return torch.from_numpy(arr.copy()).to(_device_of(x))
