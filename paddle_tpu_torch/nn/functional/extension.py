"""Distances, masks, warps and the temporal shift (port of
``paddle_tpu/nn/functional/extension.py``): the reference's formulas as
torch ops. ``grid_sample`` samples as the reference does (its own
coordinate and padding rules), not through ``torch.nn.functional
.grid_sample``."""
from __future__ import annotations

import torch

from ...core import dtype as dtypes
from ._op import amp_op

__all__ = [
    "pairwise_distance", "pdist", "sequence_mask", "diag_embed",
    "temporal_shift", "affine_grid", "grid_sample", "npair_loss",
]


@amp_op("pairwise_distance")
def pairwise_distance(x, y, p: float = 2.0, epsilon: float = 1e-6,
                      keepdim: bool = False, name=None):
    d = x - y + epsilon
    return (d.abs() ** p).sum(dim=-1, keepdim=keepdim) ** (1.0 / p)


@amp_op("pdist")
def pdist(x, p: float = 2.0, name=None):
    n = x.shape[0]
    s = ((x[:, None, :] - x[None, :, :]).abs() ** p).sum(dim=-1)
    iu = torch.triu_indices(n, n, offset=1, device=x.device)
    # the root after the diagonal is sliced off: its derivative at 0 is inf
    return s[iu[0], iu[1]] ** (1.0 / p)


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    ml = int(maxlen) if maxlen is not None else int(x.max().item())
    out = torch.arange(ml, device=x.device) < x[..., None]
    return out.to(dtypes.convert_dtype(dtype))


@amp_op("diag_embed")
def diag_embed(input, offset: int = 0, dim1: int = -2, dim2: int = -1):
    return torch.diag_embed(input, offset=offset, dim1=dim1, dim2=dim2)


@amp_op("temporal_shift")
def temporal_shift(x, seg_num: int, shift_ratio: float = 0.25,
                   data_format: str = "NCHW", name=None):
    v = x.permute(0, 3, 1, 2) if data_format == "NHWC" else x
    nt, c, h, w = v.shape
    v = v.reshape(nt // seg_num, seg_num, c, h, w)
    c1, c2 = int(c * shift_ratio), int(c * 2 * shift_ratio)
    back = torch.cat([v[:, 1:, :c1], torch.zeros_like(v[:, :1, :c1])], 1)
    fwd = torch.cat([torch.zeros_like(v[:, :1, c1:c2]), v[:, :-1, c1:c2]], 1)
    out = torch.cat([back, fwd, v[:, :, c2:]], 2).reshape(nt, c, h, w)
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out


@amp_op("affine_grid")
def affine_grid(theta, out_shape, align_corners: bool = True, name=None):
    shape = [int(s) for s in (out_shape.tolist()
                              if isinstance(out_shape, torch.Tensor)
                              else out_shape)]
    n, h, w = shape[0], shape[2], shape[3]

    def coords(size):
        if align_corners:
            return torch.linspace(-1.0, 1.0, size, device=theta.device)
        step = 2.0 / size
        return torch.linspace(-1.0 + step / 2, 1.0 - step / 2, size,
                              device=theta.device)

    gy, gx = torch.meshgrid(coords(h), coords(w), indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], -1).reshape(-1, 3)
    out = torch.einsum("nij,pj->npi", theta.float(), base)
    return out.reshape(n, h, w, 2).to(theta.dtype)


@amp_op("grid_sample")
def grid_sample(x, grid, mode: str = "bilinear", padding_mode: str = "zeros",
                align_corners: bool = True, name=None):
    n, c, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        fx, fy = (gx + 1) * (w - 1) / 2, (gy + 1) * (h - 1) / 2
    else:
        fx, fy = ((gx + 1) * w - 1) / 2, ((gy + 1) * h - 1) / 2
    if padding_mode == "reflection":
        def reflect(coord, size):
            if size == 1:
                return torch.zeros_like(coord)
            if align_corners:
                m = 2.0 * (size - 1)
                t = torch.remainder(coord.abs(), m)
                return torch.where(t > size - 1, m - t, t)
            m = 2.0 * size
            t = torch.remainder((coord + 0.5).abs(), m)
            t = torch.where(t > size, m - t, t)
            return (t - 0.5).clamp(0.0, size - 1.0)

        fx, fy = reflect(fx, w), reflect(fy, h)
    rows = torch.arange(n, device=x.device)[:, None, None]

    def sample(ix, iy):
        valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        out = x[rows, :, iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
        if padding_mode == "zeros":
            out = out * valid[..., None].to(out.dtype)
        return out                                        # [n, gh, gw, c]

    if mode == "nearest":
        out = sample(torch.round(fx).long(), torch.round(fy).long())
    else:
        x0, y0 = torch.floor(fx).long(), torch.floor(fy).long()
        x1, y1 = x0 + 1, y0 + 1
        wa = (x1 - fx) * (y1 - fy)
        wb = (x1 - fx) * (fy - y0)
        wc = (fx - x0) * (y1 - fy)
        wd = (fx - x0) * (fy - y0)
        out = (sample(x0, y0) * wa[..., None] + sample(x0, y1) * wb[..., None]
               + sample(x1, y0) * wc[..., None]
               + sample(x1, y1) * wd[..., None])
    return out.permute(0, 3, 1, 2)


@amp_op("npair_loss")
def npair_loss(anchor, positive, labels, l2_reg: float = 0.002):
    l2 = l2_reg * ((anchor * anchor).sum() + (positive * positive).sum()) \
        / anchor.shape[0]
    sim = anchor @ positive.T
    lbl = torch.as_tensor(labels, device=anchor.device)
    y = (lbl[:, None] == lbl[None, :]).to(sim.dtype)
    y = y / y.sum(dim=1, keepdim=True)
    ce = -(y * torch.log_softmax(sim, dim=1)).sum(dim=1).mean()
    return ce + l2
