"""paddle.incubate's top-level functions (port of
``paddle_tpu/incubate/_api.py``; reference python/paddle/incubate/
__init__.py): the segment and graph re-exports of ``geometric``,
``graph_khop_sampler`` (host), the fused softmax-mask functions as torch
compositions (the reference's CUDA fusions exist to avoid materializing
``x + mask``; the JAX package leaves the fusion to XLA, the port to the
card's elementwise kernels), ``identity_loss``, and the ``LookAhead`` and
``ModelAverage`` wrappers over the port's optimizers.
"""
from __future__ import annotations

import numpy as np
import torch

from ..geometric import (reindex_graph as graph_reindex,
                         sample_neighbors as graph_sample_neighbors,
                         segment_max, segment_mean, segment_min, segment_sum,
                         send_u_recv as graph_send_recv)
from ..ops._helpers import device_of

__all__ = ["segment_sum", "segment_mean", "segment_min", "segment_max",
           "graph_send_recv", "graph_reindex", "graph_sample_neighbors",
           "graph_khop_sampler", "softmax_mask_fuse",
           "softmax_mask_fuse_upper_triangle", "identity_loss",
           "LookAhead", "ModelAverage"]


def graph_khop_sampler(row, colptr, input_nodes, sample_sizes,
                       sorted_eids=None, return_eids=False, name=None):
    """Multi-hop neighbor sampling (reference incubate/operators/
    graph_khop_sampler.py): per-hop ``sample_neighbors`` chained, the union
    reindexed, on the host like the per-hop sampler. Returns
    (reindexed src, reindexed dst, out_nodes) on the nodes' device."""
    from ..geometric import _host, _sample

    all_src, all_dst = [], []
    frontier = _host(input_nodes)
    r, cp = _host(row), _host(colptr)
    for k in sample_sizes:
        neigh, counts, _ = _sample(r, cp, frontier, int(k), None, False)
        all_src.append(neigh)
        all_dst.append(np.repeat(frontier, counts))
        frontier = np.unique(neigh)
    src = np.concatenate(all_src) if all_src else np.zeros((0,), np.int64)
    dst = np.concatenate(all_dst) if all_dst else np.zeros((0,), np.int64)
    # compact ids: input nodes first (the reference's out_nodes order),
    # then new nodes in order of first appearance in the sampled edges
    inp = _host(input_nodes).ravel()
    mapping = {int(n): i for i, n in enumerate(inp)}
    out_nodes = list(inp)
    for n in np.concatenate([src, dst]):
        n = int(n)
        if n not in mapping:
            mapping[n] = len(out_nodes)
            out_nodes.append(n)
    r_src = np.asarray([mapping[int(n)] for n in src], np.int64)
    r_dst = np.asarray([mapping[int(n)] for n in dst], np.int64)
    dev = device_of(input_nodes)
    return tuple(torch.from_numpy(a).to(dev) for a in
                 (r_src, r_dst, np.asarray(out_nodes, np.int64)))


def softmax_mask_fuse(x, mask, name=None):
    """softmax(x + mask) over the last dim, in x's dtype (reference
    incubate/operators/softmax_mask_fuse.py)."""
    z = x + mask
    e = torch.exp(z - torch.amax(z, -1, keepdim=True))
    return e / torch.sum(e, -1, keepdim=True)


def softmax_mask_fuse_upper_triangle(x, name=None):
    """softmax with the upper-triangle (future) positions masked
    (reference softmax_mask_fuse_upper_triangle, the causal attention
    softmax): masked scores -1e30, the row sum floored at 1e-30."""
    s = x.shape[-1]
    mask = torch.tril(torch.ones((x.shape[-2], s), dtype=torch.bool,
                                 device=x.device))
    z = torch.where(mask, x, -1e30)
    z = z - torch.amax(z, -1, keepdim=True)
    e = torch.exp(z) * mask
    return e / torch.clamp(torch.sum(e, -1, keepdim=True), min=1e-30)


def identity_loss(x, reduction="none"):
    """Mark a tensor as a loss (reference incubate identity_loss, an IPU
    pipeline marker) with the requested reduction."""
    red = {"none": 0, "sum": 1, "mean": 2}.get(reduction, reduction)
    if red == 0:
        return x.clone()
    if red == 1:
        return torch.sum(x)
    return torch.mean(x)


class LookAhead:
    """Lookahead optimizer wrapper (reference incubate/optimizer/lookahead
    .py; Zhang et al. 2019): every k steps, slow weights interpolate
    toward fast weights and fast weights reset to slow."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        self._inner_opt = inner_optimizer
        self.alpha = alpha
        self.k = max(1, int(k))
        self._count = 0
        self._slow = {}

    @torch.no_grad()
    def step(self):
        self._inner_opt.step()
        self._count += 1
        params = self._inner_opt._parameter_list or []
        if self._count == 1:
            for p in params:
                self._slow[id(p)] = p.detach().clone()
        if self._count % self.k:
            return
        for p in params:
            slow = self._slow.get(id(p), p.detach())
            slow = slow + self.alpha * (p.detach() - slow)
            self._slow[id(p)] = slow
            p.copy_(slow)

    def minimize(self, loss, *a, **kw):
        loss.backward()
        self.step()
        return None, None

    def clear_grad(self, set_to_zero: bool = False):
        self._inner_opt.clear_grad(set_to_zero)

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)


class ModelAverage:
    """Running average of parameters for evaluation (reference incubate/
    optimizer/modelaverage.py): accumulates sums, apply()/restore() swap
    the averaged weights in and out."""

    def __init__(self, average_window_rate, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        self._params = list(parameters or [])
        self._rate = average_window_rate
        self._min_w = min_average_window
        self._max_w = max_average_window
        self._sum = {id(p): torch.zeros_like(p.detach())
                     for p in self._params}
        self._n = 0
        self._backup = None

    @torch.no_grad()
    def step(self):
        self._n += 1
        for p in self._params:
            self._sum[id(p)] = self._sum[id(p)] + p.detach()
        if self._n > self._max_w:
            # restart the window (the reference resets its sums past max)
            for p in self._params:
                self._sum[id(p)] = p.detach().to(self._sum[id(p)].dtype,
                                                 copy=True)
            self._n = 1

    class _Guard:
        def __init__(self, outer, need_restore):
            self.outer = outer
            self.need_restore = need_restore

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            if self.need_restore:
                self.outer.restore()
            return False

    @torch.no_grad()
    def apply(self, executor=None, need_restore=True):
        self._backup = {id(p): p.detach().clone() for p in self._params}
        n = max(self._n, 1)
        for p in self._params:
            p.copy_((self._sum[id(p)] / n).to(p.dtype))
        return self._Guard(self, need_restore)

    @torch.no_grad()
    def restore(self, executor=None):
        if self._backup is None:
            return
        for p in self._params:
            p.copy_(self._backup[id(p)])
        self._backup = None

    def minimize(self, loss, *a, **kw):
        loss.backward()
        self.step()
        return None, None
