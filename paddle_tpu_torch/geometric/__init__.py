"""paddle.geometric counterpart (port of ``paddle_tpu/geometric``;
reference python/paddle/geometric/: message_passing/send_recv.py,
sampling/neighbors.py, reindex.py).

Message passing runs on the inputs' device as torch scatter-reductions:
sums and means through ``index_add``, maxima and minima through
``scatter_reduce`` into a tensor filled with the reduction's identity, so
an empty segment keeps ``-inf`` (max) or ``+inf`` (min) for floats and the
integer type's least or greatest value, as ``jax.ops.segment_max`` /
``segment_min`` give it. Every reduction is differentiable in the data;
the gradient of a max or min goes to the element that holds it, split
evenly among tied elements (``scatter_reduce``'s rule).

Neighbour sampling and reindexing run on the host in numpy, as in the
reference and the JAX package (a data-pipeline step, not a device kernel);
their outputs go to the device of the nodes they were given.
``sample_neighbors`` draws from an unseeded ``np.random.RandomState()``,
as the JAX package does (``paddle_tpu/geometric/__init__.py:150``), so a
sample below a node's degree is not reproducible there either.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops._helpers import device_of

__all__ = ["segment_sum", "segment_mean", "segment_max", "segment_min",
           "send_u_recv", "send_ue_recv", "send_uv", "sample_neighbors",
           "weighted_sample_neighbors", "reindex_graph",
           "reindex_heter_graph"]


def _nseg(ids: torch.Tensor) -> int:
    """Segments of ``ids``: the largest id plus one (one host read)."""
    return int(ids.max()) + 1 if ids.numel() else 0


def _sum(data: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add(0, ids.long(), data)


def _mean(data: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    s = _sum(data, ids, n)
    ones = torch.ones((data.shape[0],) + (1,) * (data.dim() - 1),
                      dtype=data.dtype, device=data.device)
    return s / torch.clamp(_sum(ones, ids, n), min=1)


def _identity(dtype: torch.dtype, reduce: str):
    if dtype.is_floating_point:
        return float("-inf") if reduce == "amax" else float("inf")
    info = torch.iinfo(dtype)
    return info.min if reduce == "amax" else info.max


def _extreme(data: torch.Tensor, ids: torch.Tensor, n: int,
             reduce: str) -> torch.Tensor:
    out = torch.full((n,) + tuple(data.shape[1:]),
                     _identity(data.dtype, reduce), dtype=data.dtype,
                     device=data.device)
    idx = ids.long().reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce(0, idx, data, reduce, include_self=True)


_REDUCE = {
    "sum": _sum,
    "add": _sum,
    "mean": _mean,
    "max": lambda d, i, n: _extreme(d, i, n, "amax"),
    "min": lambda d, i, n: _extreme(d, i, n, "amin"),
}


def segment_sum(data, segment_ids, name=None):
    return _sum(data, segment_ids, _nseg(segment_ids))


def segment_mean(data, segment_ids, name=None):
    return _mean(data, segment_ids, _nseg(segment_ids))


def segment_max(data, segment_ids, name=None):
    return _REDUCE["max"](data, segment_ids, _nseg(segment_ids))


def segment_min(data, segment_ids, name=None):
    return _REDUCE["min"](data, segment_ids, _nseg(segment_ids))


def _reduce(msg, dst_index, reduce_op, n):
    fn = _REDUCE.get(reduce_op)
    if fn is None:
        raise ValueError(f"unknown reduce_op {reduce_op}")
    return fn(msg, dst_index, n)


def _message(a, b, message_op):
    if message_op == "add":
        return a + b
    if message_op == "sub":
        return a - b
    if message_op == "mul":
        return a * b
    if message_op == "div":
        return a / b
    raise ValueError(f"unknown message_op {message_op}")


def send_u_recv(x, src_index, dst_index, reduce_op="sum", out_size=None,
                name=None):
    """Gather x[src], scatter-reduce onto dst (send_recv.py send_u_recv)."""
    n = int(out_size) if out_size else x.shape[0]
    return _reduce(x.index_select(0, src_index.long()), dst_index,
                   reduce_op, n)


def send_ue_recv(x, y, src_index, dst_index, message_op="add",
                 reduce_op="sum", out_size=None, name=None):
    """Combine node features with edge features, then scatter-reduce."""
    n = int(out_size) if out_size else x.shape[0]
    msg = _message(x.index_select(0, src_index.long()), y, message_op)
    return _reduce(msg, dst_index, reduce_op, n)


def send_uv(x, y, src_index, dst_index, message_op="add", name=None):
    """Per-edge message from both endpoints (send_recv.py send_uv)."""
    return _message(x.index_select(0, src_index.long()),
                    y.index_select(0, dst_index.long()), message_op)


def _host(x) -> np.ndarray:
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


def _sample(r, cp, nodes, sample_size, ev, return_eids, weights=None):
    rng = np.random.RandomState()
    outs, counts, out_eids = [], [], []
    for nd in nodes:
        beg, end = int(cp[nd]), int(cp[nd + 1])
        neigh = r[beg:end]
        ids = np.arange(beg, end)
        if 0 <= sample_size < len(neigh):
            p = None
            if weights is not None:
                w = weights[beg:end]
                p = w / w.sum() if w.sum() > 0 else None
            pick = rng.choice(len(neigh), size=sample_size, replace=False,
                              p=p)
            neigh = neigh[pick]
            ids = ids[pick]
        outs.append(neigh)
        counts.append(len(neigh))
        if return_eids and ev is not None:
            out_eids.append(ev[ids])
    out = np.concatenate(outs) if outs else np.zeros((0,), r.dtype)
    eids = (np.concatenate(out_eids) if out_eids
            else np.zeros((0,), r.dtype))
    return out, np.asarray(counts, np.int32), eids


def _outputs(dev, *arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in arrays)


def sample_neighbors(row, colptr, input_nodes, sample_size=-1, eids=None,
                     return_eids=False, perm_buffer=None, name=None):
    """Uniform neighbor sampling over a CSC graph (sampling/neighbors.py),
    on the host. Returns (out_neighbors, out_count[, out_eids])."""
    dev = device_of(input_nodes, row)
    out, cnt, ev = _sample(_host(row), _host(colptr), _host(input_nodes),
                           sample_size,
                           _host(eids) if eids is not None else None,
                           return_eids)
    return _outputs(dev, out, cnt, ev) if return_eids else \
        _outputs(dev, out, cnt)


def weighted_sample_neighbors(row, colptr, edge_weight, input_nodes,
                              sample_size=-1, eids=None, return_eids=False,
                              name=None):
    """Weight-proportional sampling (sampling/neighbors.py weighted
    variant), on the host."""
    dev = device_of(input_nodes, row)
    out, cnt, ev = _sample(_host(row), _host(colptr), _host(input_nodes),
                           sample_size,
                           _host(eids) if eids is not None else None,
                           return_eids,
                           _host(edge_weight).astype(np.float64))
    return _outputs(dev, out, cnt, ev) if return_eids else \
        _outputs(dev, out, cnt)


def reindex_graph(x, neighbors, count, value_buffer=None, index_buffer=None,
                  name=None):
    """Compact subgraph node ids to 0..n (reindex.py reindex_graph), on the
    host. Returns (reindexed_src, reindexed_dst, out_nodes)."""
    xv, nb, ct = _host(x), _host(neighbors), _host(count)
    seen = {int(v): i for i, v in enumerate(xv)}
    order = list(xv)
    for v in nb:
        vi = int(v)
        if vi not in seen:
            seen[vi] = len(order)
            order.append(vi)
    src = np.asarray([seen[int(v)] for v in nb], np.int64)
    dst = np.repeat(np.arange(len(xv)), ct).astype(np.int64)
    return _outputs(device_of(x), src, dst, np.asarray(order, xv.dtype))


def reindex_heter_graph(x, neighbors, count, value_buffer=None,
                        index_buffer=None, name=None):
    """Heterogeneous variant: neighbors/count are per-edge-type lists."""
    xv = _host(x)
    seen = {int(v): i for i, v in enumerate(xv)}
    order = list(xv)
    srcs, dsts = [], []
    for nb_t, ct_t in zip(neighbors, count):
        nb, ct = _host(nb_t), _host(ct_t)
        for v in nb:
            vi = int(v)
            if vi not in seen:
                seen[vi] = len(order)
                order.append(vi)
        srcs.append(np.asarray([seen[int(v)] for v in nb], np.int64))
        dsts.append(np.repeat(np.arange(len(xv)), ct).astype(np.int64))
    dev = device_of(x)
    return ([_outputs(dev, a)[0] for a in srcs],
            [_outputs(dev, a)[0] for a in dsts],
            _outputs(dev, np.asarray(order, xv.dtype))[0])
