"""Mixture-of-Experts layer (port of
``paddle_tpu/incubate/distributed/models/moe/moe_layer.py``).

Routing is the reference's capacity-bucketed dispatch (GShard / Mesh-TF):
the gate's top-k choices take positions in their experts by a cumsum, in
token order, every token's first choice before any second choice; a
choice past the expert's capacity is dropped (its probability mass is
lost, not renormalised). Two forms of it give the same keep/drop set and
slots:

- dense: a ``[T, E, C]`` dispatch mask and combine weights, applied as
  ``einsum('tec,td->ecd')`` and ``einsum('tec,ecd->td')``;
- sort: the (token, choice) pairs sorted stably by expert, O(T k) index
  arrays, a scatter into the ``[E * C, d]`` expert buffer and an
  ``index_add`` back. Its gathers are ``index_select`` s, whose backward
  is an ``index_add``: advanced indexing's backward sorts its indices and
  walks each run of equal ones serially, and every dropped choice reads
  the one sentinel row.

``dispatch_mode="auto"`` takes sort once the dense form's ``T * E * C``
passes 2^24 elements, as the reference does. The experts run one after
another on their ``[C, d]`` slices, as in the reference; the expert-
parallel all-to-all (the reference's ``ep`` mesh axis) waits for the
hybrid-parallel port (ROADMAP A13), so ``moe_group`` is kept for its name.
Everything is torch ops, differentiable in the tokens and the gate's
weights, with no host sync.
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch

from .....nn.layer.container import LayerList
from .....nn.layer.layers import Layer
from .gate.base_gate import one_hot

__all__ = ["MoELayer", "moe_dispatch", "moe_combine",
           "moe_dispatch_sorted", "moe_combine_sorted"]


def _normalized_weights(idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Zero the dropped choices (idx < 0) and renormalise over the kept
    ones, in fp32 (capacity drops are not renormalised)."""
    val = torch.where(idx >= 0, val.float(), 0.0)
    return val / val.sum(-1, keepdim=True).clamp_min(1e-9)


def _build_dispatch(idx: torch.Tensor, val: torch.Tensor, num_expert: int,
                    capacity: int):
    """idx, val [T, k] -> dispatch [T, E, C] bool, combine [T, E, C] fp32
    (the GShard cumsum position assignment)."""
    T, k = idx.shape
    dev = idx.device
    counts = torch.zeros(num_expert, dtype=torch.int64, device=dev)
    disp = torch.zeros(T, num_expert, capacity, dtype=torch.bool, device=dev)
    comb = torch.zeros(T, num_expert, capacity, device=dev)
    val = _normalized_weights(idx, val)
    for j in range(k):
        oh = one_hot(idx[:, j], num_expert, torch.int64)      # [T, E]
        pos = torch.cumsum(oh, 0) * oh        # 1-based rank in its expert
        pos = pos + counts[None, :] * oh      # after the earlier choices
        counts = counts + oh.sum(0)
        kept = (pos > 0) & (pos <= capacity)
        c = (pos.sum(1) - 1).clamp(0, capacity - 1)
        sel = one_hot(c, capacity) * kept.any(1)[:, None]
        contrib = oh.float()[:, :, None] * sel[:, None, :]
        disp = disp | (contrib > 0)
        comb = comb + contrib * val[:, j][:, None, None]
    return disp, comb


def moe_dispatch(x: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
                 num_expert: int, capacity: int):
    """x [T, d] -> (expert_in [E, C, d], combine weights [T, E, C])."""
    disp, comb = _build_dispatch(idx, val, num_expert, capacity)
    return torch.einsum("tec,td->ecd", disp.to(x.dtype), x), comb


def moe_combine(expert_out: torch.Tensor, comb: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    return torch.einsum("tec,ecd->td", comb.to(expert_out.dtype),
                        expert_out).to(dtype)


def _sort_dispatch_plan(idx: torch.Tensor, val: torch.Tensor,
                        num_expert: int, capacity: int):
    """The (token, choice) pairs in choice-major order, sorted stably by
    expert: the dense path's ranking, so the same keep/drop set. Returns
    (t, w, slot, kept) over the T k pairs: ``slot`` is the row of the
    ``[E * C, d]`` expert buffer, ``E * C`` (one past it) for a drop."""
    T, k = idx.shape
    dev = idx.device
    val = _normalized_weights(idx, val)
    e = idx.T.reshape(-1)
    t = torch.arange(T, device=dev).repeat(k)
    w = val.T.reshape(-1)
    ekey = torch.where(e >= 0, e, num_expert)
    order = torch.sort(ekey, stable=True).indices
    es, ts, ws = ekey[order], t[order], w[order]
    counts = torch.zeros(num_expert + 1, dtype=torch.int64,
                         device=dev).index_add_(0, ekey,
                                                torch.ones_like(ekey))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=dev) - starts[es]
    kept = (es < num_expert) & (pos < capacity)
    slot = torch.where(kept, es * capacity + pos, num_expert * capacity)
    return ts, ws, slot, kept


def moe_dispatch_sorted(x: torch.Tensor, idx: torch.Tensor,
                        val: torch.Tensor, num_expert: int, capacity: int):
    """Sort-based dispatch: ``moe_dispatch``'s contract, with the O(T k)
    plan (t, w, slot, kept) in place of the [T, E, C] weights."""
    ts, ws, slot, kept = _sort_dispatch_plan(idx, val, num_expert, capacity)
    d = x.shape[-1]
    vals = x.index_select(0, ts) * kept[:, None].to(x.dtype)
    flat = x.new_zeros(num_expert * capacity + 1, d)   # + the drops' row
    flat = flat.index_put((slot,), vals)
    expert_in = flat[:-1].reshape(num_expert, capacity, d)
    return expert_in, (ts, ws, slot, kept)


def moe_combine_sorted(expert_out: torch.Tensor, ts, ws, slot, kept,
                       num_tokens: int, dtype: torch.dtype) -> torch.Tensor:
    e, c, d = expert_out.shape
    eo = torch.cat([expert_out.reshape(e * c, d),
                    expert_out.new_zeros(1, d)])        # a drop reads zeros
    contrib = eo.index_select(0, slot) * (ws * kept).to(eo.dtype)[:, None]
    y = eo.new_zeros(num_tokens, d).index_add(0, ts, contrib)
    return y.to(dtype)


def _pick_dispatch_mode(num_tokens: int, num_expert: int,
                        capacity: int) -> str:
    """auto: the dense path holds two [T, E, C] tensors; past 2^24
    elements (64 MB in fp32) take the sort plan."""
    return ("sort" if num_tokens * num_expert * capacity > (1 << 24)
            else "dense")


class MoELayer(Layer):
    """``d_model``, ``experts`` (a list of expert layers), ``gate`` (a gate
    or a dict ``{"type": "naive" | "gshard" | "switch", "top_k": k}``),
    ``capacity_factor`` (capacity = ceil(cf * top_k * T / E)) and
    ``dispatch_mode`` ("auto", "dense" or "sort"), as the reference's.
    ``last_routing`` keeps the latest forward's mode, capacity and expert
    ids ``[T, k]`` (detached), from which the per-expert load and the
    choices dropped by capacity can be read."""

    def __init__(self, d_model: int, experts: Optional[List[Layer]] = None,
                 gate=None, moe_group=None, mp_group=None,
                 recompute_interval: int = 0, capacity_factor: float = 1.2,
                 dispatch_mode: str = "auto", **kwargs):
        super().__init__()
        if dispatch_mode not in ("auto", "dense", "sort"):
            raise ValueError(
                f"dispatch_mode={dispatch_mode!r}: expected auto|dense|sort")
        if experts is None:
            raise ValueError("experts list is required")
        self.dispatch_mode = dispatch_mode
        self.d_model = d_model
        self.experts = (experts if isinstance(experts, LayerList)
                        else LayerList(list(experts)))
        self.num_expert = len(self.experts)
        self.capacity_factor = capacity_factor
        self.moe_group = moe_group
        self.recompute_interval = recompute_interval
        if gate is None:
            gate = {"type": "gshard"}
        if isinstance(gate, dict):
            from .gate import GShardGate, NaiveGate, SwitchGate

            gtype = gate.get("type", "gshard")
            topk = gate.get("top_k", 2)
            if gtype == "naive":
                gate = NaiveGate(d_model, self.num_expert, topk=topk)
            elif gtype == "gshard":
                # a top_k other than 2 fails in GShardGate, not silently
                gate = GShardGate(d_model, self.num_expert, topk=topk)
            elif gtype == "switch":
                gate = SwitchGate(d_model, self.num_expert, topk=1)
            else:
                raise ValueError(f"unknown gate type {gtype}")
        self.gate = gate
        self.last_routing = None
        for exp in self.experts:
            for p in exp.parameters():
                p.is_distributed = True

    def forward(self, inp):
        orig_shape = inp.shape
        x = inp.reshape(-1, orig_shape[-1])
        T, E = x.shape[0], self.num_expert
        # slots per expert: balanced top-k routing gives k T / E
        # assignments each (the reference's GShard convention)
        topk = getattr(self.gate, "top_k",
                       getattr(self.gate, "topk", 1)) or 1
        capacity = max(1, int(math.ceil(self.capacity_factor * topk * T / E)))
        val, idx = self.gate(x)
        mode = self.dispatch_mode
        if mode == "auto":
            mode = _pick_dispatch_mode(T, E, capacity)
        if mode == "sort":
            expert_in, plan = moe_dispatch_sorted(x, idx, val, E, capacity)
        else:
            expert_in, comb = moe_dispatch(x, idx, val, E, capacity)
        stacked = torch.stack([self.experts[e](expert_in[e])
                               for e in range(E)])
        if mode == "sort":
            y = moe_combine_sorted(stacked, *plan, T, stacked.dtype)
        else:
            y = moe_combine(stacked, comb, stacked.dtype)
        self.last_routing = dict(mode=mode, capacity=capacity, idx=idx)
        return y.reshape(orig_shape)
