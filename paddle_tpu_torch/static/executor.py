"""Static Executor: replay a recorded Program on real tensors (port of
``paddle_tpu/static/executor.py``; reference python/paddle/fluid/executor.py:895
Executor, run:1277).

The JAX package composes the recorded ops into one function and
``jax.jit``s it. Here a run replays the nodes in their recorded order on
the executor's device: each node calls the op it recorded, a kernel node
its eager wrapper (the autograd ``Function`` and the ``ctypes`` launch),
so a static step launches exactly the kernels of the eager step it
recorded, in the same order. The replay plan (the nodes, the feed and
fetch slots) is cached per (program nodes, fetches, feeds, training), as
the JAX package caches its jitted step.

A training program (``optimizer.minimize`` in static mode) replays its
forward with autograd on, runs ``backward`` from the loss and then the
optimizer's own ``step()`` over the scope's parameters, so the
optimizer's state and LR scheduler stay live across runs. Gradient
fetches (``append_backward``, ``gradients``) go through
``torch.autograd.grad``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core import dispatch, op_hooks
from ..core.place import resolve_device
from .program import Program, default_main_program, global_scope

__all__ = ["Executor"]


def _feed_tensor(value, like: torch.Tensor, device) -> torch.Tensor:
    """A feed as a tensor on ``device`` in its variable's dtype."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
    else:
        t = torch.from_numpy(np.ascontiguousarray(np.asarray(value)))
    return t.to(device=device, dtype=like.dtype)


def _as_numpy(t):
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class _Replay:
    """A program's replay plan for one (fetches, feeds) signature: the
    nodes, and after each node the variables no later node reads, which
    the replay drops (autograd keeps what the backward saves), so a
    step's memory is the eager step's rather than every intermediate's."""

    def __init__(self, prog: Program, fetch_ids, feed_names):
        self.nodes = list(prog.nodes)
        self.fetch_ids = list(fetch_ids)
        self.feed_names = feed_names
        self.grad_vars = dict(getattr(prog, "grad_vars", {}))
        self.input_grad_vars = dict(getattr(prog, "input_grad_vars", {}))
        keep = (set(self.fetch_ids) | set(prog.feed_vars.values())
                | set(prog.param_vars.values()))
        keep.add(prog.train_config[1] if prog.train_config is not None
                 else getattr(prog, "loss_id", None))
        for targets, _ in self.input_grad_vars.values():
            keep.update(targets)
        last = {}
        for i, node in enumerate(self.nodes):
            for kind, v in node.in_ids:
                if kind == "var":
                    last[v] = i
            for v in node.out_ids:
                last[v] = i
        self.frees = [[] for _ in self.nodes]
        for v, i in last.items():
            if v not in keep:
                self.frees[i].append(v)

    def forward(self, env: Dict[int, Any], device) -> Dict[int, Any]:
        for node, frees in zip(self.nodes, self.frees):
            flat = [env[v] if kind == "var" else
                    device if kind == "device" else v
                    for kind, v in node.in_ids]
            out = node.fn(*flat)
            if node.out_ids:
                leaves = [o for o in torch.utils._pytree.tree_leaves(out)
                          if isinstance(o, torch.Tensor)]
                for vid, val in zip(node.out_ids, leaves):
                    env[vid] = val
            del flat, out
            for v in frees:
                env.pop(v, None)
        return env


class Executor:
    """reference executor.py:895. ``place`` (a ``CPUPlace()`` /
    ``CUDAPlace(i)`` or a device name) picks the device the replay runs
    on; without one the current place (the CUDA card unless
    ``set_device("cpu")``), which raises where CUDA is missing."""

    def __init__(self, place=None):
        self.place = place
        self.device = resolve_device(place)
        self._cache: Dict[tuple, _Replay] = {}

    def close(self):
        self._cache.clear()

    def run(self, program: Optional[Program] = None, feed=None,
            fetch_list=None, scope=None, return_numpy: bool = True):
        # the executor's own reads of the program's symbolic values are no
        # ops of a program being recorded
        with dispatch.internal():
            prep = self._prepare(program, feed, fetch_list, scope)
        if prep is None:
            return []
        prog, rp, env, params, training = prep
        # no hook to feed: the mode off the stack for the replay
        quiet = (dispatch.suspended() if op_hooks.op_span_hook is None
                 else dispatch.replaying())
        with quiet:
            fetches = self._run(prog, rp, env, params, training)
        if return_numpy:
            return [_as_numpy(f) for f in fetches]
        return [f.detach() if isinstance(f, torch.Tensor) else f
                for f in fetches]

    def _prepare(self, program, feed, fetch_list, scope):
        prog = program if program is not None else default_main_program()
        prog = getattr(prog, "_program", prog)      # CompiledProgram
        scope = scope or global_scope()
        feed = feed or {}
        fetch_list = fetch_list or []

        # startup program (or any program with no nodes): initialize scope
        # params from their eager initial values
        if not prog.nodes:
            for name, p in prog.param_objs.items():
                scope.set(name, p)
            return None
        for name, p in prog.param_objs.items():
            if scope.var(name) is None:
                scope.set(name, p)

        fetch_ids = []
        for f in fetch_list:
            if not isinstance(f, torch.Tensor):
                raise TypeError("fetch_list entries must be program outputs")
            fetch_ids.append(id(f))
        feed_names = tuple(sorted(feed))
        training = prog.train_config is not None
        key = (getattr(prog, "_origin_id", prog.id),
               tuple(id(n) for n in prog.nodes), tuple(fetch_ids),
               feed_names, training)
        rp = self._cache.get(key)
        if rp is None:
            rp = self._cache[key] = _Replay(prog, fetch_ids, feed_names)

        env: Dict[int, Any] = {}
        for n in feed_names:
            vid = prog.feed_vars[n]
            env[vid] = _feed_tensor(feed[n], prog.var_meta[vid][1],
                                    self.device)
        params = {}
        for n, vid in prog.param_vars.items():
            t = self._scope_tensor(scope, n, prog.param_objs[n])
            params[n] = t
            env[vid] = t
        return prog, rp, env, params, training

    def _scope_tensor(self, scope, name, param):
        """The scope's value of parameter ``name`` as a tensor on the
        executor's device (a value set as numpy is stored back as a
        tensor)."""
        v = scope.var(name)
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(np.asarray(v), dtype=param.dtype,
                                device=self.device)
            if param.requires_grad:
                v.requires_grad_(True)
            scope.set(name, v)
        return v

    def _run(self, prog, rp: _Replay, env, params, training):
        grad_fetch = any(f in rp.grad_vars or f in rp.input_grad_vars
                         for f in rp.fetch_ids)
        if not training and not grad_fetch:
            with torch.no_grad():
                env = rp.forward(env, self.device)
            return [env[f] for f in rp.fetch_ids]

        loss_id = (prog.train_config[1] if training
                   else getattr(prog, "loss_id", None))
        param_grads = training or any(f in rp.grad_vars
                                      for f in rp.fetch_ids)
        if param_grads and loss_id is None:
            raise ValueError(
                "gradient fetch requires append_backward(loss) to have "
                "marked the loss on this program")
        feed_ids = {}
        for f in rp.fetch_ids:
            if f in rp.input_grad_vars:
                fname = rp.input_grad_vars[f][1]
                vid = prog.feed_vars[fname]
                env[vid] = env[vid].detach().requires_grad_(True)
                feed_ids[fname] = vid
        with torch.enable_grad():
            env = rp.forward(env, self.device)
            input_grads = {}
            for f in rp.fetch_ids:
                if f in rp.input_grad_vars:
                    targets, fname = rp.input_grad_vars[f]
                    total = sum(env[t].sum() for t in targets)
                    (input_grads[f],) = torch.autograd.grad(
                        total, env[feed_ids[fname]], retain_graph=True)
            grads = {}
            if param_grads:
                loss = env[loss_id]
                if loss.dim():
                    loss = loss.sum()
            if training:
                opt = prog.train_config[0]
                live = {n: t for n, t in params.items() if t.requires_grad}
                opt._static_bind(live)
                loss.backward()
                grads = {n: t.grad for n, t in live.items()}
            elif param_grads:
                names = sorted({rp.grad_vars[f] for f in rp.fetch_ids
                                if f in rp.grad_vars})
                gs = torch.autograd.grad(loss, [params[n] for n in names],
                                         allow_unused=True)
                grads = dict(zip(names, gs))
        fetches = [grads.get(rp.grad_vars[f]) if f in rp.grad_vars
                   else input_grads[f] if f in input_grads else env.get(f)
                   for f in rp.fetch_ids]
        if training:
            opt.step()
            opt.clear_grad()
        return fetches
