"""paddle.static counterpart (port of ``paddle_tpu/static``; reference
python/paddle/static/).

Static mode here is record-then-replay: while ``enable_static()`` is on,
ops are recorded at the port's record point (``core/dispatch.py``,
``record.py``) into the default main Program, and ``Executor`` replays
them on real tensors (``executor.py``), a kernel node through its eager
wrapper. See ``program.py`` for the design note. ``static.amp`` and
``static.quantization`` rewrite recorded programs.
"""
from __future__ import annotations

import contextlib
import io
import pickle
from typing import Sequence

import numpy as np
import torch

from ..core import dispatch
from ..core import dtype as dtypes
from ..core.place import CPUPlace, CUDAPlace, resolve_device
from .executor import Executor
from .program import (Program, Scope, default_main_program,
                      default_startup_program, disable_static, enable_static,
                      global_scope, in_static_mode, param_name, program_guard,
                      static_state)
from .record import make_symbolic

__all__ = ["data", "Executor", "Program", "program_guard",
           "default_main_program", "default_startup_program", "scope_guard",
           "global_scope", "enable_static", "disable_static",
           "in_static_mode", "append_backward", "gradients", "InputSpec",
           "name_scope", "save", "load", "save_inference_model",
           "load_inference_model", "cpu_places", "cuda_places", "nn"]


class InputSpec:
    """reference paddle.static.InputSpec: a shape (None or -1 for a
    dynamic dim), a dtype and a name."""

    def __init__(self, shape, dtype="float32", name=None,
                 stop_gradient=True):
        self.shape = tuple(shape)
        self.dtype = dtypes.convert_dtype(dtype)
        self.name = name
        self.stop_gradient = stop_gradient

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(tuple(tensor.shape), tensor.dtype, name)

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")


def data(name: str, shape: Sequence[int], dtype="float32",
         lod_level: int = 0) -> torch.Tensor:
    """Declare a feed placeholder (reference paddle.static.data). A dynamic
    dim (None or -1) records as size 1; a run replays with the feed's
    real shape."""
    prog = default_main_program()
    dt = dtypes.convert_dtype(dtype)
    shape = tuple(shape)
    t = make_symbolic(tuple(1 if (s is None or s == -1) else int(s)
                            for s in shape), dt, name=name)
    prog.feed_vars[name] = id(t)
    if not hasattr(prog, "feed_shapes"):
        prog.feed_shapes = {}
    prog.feed_shapes[name] = shape
    return t


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None):
    """reference fluid/backward.py:1885: returns [(param, grad_var)]; a grad
    var's value is computed when it is fetched (``torch.autograd.grad`` of
    the replayed loss)."""
    with dispatch.internal():
        return _append_backward(loss, parameter_list)


def _append_backward(loss, parameter_list):
    prog = default_main_program()
    if not hasattr(prog, "grad_vars"):
        prog.grad_vars = {}
    prog.loss_id = id(loss)
    out = []
    params = parameter_list or list(prog.param_objs.values())
    for p in params:
        name = param_name(p)
        if name not in prog.param_vars:
            continue
        g = make_symbolic(p.shape, p.dtype, name=f"{name}@GRAD")
        prog.grad_vars[id(g)] = name
        out.append((p, g))
    return out


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """reference paddle.static.gradients: symbolic gradients of the summed
    targets with respect to feed variables, each fetchable."""
    with dispatch.internal():
        return _gradients(targets, inputs, no_grad_set)


def _gradients(targets, inputs, no_grad_set):
    prog = default_main_program()
    targets = list(targets) if isinstance(targets, (list, tuple)) \
        else [targets]
    inputs = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
    ng = set(id(v) for v in (no_grad_set or []))
    target_ids = tuple(id(t) for t in targets)
    vid_to_feed = {vid: name for name, vid in prog.feed_vars.items()}
    out = []
    for inp in inputs:
        if id(inp) in ng:
            out.append(None)
            continue
        feed_name = vid_to_feed.get(id(inp))
        if feed_name is None:
            raise ValueError(
                "static.gradients supports gradients wrt feed (data()) "
                "variables; for parameter gradients use append_backward")
        g = make_symbolic(inp.shape, inp.dtype, name=f"{feed_name}@GRAD")
        if not hasattr(prog, "input_grad_vars"):
            prog.input_grad_vars = {}
        prog.input_grad_vars[id(g)] = (target_ids, feed_name)
        out.append(g)
    return out


class scope_guard:
    """Route Executor state through ``scope`` for the block (reference
    paddle.static.scope_guard)."""

    def __init__(self, scope: Scope):
        self.scope = scope

    def __enter__(self):
        from .program import _push_scope

        _push_scope(self.scope)
        return self

    def __exit__(self, *exc):
        from .program import _pop_scope

        _pop_scope()
        return False


def name_scope(prefix: str = None):
    return contextlib.nullcontext()


def _param_state(program):
    scope = global_scope()
    out = {}
    for name, p in program.param_objs.items():
        v = scope.var(name)
        out[name] = (v if isinstance(v, torch.Tensor) else p).detach()
    return out


def _set_param(program, name, value):
    """Write ``value`` into parameter ``name`` of ``program`` and its scope
    entry."""
    p = program.param_objs[name]
    v = value if isinstance(value, torch.Tensor) else torch.as_tensor(
        np.asarray(value))
    with torch.no_grad():
        p.copy_(v.to(device=p.device, dtype=p.dtype))
    global_scope().set(name, p)


def save(program: Program, model_path: str, protocol: int = 4):
    """Persist program params (reference paddle.static.save -> .pdparams)."""
    from ..framework import io as fio

    fio.save(_param_state(program), model_path + ".pdparams")


def load(program: Program, model_path: str, executor=None, var_list=None):
    from ..framework import io as fio

    dev = next(iter(program.param_objs.values())).device \
        if program.param_objs else None
    sd = fio.load(model_path + ".pdparams", device=dev)
    for name, val in sd.items():
        if name in program.param_objs:
            _set_param(program, name, val)


class _ProgramModule(torch.nn.Module):
    """``fwd(params, *feeds)`` of a recorded program: its replay, for
    ``torch.export``."""

    def __init__(self, program, feed_names, fetch_ids, device):
        super().__init__()
        from .executor import _Replay

        self._rp = _Replay(program, fetch_ids, tuple(feed_names))
        self._prog = program
        self._device = device

    def forward(self, params, *feeds):
        prog = self._prog
        env = {prog.param_vars[n]: t for n, t in params.items()}
        for n, x in zip(self._rp.feed_names, feeds):
            env[prog.feed_vars[n]] = x
        env = self._rp.forward(env, self._device)
        return tuple(env[f] for f in self._rp.fetch_ids)


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor,
                         program=None, **kw):
    """Export the program's feed -> fetch replay as ``<path>.pt2``
    (``torch.export`` of ``fwd(params, *feeds)``; the kernels as the
    ``paddle_tpu::`` library ops, dims declared None or -1 dynamic) and its
    parameters as ``<path>.pdiparams``: the artifact
    :func:`load_inference_model` and ``inference.create_predictor``
    load."""
    from ..framework import io as fio
    from ..inference.aot import save_exported
    from ..jit import DYNAMIC_DIM_MAX, DYNAMIC_DIM_MIN

    program = program or default_main_program()
    feed_vars = list(feed_vars) if isinstance(feed_vars, (list, tuple)) \
        else [feed_vars]
    fetch_vars = list(fetch_vars) if isinstance(fetch_vars, (list, tuple)) \
        else [fetch_vars]
    vid_to_feed = {vid: n for n, vid in program.feed_vars.items()}
    names = [vid_to_feed[id(v)] for v in feed_vars]
    params = _param_state(program)
    dev = executor.device if executor is not None else resolve_device(None)
    declared = getattr(program, "feed_shapes", {})
    examples, dims = [], []
    for i, n in enumerate(names):
        meta = program.var_meta[program.feed_vars[n]][1]
        shape, spec = [], {}
        for j, s in enumerate(declared.get(n, tuple(meta.shape))):
            if s is None or s == -1:
                spec[j] = torch.export.Dim(f"d{i}_{j}", min=DYNAMIC_DIM_MIN,
                                           max=DYNAMIC_DIM_MAX)
                shape.append(2)
            else:
                shape.append(int(s))
        examples.append(torch.zeros(shape, dtype=meta.dtype, device=dev))
        dims.append(spec or None)
    mod = _ProgramModule(program, names, [id(v) for v in fetch_vars], dev)
    with dispatch.suspended(), torch.no_grad():
        ep = torch.export.export(
            mod, (params, *examples),
            dynamic_shapes=({k: None for k in params}, tuple(dims)),
            strict=False)
    ep.example_inputs = None
    save_exported(ep, path_prefix + ".pt2")
    fio.save(params, path_prefix + ".pdiparams")


def load_inference_model(path_prefix, executor, **kw):
    """Load a serving artifact saved by ``save_inference_model`` or
    ``jit.save``: ``(predictor, feed_names, fetch_names)``, shaped like the
    reference API. The first item is an ``inference.Predictor`` (run it with
    ``program.run([input_arrays])``, numpy outputs), not an op list for
    ``Executor.run``."""
    import os as _os

    from ..inference import Config, create_predictor

    if _os.path.exists(path_prefix + ".pt2") or _os.path.exists(
            path_prefix + ".pdiparams"):
        pred = create_predictor(Config(path_prefix))
        n_out = len(pred._exported.graph_signature.user_outputs)
        return pred, pred.get_input_names(), [f"out{i}" for i in range(n_out)]
    raise FileNotFoundError(f"no inference artifact at {path_prefix}")


def cpu_places(device_count=None):
    return [CPUPlace() for _ in range(device_count or 1)]


def cuda_places(device_ids=None):
    ids = range(torch.cuda.device_count()) if device_ids is None \
        else device_ids
    return [CUDAPlace(i) for i in ids]


class _StaticNN:
    """paddle.static.nn facade: layers over the record mechanism."""

    @staticmethod
    def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None,
           activation=None, name=None):
        from ..nn import functional as F
        from ..nn.layer.common import Linear

        in_dim = int(np.prod(tuple(x.shape)[num_flatten_dims:]))
        out = Linear(in_dim, size, weight_attr, bias_attr)(x)
        if activation == "relu":
            out = F.relu(out)
        elif activation == "tanh":
            out = torch.tanh(out)
        return out

    @staticmethod
    def batch_norm(input, **kw):
        from ..nn.layer.norm import BatchNorm1D

        return BatchNorm1D(int(input.shape[-1]))(input)


nn = _StaticNN()


# -- remaining reference static surface ------------------------------------
# (python/paddle/static/__init__.py __all__ parity)


Variable = torch.Tensor  # a program's Variable is a (symbolic) tensor


class BuildStrategy:
    """Accepted-and-recorded build options (reference BuildStrategy, the
    fused executor's pass knobs; a replay has no such passes, so the knobs
    are inert but printable and settable)."""

    def __init__(self):
        self.__dict__["_opts"] = {}

    def __setattr__(self, k, v):
        self._opts[k] = v

    def __getattr__(self, k):
        try:
            return self.__dict__["_opts"][k]
        except KeyError:
            return None

    def __repr__(self):
        return f"BuildStrategy({self._opts})"


class ExecutionStrategy(BuildStrategy):
    """reference ExecutionStrategy: the same inert-knob treatment."""


class CompiledProgram:
    """reference CompiledProgram(program): carries the program and its
    strategies through ``Executor.run``."""

    def __init__(self, program, build_strategy=None):
        self._program = program
        self._build_strategy = build_strategy or BuildStrategy()

    def __getattr__(self, item):
        return getattr(self._program, item)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """reference static.create_global_var: a filled persistable var."""
    dev = torch.device("cpu") if force_cpu else resolve_device(None)
    t = torch.full(tuple(shape), value, dtype=dtypes.convert_dtype(dtype),
                   device=dev)
    t.persistable = persistable
    if name:
        t.name = name
        global_scope().set(name, t)
    return t


def create_parameter(shape, dtype, name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """reference static.create_parameter."""
    from ..ops.creation import create_parameter as _top

    return _top(shape, dtype, name=name, attr=attr, is_bias=is_bias,
                default_initializer=default_initializer)


def device_guard(device=None):
    """reference static.device_guard: an op placement hint. A program
    replays on its executor's device; the context is accepted and
    inert."""
    return contextlib.nullcontext()


def ipu_shard_guard(index=-1, stage=-1):
    return contextlib.nullcontext()


def _print_meta(x, message):
    return x


@dispatch.op("print", meta=_print_meta)
def _print(x, message):
    print(f"{message} {x}")
    return x


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_layout=True,
          print_tensor_lod=True, print_phase="both"):
    """reference static.nn.Print: an identity op that prints its value
    when the program runs (at once in dynamic mode)."""
    return _print(input, message or "")


class _PyFunc(torch.autograd.Function):
    @staticmethod
    def forward(ctx, func, backward_func, like, *xs):
        ctx.func = backward_func
        ctx.save_for_backward(*xs)
        res = func(*[x.detach().cpu().numpy() for x in xs])
        res = res if isinstance(res, (list, tuple)) else (res,)
        return tuple(torch.as_tensor(np.asarray(r)).to(
            device=xs[0].device, dtype=dt) for r, (_, dt) in zip(res, like))

    @staticmethod
    def backward(ctx, *gs):
        xs = ctx.saved_tensors
        if ctx.func is None:
            return (None, None, None) + (None,) * len(xs)
        grads = ctx.func(*[x.detach().cpu().numpy() for x in xs],
                         *[g.detach().cpu().numpy() for g in gs])
        grads = grads if isinstance(grads, (list, tuple)) else (grads,)
        return (None, None, None) + tuple(
            torch.as_tensor(np.asarray(g)).to(device=x.device, dtype=x.dtype)
            for g, x in zip(grads, xs))


def _py_func_meta(func, backward_func, like, *xs):
    return tuple(torch.empty(shape, dtype=dt, device="meta")
                 for shape, dt in like)


@dispatch.op("py_func", meta=_py_func_meta)
def _py_func(func, backward_func, like, *xs):
    return _PyFunc.apply(func, backward_func, like, *xs)


def py_func(func, x, out, backward_func=None, skip_vars_in_backward_input=None):
    """reference static.py_func: a host Python op inside the program.
    ``func`` takes and returns numpy arrays of ``out``'s shapes and dtypes;
    ``backward_func(*inputs, *output_grads) -> input grads`` makes it
    trainable (an autograd ``Function``)."""
    xs = x if isinstance(x, (list, tuple)) else [x]
    outs = out if isinstance(out, (list, tuple)) else [out]
    like = tuple((tuple(o.shape), o.dtype) for o in outs)
    result = _py_func(func, backward_func, like, *xs)
    if isinstance(out, (list, tuple)):
        return list(result)
    return result[0]


# -- program/persistable (de)serialization ---------------------------------


def serialize_program(feed_vars, fetch_vars, program=None) -> bytes:
    """reference static.serialize_program: the program's topology without
    weights. The portable program format is ``save_inference_model``'s
    ``.pt2``; this is the recorded op list's description."""
    prog = program or default_main_program()
    return pickle.dumps({"nodes": len(prog.nodes), "desc": None,
                         "ops": [n.name for n in prog.nodes]})


def deserialize_program(data: bytes):
    return pickle.loads(data)


def serialize_persistables(feed_vars, fetch_vars, program=None) -> bytes:
    prog = program or default_main_program()
    buf = io.BytesIO()
    torch.save({k: v.cpu() for k, v in _param_state(prog).items()}, buf)
    return buf.getvalue()


def deserialize_persistables(program, data: bytes, executor=None):
    state = torch.load(io.BytesIO(data), weights_only=True)
    for k, v in state.items():
        if k in program.param_objs:
            _set_param(program, k, v)
    return state


def save_to_file(path: str, content: bytes):
    with open(path, "wb") as f:
        f.write(content)


def load_from_file(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def normalize_program(program, feed_vars, fetch_vars):
    """reference static.normalize_program: prune to the feed -> fetch
    subgraph. A recorded Program already holds exactly the recorded ops,
    so this is the identity with validation."""
    if program is None:
        raise TypeError("program must be a Program")
    return program


def _numpy(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def save_program_state(program=None):
    prog = program or default_main_program()
    return {k: _numpy(v) for k, v in _param_state(prog).items()}


def load_program_state(model_path, var_list=None):
    """reference static.load_program_state: the state dict of a save()
    artifact, as numpy."""
    from ..framework.io import load as fload

    state = fload(model_path if model_path.endswith(".pdparams")
                  else model_path + ".pdparams", return_numpy=True)
    return {k: np.asarray(v) for k, v in state.items()}


def set_program_state(program, state_dict):
    """reference static.set_program_state: parameter name -> array."""
    for k, v in state_dict.items():
        if k in program.param_objs:
            _set_param(program, k, v)


# -- legacy metrics + EMA ---------------------------------------------------


@dispatch.op("accuracy")
def _accuracy(lg, lb, k):
    topk = torch.argsort(lg, dim=-1, stable=True)[..., -k:]
    hit = (topk == lb.reshape(-1, 1)).any(dim=-1)
    return hit.float().mean()


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """reference static.accuracy: top-k accuracy over logits."""
    return _accuracy(input, label, k)


@dispatch.op("auc")
def _auc(pred, lb, num_thresholds):
    pos = pred[:, 1] if pred.dim() == 2 else pred
    lbf = lb.reshape(-1).float()
    th = torch.linspace(0.0, 1.0, num_thresholds, device=pred.device)
    above = (pos[None, :] > th[:, None]).float()
    tp = (above * lbf[None, :]).sum(1)
    fp = (above * (1 - lbf[None, :])).sum(1)
    tpr = tp / lbf.sum().clamp_min(1e-6)
    fpr = fp / (1 - lbf).sum().clamp_min(1e-6)
    return -torch.trapezoid(tpr, fpr)


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1, ins_tag_weight=None):
    """reference static.auc: ROC-AUC from thresholded TP/FP counts (the
    phi auc kernel's binning)."""
    return _auc(input, label, num_thresholds), [], []


@dispatch.op("ctr_metric_bundle")
def _ctr_stats(pred, lb):
    pos = pred[:, 1] if pred.dim() == 2 else pred
    lbf = lb.reshape(-1).float()
    return ((pos - lbf) ** 2).sum(), (pos - lbf).abs().sum(), pos.sum(), \
        lbf.sum(), torch.tensor(float(lbf.shape[0]), device=pred.device)


def ctr_metric_bundle(input, label, ins_tag_weight=None):
    """reference static.ctr_metric_bundle: (auc, sqrerr, abserr, prob, q,
    pos, total) for CTR models."""
    a, _, _ = auc(input, label)
    return (a,) + tuple(_ctr_stats(input, label))


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """Legacy lr helper (reference static exponential_decay:
    lr * decay_rate^(step/decay_steps), floored per interval when
    staircase)."""
    from ..optimizer.lr import LambdaDecay

    def factor(step):
        exp = step / float(decay_steps)
        if staircase:
            exp = float(int(exp))
        return decay_rate ** exp

    return LambdaDecay(learning_rate=learning_rate, lr_lambda=factor)


class WeightNormParamAttr:
    """reference static.WeightNormParamAttr: the weight-norm attr, carried
    for API shape (``nn.utils.weight_norm`` is the dygraph path)."""

    def __init__(self, dim=None, name=None, initializer=None,
                 learning_rate=1.0, regularizer=None, trainable=True,
                 do_model_average=False, need_clip=True):
        self.dim = dim
        self.name = name
        self.initializer = initializer


class ExponentialMovingAverage:
    """EMA of parameters (reference static.ExponentialMovingAverage):
    update() folds the current params into fp32 shadows, apply()/restore()
    swap them in and out of the parameter objects update() saw."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._shadow = {}
        self._backup = {}
        self._step = 0
        self._tracked = {}

    @torch.no_grad()
    def update(self, parameters=None):
        params = parameters or list(default_main_program()
                                    .param_objs.values())
        self._step += 1
        d = min(self._decay, (1 + self._step) / (10 + self._step))
        for p in params:
            key = param_name(p)
            self._tracked[key] = p
            prev = self._shadow.get(key)
            v = p.detach().float()
            self._shadow[key] = v.clone() if prev is None \
                else d * prev + (1 - d) * v

    @torch.no_grad()
    def apply(self, executor=None, need_restore=True):
        self._backup = {k: p.detach().clone()
                        for k, p in self._tracked.items()}
        for key, p in self._tracked.items():
            if key in self._shadow:
                p.copy_(self._shadow[key].to(p.dtype))

        ema = self

        @contextlib.contextmanager
        def guard():
            try:
                yield
            finally:
                if need_restore:
                    ema.restore(executor)

        return guard()

    @torch.no_grad()
    def restore(self, executor=None):
        for key, p in self._tracked.items():
            if key in self._backup:
                p.copy_(self._backup[key])
        self._backup = {}


def xpu_places(device_ids=None):
    raise RuntimeError("XPU is not available in the PyTorch port")


__all__ += ["Variable", "BuildStrategy", "ExecutionStrategy",
            "CompiledProgram", "create_global_var", "create_parameter",
            "device_guard", "ipu_shard_guard", "Print", "py_func",
            "serialize_program", "deserialize_program",
            "serialize_persistables", "deserialize_persistables",
            "save_to_file", "load_from_file", "normalize_program",
            "save_program_state", "load_program_state", "set_program_state",
            "accuracy", "auc", "ctr_metric_bundle", "exponential_decay",
            "WeightNormParamAttr", "ExponentialMovingAverage", "xpu_places"]

from . import amp  # noqa: E402,F401  (reference static/amp)
from . import quantization  # noqa: E402,F401  (reference static/quantization)
