"""paddle.jit counterpart (port of ``paddle_tpu/jit/__init__.py``;
reference python/paddle/jit/api.py:233 ``to_static``).

``to_static`` wraps a function, or a Layer's ``forward``, in
:class:`StaticFunction`: the dy2static pass (``jit/dy2static.py``) rewrites
its tensor-predicate ``if`` / ``while`` into ``torch.cond`` /
``while_loop``, and ``torch.compile(fullgraph=True)`` compiles the result
into one program, as the JAX package compiles one ``jax.jit``. A pattern
dy2static cannot convert fails loudly with :func:`control_flow_guidance`,
never as a silent graph break. Autograd flows through the compiled forward
into ``loss.backward()`` (a compiled backward), buffers (BatchNorm's running
statistics) update as in eager, and every compile, the first and each
recompile, is counted (``StaticFunction.compiles`` and, with the monitor on,
``paddle_tpu_jit_cache_miss_total{fn="to_static:<name>"}``): the program
compiles through ``monitor.monitored_jit``, which also runs it with the
record point suspended.

The kernels K1, K2, K3, K5 and K6 enter a compiled program as the library
ops ``paddle_tpu::rms_norm``, ``fused_rope``, ``flash_fwd``,
``flash_bwd_dq`` and ``flash_bwd_dkv``: one node each, which launches the
hand-written kernel on the card (``ops/fused_kernels.py``,
``ops/flash_attention_kernel.py``).

Random draws: each call draws one seed from the port's generator on the
host and hands it to the program as a tensor (``core/random.py``), so a
program's dropout masks repeat under ``paddle.seed(s)``, are fresh on every
call and are drawn without a graph break; they are not the eager masks,
as the JAX package's ``to_static`` masks are not its eager ones.

``save`` writes ``<path>.pdiparams`` (the state dict through
``framework.io.save``) and, given ``input_spec``, ``<path>.pt2``: the
``torch.export`` program of ``fwd(params, *inputs)`` (``torch.export.save``),
which holds no weights. A ``.pt2`` program names the ``paddle_tpu::`` ops,
so ``paddle_tpu_torch`` must be imported before it loads. The JAX package's
``.stablehlo`` does not load here, and nothing pretends it does.
"""
from __future__ import annotations

import functools
import inspect
import types
from typing import Callable, Optional

import torch

from ..core import random as _random
from .dy2static import control_flow_guidance, convert_to_static

__all__ = ["to_static", "not_to_static", "enable_to_static", "TracedLayer",
           "TranslatedLayer", "StaticFunction", "save", "load",
           "ignore_module", "set_verbosity", "set_code_level",
           "control_flow_guidance"]

_to_static_enabled = [True]

# the bounds ``save`` gives a dim given as None or -1
DYNAMIC_DIM_MIN = 1
DYNAMIC_DIM_MAX = 65536


def enable_to_static(flag: bool):
    _to_static_enabled[0] = bool(flag)


def _backend(name: Optional[str]) -> Callable:
    """The torch backend a ``to_static`` program compiles with: inductor
    for None, else the named one; the reference's "CINN" has no
    counterpart here."""
    if name is not None and str(name).upper() == "CINN":
        raise ValueError(
            "to_static: backend 'CINN' is the reference's compiler; the "
            "port compiles with torch.compile (backend=None: inductor, or a "
            "torch backend name such as 'aot_eager')")
    return torch._dynamo.lookup_backend(name or "inductor")


class StaticFunction:
    """≙ reference StaticFunction (jit/dy2static/program_translator.py:305):
    the dy2static-converted function compiled by ``torch.compile`` into
    one program, with the call's seed as its first argument."""

    def __init__(self, function: Callable, layer=None, input_spec=None,
                 backend: Optional[str] = None):
        self._fn = convert_to_static(function)
        self._raw_fn = function
        self._layer = layer
        self._input_spec = input_spec
        self._backend = _backend(backend)
        self._compiled = None
        functools.update_wrapper(self, function,
                                 assigned=("__name__", "__doc__",
                                           "__qualname__"),
                                 updated=())

    @property
    def _label(self) -> str:
        return "to_static:" + getattr(self._raw_fn, "__name__", "fn")

    @property
    def compiles(self) -> int:
        """Programs compiled so far (the first and each recompile)."""
        return self._compiled.compiles if self._compiled is not None else 0

    def _program(self):
        if self._compiled is None:
            from ..monitor import monitored_jit

            fn = self._fn

            def program(seed, args, kwargs):
                _random.push_trace_seed(seed)
                try:
                    return fn(*args, **kwargs)
                finally:
                    _random.pop_trace_seed()

            # a code object of its own: the compiler caches programs (and
            # counts recompiles against its limit) per code object, and
            # every StaticFunction's ``program`` would share this one
            name = "to_static_" + getattr(self._raw_fn, "__name__", "fn")
            program = types.FunctionType(
                program.__code__.replace(co_name=name, co_qualname=name),
                program.__globals__, name, None, program.__closure__)
            self._compiled = monitored_jit(program, name=self._label,
                                           fullgraph=True,
                                           backend=self._backend)
        return self._compiled

    def __call__(self, *args, **kwargs):
        if not _to_static_enabled[0]:
            # dygraph semantics: the untransformed function
            return self._raw_fn(*args, **kwargs)
        seed = torch.tensor(_random.draw_seed(), dtype=torch.int64)
        try:
            return self._program()(seed, args, kwargs)
        except torch._dynamo.exc.TorchDynamoException as e:
            self._raise_control_flow(e)

    def _raise_control_flow(self, e):
        """Loud, actionable error (never a silent graph break or a
        specialization on the traced branch): name the pattern and the
        rewrite."""
        causes, c = [], e
        while c is not None and len(causes) < 3:
            line = str(c).strip().splitlines()
            causes.append(f"{type(c).__name__}: {line[0] if line else ''}")
            c = c.__cause__
        raise RuntimeError(
            f"{self._label}: the program could not be compiled as one graph "
            f"-- typically data-dependent Python control flow that dy2static "
            f"could not convert (break/continue/return inside a "
            f"tensor-predicate if/while, `for` over a tensor-valued range, "
            f"or a tensor used as a plain Python bool outside if/while).\n"
            f"{control_flow_guidance()}\n"
            f"Compiler error: {' <- '.join(causes)}") from e

    @property
    def code(self):
        """Transformed source when dy2static rewrote the function
        (reference StaticFunction.code shows converted code), else the
        original source."""
        src = getattr(getattr(self._fn, "__func__", self._fn),
                      "__dy2static_source__", None)
        if src is not None:
            return src
        return inspect.getsource(self._raw_fn)


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, **kwargs):
    """Decorator/wrapper compiling a dygraph function or ``Layer.forward``
    (``backend=None``: inductor; a torch backend name passes through;
    "CINN" raises ``ValueError``)."""

    def decorate(fn):
        if isinstance(fn, torch.nn.Module):
            layer = fn
            layer.forward = StaticFunction(layer.forward, layer=layer,
                                           input_spec=input_spec,
                                           backend=backend)
            return layer
        return StaticFunction(fn, layer=None, input_spec=input_spec,
                              backend=backend)

    if function is not None:
        return decorate(function)
    return decorate


def not_to_static(fn):
    fn._not_to_static = True
    return fn


class TracedLayer:
    """Minimal trace-and-run artifact (reference paddle.jit.TracedLayer)."""

    def __init__(self, static_fn):
        self._fn = static_fn

    def __call__(self, *args, **kwargs):
        return self._fn(*args, **kwargs)


def _spec_dtype(spec) -> torch.dtype:
    from ..core.dtype import convert_dtype

    dt = getattr(spec, "dtype", None)
    return convert_dtype(dt if dt is not None else "float32")


def _example_and_dims(input_spec, device):
    """Example inputs for ``torch.export`` and their dynamic dims: a dim
    given as None or -1 becomes ``torch.export.Dim`` in [DYNAMIC_DIM_MIN,
    DYNAMIC_DIM_MAX] (its example size 2, so export does not specialize
    it to 1)."""
    examples, dims = [], []
    for i, spec in enumerate(input_spec):
        shape, spec_dims = [], {}
        for j, s in enumerate(getattr(spec, "shape", spec)):
            if s is None or (isinstance(s, int) and s < 0):
                spec_dims[j] = torch.export.Dim(
                    f"d{i}_{j}", min=DYNAMIC_DIM_MIN, max=DYNAMIC_DIM_MAX)
                shape.append(2)
            else:
                shape.append(int(s))
        examples.append(torch.zeros(shape, dtype=_spec_dtype(spec),
                                    device=device))
        dims.append(spec_dims or None)
    return examples, dims


class _Program(torch.nn.Module):
    """``fwd(params, *inputs)`` of a layer: its parameters are inputs of
    the exported program, so the program file holds no weights (the layer
    is not registered as a submodule, which would put its parameters in the
    program's state; its buffers, a BatchNorm's statistics, become the
    program's constants, as the JAX package's export closes over them)."""

    def __init__(self, layer):
        super().__init__()
        object.__setattr__(self, "_layer", layer)

    def forward(self, params, *xs):
        from ..nn.functional_call import functional_call

        out = functional_call(self._layer, params, *xs)
        return tuple(out) if isinstance(out, (tuple, list)) else out


def export_program(layer, input_spec, device=None):
    """``torch.export`` of ``fwd(params, *inputs)`` at ``input_spec``'s
    shapes (None/-1 dims dynamic). Returns the ``ExportedProgram``."""
    params = dict(layer.named_parameters())
    dev = device or next(iter(params.values())).device
    examples, dims = _example_and_dims(input_spec, dev)
    param_dims = {k: None for k in params}
    from ..core import dispatch

    with dispatch.suspended(), torch.no_grad():
        ep = torch.export.export(
            _Program(layer), (params, *examples),
            dynamic_shapes=(param_dims, tuple(dims)), strict=False)
    # the example inputs hold the parameters: ``torch.export.save`` would
    # write them into the program file
    ep.example_inputs = None
    return ep


def save(layer, path, input_spec=None, **configs):
    """jit.save: ``<path>.pdiparams`` (the state dict) and, with
    ``input_spec``, ``<path>.pt2``: the ``torch.export`` program of
    ``fwd(params, *inputs)``, weights left out (a 350M model would
    otherwise ship its weights twice). A dim given as None or -1 is
    dynamic in [``DYNAMIC_DIM_MIN``, ``DYNAMIC_DIM_MAX``]. The reference
    emits ``*.pdmodel`` + ``*.pdiparams``, the JAX package
    ``*.stablehlo`` + ``*.pdiparams``; ``<path>.pt2`` loads with
    ``inference.create_predictor`` after ``import paddle_tpu_torch``."""
    from ..framework.io import save as fsave
    from ..inference.aot import save_exported

    fsave(layer.state_dict(), path + ".pdiparams")
    if input_spec:
        save_exported(export_program(layer, input_spec), path + ".pt2")


def load(path, **configs):
    """The state dict ``save`` wrote (what the reference's returns)."""
    from ..framework.io import load as fload

    return fload(path + ".pdiparams")


class TranslatedLayer:
    """Layer-shaped wrapper over a jit.load artifact (reference
    jit/translated_layer.py TranslatedLayer): calls through, with
    program()/train()/eval() for API parity."""

    def __init__(self, loaded):
        self._loaded = loaded
        self.training = False

    def __call__(self, *args, **kwargs):
        return self._loaded(*args, **kwargs)

    forward = __call__

    def program(self, method_name: str = "forward"):
        return getattr(self._loaded, "_exported", None)

    def train(self):
        self.training = True
        return self

    def eval(self):
        self.training = False
        return self

    def __getattr__(self, item):
        return getattr(self._loaded, item)


_ignored_modules = set()


def ignore_module(modules):
    """Register modules dy2static must not transcribe (reference
    jit/api.py ignore_module): bookkeeping, as in the JAX package."""
    if not isinstance(modules, (list, tuple, set)):
        modules = [modules]
    _ignored_modules.update(getattr(m, "__name__", str(m)) for m in modules)
    return sorted(_ignored_modules)


_verbosity = [0]
_code_level = [0]


def set_verbosity(level: int = 0, also_to_stdout: bool = False):
    """Dy2static transcription log verbosity (reference jit/dy2static/
    logging_utils.py); recorded."""
    _verbosity[0] = int(level)


def set_code_level(level: int = 100, also_to_stdout: bool = False):
    """Code-dump level for transformed functions (reference analog);
    recorded. ``StaticFunction.code`` holds the transformed source."""
    _code_level[0] = int(level)
