"""The deploy surface of ``paddle.inference``: ``Config``, ``Predictor``,
``create_predictor`` and ``convert_to_mixed_precision`` (port of
``paddle_tpu/inference/__init__.py:29-270``).

The reference's AnalysisPredictor (``paddle/fluid/inference/api/
analysis_predictor.h:94``, Run at ``:148``) runs an IR-pass pipeline over a
ProgramDesc; the JAX package runs one AOT XLA program from ``jax.export``.
Here the program is the ``torch.export`` program ``jit.save`` writes
(``<path>.pt2``, ``fwd(params, *inputs)``) and the weights are its
``<path>.pdiparams``; the kernels run inside it as the ``paddle_tpu::``
library ops, so a served forward launches the hand-written kernels on the
card. The program is exported once and never retraced at serve time.

Device policy: ``Config``'s device is ``cuda`` when torch sees a card, else
``cpu`` (the JAX package picks its TPU the same way); a program saved on
one device runs on the Config's device.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.dtype import convert_dtype
from ..core.place import resolve_device

__all__ = ["Config", "Predictor", "create_predictor",
           "convert_to_mixed_precision", "PrecisionType", "PlaceType"]


class PrecisionType:
    Float32 = "float32"
    Half = "float16"
    Bfloat16 = "bfloat16"
    Int8 = "int8"


class PlaceType:
    CPU = "cpu"
    GPU = "cuda"
    XPU = "cuda"


class Config:
    """≙ AnalysisConfig (inference/api/paddle_analysis_config.h). The knobs
    that steer the reference's CUDA/TRT/MKLDNN pass pipelines are accepted
    and recorded; the optimization here is the export itself."""

    def __init__(self, model_path: Optional[str] = None,
                 params_path: Optional[str] = None):
        self.model_path = model_path
        self.params_path = params_path or (
            model_path + ".pdiparams" if model_path else None)
        self._device = "cuda" if torch.cuda.is_available() else "cpu"
        self._precision = PrecisionType.Float32
        self._memory_optim = True
        self._ir_optim = True
        self._flags: Dict[str, Any] = {}

    # -- device selection ---------------------------------------------------
    def enable_use_gpu(self, memory_pool_init_size_mb: int = 100,
                       device_id: int = 0,
                       precision=PrecisionType.Float32):
        self._device = f"cuda:{int(device_id)}"
        self._precision = precision

    def disable_gpu(self):
        self._device = "cpu"

    def use_gpu(self) -> bool:
        return self._device != "cpu"

    @property
    def device(self) -> torch.device:
        """The device the predictor runs on (raises for ``cuda`` without a
        card)."""
        return resolve_device(self._device)

    # -- recorded knobs -----------------------------------------------------
    def switch_ir_optim(self, flag: bool = True):
        self._ir_optim = flag

    def enable_memory_optim(self, flag: bool = True):
        self._memory_optim = flag

    def enable_tensorrt_engine(self, *a, **kw):
        raise NotImplementedError(
            "TensorRT is not part of this framework: the serving program is "
            "the torch.export program of jit.save, whose kernels are the "
            "port's own")

    def enable_mkldnn(self):
        pass

    def set_cpu_math_library_num_threads(self, n: int):
        self._flags["cpu_threads"] = n

    def summary(self) -> str:
        return (f"Config(model={self.model_path}, device={self._device}, "
                f"precision={self._precision})")


def _user_input_vals(exported) -> List[Any]:
    """The fake values of the program's user inputs, in order."""
    sig = exported.graph_signature
    by_name = {n.name: n for n in exported.graph.nodes
               if n.op == "placeholder"}
    return [by_name[name].meta["val"] for name in sig.user_inputs]


def _child(spec, i: int):
    """Child ``i`` of a pytree spec (``child`` in newer torch,
    ``children_specs`` before it)."""
    child = getattr(spec, "child", None)
    return child(i) if child is not None else spec.children_specs[i]


class Predictor:
    """≙ AnalysisPredictor (analysis_predictor.h:94). Built from a
    ``Config`` pointing at a ``jit.save`` artifact (``<path>.pt2`` +
    ``<path>.pdiparams``), or from a Layer and example inputs
    (:meth:`from_layer`, which exports the forward once)."""

    def __init__(self, config: Config):
        self.config = config
        self._exported = None
        self._fn = None
        self._params = None
        self._inputs: Dict[str, Any] = {}
        self._input_names: List[str] = []
        self._input_dtypes: List[torch.dtype] = []
        self._outputs: List[torch.Tensor] = []
        if config.model_path:
            self._load(config.model_path)

    # -- loading -------------------------------------------------------------
    def _load(self, path: str):
        from ..framework.io import load as fload
        from .aot import load_exported

        dev = self.config.device
        exported = None
        if os.path.exists(path + ".pt2"):
            exported = load_exported(path + ".pt2")
        params = None
        if os.path.exists(self.config.params_path or ""):
            params = fload(self.config.params_path, device=dev)
        if exported is None and params is None:
            raise FileNotFoundError(
                f"no serving artifact at {path} (.pt2/.pdiparams)")
        if exported is None:
            # jit.save without input_spec exports no program: fail here,
            # not at the first run()
            raise FileNotFoundError(
                f"{path}.pt2 missing: the artifact has weights but no "
                "exported program -- re-save with jit.save(layer, path, "
                "input_spec=[...]) to emit one")
        if params is None:
            raise FileNotFoundError(
                f"{self.config.params_path}: exported program needs its "
                "weights file")
        self._bind(exported, params, dev)

    def _bind(self, exported, params: Dict[str, torch.Tensor], dev):
        """Run ``exported`` (``fwd(params, *inputs)``) on ``dev`` with
        ``params``."""
        from torch.export.passes import move_to_device_pass

        vals = _user_input_vals(exported)
        # the program's first argument: the dict of its parameters (a
        # state dict also holds buffers, which the program keeps itself)
        keys = _child(_child(exported.call_spec.in_spec, 0), 0).context
        n_in = len(vals) - len(keys)
        if any(v.device != dev for v in vals):
            exported = move_to_device_pass(exported, dev)
        self._exported = exported
        self._params = {k: params[k] for k in keys}
        module = exported.module()
        self._fn = lambda *xs: module(self._params, *xs)
        self._input_names = [f"x{i}" for i in range(n_in)]
        self._input_dtypes = [v.dtype for v in vals[len(vals) - n_in:]]
        self._device = dev

    @classmethod
    def from_layer(cls, layer, example_inputs: Sequence[Any],
                   precision: Optional[str] = None):
        """Export ``layer(*example_inputs)`` once (each input's first dim,
        the batch, dynamic); the predictor then runs that program (no
        retracing at serve time). ``precision`` casts the floating
        parameters, and the floating inputs at run time, to that dtype."""
        from ..jit import export_program
        from ..static import InputSpec

        self = cls.__new__(cls)
        self.config = Config()
        self._inputs = {}
        self._outputs = []
        dev = next(iter(layer.parameters())).device
        self.config._device = str(dev)
        exam = [torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x) for x in example_inputs]
        dt = convert_dtype(precision) if precision is not None else None
        if dt is not None:
            exam = [x.to(dt) if x.is_floating_point() else x for x in exam]
            layer = _cast_copy(layer, dt)
        specs = [InputSpec((None,) + tuple(x.shape[1:]), x.dtype)
                 for x in exam]
        params = {k: p.detach() for k, p in layer.named_parameters()}
        self._bind(export_program(layer, specs, dev), params, dev)
        return self

    # -- AnalysisPredictor-shaped API -----------------------------------------
    def get_input_names(self) -> List[str]:
        return list(self._input_names)

    def get_input_handle(self, name: str):
        return _Handle(self._inputs, name)

    def get_output_names(self) -> List[str]:
        return [f"out{i}" for i in range(len(self._outputs))]

    def get_output_handle(self, name: str):
        idx = int(name.replace("out", "") or 0)
        return _OutHandle(self, idx)

    def _tensor(self, x, dtype: torch.dtype) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(x))
        return t.to(device=self._device, dtype=dtype)

    def run(self, inputs: Optional[Sequence[Any]] = None):
        """Run the program. Either pass the inputs (numpy arrays or
        tensors; returns the outputs as numpy, bf16 ones as float32) or
        stage them through the input handles (returns True; read the output
        handles)."""
        explicit = inputs is not None
        if not explicit:
            inputs = [self._inputs[n] for n in self._input_names]
        xs = [self._tensor(x, dt) for x, dt in zip(inputs,
                                                   self._input_dtypes)]
        with torch.no_grad():
            out = self._fn(*xs)
        self._outputs = list(out) if isinstance(out, (tuple, list)) \
            else [out]
        if explicit:
            return [_numpy(o) for o in self._outputs]
        return True

    # -- introspection ---------------------------------------------------------
    def get_serialized_program(self) -> bytes:
        """The program as ``torch.export.save`` writes it."""
        from .aot import serialize_exported

        return serialize_exported(self._exported)


def _cast_copy(layer, dtype: torch.dtype):
    """A copy of ``layer`` with its floating parameters and buffers in
    ``dtype``."""
    import copy

    out = copy.deepcopy(layer)
    for t in list(out.parameters()) + list(out.buffers()):
        if t.is_floating_point():
            t.data = t.data.to(dtype)
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class _Handle:
    def __init__(self, store, name):
        self._store = store
        self._name = name

    def reshape(self, shape):
        pass  # shapes are taken from copy_from_cpu

    def copy_from_cpu(self, arr):
        self._store[self._name] = np.asarray(arr)


class _OutHandle:
    def __init__(self, pred, idx):
        self._pred = pred
        self._idx = idx

    def copy_to_cpu(self) -> np.ndarray:
        return _numpy(self._pred._outputs[self._idx])

    def shape(self):
        return list(self._pred._outputs[self._idx].shape)


def create_predictor(config: Config) -> Predictor:
    """≙ paddle_infer::CreatePredictor."""
    return Predictor(config)


def convert_to_mixed_precision(src_model, src_params, dst_model, dst_params,
                               mixed_precision=PrecisionType.Bfloat16,
                               backend=None, keep_io_types=True,
                               black_list=None):
    """Offline weight conversion (reference convert_to_mixed_precision):
    floating-point params cast to the target dtype, re-saved to
    ``dst_params`` (on the CPU; the program file is not rewritten, as in
    the JAX package)."""
    from ..framework.io import load as fload
    from ..framework.io import save as fsave

    dt = convert_dtype(mixed_precision)
    params = fload(src_params, device="cpu")
    fsave({k: (v.to(dt) if isinstance(v, torch.Tensor)
               and v.is_floating_point() else v)
           for k, v in params.items()}, dst_params)
