"""paddle_tpu_torch: the PyTorch / CUDA port of paddle_tpu for NVIDIA Hopper.

The JAX package ``paddle_tpu`` stays the reference; this package imports
neither it nor JAX. Its kernels are written by hand for ``sm_90a`` (CUDA C++
built by ``nvcc`` and loaded with ``ctypes``, or Triton where a kernel is a
plain elementwise pass or row reduction), each beside a plain PyTorch
version with the same arithmetic.

Device policy: entry points run on the CUDA card unless the caller passes
``device="cpu"`` (:func:`get_device`); without CUDA they raise. A kernel
wrapper takes its plain version only for CPU tensors; for CUDA tensors it
launches its kernel or raises.

Ported so far: inference of the Llama causal LM (``models.llama``,
``inference.generation``: the offline ``CausalLMEngine.generate`` and the
dense and paged continuous-batching engines, their decode captured as CUDA
graphs with ``warmup()`` and ``reset_state()``, int8 KV pools on the
paged engine, ``quantization.kv``, chunked prefill and chunked admission,
and greedy or sampled decoding per request, ``inference.sampling``), its
training, through the
Layer API (``model(ids, labels).backward()``, with ``recompute``) and the
functional AdamW step (``models.llama_functional.build_train_step``,
``optimizer.functional``), and the incubate ``FusedMultiTransformer``
(``incubate.nn``); their eight kernels (``ops``): RMSNorm, LayerNorm,
rotary embedding, flash attention forward with dropout, its two backward
kernels, paged and dense-cache decode attention. Also the JAX package's
public kernel ops that no model calls yet: ``fused_linear_param_grad_add``
and ``grouped_matmul`` (two more kernels), the stock-layout
``paged_attention`` (over the paged decode kernel) and the head-batched
flash route under ``FLAGS_flash_head_batched`` (``get_flags``,
``set_flags``). The online serving front over the engines (``serving``:
``Server``, ``RequestQueue``, the overload control plane and
``serve_http``) with the host modules it needs: the metrics registry and
SLO digests (``monitor``, ``monitor.slo``, ``monitor.provenance``), the
request trace ring and flight recorder (``tracing``) and deterministic
fault injection (``testing``), switched by ``FLAGS_enable_monitor`` and
``FLAGS_enable_trace``.

The eager training surface, as a PaddlePaddle user trains: the optimizers,
LR schedulers and regularizers (``optimizer``, ``optimizer.lr``), the
gradient clips and losses (``nn``, ``nn.functional``), AMP with the
reference's op lists, ``GradScaler`` and the nan/inf checks (``amp``,
``FLAGS_check_nan_inf``), main-gradient mixed precision
(``distributed.fleet.utils``), ``save``/``load``, ``metric`` and ``Model``
with its callbacks (``hapi``); ``build_train_step`` also takes the selective
remat policies ``"attn_out"`` and ``"dots"``.

``serving``, ``monitor``, ``tracing``, ``testing``, ``profiler``, ``amp``
and ``metric`` load on first access (``paddle_tpu_torch.serving``), as in
the reference; nothing imports ``http.server`` before ``serve_http`` is
called.
"""
import importlib as _importlib

from .device import get_device
from .framework import get_flags, load, save, set_flags
from .inference.generation import (CausalLMEngine, ContinuousBatchingEngine,
                                   GenerationConfig,
                                   PagedContinuousBatchingEngine)
from .hapi import Model
from .models import (LlamaConfig, LlamaForCausalLM, build_train_step,
                     llama_config, load_paddle_params, load_stacked_params)

__all__ = ["get_device", "get_flags", "set_flags", "LlamaConfig", "LlamaForCausalLM", "llama_config",
           "load_paddle_params", "load_stacked_params", "build_train_step",
           "GenerationConfig", "CausalLMEngine", "ContinuousBatchingEngine",
           "PagedContinuousBatchingEngine", "save", "load", "Model"]

# subpackages that load on first access (PEP 562), as the reference's do
_LAZY_SUBMODULES = {"serving", "monitor", "tracing", "testing", "profiler",
                    "amp", "metric"}


def __getattr__(name):
    if name in _LAZY_SUBMODULES:
        return _importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
