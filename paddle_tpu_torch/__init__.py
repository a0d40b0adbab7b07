"""paddle_tpu_torch: the PyTorch / CUDA port of paddle_tpu for NVIDIA Hopper.

The JAX package ``paddle_tpu`` stays the reference; this package imports
neither it nor JAX. Its kernels are written by hand for ``sm_90a`` (CUDA C++
built by ``nvcc`` and loaded with ``ctypes``, or Triton where a kernel is a
plain elementwise pass or row reduction), each beside a plain PyTorch
version with the same arithmetic.

Device policy: entry points run on the CUDA card unless the caller passes
``device="cpu"`` or calls ``set_device("cpu")`` (``device.resolve_device``);
without CUDA they raise. A kernel wrapper takes its plain version only for
CPU tensors; for CUDA tensors it launches its kernel or raises.

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

The ``paddle.*`` tensor surface: the dtypes (``float32``, ``int64``, ...,
64-bit names really 64-bit), places and ``set_device`` / ``get_device``,
``seed`` and the generator the random ops draw from (``core``),
``to_tensor``, the gradient switches and the autograd API (``grad``,
``jacobian``, ``hessian``, ``PyLayer``: ``autograd``), and the tensor ops
of creation, math, manipulation, logic, search, random and linalg
(``ops``; ``linalg``), with ``framework.compat``. The tensor is
``torch.Tensor`` and its methods are torch's: the surface is functions.

``paddle.nn`` whole (layers, functions, losses, the decoders),
``paddle.vision`` whole (the model families, the detection operators,
``transforms``, ``datasets`` and the image backend: ``vision``),
``summary`` and ``flops`` (``hapi``) and ``paddle.text`` (Viterbi
decoding and the text datasets: ``text``).

Compile and deploy: ``jit`` (``to_static`` over ``torch.compile`` with the
dy2static pass, ``save`` / ``load``), ``static.InputSpec``, the Predictor
(``inference.Config``, ``create_predictor``, ``inference.aot`` over
``torch.export``) and ``onnx.export``; the kernels K1, K2, K3, K5 and K6
enter compiled and exported programs as ``paddle_tpu::`` library ops.
``geometric`` (message passing and sampling) and incubate's ``asp``,
``autograd``, ``optimizer`` and top-level functions.

``serving``, ``monitor``, ``tracing``, ``testing``, ``profiler``, ``amp``,
``metric``, ``autograd``, ``io``, ``vision``, ``text``, ``jit``,
``static``, ``onnx``, ``geometric`` and ``incubate`` load on first
access (``paddle_tpu_torch.serving``), as in the reference; nothing imports
``http.server`` before ``serve_http`` is called.
"""
import importlib as _importlib

from .core.autograd import (enable_grad, is_grad_enabled, no_grad,
                            set_grad_enabled)
from .core.dtype import (bfloat16, bool_, complex64, complex128, float16,
                         float32, float64, get_default_dtype, int8, int16,
                         int32, int64, set_default_dtype, uint8)
from .core.random import get_rng_state, seed, set_rng_state
from .core.tensor import Tensor, is_tensor, to_tensor
from .device import (CPUPlace, CUDAPlace, TPUPlace, device_count, get_device,
                     is_compiled_with_cuda, is_compiled_with_tpu, set_device)
from .framework import get_flags, load, save, set_flags
from .inference.generation import (CausalLMEngine, ContinuousBatchingEngine,
                                   GenerationConfig,
                                   PagedContinuousBatchingEngine)
from .hapi import Model
from .models import (LlamaConfig, LlamaForCausalLM, build_train_step,
                     llama_config, load_paddle_params, load_stacked_params)

# the tensor ops; from here on max, min, sum, abs, round, pow, all and any
# are the ops, not the builtins
from .ops.creation import *  # noqa: E402,F401,F403
from .ops.math import *  # noqa: E402,F401,F403
from .ops.manipulation import *  # noqa: E402,F401,F403
from .ops.linalg import *  # noqa: E402,F401,F403
from .ops.logic import *  # noqa: E402,F401,F403
from .ops.search import *  # noqa: E402,F401,F403
from .ops.random import *  # noqa: E402,F401,F403
from .ops import linalg  # noqa: E402

__all__ = ["get_device", "get_flags", "set_flags", "LlamaConfig", "LlamaForCausalLM", "llama_config",
           "load_paddle_params", "load_stacked_params", "build_train_step",
           "GenerationConfig", "CausalLMEngine", "ContinuousBatchingEngine",
           "PagedContinuousBatchingEngine", "save", "load", "Model"]

# subpackages that load on first access (PEP 562), as the reference's do
_LAZY_SUBMODULES = {"serving", "monitor", "tracing", "testing", "profiler",
                    "amp", "metric", "autograd", "io", "vision", "text",
                    "jit", "static", "onnx", "geometric", "incubate"}

# names that load their module on first access, as the reference's do
_LAZY_ATTRS = {
    "grad": ("paddle_tpu_torch.autograd", "grad"),
    "finfo": ("paddle_tpu_torch.core.dtype", "finfo"),
    "iinfo": ("paddle_tpu_torch.core.dtype", "iinfo"),
    "dtype": ("paddle_tpu_torch.framework.compat", "dtype"),
    "bool": ("paddle_tpu_torch.core.dtype", "bool_"),
    "CUDAPinnedPlace": ("paddle_tpu_torch.core.place", "CUDAPinnedPlace"),
    "batch": ("paddle_tpu_torch.framework.compat", "batch"),
    "LazyGuard": ("paddle_tpu_torch.framework.compat", "LazyGuard"),
    "check_shape": ("paddle_tpu_torch.framework.compat", "check_shape"),
    "disable_signal_handler": ("paddle_tpu_torch.framework.compat",
                               "disable_signal_handler"),
    "set_printoptions": ("paddle_tpu_torch.framework.compat",
                         "set_printoptions"),
    "tolist": ("paddle_tpu_torch.framework.compat", "tolist"),
    "get_cuda_rng_state": ("paddle_tpu_torch.core.random", "get_rng_state"),
    "set_cuda_rng_state": ("paddle_tpu_torch.core.random", "set_rng_state"),
    "pow_": ("paddle_tpu_torch.framework.compat", "pow_"),
    "index_add_": ("paddle_tpu_torch.framework.compat", "index_add_"),
    "index_put_": ("paddle_tpu_torch.framework.compat", "index_put_"),
    "scatter_": ("paddle_tpu_torch.framework.compat", "scatter_"),
    "squeeze_": ("paddle_tpu_torch.framework.compat", "squeeze_"),
    "tanh_": ("paddle_tpu_torch.framework.compat", "tanh_"),
    "unsqueeze_": ("paddle_tpu_torch.framework.compat", "unsqueeze_"),
    "synchronize": ("paddle_tpu_torch.device", "synchronize"),
    "ParamAttr": ("paddle_tpu_torch.nn.param_attr", "ParamAttr"),
    "summary": ("paddle_tpu_torch.hapi.model_summary", "summary"),
    "flops": ("paddle_tpu_torch.hapi.dynamic_flops", "flops"),
    "to_static": ("paddle_tpu_torch.jit", "to_static"),
}


def __getattr__(name):
    if name in _LAZY_SUBMODULES:
        return _importlib.import_module(f".{name}", __name__)
    if name in _LAZY_ATTRS:
        mod_name, attr = _LAZY_ATTRS[name]
        return getattr(_importlib.import_module(mod_name), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | _LAZY_SUBMODULES | set(_LAZY_ATTRS))
