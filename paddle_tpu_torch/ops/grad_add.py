"""K9: ``fused_linear_param_grad_add`` (CUDA C++, ``csrc/grad_add.cu``)
beside its plain PyTorch version.

Port of ``paddle_tpu/ops/pallas_kernels.py::fused_linear_param_grad_add``
(``_grad_add_kernel``, pallas_call at :439): the main-grad accumulation of
a linear layer's weight, ``dweight + x^T dy`` summed in fp32. The JAX
function returns a new fp32 array (its ``input_output_aliases`` donate
nothing under ``jax.jit``), so the port returns a new fp32 tensor and
leaves the caller's ``dweight`` as it was.

The kernel has three instances (``csrc/grad_add.cu``), and
:func:`kernel_for` is the dispatch: bf16 operands TMA can read go to the
Hopper instance (TMA and ``wgmma``), other bf16 operands to the
``mma.sync`` one, fp32 operands to the CUDA cores. No instance splits the
sum over T across blocks, so two launches give bitwise-equal results.

The wrapper takes the plain version only for CPU tensors; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _build

__all__ = ["fused_linear_param_grad_add", "fused_linear_param_grad_add_ref",
           "kernel_for"]

_IN_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_DW_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the C entry point of each instance
_ENTRIES = {"wgmma": "grad_add_wgmma", "mma_sync": "grad_add",
            "f32": "grad_add"}


def kernel_for(dtype: torch.dtype, t: int, k: int, n: int,
               strides: Sequence[int], ptrs: Sequence[int]) -> str:
    """K9's dispatch for x [t, k] and dy [t, n] of ``dtype``, with
    ``strides`` their row strides in elements and ``ptrs`` their data
    pointers: "wgmma" for bf16 operands TMA can read (t > 0, k and n
    multiples of 8, the strides multiples of 8 elements, i.e. 16 bytes,
    the pointers 16-byte aligned), "mma_sync" for other bf16 operands,
    "f32" for fp32 ones. Raises ``ValueError`` for other dtypes."""
    if dtype == torch.float32:
        return "f32"
    if dtype != torch.bfloat16:
        raise ValueError(f"fused_linear_param_grad_add: no kernel for "
                         f"{dtype}; the kernel takes bfloat16 and float32")
    tma = (t > 0 and k % 8 == 0 and n % 8 == 0
           and all(st % 8 == 0 for st in strides)
           and all(p % 16 == 0 for p in ptrs))
    return "wgmma" if tma else "mma_sync"


def _flatten(x: torch.Tensor, dy: torch.Tensor, dweight: torch.Tensor):
    """x [..., K] and dy [..., N] as [T, K] and [T, N]."""
    if dweight.dim() != 2 or x.shape[-1] != dweight.shape[0] \
            or dy.shape[-1] != dweight.shape[1]:
        raise ValueError(
            f"fused_linear_param_grad_add takes x [..., K], dy [..., N] and "
            f"dweight [K, N], got {tuple(x.shape)}, {tuple(dy.shape)}, "
            f"{tuple(dweight.shape)}")
    x2 = x.reshape(-1, x.shape[-1])
    dy2 = dy.reshape(-1, dy.shape[-1])
    if x2.shape[0] != dy2.shape[0]:
        raise ValueError(f"x and dy hold {x2.shape[0]} and {dy2.shape[0]} "
                         "rows")
    return x2, dy2


def fused_linear_param_grad_add_ref(x: torch.Tensor, dy: torch.Tensor,
                                    dweight: torch.Tensor) -> torch.Tensor:
    """Plain version of K9: ``dweight.float() + x2.float()^T dy2.float()``
    in fp32, a new tensor."""
    x2, dy2 = _flatten(x, dy, dweight)
    return dweight.float() + x2.float().t() @ dy2.float()


def _rows(t: torch.Tensor) -> torch.Tensor:
    """Unit column stride and a row stride the kernel can take."""
    return t if t.stride(1) == 1 and t.stride(0) >= t.shape[1] \
        else t.contiguous()


def _launch(instance: str, x2: torch.Tensor, dy2: torch.Tensor,
            dw: torch.Tensor, out: torch.Tensor) -> None:
    """One launch of ``instance`` on CUDA tensors (x2 and dy2 as
    :func:`_rows` gives them, dw and out contiguous); raises on a CUDA
    error."""
    (t, k), n = x2.shape, dy2.shape[1]
    lib = _build.load("grad_add")
    fn = getattr(lib, _ENTRIES[instance])
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 4 + [i] * 3 + [ll] * 2 + [i] * 2 + [p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x2.data_ptr(), dy2.data_ptr(), dw.data_ptr(), out.data_ptr(),
                 t, k, n, x2.stride(0), dy2.stride(0), _IN_DTYPES[x2.dtype],
                 _DW_DTYPES[dw.dtype], stream)
    _build.check(lib, err, _ENTRIES[instance])


def fused_linear_param_grad_add(x: torch.Tensor, dy: torch.Tensor,
                                dweight: torch.Tensor) -> torch.Tensor:
    """``dweight + x^T dy`` as a new fp32 [K, N] tensor (K9): x [..., K]
    and dy [..., N] flattened to [T, K] and [T, N], both bf16 (tensor
    cores) or both fp32 (CUDA cores); dweight [K, N] fp32, bf16 or fp16.
    Every product is summed in fp32; ``dweight`` is not changed."""
    x2, dy2 = _flatten(x, dy, dweight)
    if x.device.type == "cpu":
        return fused_linear_param_grad_add_ref(x, dy, dweight)
    devs = {t.device for t in (x, dy, dweight)}
    if len(devs) != 1 or x.device.type != "cuda":
        raise ValueError(f"fused_linear_param_grad_add: no kernel for "
                         f"devices {devs}")
    if x.dtype not in _IN_DTYPES or dy.dtype != x.dtype:
        raise ValueError(
            f"fused_linear_param_grad_add kernel takes x and dy both bf16 or "
            f"both fp32, got {x.dtype}, {dy.dtype}")
    if dweight.dtype not in _DW_DTYPES:
        raise ValueError(
            f"fused_linear_param_grad_add kernel takes an fp32, bf16 or fp16 "
            f"dweight, got {dweight.dtype}")
    (t, k), n = x2.shape, dy2.shape[1]
    out = torch.empty((k, n), dtype=torch.float32, device=x.device)
    if out.numel() == 0:      # an empty grid is not a launch
        return out
    x2, dy2, dw = _rows(x2), _rows(dy2), dweight.contiguous()
    instance = kernel_for(x2.dtype, t, k, n, (x2.stride(0), dy2.stride(0)),
                          (x2.data_ptr(), dy2.data_ptr()))
    _launch(instance, x2, dy2, dw, out)
    fused_linear_param_grad_add.launches += 1
    return out


fused_linear_param_grad_add.launches = 0
