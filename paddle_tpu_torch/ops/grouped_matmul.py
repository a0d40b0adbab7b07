"""K10: grouped matmul, the MoE expert GEMM (CUDA C++,
``csrc/grouped_matmul.cu``), beside its plain PyTorch version.

Port of ``paddle_tpu/ops/pallas.py::grouped_matmul`` (:231-247): megablox
``gmm`` on the TPU, a gather-einsum fallback elsewhere. Row r of lhs
``[M, K]`` is multiplied by ``rhs[g(r)]`` of ``rhs [G, K, N]``, where the
rows are grouped in order by ``group_sizes [G]`` (empty groups allowed).
Rows past ``sum(group_sizes)`` take the last group, as the fallback's
``clip(#{g: r >= start_g} - 1)`` gives them; megablox assumes the sum is
M (ROADMAP C-ref-5). The result is in ``preferred_element_type`` (fp32 by
default).

The wrapper takes the plain version only for CPU tensors; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["grouped_matmul", "grouped_matmul_ref"]

_IN_DTYPES = {torch.bfloat16: 0, torch.float32: 1}     # in_f32
_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}    # out_bf16


def _check(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor):
    if lhs.dim() != 2 or rhs.dim() != 3 or lhs.shape[1] != rhs.shape[1]:
        raise ValueError(
            f"grouped_matmul takes lhs [M, K] and rhs [G, K, N], got "
            f"{tuple(lhs.shape)}, {tuple(rhs.shape)}")
    if tuple(group_sizes.shape) != (rhs.shape[0],) or rhs.shape[0] == 0:
        raise ValueError(
            f"group_sizes must be [G] with G = {rhs.shape[0]} > 0, got "
            f"{tuple(group_sizes.shape)}")
    if group_sizes.dtype.is_floating_point:
        raise ValueError(f"group_sizes must be integers, got "
                         f"{group_sizes.dtype}")


def grouped_matmul_ref(lhs: torch.Tensor, rhs: torch.Tensor,
                       group_sizes: torch.Tensor,
                       preferred_element_type: torch.dtype = torch.float32
                       ) -> torch.Tensor:
    """Plain version of K10: one fp32 ``torch.matmul`` per non-empty group
    on its row slice (the last group also takes the rows past the sum),
    rounded once to ``preferred_element_type``. Reads the group sizes on
    the host; never gathers ``rhs`` per row."""
    _check(lhs, rhs, group_sizes)
    m, n, g = lhs.shape[0], rhs.shape[2], rhs.shape[0]
    out = torch.zeros((m, n), dtype=preferred_element_type,
                      device=lhs.device)
    start = 0
    for grp, size in enumerate(group_sizes.tolist()):
        end = m if grp == g - 1 else min(start + int(size), m)
        if end > start:
            out[start:end] = (lhs[start:end].float()
                              @ rhs[grp].float()).to(preferred_element_type)
        start = max(start, end)
    return out


def _unit_cols(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def grouped_matmul(lhs: torch.Tensor, rhs: torch.Tensor,
                   group_sizes: torch.Tensor,
                   preferred_element_type: torch.dtype = torch.float32
                   ) -> torch.Tensor:
    """``out[r] = lhs[r] @ rhs[g(r)]`` by row group (K10): lhs [M, K] and
    rhs [G, K, N], both bf16 (tensor cores) or both fp32 (CUDA cores),
    group_sizes [G] integers, out [M, N] in
    ``preferred_element_type`` (fp32 or bf16), summed in fp32. The groups'
    offsets are a cumulative sum made on the card: nothing is read back."""
    _check(lhs, rhs, group_sizes)
    if lhs.device.type == "cpu":
        return grouped_matmul_ref(lhs, rhs, group_sizes,
                                  preferred_element_type)
    devs = {t.device for t in (lhs, rhs, group_sizes)}
    if len(devs) != 1 or lhs.device.type != "cuda":
        raise ValueError(f"grouped_matmul: no kernel for devices {devs}")
    if lhs.dtype != rhs.dtype or lhs.dtype not in _IN_DTYPES:
        raise ValueError(f"grouped_matmul kernel takes lhs and rhs both bf16 "
                         f"or both fp32, got {lhs.dtype}, {rhs.dtype}")
    if preferred_element_type not in _OUT_DTYPES:
        raise ValueError(f"grouped_matmul kernel writes fp32 or bf16, got "
                         f"{preferred_element_type}")
    (m, k), (g, _, n) = lhs.shape, rhs.shape
    out = torch.empty((m, n), dtype=preferred_element_type,
                      device=lhs.device)
    if out.numel() == 0:      # an empty grid is not a launch
        return out
    ends = torch.cumsum(group_sizes, 0, dtype=torch.int32)
    lhs, rhs = _unit_cols(lhs), _unit_cols(rhs)
    lib = _build.load("grouped_matmul")
    fn = lib.grouped_matmul
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 4 + [i] * 4 + [ll] * 3 + [i, i, p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(lhs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(lhs.data_ptr(), rhs.data_ptr(), ends.data_ptr(),
                 out.data_ptr(), m, k, n, g, lhs.stride(0), rhs.stride(0),
                 rhs.stride(1), _IN_DTYPES[lhs.dtype],
                 _OUT_DTYPES[preferred_element_type], stream)
    _build.check(lib, err, "grouped_matmul")
    grouped_matmul.launches += 1
    return out


grouped_matmul.launches = 0
