"""K7: decode attention over a dense KV cache (CUDA C++,
``csrc/decode_mha.cu``) beside its plain PyTorch version.

Port of ``paddle_tpu/ops/pallas_kernels.py::decode_mha`` (``_decode_kernel``,
pallas_call in ``_decode_mha_jit`` at :368) and of the grouped einsum branch
of ``paddle_tpu/ops/_decode.py::gqa_decode_attention`` (:53-67): one query
token per row over caches ``[B, S, Hkv, D]``, each row attending its first
``seq_lens[b]`` positions. The TPU kernel was MHA-only; this one takes GQA
(Hq a multiple of Hkv) itself, so both branches of the TPU dispatch become
this one kernel.

The kernel takes bf16, fp16 and fp32, any head dim up to 128 (its tile is
instantiated at 32, 64 and 128 and masks the columns past D, so the cache
is never copied) and any GQA group (groups of more than 8 query heads are
split over blocks); :func:`kernel_for` is the dispatch. Other dtypes and
head dims above 128 raise ``ValueError``.

The wrapper takes the plain version only for CPU tensors; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["decode_mha", "decode_mha_ref", "kernel_for"]

_WIDTHS = (32, 64, 128)  # the tile's instances in csrc/decode_mha.cu
_MAX_GROUP = 8           # query heads of a group one block holds
_ENTRY = {torch.bfloat16: "decode_mha_bf16", torch.float16: "decode_mha_f16",
          torch.float32: "decode_mha_f32"}


def kernel_for(dtype: torch.dtype, d: int, group: int):
    """K7's dispatch for q and caches of ``dtype``, head dim ``d`` and
    ``group`` query heads per kv head: ``(entry point, instantiated width,
    blocks per (kv head, row))``. Raises ``ValueError`` for a dtype
    without a kernel and head dims outside 1..128."""
    if dtype not in _ENTRY:
        raise ValueError(f"decode_mha: no kernel for {dtype}; the kernel "
                         f"takes bfloat16, float16 and float32")
    width = next((w for w in _WIDTHS if 0 < d <= w), None)
    if width is None:
        raise ValueError(f"decode_mha: the kernel takes head_dim 1 to "
                         f"{_WIDTHS[-1]}, got {d}")
    return _ENTRY[dtype], width, -(-group // _MAX_GROUP)


def _check_args(q, k_cache, v_cache, seq_lens):
    if (q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape
            or k_cache.shape[0] != q.shape[0]
            or k_cache.shape[3] != q.shape[2]):
        raise ValueError(
            f"decode attention takes q [B, Hq, D] and caches [B, S, Hkv, D], "
            f"got {tuple(q.shape)}, {tuple(k_cache.shape)}, "
            f"{tuple(v_cache.shape)}")
    if q.shape[1] % k_cache.shape[2]:
        raise ValueError(f"Hq={q.shape[1]} not a multiple of "
                         f"Hkv={k_cache.shape[2]}")
    if seq_lens.shape != (q.shape[0],):
        raise ValueError(f"seq_lens {tuple(seq_lens.shape)} does not match "
                         f"batch {q.shape[0]}")


def decode_mha_ref(q: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor,
                   seq_lens: torch.Tensor) -> torch.Tensor:
    """Plain version of K7: fp32 scores, mask ``pos < len``, softmax, P.V,
    cast to q's dtype (the math of ``_decode_kernel`` and of the einsum
    branch). Rows with length 0 give zeros."""
    _check_args(q, k_cache, v_cache, seq_lens)
    b, hq, d = q.shape
    s_max, hkv = k_cache.shape[1], k_cache.shape[2]
    q4 = q.float().reshape(b, hkv, hq // hkv, d)
    s = torch.einsum("bkgd,bskd->bkgs", q4, k_cache.float()) * (
        1.0 / math.sqrt(d))
    mask = (torch.arange(s_max, device=q.device)[None, None, None, :]
            < seq_lens.to(q.device).long()[:, None, None, None])
    s = s.masked_fill(~mask, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True)).masked_fill(~mask, 0.0)
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return o.reshape(b, hq, d).to(q.dtype)


def _bind(lib: ctypes.CDLL, name: str):
    fn = getattr(lib, name)
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 5 + [i] * 5 + [ll] * 6 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def decode_mha(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
               seq_lens: torch.Tensor) -> torch.Tensor:
    """One decode step of attention over a dense KV cache (K7).

    q [B, Hq, D]; k_cache/v_cache [B, S, Hkv, D] (Hq a multiple of Hkv; any
    strides with unit stride on D), the new token's K/V already written at
    ``seq_lens - 1``; seq_lens [B] int32. Returns [B, Hq, D] in q's dtype.
    Not differentiable (the TPU kernel has no VJP either)."""
    _check_args(q, k_cache, v_cache, seq_lens)
    if q.device.type == "cpu":
        return decode_mha_ref(q, k_cache, v_cache, seq_lens)
    devs = {t.device for t in (q, k_cache, v_cache, seq_lens)}
    if len(devs) != 1 or q.device.type != "cuda":
        raise ValueError(f"decode_mha: no kernel for devices {devs}")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(
            f"decode_mha kernel takes caches of q's dtype, got {q.dtype}, "
            f"{k_cache.dtype}/{v_cache.dtype}")
    if seq_lens.dtype != torch.int32:
        raise ValueError("decode_mha kernel takes int32 seq_lens")
    b, hq, d = q.shape
    s_max, hkv = k_cache.shape[1], k_cache.shape[2]
    entry, _, _ = kernel_for(q.dtype, d, hq // hkv)
    out = torch.empty((b, hq, d), dtype=q.dtype, device=q.device)
    if b == 0 or hq == 0:
        return out
    q = q.contiguous()
    k_cache = k_cache if k_cache.stride(-1) == 1 else k_cache.contiguous()
    v_cache = v_cache if v_cache.stride(-1) == 1 else v_cache.contiguous()
    seq_lens = seq_lens.contiguous()
    lib = _build.load("decode_mha")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bind(lib, entry)(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            seq_lens.data_ptr(), out.data_ptr(), b, hq, hkv, d, s_max,
            *k_cache.stride()[:3], *v_cache.stride()[:3],
            1.0 / math.sqrt(d), stream)
    _build.check(lib, err, "decode_mha")
    decode_mha.launches += 1
    return out


decode_mha.launches = 0
