"""K4: paged decode attention (CUDA C++, ``csrc/paged_decode.cu``) beside
its plain PyTorch version.

Port of ``paddle_tpu/ops/paged_attention.py::paged_decode_mha`` (pallas_call
at :268) and its plain twin ``_paged_decode_ref`` (:126). The KV cache is a
shared pool of pages ``[num_pages, page_size, Hkv, D]``; a row's cache is its
row of ``page_table`` (page ids in order, -1 unmapped). bf16 pools, or int8
pools with per-(page, kv head) absmax scales (``quantization/kv.py``
conventions, copied below).

The wrapper takes the plain version only for CPU tensors; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

__all__ = ["paged_decode_mha", "paged_decode_mha_ref", "KV_QMAX",
           "KV_SCALE_FLOOR"]

# int8 KV conventions (copied from paddle_tpu/quantization/kv.py):
# value = int8 * scale / KV_QMAX; scales never drop below the floor
KV_QMAX = 127.0
KV_SCALE_FLOOR = 1e-8

_HEAD_DIMS = (64, 128)   # instantiated in csrc/paged_decode.cu
_MAX_GROUP = 8           # query heads per kv head the kernel holds


def _check_args(q, k_pool, v_pool, k_scale, v_scale):
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale or neither")
    if q.dim() != 3 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"paged decode takes q [B, Hq, D] and pools [P, page_size, Hkv, "
            f"D], got {tuple(q.shape)}, {tuple(k_pool.shape)}, "
            f"{tuple(v_pool.shape)}")
    h, hkv = q.shape[1], k_pool.shape[2]
    if h % hkv:
        raise ValueError(f"Hq={h} not a multiple of Hkv={hkv}")


def paged_decode_mha_ref(q: torch.Tensor, k_pool: torch.Tensor,
                         v_pool: torch.Tensor, page_table: torch.Tensor,
                         seq_lens: torch.Tensor,
                         k_scale: Optional[torch.Tensor] = None,
                         v_scale: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Plain version of K4: gather each row's pages dense and run a masked
    fp32 softmax (``_paged_decode_ref``). Rows with length 0 give zeros."""
    _check_args(q, k_pool, v_pool, k_scale, v_scale)
    b, h, d = q.shape
    ps, hkv = k_pool.shape[1], k_pool.shape[2]
    idx = page_table.long().clamp_min(0)                  # [B, maxp]
    k = k_pool[idx].float()                               # [B, maxp, ps, Hkv, D]
    v = v_pool[idx].float()
    if k_scale is not None:
        k = k * (k_scale[idx].float() / KV_QMAX)[:, :, None, :, None]
        v = v * (v_scale[idx].float() / KV_QMAX)[:, :, None, :, None]
    n = idx.shape[1] * ps
    k = k.reshape(b, n, hkv, d)
    v = v.reshape(b, n, hkv, d)
    if h != hkv:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    s = torch.einsum("bhd,blhd->blh", q.float(), k) * (1.0 / math.sqrt(d))
    mask = (torch.arange(n, device=q.device)[None, :, None]
            < seq_lens.to(q.device).long()[:, None, None])
    s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=1).masked_fill(~mask, 0.0)
    return torch.einsum("blh,blhd->bhd", p, v).to(q.dtype)


def _bind(lib: ctypes.CDLL, quant: bool):
    fn = lib.paged_decode_int8 if quant else lib.paged_decode_bf16
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p] * (7 if quant else 5) + [p] + [i] * 6
                       + [ctypes.c_float, p])
        fn.restype = ctypes.c_int
    return fn


def paged_decode_mha(q: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, page_table: torch.Tensor,
                     seq_lens: torch.Tensor,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decode step of attention over a paged KV pool (K4).

    q [B, Hq, D]; k_pool/v_pool [P, page_size, Hkv, D] (Hq a multiple of
    Hkv); page_table [B, max_pages] int32 (-1 unmapped; entries past a
    row's length are never read); seq_lens [B] int32 (the new token's K/V
    already written at seq_lens - 1); k_scale/v_scale [P, Hkv] fp32 for
    int8 pools. Returns [B, Hq, D] in q's dtype."""
    _check_args(q, k_pool, v_pool, k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_decode_mha_ref(q, k_pool, v_pool, page_table, seq_lens,
                                    k_scale, v_scale)
    quant = k_scale is not None
    devs = {t.device for t in (q, k_pool, v_pool, page_table, seq_lens)
            + ((k_scale, v_scale) if quant else ())}
    if len(devs) != 1 or q.device.type != "cuda":
        raise ValueError(f"paged decode: no kernel for devices {devs}")
    pool_dtype = torch.int8 if quant else torch.bfloat16
    if (q.dtype != torch.bfloat16 or k_pool.dtype != pool_dtype
            or v_pool.dtype != pool_dtype):
        raise ValueError(
            f"paged decode kernel takes a bf16 query and {pool_dtype} pools, "
            f"got {q.dtype}, {k_pool.dtype}/{v_pool.dtype}")
    if quant and (k_scale.dtype != torch.float32
                  or v_scale.dtype != torch.float32):
        raise ValueError("paged decode kernel takes fp32 scales")
    if page_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise ValueError("paged decode kernel takes int32 page_table and "
                         "seq_lens")
    b, h, d = q.shape
    ps, hkv = k_pool.shape[1], k_pool.shape[2]
    if d not in _HEAD_DIMS or h // hkv > _MAX_GROUP:
        raise ValueError(
            f"paged decode kernel takes head_dim in {_HEAD_DIMS} and at most "
            f"{_MAX_GROUP} query heads per kv head, got D={d}, "
            f"group={h // hkv}")
    if page_table.shape[0] != b or seq_lens.shape != (b,):
        raise ValueError(
            f"page_table {tuple(page_table.shape)} / seq_lens "
            f"{tuple(seq_lens.shape)} do not match batch {b}")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if b == 0:
        return out
    args = [q.contiguous(), k_pool.contiguous(), v_pool.contiguous()]
    if quant:
        args += [k_scale.contiguous(), v_scale.contiguous()]
    args += [page_table.contiguous(), seq_lens.contiguous()]
    lib = _build.load("paged_decode")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bind(lib, quant)(
            *[t.data_ptr() for t in args], out.data_ptr(), b, h, hkv, d, ps,
            page_table.shape[1], 1.0 / math.sqrt(d), stream)
    _build.check(lib, err, "paged_decode")
    paged_decode_mha.launches += 1
    return out


paged_decode_mha.launches = 0
