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

Each row's context is split over several blocks (flash-decoding): every
block leaves the online softmax's (m, l, acc) of its split, and a second
kernel combines the splits. :func:`split_plan` sizes the splits from the
shapes alone (the cache's capacity, never ``seq_lens``), so no length is
read on the host; :func:`decode_partials_ref` and
:func:`combine_partials_ref` are the plain algebra of the two kernels, for
the tests.

The wrapper takes the plain version only for CPU tensors; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from ._launches import costed, count

__all__ = ["decode_mha", "decode_mha_ref", "kernel_for", "split_plan",
           "decode_partials_ref", "combine_partials_ref"]

_WIDTHS = (32, 64, 128)  # the tile's instances in csrc/decode_mha.cu
_MAX_GROUP = 8           # query heads of a group one block holds
_TILE = 64               # tokens a split is a multiple of (a kernel tile)
# the grid the split plan aims at, per SM: of 2, 3, 4, 6, 8, 16 and 32, 4
# read fastest at the 7B serve shape on an H100 (PERF.md, section 6)
_BLOCKS_PER_SM = 4
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


def split_plan(batch: int, hkv: int, group: int, ctx_len: int,
               sm_count: int = 132, unit: int = _TILE):
    """How K7 and K4 cut each row's context over blocks: ``(tokens per
    split, number of splits)``. The splits are multiples of ``unit`` (64
    for K7; K4 passes a multiple of its page size) and cover ``ctx_len``,
    the cache's capacity (K7: S; K4: max_pages * page_size), exactly once:
    ``(splits - 1) * split < ctx_len <= splits * split``. The plan depends
    on these shapes alone, never on the rows' lengths, so the wrappers read
    nothing back from the card and the grid is fixed by the shapes. It aims
    at about ``_BLOCKS_PER_SM * sm_count`` blocks of one (row, kv head, at
    most 8 query heads, split) each, so that a ragged batch still leaves
    several blocks an SM once the splits past each row's length have
    returned; a single split where the unsplit grid reaches that already
    or the context fits one unit."""
    blocks = batch * hkv * -(-group // _MAX_GROUP)
    units = max(1, -(-ctx_len // unit))
    want = max(1, -(-_BLOCKS_PER_SM * sm_count // max(1, blocks)))
    split = -(-units // min(want, units)) * unit
    return split, max(1, -(-ctx_len // split))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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


def decode_partials_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        seq_lens: torch.Tensor, split: int,
                        scale: Optional[float] = None,
                        soft_cap: float = 0.0):
    """Plain version of what the split kernels leave before the combine:
    for each split ``s`` of ``split`` tokens, row b and query head h, over
    the split's tokens below ``seq_lens[b]``, the max score m, l = sum
    exp(score - m) and acc = sum exp(score - m) v, unnormalized. q [B, Hq,
    D]; k, v [B, N, Hkv, D], dense (K4's plain path gathers its pages
    first); scores q.k * ``scale`` (default 1/sqrt(D)), then ``soft_cap *
    tanh(s / soft_cap)`` where ``soft_cap`` > 0. Returns fp32 ``(acc
    [splits, B, Hq, D], m [splits, B, Hq], l [splits, B, Hq])``; a split
    with no live token gives m = -1e30, l = 0, acc = 0."""
    b, hq, d = q.shape
    n_tok, hkv = k.shape[1], k.shape[2]
    n = max(1, -(-n_tok // split))
    q4 = q.float().reshape(b, hkv, hq // hkv, d)
    s = torch.einsum("bkgd,bskd->bkgs", q4, k.float()) * (
        1.0 / math.sqrt(d) if scale is None else scale)
    if soft_cap:
        s = soft_cap * torch.tanh(s / soft_cap)
    pad = n * split - n_tok
    s = F.pad(s, (0, pad)).reshape(*s.shape[:3], n, split)
    v = F.pad(v.float(), (0, 0, 0, 0, 0, pad)).reshape(b, n, split, hkv, d)
    pos = torch.arange(n * split, device=q.device).reshape(n, split)
    mask = ((pos < seq_lens.to(q.device).long()[:, None, None, None, None])
            & (pos < n_tok))
    s = s.masked_fill(~mask, -1e30)
    m = s.amax(-1)                                      # [B, Hkv, G, n]
    p = torch.exp(s - m[..., None]).masked_fill(~mask, 0.0)
    acc = torch.einsum("bkgns,bnskd->nbkgd", p, v).reshape(n, b, hq, d)
    return (acc, m.permute(3, 0, 1, 2).reshape(n, b, hq),
            p.sum(-1).permute(3, 0, 1, 2).reshape(n, b, hq))


def combine_partials_ref(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                         seq_lens: torch.Tensor, split: int,
                         dtype: torch.dtype) -> torch.Tensor:
    """Plain version of the combine kernel: for each row b it reads only
    its first ceil(seq_lens[b] / split) partials (the splits the kernel
    wrote; the rest may hold anything), rescales each by exp(m_i - M), M
    their max, and returns sum acc_i exp(m_i - M) / max(sum l_i exp(m_i -
    M), 1e-30) in ``dtype``: [B, Hq, D]. A row of length 0 gives zeros."""
    n = acc.shape[0]
    live = (torch.arange(n, device=acc.device)[:, None]
            < -(-seq_lens.to(acc.device).long() // split))[:, :, None]
    m = m.masked_fill(~live, -1e30)
    mx = m.amax(0)
    w = torch.exp(m - mx).masked_fill(~live, 0.0)        # [n, B, Hq]
    tot = (l.masked_fill(~live, 0.0) * w).sum(0)
    o = (acc.masked_fill(~live[..., None], 0.0) * w[..., None]).sum(0)
    return (o / tot.clamp_min(1e-30)[..., None]).to(dtype)


def _bind(lib: ctypes.CDLL, name: str):
    fn = getattr(lib, name)
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([p] * 5 + [i] * 5 + [ll] * 6 + [ctypes.c_float, i]
                       + [p] * 4)
        fn.restype = ctypes.c_int
    return fn


def _workspace(n: int, b: int, hq: int, d: int, device):
    """The split kernels' fp32 partials, (acc [n, B, Hq, D], m and l [n,
    B, Hq]) as pointers; none for one split."""
    if n == 1:
        return None, None, None
    acc = torch.empty((n, b, hq, d), dtype=torch.float32, device=device)
    ml = torch.empty((2, n, b, hq), dtype=torch.float32, device=device)
    return acc, ml[0], ml[1]


def _decode_cost(q, k_cache, v_cache, seq_lens):
    """K7's (FLOPs, bytes) on this run's lengths (``seq_lens`` read back):
    4 D operations a live token a query head; each live token's K and V
    rows read once, q read and out written once, the lengths read once."""
    b, hq, d = q.shape
    tokens = int(seq_lens.sum())
    return 4 * d * tokens * hq, (
        tokens * k_cache.shape[2] * d * k_cache.element_size() * 2
        + 2 * q.numel() * q.element_size() + b * 4)


@costed(_decode_cost)
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
    split, n = split_plan(b, hkv, hq // hkv, s_max, _sm_count(q.device))
    part = _workspace(n, b, hq, d, q.device)
    lib = _build.load("decode_mha")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bind(lib, entry)(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            seq_lens.data_ptr(), out.data_ptr(), b, hq, hkv, d, s_max,
            *k_cache.stride()[:3], *v_cache.stride()[:3],
            1.0 / math.sqrt(d), split,
            *[t if t is None else t.data_ptr() for t in part], stream)
    _build.check(lib, err, "decode_mha")
    count(decode_mha)
    return out


decode_mha.launches = 0
