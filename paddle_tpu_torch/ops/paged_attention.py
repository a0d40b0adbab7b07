"""K4: paged decode attention (CUDA C++, ``csrc/paged_decode.cu``) beside
its plain PyTorch version, and the stock ``paged_attention`` API over it.

Port of ``paddle_tpu/ops/paged_attention.py::paged_decode_mha`` (pallas_call
at :268) and its plain twin ``_paged_decode_ref`` (:126). The KV cache is a
shared pool of pages ``[num_pages, page_size, Hkv, D]``; a row's cache is its
row of ``page_table`` (page ids in order, -1 unmapped). int8 pools with
per-(page, kv head) absmax scales (the conventions and constants of
``quantization/kv.py``) under a bf16, fp16 or fp32 query (the JAX package stores int8
pages under the model's own dtype, fp32 for its ``"tiny"`` preset, and
dequantizes to fp32 whatever the query's type), or bf16, fp16 or fp32 pools
under a query of their dtype. The kernel reads the pools through their
strides, so a view in another layout is read in place. Any head dim up to
128 (the tile is instantiated at 32, 64 and 128 and masks the columns past
D, so no pool is copied) and any GQA group (more than 8 query heads a group
are split over blocks); :func:`kernel_for` is the dispatch. Mixed float
types, fp64 and head dims above 128 raise ``ValueError``.

:func:`paged_attention` ports ``paddle_tpu/ops/pallas.py::paged_attention``
(:216-228), which calls JAX's stock TPU paged-attention kernel
(``jax.experimental.pallas.ops.tpu.paged_attention``). That kernel differs
from ``paged_decode_mha`` in three ways, all taken care of here: its pools
are ``[Hkv, num_pages, page_size, D]`` (handed to K4 as a permuted view), it
does not scale q by ``1/sqrt(D)`` (K4 runs with scale 1), and it takes an
optional logit soft cap ``c tanh(s / c)`` (K4's ``soft_cap``).

K4 splits each row's context over blocks as K7 does (flash-decoding, a
second kernel combines the splits), with the split from
``decode_attention.split_plan`` on the pool's capacity ``max_pages *
page_size`` in multiples of the page size, never from ``seq_lens``;
:func:`paged_decode_partials_ref` is the plain version of the per-split
partials, for the tests.

The wrappers take the plain version only for CPU tensors; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..quantization.kv import KV_QMAX, KV_SCALE_FLOOR
from . import _build
from .decode_attention import (_TILE, _sm_count, _workspace,
                               decode_partials_ref, split_plan)

__all__ = ["paged_decode_mha", "paged_decode_mha_ref", "paged_attention",
           "paged_attention_ref", "kernel_for", "KV_QMAX", "KV_SCALE_FLOOR",
           "paged_decode_partials_ref", "split_unit"]

_WIDTHS = (32, 64, 128)  # the tile's instances in csrc/paged_decode.cu
_MAX_GROUP = 8           # query heads of a group one block holds
# (query dtype, pool dtype) -> entry point
_ENTRY = {(torch.bfloat16, torch.bfloat16): "paged_decode_bf16",
          (torch.bfloat16, torch.int8): "paged_decode_int8",
          (torch.float16, torch.int8): "paged_decode_int8_f16",
          (torch.float32, torch.int8): "paged_decode_int8_f32",
          (torch.float16, torch.float16): "paged_decode_f16",
          (torch.float32, torch.float32): "paged_decode_f32"}


def kernel_for(q_dtype: torch.dtype, pool_dtype: torch.dtype, d: int,
               group: int):
    """K4's dispatch for a query of ``q_dtype`` over pools of
    ``pool_dtype``, head dim ``d`` and ``group`` query heads per kv head:
    ``(entry point, instantiated width, blocks per (row, kv head))``.
    Raises ``ValueError`` for a pairing without a kernel and head dims
    outside 1..128."""
    entry = _ENTRY.get((q_dtype, pool_dtype))
    if entry is None:
        raise ValueError(
            f"paged decode: no kernel for a {q_dtype} query over "
            f"{pool_dtype} pools; the kernel takes int8 pools under a bf16, "
            f"fp16 or fp32 query and bf16, fp16 or fp32 pools under a query "
            f"of their dtype")
    width = next((w for w in _WIDTHS if 0 < d <= w), None)
    if width is None:
        raise ValueError(f"paged decode: the kernel takes head_dim 1 to "
                         f"{_WIDTHS[-1]}, got {d}")
    return entry, width, -(-group // _MAX_GROUP)


def split_unit(page_size: int) -> int:
    """What K4's splits are a multiple of: whole pages, and a whole
    64-token tile of the kernel where pages divide it."""
    return page_size * max(1, _TILE // page_size)


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


def _scale_and_cap(d: int, sm_scale, soft_cap):
    """(scale, soft cap) as the kernel takes them: 1/sqrt(D) by default,
    cap 0 for none. A cap of c and of -c cap alike (c tanh(s / c) is even
    in c); 0 is refused (the stock kernel divides by it)."""
    scale = 1.0 / math.sqrt(d) if sm_scale is None else float(sm_scale)
    if soft_cap is None:
        return scale, 0.0
    if float(soft_cap) == 0.0:
        raise ValueError("soft_cap must be non-zero (None turns it off)")
    return scale, abs(float(soft_cap))


def _gather(k_pool, v_pool, page_table, k_scale, v_scale):
    """Each row's pages dense, dequantized, fp32: K and V [B, max_pages *
    page_size, Hkv, D] (a -1 entry reads page 0)."""
    b, maxp = page_table.shape
    ps, hkv, d = k_pool.shape[1:]
    idx = page_table.long().clamp_min(0)          # [B, maxp]
    k = k_pool[idx].float()                       # [B, maxp, ps, Hkv, D]
    v = v_pool[idx].float()
    if k_scale is not None:
        k = k * (k_scale[idx].float() / KV_QMAX)[:, :, None, :, None]
        v = v * (v_scale[idx].float() / KV_QMAX)[:, :, None, :, None]
    return k.reshape(b, maxp * ps, hkv, d), v.reshape(b, maxp * ps, hkv, d)


def paged_decode_mha_ref(q: torch.Tensor, k_pool: torch.Tensor,
                         v_pool: torch.Tensor, page_table: torch.Tensor,
                         seq_lens: torch.Tensor,
                         k_scale: Optional[torch.Tensor] = None,
                         v_scale: Optional[torch.Tensor] = None, *,
                         sm_scale: Optional[float] = None,
                         soft_cap: Optional[float] = None) -> torch.Tensor:
    """Plain version of K4: gather each row's pages dense (indexing the
    pools as they are, views included) and run a masked fp32 softmax
    (``_paged_decode_ref``) of the scores times ``sm_scale`` (default
    1/sqrt(D)), soft-capped where ``soft_cap`` is given. Rows with length 0
    give zeros."""
    _check_args(q, k_pool, v_pool, k_scale, v_scale)
    scale, cap = _scale_and_cap(q.shape[2], sm_scale, soft_cap)
    b, h, d = q.shape
    hkv = k_pool.shape[2]
    k, v = _gather(k_pool, v_pool, page_table, k_scale, v_scale)
    n = k.shape[1]
    if h != hkv:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    s = torch.einsum("bhd,blhd->blh", q.float(), k) * scale
    if cap:
        s = cap * torch.tanh(s / cap)
    mask = (torch.arange(n, device=q.device)[None, :, None]
            < seq_lens.to(q.device).long()[:, None, None])
    s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=1).masked_fill(~mask, 0.0)
    return torch.einsum("blh,blhd->bhd", p, v).to(q.dtype)


def paged_decode_partials_ref(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, page_table: torch.Tensor,
                              seq_lens: torch.Tensor,
                              k_scale: Optional[torch.Tensor] = None,
                              v_scale: Optional[torch.Tensor] = None, *,
                              split: int, sm_scale: Optional[float] = None,
                              soft_cap: Optional[float] = None):
    """Plain version of K4's per-split partials before the combine (see
    ``decode_attention.decode_partials_ref``) over each row's gathered
    pages: ``(acc [splits, B, Hq, D], m, l [splits, B, Hq])``, fp32."""
    _check_args(q, k_pool, v_pool, k_scale, v_scale)
    scale, cap = _scale_and_cap(q.shape[2], sm_scale, soft_cap)
    k, v = _gather(k_pool, v_pool, page_table, k_scale, v_scale)
    return decode_partials_ref(q, k, v, seq_lens, split, scale, cap)


def _bind(lib: ctypes.CDLL, entry: str, quant: bool):
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p] * (7 if quant else 5) + [p] + [i] * 6
                       + [ctypes.c_longlong] * 3 + [ctypes.c_float] * 2
                       + [i] + [p] * 4)
        fn.restype = ctypes.c_int
    return fn


def paged_decode_mha(q: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, page_table: torch.Tensor,
                     seq_lens: torch.Tensor,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None, *,
                     sm_scale: Optional[float] = None,
                     soft_cap: Optional[float] = None) -> torch.Tensor:
    """One decode step of attention over a paged KV pool (K4).

    q [B, Hq, D]; k_pool/v_pool [P, page_size, Hkv, D] (Hq a multiple of
    Hkv), any strides, the same for both, with a unit stride on D (read in
    place, never copied); page_table [B, max_pages] int32 (-1 unmapped; entries past a
    row's length are never read); seq_lens [B] int32 (the new token's K/V
    already written at seq_lens - 1); k_scale/v_scale [P, Hkv] fp32 for
    int8 pools. Scores are q.k times ``sm_scale`` (default 1/sqrt(D)),
    then ``soft_cap * tanh(s / soft_cap)`` where a soft cap is given.
    Returns [B, Hq, D] in q's dtype."""
    _check_args(q, k_pool, v_pool, k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_decode_mha_ref(q, k_pool, v_pool, page_table, seq_lens,
                                    k_scale, v_scale, sm_scale=sm_scale,
                                    soft_cap=soft_cap)
    scale, cap = _scale_and_cap(q.shape[2], sm_scale, soft_cap)
    quant = k_scale is not None
    devs = {t.device for t in (q, k_pool, v_pool, page_table, seq_lens)
            + ((k_scale, v_scale) if quant else ())}
    if len(devs) != 1 or q.device.type != "cuda":
        raise ValueError(f"paged decode: no kernel for devices {devs}")
    if k_pool.dtype != v_pool.dtype or quant != (k_pool.dtype == torch.int8):
        raise ValueError(
            f"paged decode kernel takes K and V pools of one dtype, int8 "
            f"with scales and others without, got {k_pool.dtype}/"
            f"{v_pool.dtype}, scales {'given' if quant else 'none'}")
    if quant and (k_scale.dtype != torch.float32
                  or v_scale.dtype != torch.float32):
        raise ValueError("paged decode kernel takes fp32 scales")
    if page_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise ValueError("paged decode kernel takes int32 page_table and "
                         "seq_lens")
    b, h, d = q.shape
    ps, hkv = k_pool.shape[1], k_pool.shape[2]
    entry, _, _ = kernel_for(q.dtype, k_pool.dtype, d, h // hkv)
    if page_table.shape[0] != b or seq_lens.shape != (b,):
        raise ValueError(
            f"page_table {tuple(page_table.shape)} / seq_lens "
            f"{tuple(seq_lens.shape)} do not match batch {b}")
    if k_pool.stride() != v_pool.stride() or k_pool.stride(3) != 1:
        raise ValueError(
            f"paged decode kernel takes K and V pools of the same strides "
            f"with a unit stride on head_dim, got {k_pool.stride()} and "
            f"{v_pool.stride()}")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if b == 0:
        return out
    args = [q.contiguous(), k_pool, v_pool]
    if quant:
        args += [k_scale.contiguous(), v_scale.contiguous()]
    args += [page_table.contiguous(), seq_lens.contiguous()]
    maxp = page_table.shape[1]
    split, n = split_plan(b, hkv, h // hkv, maxp * ps, _sm_count(q.device),
                          split_unit(ps))
    part = _workspace(n, b, h, d, q.device)
    lib = _build.load("paged_decode")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bind(lib, entry, quant)(
            *[t.data_ptr() for t in args], out.data_ptr(), b, h, hkv, d, ps,
            maxp, *k_pool.stride()[:3], scale, cap, split,
            *[t if t is None else t.data_ptr() for t in part], stream)
    _build.check(lib, err, "paged_decode")
    paged_decode_mha.launches += 1
    return out


paged_decode_mha.launches = 0


# the stock kernel's default mask value (paged_attention_kernel.py)
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def _stock_pools(q, k_pages, v_pages, lengths, page_indices, mask_value,
                 pages_per_compute_block, megacore_mode):
    """The stock kernel's argument checks (paged_attention_kernel.py
    :441-483), then its pools as ``[P, page_size, Hkv, D]`` views."""
    if not mask_value <= DEFAULT_MASK_VALUE:
        # the stock kernel adds mask_value to the logits of the tokens past
        # a row's length inside its last compute block; from the default
        # down, exp() of those logits is 0 and they drop out exactly, as
        # here. Above it they take weight, from pages past the length.
        raise ValueError(
            f"paged_attention leaves tokens past a row's length out "
            f"exactly, which the stock kernel does for a mask_value of at "
            f"most DEFAULT_MASK_VALUE ({DEFAULT_MASK_VALUE:g}); got "
            f"{mask_value}")
    for t in (k_pages, v_pages):
        if not t.dtype.is_floating_point:
            raise TypeError(
                f"paged_attention takes unquantized pools, got {t.dtype}: "
                "int8 pools with scales go through paged_decode_mha")
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(
            f"paged_attention takes q [B, H, D] and pools [Hkv, P, "
            f"page_size, D], got {tuple(q.shape)}, {tuple(k_pages.shape)}")
    b, hq, d = q.shape
    hkv, _, _, d_k = k_pages.shape
    if k_pages.shape != v_pages.shape:
        raise ValueError(f"k_pages and v_pages must have the same shape. Got "
                         f"{tuple(k_pages.shape)} and {tuple(v_pages.shape)}")
    if hq % hkv:
        raise ValueError("Number of Q heads must be divisible by number of "
                         f"KV heads. Got {hq} and {hkv}.")
    if d_k != d:
        raise ValueError("head_dim of Q must be the same as that of K/V. Got "
                         f"{d} and {d_k}.")
    if page_indices.dim() != 2:
        raise ValueError("page_indices must be [batch, pages_per_sequence], "
                         f"got {tuple(page_indices.shape)}")
    if page_indices.shape[1] % pages_per_compute_block:
        raise ValueError(
            "pages_per_compute_block must be divisible by pages per "
            f"sequence. Got {pages_per_compute_block} and "
            f"{page_indices.shape[1]}.")
    if tuple(lengths.shape) != (b,):
        raise ValueError("`lengths` and `q` must have the same batch size")
    if page_indices.shape[0] != b:
        raise ValueError("`page_indices` and `q` must have the same batch "
                         "size")
    if lengths.dtype != torch.int32:
        raise ValueError(f"The dtype of `lengths` must be int32. Got "
                         f"{lengths.dtype}")
    if megacore_mode == "kv_head":
        if hkv % 2:
            raise ValueError("number of KV heads must be even when "
                             "megacore_mode is 'kv_head'")
    elif megacore_mode == "batch":
        if b % 2:
            raise ValueError("batch size must be even when megacore_mode is "
                             "'batch'")
    elif megacore_mode is not None:
        raise ValueError("megacore_mode must be one of ['kv_head', 'batch', "
                         "None]")
    return k_pages.permute(1, 2, 0, 3), v_pages.permute(1, 2, 0, 3)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, lengths: torch.Tensor,
                    page_indices: torch.Tensor, *,
                    mask_value: float = DEFAULT_MASK_VALUE,
                    attn_logits_soft_cap: Optional[float] = None,
                    pages_per_compute_block: int,
                    megacore_mode: Optional[str] = None,
                    inline_seq_dim: bool = True) -> torch.Tensor:
    """Decode-time attention over paged KV in the layout of JAX's stock TPU
    kernel, through K4.

    q [B, H, D]; k_pages/v_pages [Hkv, P, page_size, D]; lengths [B] int32;
    page_indices [B, pages_per_sequence] int32 (entries past a row's
    length are never read). Scores are q.k with no 1/sqrt(D) (the stock
    kernel leaves the scaling to its caller), soft-capped as
    ``c tanh(s / c)`` where ``attn_logits_soft_cap`` is c. Tokens past a
    row's length are left out exactly, which is what the stock kernel's
    ``mask_value`` does at its default and below; a larger ``mask_value``
    raises ``ValueError``. Rows of length 0 give zeros.
    ``pages_per_compute_block``, ``megacore_mode`` and ``inline_seq_dim``
    are the TPU kernel's tiling hints: checked as the stock kernel checks
    them, with no effect here. Quantized pools raise ``TypeError``.
    Returns [B, H, D] in q's dtype."""
    kp, vp = _stock_pools(q, k_pages, v_pages, lengths, page_indices,
                          mask_value, pages_per_compute_block, megacore_mode)
    paged_attention.calls += 1
    return paged_decode_mha(q, kp, vp, page_indices, lengths, sm_scale=1.0,
                            soft_cap=attn_logits_soft_cap)


paged_attention.calls = 0


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, lengths: torch.Tensor,
                        page_indices: torch.Tensor, *,
                        mask_value: float = DEFAULT_MASK_VALUE,
                        attn_logits_soft_cap: Optional[float] = None,
                        pages_per_compute_block: int,
                        megacore_mode: Optional[str] = None,
                        inline_seq_dim: bool = True) -> torch.Tensor:
    """Plain version of :func:`paged_attention`: K4's plain version on the
    same permuted views, with scale 1 and the soft cap."""
    kp, vp = _stock_pools(q, k_pages, v_pages, lengths, page_indices,
                          mask_value, pages_per_compute_block, megacore_mode)
    return paged_decode_mha_ref(q, kp, vp, page_indices, lengths,
                                sm_scale=1.0, soft_cap=attn_logits_soft_cap)
