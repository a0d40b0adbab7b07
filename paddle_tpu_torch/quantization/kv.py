"""int8 KV-cache quantization math (port of ``paddle_tpu/quantization/kv.py``).

One home for the absmax quantize / dequantize arithmetic of the int8 KV
path: the page-pool store (``inference/paged_cache.py::write_tokens_q``,
the paged decode step of ``models/llama.py``) and the fused dequant of the
paged decode kernel (``ops/paged_attention.py``) all take their constants
from here, so the quantizer and the kernel's dequant cannot drift apart.

Conventions (symmetric absmax, one fp32 scale per page and kv head):

- a scale ``s`` is the running absmax of everything quantized against it,
  never below :data:`KV_SCALE_FLOOR` (a never-written page dequantizes to
  ~0, not NaN);
- quantize: ``q = clip(round(x / s * KV_QMAX), -KV_QMAX, KV_QMAX)``;
  ``torch.round`` rounds half to even, as ``jnp.round`` does, and the order
  of operations is the reference's, so pool bytes are equal, not close;
- dequantize: ``x = q * s / KV_QMAX``, i.e. ``q *`` :func:`dequant_scale`.

The port's pools carry a sink page as their last row (see
``inference/paged_cache.py``): a write the reference drops (page index
``P``, ``mode="drop"``) is aimed at the sink instead, so every call writes
the same shapes. The sink's page and scale row take those writes and are
never read.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["KV_DTYPES", "KV_QMAX", "KV_SCALE_FLOOR", "dequant_scale",
           "quantize_page", "dequantize_page", "quant_store_rows"]

# pool storage the paged engine takes: "bf16" keeps the pools in the
# model's own dtype, "int8" stores int8 pages with per-page-per-head scales
KV_DTYPES = ("bf16", "int8")

KV_QMAX = 127.0          # symmetric int8 range [-127, 127]
KV_SCALE_FLOOR = 1e-8    # scales never 0: dequant stays finite


def dequant_scale(scale: torch.Tensor) -> torch.Tensor:
    """Per-element dequant multiplier of absmax scale(s) ``scale``."""
    return scale / KV_QMAX


def quantize_page(page: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Quantize rows ``[..., H, D]`` against per-head absmax ``scale``
    (broadcastable over the head axis at -2). Values above the scale
    saturate at +-KV_QMAX."""
    s = scale.float().clamp_min(KV_SCALE_FLOOR)
    q = torch.round(page.float() / s.unsqueeze(-1) * KV_QMAX)
    return q.clamp(-KV_QMAX, KV_QMAX).to(torch.int8)


def dequantize_page(qpage: torch.Tensor, scale: torch.Tensor
                    ) -> torch.Tensor:
    """Inverse of :func:`quantize_page` (fp32 result)."""
    return qpage.float() * dequant_scale(scale.float()).unsqueeze(-1)


def quant_store_rows(pool: torch.Tensor, scales: torch.Tensor,
                     pages: torch.Tensor, offs: torch.Tensor,
                     rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Running-absmax int8 store of token rows into a paged pool, IN PLACE.

    pool [P, page_size, H, D] int8; scales [P, H] fp32; pages [N] target
    page of each row (the sink page for rows to drop); offs [N] row offset
    within its page; rows [N, H, D] float. Per call:

    1. each row's per-head absmax joins its page's running scale by a
       scatter-max, so rows landing in one page compose in one call;
    2. the target pages' existing rows re-quantize by old / new scale;
    3. the new rows store quantized against the new scales.

    Step 2 runs unconditionally, where the reference gates it on any page
    having grown (``lax.cond(jnp.any(r < 1.0), ...)``): a branch on a
    device value would cost a host sync every step and cannot sit inside a
    captured CUDA graph. The bytes are the same: a page that did not grow
    has ``old / new`` exactly 1.0, and ``round(q * 1.0) == q`` for every
    int8 ``q``. Several rows of one page write identical re-quantized
    copies of it. Returns ``(pool, scales)``."""
    pages = pages.long()
    n, h = rows.shape[0], rows.shape[1]
    a = rows.float().abs().amax(-1)                              # [N, H]
    old = scales.clamp_min(KV_SCALE_FLOOR)
    new = old.scatter_reduce(0, pages[:, None].expand(n, h), a, "amax")
    new = new.clamp_min(KV_SCALE_FLOOR)
    r = (old / new)[pages]                                       # [N, H]
    pool[pages] = torch.round(pool[pages].float() * r[:, None, :, None]
                              ).clamp_(-KV_QMAX, KV_QMAX).to(torch.int8)
    pool[pages, offs.long()] = quantize_page(rows, new[pages])
    scales.copy_(new)
    return pool, scales
