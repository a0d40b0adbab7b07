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
           "quantize_page", "dequantize_page", "quant_store_rows",
           "max_logit_divergence"]

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


def max_logit_divergence(eng_a, eng_b, prompts, cfg=None,
                         steps: int = 16):
    """Plain-vs-quantized logit-divergence probe (the reference's): admit
    the same prompts (greedy) into two IDLE continuous-batching engines,
    step them one decode token at a time, and before each step compare the
    next-token logits both engines would take. Returns ``{"max_logit_div",
    "mean_logit_div", "token_flips", "tokens"}``.

    Both engines run their public admission and segment path, so the probe
    exercises the real store and read pipeline (quantize on store, the
    fused dequant); the extra logit read a step is one more decode forward,
    whose cache writes are the ones the step itself makes next. Once a
    slot's argmax flips, the two trajectories feed themselves different
    tokens, so a flipped slot is counted once and left out of later
    comparisons."""
    import numpy as np

    from ..inference.generation import GenerationConfig

    cfg = cfg or GenerationConfig(max_new_tokens=steps)
    for eng in (eng_a, eng_b):
        if eng._slot_req:
            raise RuntimeError("max_logit_divergence needs idle engines")
    for p in prompts:
        eng_a.add_request(p, cfg)
        eng_b.add_request(p, cfg)

    def logits(eng):
        with torch.no_grad():
            out = eng._fwd_decode(eng.last[:, None], eng.lens,
                                  eng.active_dev)
        return out[:, 0].float().cpu().numpy()

    max_div = sum_div = 0.0
    flips = tokens = n = 0
    dead = set()                      # slots whose trajectories split
    for _ in range(steps):
        if not (eng_a._slot_req and eng_b._slot_req):
            break
        la, lb = logits(eng_a), logits(eng_b)
        live = (eng_a.active_dev & eng_b.active_dev).cpu().numpy()
        for s in np.nonzero(live)[0]:
            if int(s) in dead:
                continue
            d = float(np.max(np.abs(la[s] - lb[s])))
            max_div = max(max_div, d)
            sum_div += d
            n += 1
            tokens += 1
            if int(la[s].argmax()) != int(lb[s].argmax()):
                flips += 1
                dead.add(int(s))
        eng_a.decode_segment(1)
        eng_b.decode_segment(1)
    # drain so the engines come back idle for the caller
    while eng_a.decode_segment(4):
        pass
    while eng_b.decode_segment(4):
        pass
    eng_a.collect_finished()
    eng_b.collect_finished()
    return {"max_logit_div": max_div,
            "mean_logit_div": (sum_div / n if n else 0.0),
            "token_flips": flips, "tokens": tokens}
