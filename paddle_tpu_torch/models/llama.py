"""Llama-family causal LM in PyTorch (port of ``paddle_tpu/models/llama.py``).

Architecture: RMSNorm / RoPE / GQA attention / SwiGLU, the Llama-2 recipe,
with the reference's layouts: activations ``[B, S, H, D]``, linear weights
``[in, out]`` applied as ``x @ W``, and the reference's parameter names, so
``models/convert.py`` carries a JAX model's weights over as they are.

Kernels on the path (each a Hopper kernel on the card, its plain version on
the CPU): RMSNorm -> K1 ``rms_norm``; RoPE over the shared position tables
(training, prefill and the S == 1 step of ``forward_with_cache``) -> K2
``fused_rope``; training and prefill attention -> K3 flash forward, with
the ``flash_bwd_dq``/``flash_bwd_dkv`` kernels in its backward; a prefill
chunk's attention -> K3's prefix-chunk instance; decode
attention over the page pool -> K4 ``paged_decode_mha``, over a dense cache
-> K7 ``decode_mha`` (through ``ops._decode.gqa_decode_attention``). The
per-row RoPE of a ragged or paged decode step stays plain torch, as it is
plain jnp in the reference. Every kernel wrapper on the training path is
differentiable, so ``model(ids, labels).backward()`` reaches every
parameter; ``config.recompute = "full"`` recomputes each decoder layer in
the backward (``distributed.fleet.recompute``) while the model trains.
Under ``amp.auto_cast`` its ops cast by the reference's op lists
(``framework/amp_state.py``); the tied head is ``tied_lm_head`` (gray).

Serving forwards ported: ``forward_with_cache`` as a fresh prefill
(``pos == 0``), a chunk of a prefill at any ``pos`` (an int or a 0-d device
tensor: chunked prefill) or a one-token step at any ``pos`` into a dense
cache,
``forward_decode_ragged`` (per-row lengths over a dense cache) and
``forward_decode_paged`` over page pools in the model's dtype or in int8
with per-(page, kv head) scales (quantize on store,
``quantization/kv.py``; K4 dequantizes inside the kernel), and the
speculative verify steps ``forward_decode_spec`` (dense, one K7 call per
window position) and ``forward_decode_spec_paged`` (K4 per window
position, bf16 or int8 pools). Every serving forward takes ``lora``, the
per-row batched-adapter input of multi-tenant LoRA (:func:`_lora_add`);
the training forward takes none, as in the reference. Tensor parallelism
is not ported yet and is absent. Cache writes happen in place, so
a decode step reads and writes the same storage every time (what a
captured CUDA graph needs).

Page pools carry one extra SINK page at index ``num_pages``: the
reference's ``pool.at[page, offs].set(..., mode="drop")`` drops writes of
dead rows and unmapped pages; here those writes are aimed at the sink page,
which no page table maps, so every step writes the same shape (ready for
CUDA-graph capture) and no valid page is touched.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..distributed.fleet.recompute import recompute
from ..distributed.mp_layers import (ColumnParallelLinear,
                                     ParallelCrossEntropy, RowParallelLinear,
                                     VocabParallelEmbedding)
from ..framework.amp_state import cast_inputs
from ..nn.layer.norm import RMSNorm
from ..ops._decode import gqa_decode_attention
from ..ops.attention import flash_attention, prefix_chunk_attention
from ..ops.fused_kernels import fused_rope
from ..ops.paged_attention import paged_decode_mha
from ..quantization.kv import KV_DTYPES, KV_SCALE_FLOOR, quant_store_rows
from ._utils import IGNORE_INDEX, masked_lm_loss

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM", "llama_config",
           "apply_rotary_emb"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}

Cache = Tuple[torch.Tensor, torch.Tensor]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None  # GQA; None -> MHA
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    dtype: str = "float32"
    # remat policy for the decoder stack while training ("none" | "full")
    recompute: str = "none"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def kv_heads(self) -> int:
        return self.num_key_value_heads or self.num_attention_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


_PRESETS = {
    # name: (hidden, inter, layers, heads, kv_heads, vocab)
    "tiny":  (64, 176, 2, 4, 4, 256),
    "350m":  (1024, 2816, 24, 16, 16, 32000),
    "1b3":   (2048, 5504, 24, 16, 16, 32000),
    "7b":    (4096, 11008, 32, 32, 32, 32000),
    "13b":   (5120, 13824, 40, 40, 40, 32000),
    "65b":   (8192, 22016, 80, 64, 64, 32000),  # Llama-2-65B: MHA (kv=64)
}


def llama_config(preset: str = "tiny", **overrides) -> LlamaConfig:
    h, i, l, a, kv, v = _PRESETS[preset]
    cfg = LlamaConfig(hidden_size=h, intermediate_size=i, num_hidden_layers=l,
                      num_attention_heads=a, num_key_value_heads=kv,
                      vocab_size=v)
    for k, val in overrides.items():
        if not hasattr(cfg, k):
            raise TypeError(f"unknown LlamaConfig field {k!r}")
        setattr(cfg, k, val)
    return cfg


def _rope_cos_sin(seq_len: int, head_dim: int, theta: float,
                  dtype: torch.dtype, device) -> Cache:
    """RoPE tables [seq, head_dim // 2], computed in fp32 and cast."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def _lora_add(x: torch.Tensor, y: torch.Tensor, lora, name: str
              ) -> torch.Tensor:
    """``y`` plus the per-row LoRA delta of target projection ``name``:
    ``y + (x @ A[idx]^T) @ B[idx]^T``, each row's factors gathered by its
    adapter index (the S-LoRA batched-adapter shape: one program serves any
    mix of adapters, the weights picked per row from a device vector).

    ``lora`` is ``(bank, idx)``: ``bank`` maps target names to THIS
    layer's factor stacks ``A [K+1, r, d_in]`` / ``B [K+1, d_out, r]``
    (index 0 is the base model, its rows zeros, so a base row's delta is
    exactly 0.0 and the row is bit for bit what a LoRA-free forward gives);
    ``idx`` is the per-row ``[B]`` int32 adapter index. ``x`` is ``[B, S,
    d_in]`` for any S (prefill, decode 1, a verify window). The LoRA scaling
    alpha / r is folded into B at install. Both products run in the model's
    dtype, so ``t`` is rounded once and the delta is added to ``y`` after
    its own rounding, as the reference's two einsums do (never folded into
    ``y`` by ``baddbmm``, which would round ``y + delta`` inside the
    product). ``lora is None`` (or a target the bank lacks) returns ``y``
    itself: no op is added."""
    if lora is None:
        return y
    bank, idx = lora
    ab = bank.get(name)
    if ab is None:
        return y
    A, B = ab
    t = torch.bmm(x, A.index_select(0, idx).transpose(1, 2))      # [B, S, r]
    return y + torch.bmm(t, B.index_select(0, idx).transpose(1, 2)).to(
        y.dtype)


def _lora_layer(lora, i: int):
    """Layer ``i``'s slice of the engine-level LoRA input: the bank holds
    per-layer stacks ``[L, K+1, r, d]`` and each decoder layer gathers from
    its own ``[K+1, r, d]`` view."""
    if lora is None:
        return None
    bank, idx = lora
    return {t: (A[i], B[i]) for t, (A, B) in bank.items()}, idx


def apply_rotary_emb(x: torch.Tensor, cos: torch.Tensor,
                     sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE of x [B, S, H, D]. ``cos``/``sin`` are either the
    shared position tables [S, D/2] (-> K2 ``fused_rope``) or per-row
    angles already broadcast to x's rank, [B, 1, 1, D/2] on the decode path
    (plain torch in x's dtype, as the reference's jnp form)."""
    if cos.dim() == 2:
        return fused_rope(x, cos, sin)
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        h, hd = config.hidden_size, config.head_dim
        self.num_heads = config.num_attention_heads
        self.kv_heads = config.kv_heads
        kw = dict(device=device, dtype=dtype)
        self.q_proj = ColumnParallelLinear(h, self.num_heads * hd,
                                           has_bias=False, **kw)
        self.k_proj = ColumnParallelLinear(h, self.kv_heads * hd,
                                           has_bias=False, **kw)
        self.v_proj = ColumnParallelLinear(h, self.kv_heads * hd,
                                           has_bias=False, **kw)
        self.o_proj = RowParallelLinear(self.num_heads * hd, h,
                                        has_bias=False, **kw)

    def _qkv(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
             lora=None):
        """The q/k/v projections, each with its LoRA delta added BEFORE the
        rotation (the reference's ``_qkv_lora``, then RoPE)."""
        b, s = x.shape[0], x.shape[1]
        hd = self.config.head_dim
        q = _lora_add(x, self.q_proj(x), lora, "q")
        k = _lora_add(x, self.k_proj(x), lora, "k")
        v = _lora_add(x, self.v_proj(x), lora, "v")
        qh = apply_rotary_emb(q.view(b, s, self.num_heads, hd), cos, sin)
        kh = apply_rotary_emb(k.view(b, s, self.kv_heads, hd), cos, sin)
        return qh, kh, v.view(b, s, self.kv_heads, hd)

    def _out(self, ctx: torch.Tensor, lora=None) -> torch.Tensor:
        b, s = ctx.shape[0], ctx.shape[1]
        ctx = ctx.reshape(b, s, self.num_heads * self.config.head_dim)
        return _lora_add(ctx, self.o_proj(ctx), lora, "o")

    def forward(self, x, cos, sin):
        # GQA stays grouped: K3 selects the shared kv head itself
        qh, kh, vh = self._qkv(x, cos, sin)
        return self._out(flash_attention(qh, kh, vh, causal=True))

    def forward_with_cache(self, x, cos_full, sin_full, cache: Cache, pos,
                           lora=None):
        """Attend over the dense cache ``(k, v)`` [B, S_max, Hkv, hd],
        writing this call's K/V IN PLACE at [pos, pos + S). S == 1 is a
        decode step at any ``pos`` (a Python int or a 0-d tensor): every
        row attends [0, pos] through K7. S > 1 at ``pos == 0`` given as an
        int is a fresh prefill: causal attention over the prompt alone
        (K3). S > 1 at any other ``pos`` (an int, or a 0-d tensor, which
        stays on the device) is a chunk of a prefill: RoPE from the tables
        at ``pos + arange(S)``, K/V written at those rows, and
        :func:`prefix_chunk_attention` over the cache's written prefix (K3's
        prefix-chunk instance). ``lora`` (here and on every serving forward
        below) is the per-row batched-adapter input, see :func:`_lora_add`.
        Returns (out, cache)."""
        b, s = x.shape[0], x.shape[1]
        kc, vc = cache
        if s == 1:
            if isinstance(pos, torch.Tensor):
                at = pos.reshape(1).long().to(x.device)
                qh, kh, vh = self._qkv(x, cos_full.index_select(0, at),
                                       sin_full.index_select(0, at), lora)
                kc.index_copy_(1, at, kh.to(kc.dtype))
                vc.index_copy_(1, at, vh.to(vc.dtype))
                lens = (at + 1).to(torch.int32).expand(b)
            else:
                qh, kh, vh = self._qkv(x, cos_full[pos:pos + 1],
                                       sin_full[pos:pos + 1], lora)
                kc[:, pos] = kh[:, 0].to(kc.dtype)
                vc[:, pos] = vh[:, 0].to(vc.dtype)
                lens = torch.full((b,), pos + 1, dtype=torch.int32,
                                  device=x.device)
            ctx = gqa_decode_attention(qh[:, 0], kc, vc, lens)
            return self._out(ctx[:, None], lora), cache
        if not (isinstance(pos, int) and pos == 0):
            p0 = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
            at = (p0.long() + torch.arange(s, device=x.device))
            qh, kh, vh = self._qkv(x, cos_full.index_select(0, at),
                                   sin_full.index_select(0, at), lora)
            kc.index_copy_(1, at, kh.to(kc.dtype))
            vc.index_copy_(1, at, vh.to(vc.dtype))
            ctx = prefix_chunk_attention(qh, kc, vc, p0)
            return self._out(ctx, lora), cache
        qh, kh, vh = self._qkv(x, cos_full[:s], sin_full[:s], lora)
        kc[:, :s] = kh.to(kc.dtype)
        vc[:, :s] = vh.to(vc.dtype)
        return self._out(flash_attention(qh, kh, vh, causal=True),
                         lora), cache

    def forward_decode_ragged(self, x, cos_full, sin_full, cache: Cache,
                              lens, live, lora=None):
        """One decode step with per-row lengths over the dense cache. x [B,
        1, h]; lens [B] int32 tokens already in each row's cache; live [B]
        bool. Row b rotates and writes its K/V at min(lens[b], S_max - 1)
        IN PLACE (a dead row re-writes the cell it read) and attends
        lens[b] + live[b] positions (K7). Returns (out, cache)."""
        b = x.shape[0]
        kc, vc = cache
        idx = lens.clamp(max=kc.shape[1] - 1).long()
        c = cos_full[idx][:, None, None, :]         # [B, 1, 1, d2] per row
        sn = sin_full[idx][:, None, None, :]
        qh, kh, vh = self._qkv(x, c, sn, lora)
        ar = torch.arange(b, device=idx.device)
        keep = live[:, None, None]
        kw = torch.where(keep, kh[:, 0].to(kc.dtype), kc[ar, idx])
        vw = torch.where(keep, vh[:, 0].to(vc.dtype), vc[ar, idx])
        kc[ar, idx] = kw
        vc[ar, idx] = vw
        ctx = gqa_decode_attention(qh[:, 0], kc, vc,
                                   lens + live.to(lens.dtype))
        return self._out(ctx[:, None], lora), cache

    def forward_decode_paged(self, x, cos_full, sin_full, cache,
                             page_table, lens, live, lora=None):
        """One paged decode step. x [B, 1, h]; ``cache`` is this layer's
        (k, v) pools [num_pages + 1, page_size, Hkv, hd] (last page = sink),
        or (k, v, k_scale, v_scale) for int8 pools with scales
        [num_pages + 1, Hkv] fp32; lens [B] int32 tokens already cached per
        row; live [B] bool. Each live row writes its new K/V IN PLACE at
        position lens[b] (int8: quantized against the page's running
        absmax, which may re-quantize the page); dead rows and unmapped
        pages write into the sink. Returns (out, cache)."""
        b = x.shape[0]
        kp, vp = cache[0], cache[1]
        ps = kp.shape[1]
        idx = lens.clamp(max=page_table.shape[1] * ps - 1).long()
        c = cos_full[idx][:, None, None, :]         # [B, 1, 1, d2] per row
        sn = sin_full[idx][:, None, None, :]
        qh, kh, vh = self._qkv(x, c, sn, lora)
        page = page_table[torch.arange(b, device=idx.device), idx // ps]
        page = torch.where(live & (page >= 0), page,
                           kp.shape[0] - 1).long()
        offs = idx % ps
        scales = cache[2:]
        if scales:
            quant_store_rows(kp, scales[0], page, offs, kh[:, 0])
            quant_store_rows(vp, scales[1], page, offs, vh[:, 0])
        else:
            kp[page, offs] = kh[:, 0].to(kp.dtype)
            vp[page, offs] = vh[:, 0].to(vp.dtype)
        ctx = paged_decode_mha(qh[:, 0], kp, vp, page_table,
                               lens + live.to(lens.dtype), *scales)
        return self._out(ctx[:, None], lora), cache

    def _spec_qkv(self, x, cos_full, sin_full, lens, max_len, lora=None):
        """The verify window's projections, rotated per row at positions
        ``lens[b] + i`` (clamped to the cache for the RoPE tables only);
        returns (qh, kh, vh, pos, idx), pos / idx int64 [B, W]."""
        w = x.shape[1]
        pos = lens.long()[:, None] + torch.arange(w, device=lens.device)
        idx = pos.clamp(max=max_len - 1)
        c = cos_full[idx][:, :, None, :]            # [B, W, 1, d2] per row
        sn = sin_full[idx][:, :, None, :]
        qh, kh, vh = self._qkv(x, c, sn, lora)
        return qh, kh, vh, pos, idx

    def forward_decode_spec(self, x, cos_full, sin_full, cache: Cache,
                            lens, live, lora=None):
        """Speculative VERIFY step over the dense cache: W query positions
        per row, position i of row b at ``lens[b] + i`` (x [B, W, h]). All
        W tokens' K/V are written IN PLACE first, one window position at a
        time; a write of a dead row or past the cache is dropped (the cell
        is rewritten with what it holds, never clamped onto the last valid
        one). Then each position runs the one-token step's K7 call with
        its own length ``lens + live * (i + 1)``, so position i attends
        exactly the history a sequential decode would, and where the input
        tokens are the greedy continuation its logits are those of
        ``forward_decode_ragged`` one token at a time. Rejected drafts
        leave stale K/V past the accepted length: every read is length
        masked and later writes overwrite it. Returns (out, cache)."""
        b, w = x.shape[0], x.shape[1]
        kc, vc = cache
        max_len = kc.shape[1]
        qh, kh, vh, pos, idx = self._spec_qkv(x, cos_full, sin_full, lens,
                                              max_len, lora)
        ok = live[:, None] & (pos < max_len)
        ar = torch.arange(b, device=idx.device)
        for i in range(w):
            at, keep = idx[:, i], ok[:, i, None, None]
            kc[ar, at] = torch.where(keep, kh[:, i].to(kc.dtype), kc[ar, at])
            vc[ar, at] = torch.where(keep, vh[:, i].to(vc.dtype), vc[ar, at])
        lv = live.to(lens.dtype)
        ctx = torch.stack([gqa_decode_attention(qh[:, i], kc, vc,
                                                lens + lv * (i + 1))
                           for i in range(w)], dim=1)     # [B, W, Hq, hd]
        return self._out(ctx, lora), cache

    def forward_decode_spec_paged(self, x, cos_full, sin_full, cache,
                                  page_table, lens, live, snapshot=None,
                                  lora=None):
        """Paged twin of :meth:`forward_decode_spec` (K4 per window
        position). Writes of dead rows, unmapped pages or positions past
        the table's width go to the sink page. Returns (out, cache, aux):
        ``aux`` is None on pools in the model's dtype.

        int8 pools store then attend one window position at a time through
        the one-token step's running-absmax ``quant_store_rows``, so a
        scale growth at position i re-quantizes the page before position
        i + 1 reads it, as the sequential step would. The window's rows
        are provisional (a rejected draft's absmax must not stay in a
        page's monotonic scale), so the touched pages and both scale
        tables are snapshotted BEFORE the first store, into ``snapshot``
        (``(k_pages [B*W, ...], v_pages, k_scale, v_scale)``, written in
        place) when given, and ``aux`` is ``(snap_k, snap_v, snap_ks,
        snap_vs, kh, vh, page, offs)``: the engine restores the snapshot
        after acceptance and replays only the accepted prefix."""
        b, w = x.shape[0], x.shape[1]
        kp, vp = cache[0], cache[1]
        ps = kp.shape[1]
        max_len = page_table.shape[1] * ps
        qh, kh, vh, pos, idx = self._spec_qkv(x, cos_full, sin_full, lens,
                                              max_len, lora)
        ar = torch.arange(b, device=idx.device)
        page = page_table[ar[:, None], idx // ps]                # [B, W]
        ok = live[:, None] & (page >= 0) & (pos < max_len)
        page = torch.where(ok, page, kp.shape[0] - 1).long()
        offs = idx % ps
        lv = live.to(lens.dtype)
        scales = cache[2:]
        if not scales:
            kp[page, offs] = kh.to(kp.dtype)
            vp[page, offs] = vh.to(vp.dtype)
            ctx = torch.stack([paged_decode_mha(qh[:, i], kp, vp, page_table,
                                                lens + lv * (i + 1))
                               for i in range(w)], dim=1)
            return self._out(ctx, lora), cache, None
        ks, vs = scales
        flat = page.reshape(-1)
        if snapshot is None:
            snap = (kp[flat], vp[flat], ks.clone(), vs.clone())
        else:
            snap = snapshot
            torch.index_select(kp, 0, flat, out=snap[0])
            torch.index_select(vp, 0, flat, out=snap[1])
            snap[2].copy_(ks)
            snap[3].copy_(vs)
        ctxs = []
        for i in range(w):
            quant_store_rows(kp, ks, page[:, i], offs[:, i], kh[:, i])
            quant_store_rows(vp, vs, page[:, i], offs[:, i], vh[:, i])
            ctxs.append(paged_decode_mha(qh[:, i], kp, vp, page_table,
                                         lens + lv * (i + 1), ks, vs))
        return (self._out(torch.stack(ctxs, dim=1), lora), cache,
                tuple(snap) + (kh, vh, page, offs))


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        kw = dict(device=device, dtype=dtype)
        self.gate_proj = ColumnParallelLinear(h, i, has_bias=False, **kw)
        self.up_proj = ColumnParallelLinear(h, i, has_bias=False, **kw)
        self.down_proj = RowParallelLinear(i, h, has_bias=False, **kw)

    def forward(self, x, lora=None):
        g = _lora_add(x, self.gate_proj(x), lora, "gate")
        u = _lora_add(x, self.up_proj(x), lora, "up")
        h = F.silu(g) * u
        return _lora_add(h, self.down_proj(h), lora, "down")


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.self_attn = LlamaAttention(config, **kw)
        self.mlp = LlamaMLP(config, **kw)
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       epsilon=config.rms_norm_eps, **kw)
        self.post_attention_layernorm = RMSNorm(
            config.hidden_size, epsilon=config.rms_norm_eps, **kw)

    def forward(self, x, cos, sin):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin)
        return x + self.mlp(self.post_attention_layernorm(x))

    def forward_with_cache(self, x, cos_full, sin_full, cache, pos,
                           lora=None):
        attn, cache = self.self_attn.forward_with_cache(
            self.input_layernorm(x), cos_full, sin_full, cache, pos, lora)
        x = x + attn
        return x + self.mlp(self.post_attention_layernorm(x), lora), cache

    def forward_decode_ragged(self, x, cos_full, sin_full, cache, lens,
                              live, lora=None):
        attn, cache = self.self_attn.forward_decode_ragged(
            self.input_layernorm(x), cos_full, sin_full, cache, lens, live,
            lora)
        x = x + attn
        return x + self.mlp(self.post_attention_layernorm(x), lora), cache

    def forward_decode_paged(self, x, cos_full, sin_full, cache,
                             page_table, lens, live, lora=None):
        attn, cache = self.self_attn.forward_decode_paged(
            self.input_layernorm(x), cos_full, sin_full, cache, page_table,
            lens, live, lora)
        x = x + attn
        return x + self.mlp(self.post_attention_layernorm(x), lora), cache

    def forward_decode_spec(self, x, cos_full, sin_full, cache, lens, live,
                            lora=None):
        attn, cache = self.self_attn.forward_decode_spec(
            self.input_layernorm(x), cos_full, sin_full, cache, lens, live,
            lora)
        x = x + attn
        return x + self.mlp(self.post_attention_layernorm(x), lora), cache

    def forward_decode_spec_paged(self, x, cos_full, sin_full, cache,
                                  page_table, lens, live, snapshot=None,
                                  lora=None):
        attn, cache, aux = self.self_attn.forward_decode_spec_paged(
            self.input_layernorm(x), cos_full, sin_full, cache, page_table,
            lens, live, snapshot, lora)
        x = x + attn
        return (x + self.mlp(self.post_attention_layernorm(x), lora), cache,
                aux)


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=dtype)
        self.embed_tokens = VocabParallelEmbedding(config.vocab_size,
                                                   config.hidden_size, **kw)
        self.layers = nn.ModuleList([LlamaDecoderLayer(config, **kw)
                                     for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, epsilon=config.rms_norm_eps,
                            **kw)
        self._rope = {}

    def _tables(self, n: int, like: torch.Tensor) -> Cache:
        """RoPE tables for positions [0, n) in like's dtype, kept per
        (n, dtype, device): the decode loop asks for the same ones every
        step. They are built at first use, so a decode step runs once
        eagerly before it is captured into a CUDA graph (the engines'
        ``inference/_graphs.py`` does), and a replay reads the same
        tables. While compiling they are computed in the program, not
        cached: under ``torch.export`` ``n`` is a symbolic length; so are
        they in a static program being recorded (``like`` symbolic), which
        computes them on each run."""
        cfg = self.config
        if torch.compiler.is_compiling() or like.is_meta:
            return _rope_cos_sin(n, cfg.head_dim, cfg.rope_theta, like.dtype,
                                 like.device)
        key = (n, like.dtype, like.device)
        if key not in self._rope:
            self._rope[key] = _rope_cos_sin(n, cfg.head_dim, cfg.rope_theta,
                                            like.dtype, like.device)
        return self._rope[key]

    def forward(self, input_ids):
        if self.config.recompute not in ("none", "full"):
            raise ValueError(f"recompute must be 'none' or 'full', got "
                             f"{self.config.recompute!r}")
        x = self.embed_tokens(input_ids)
        cos, sin = self._tables(x.shape[1], x)
        for layer in self.layers:
            if self.config.recompute == "full" and self.training:
                x = recompute(layer, x, cos, sin)
            else:
                x = layer(x, cos, sin)
        return self.norm(x)

    def _new_kv(self, shape) -> List[Cache]:
        p = self.embed_tokens.weight
        return [(torch.zeros(shape, dtype=p.dtype, device=p.device),
                 torch.zeros(shape, dtype=p.dtype, device=p.device))
                for _ in range(self.config.num_hidden_layers)]

    def init_cache(self, batch_size: int, max_len: int) -> List[Cache]:
        """Per-layer dense KV caches [batch, max_len, Hkv, hd]."""
        cfg = self.config
        return self._new_kv((batch_size, max_len, cfg.kv_heads,
                             cfg.head_dim))

    def forward_with_cache(self, input_ids, caches, pos, lora=None):
        x = self.embed_tokens(input_ids)
        cos_full, sin_full = self._tables(caches[0][0].shape[1], x)
        new_caches = []
        for i, (layer, cache) in enumerate(zip(self.layers, caches)):
            x, cache = layer.forward_with_cache(x, cos_full, sin_full, cache,
                                                pos, _lora_layer(lora, i))
            new_caches.append(cache)
        return self.norm(x), new_caches

    def forward_decode_ragged(self, input_ids, caches, lens, live,
                              lora=None):
        x = self.embed_tokens(input_ids)
        cos_full, sin_full = self._tables(caches[0][0].shape[1], x)
        new_caches = []
        for i, (layer, cache) in enumerate(zip(self.layers, caches)):
            x, cache = layer.forward_decode_ragged(
                x, cos_full, sin_full, cache, lens, live,
                _lora_layer(lora, i))
            new_caches.append(cache)
        return self.norm(x), new_caches

    def init_paged_cache(self, num_pages: int, page_size: int,
                         kv_dtype: str = "bf16") -> list:
        """Per-layer page pools [num_pages + 1, page_size, Hkv, hd]; index
        ``num_pages`` is the sink page. ``kv_dtype="bf16"`` keeps them in
        the model's dtype, as (k, v); ``"int8"`` gives (k, v, k_scale,
        v_scale): int8 zeros and fp32 scales [num_pages + 1, Hkv] at
        ``KV_SCALE_FLOOR``, as the reference's int8 layout (plus the
        sink's row)."""
        if kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}")
        cfg = self.config
        shape = (num_pages + 1, page_size, cfg.kv_heads, cfg.head_dim)
        if kv_dtype == "bf16":
            return self._new_kv(shape)
        dev = self.embed_tokens.weight.device
        return [(torch.zeros(shape, dtype=torch.int8, device=dev),
                 torch.zeros(shape, dtype=torch.int8, device=dev),
                 torch.full(shape[:1] + shape[2:3], KV_SCALE_FLOOR,
                            dtype=torch.float32, device=dev),
                 torch.full(shape[:1] + shape[2:3], KV_SCALE_FLOOR,
                            dtype=torch.float32, device=dev))
                for _ in range(cfg.num_hidden_layers)]

    def forward_decode_paged(self, input_ids, caches, page_table, lens, live,
                             lora=None):
        x = self.embed_tokens(input_ids)
        max_len = page_table.shape[1] * caches[0][0].shape[1]
        cos_full, sin_full = self._tables(max_len, x)
        new_caches = []
        for i, (layer, cache) in enumerate(zip(self.layers, caches)):
            x, cache = layer.forward_decode_paged(
                x, cos_full, sin_full, cache, page_table, lens, live,
                _lora_layer(lora, i))
            new_caches.append(cache)
        return self.norm(x), new_caches

    def forward_decode_spec(self, input_ids, caches, lens, live, lora=None):
        x = self.embed_tokens(input_ids)
        cos_full, sin_full = self._tables(caches[0][0].shape[1], x)
        new_caches = []
        for i, (layer, cache) in enumerate(zip(self.layers, caches)):
            x, cache = layer.forward_decode_spec(
                x, cos_full, sin_full, cache, lens, live,
                _lora_layer(lora, i))
            new_caches.append(cache)
        return self.norm(x), new_caches

    def forward_decode_spec_paged(self, input_ids, caches, page_table, lens,
                                  live, snapshots=None, lora=None):
        x = self.embed_tokens(input_ids)
        max_len = page_table.shape[1] * caches[0][0].shape[1]
        cos_full, sin_full = self._tables(max_len, x)
        new_caches, aux_rows = [], []
        for i, (layer, cache) in enumerate(zip(self.layers, caches)):
            x, cache, aux = layer.forward_decode_spec_paged(
                x, cos_full, sin_full, cache, page_table, lens, live,
                None if snapshots is None else snapshots[i],
                _lora_layer(lora, i))
            new_caches.append(cache)
            aux_rows.append(aux)
        return self.norm(x), new_caches, aux_rows


class LlamaForCausalLM(nn.Module):
    """Llama causal LM. Built on ``device`` (default: the current place,
    the CUDA card unless set otherwise, see
    :func:`paddle_tpu_torch.device.resolve_device`) in ``config.dtype``,
    with weights drawn from ``generator`` (default: seed 0 on that
    device): normal with std 0.02 (Llama-2's published initializer range),
    norm weights 1."""

    IGNORE_INDEX = IGNORE_INDEX

    def __init__(self, config: LlamaConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=config.torch_dtype)
        self.model = LlamaModel(config, **kw)
        self.lm_head = (None if config.tie_word_embeddings else
                        ColumnParallelLinear(config.hidden_size,
                                             config.vocab_size,
                                             has_bias=False, **kw))
        self.loss_fn = ParallelCrossEntropy(ignore_index=self.IGNORE_INDEX)
        self.init_weights(generator)

    @property
    def device(self) -> torch.device:
        return self.model.embed_tokens.weight.device

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None
                     ) -> None:
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=generator)

    def logits(self, hidden):
        if self.lm_head is None:
            hidden, w = cast_inputs("tied_lm_head", hidden,
                                    self.model.embed_tokens.weight)
            return torch.matmul(hidden, w.T)
        return self.lm_head(hidden)

    def forward(self, input_ids, labels=None):
        logits = self.logits(self.model(input_ids))
        if labels is None:
            return logits
        loss = self.loss_fn(logits, labels)
        return masked_lm_loss(loss, labels, self.IGNORE_INDEX)

    def init_cache(self, batch_size: int, max_len: int):
        return self.model.init_cache(batch_size, max_len)

    def lora_shapes(self, targets):
        """The LoRA bank's geometry for the serving engines: ``(num_layers,
        {target: (d_in, d_out)})`` for the requested target projections
        (a subset of q/k/v/o and gate/up/down). The engine stacks every
        resident adapter's factors into ``[L, K+1, r, d_in]`` / ``[L, K+1,
        d_out, r]`` tensors per target and gathers each row's delta inside
        the decode programs (see :func:`_lora_add`)."""
        cfg = self.config
        hd = cfg.head_dim
        dims = {
            "q": (cfg.hidden_size, cfg.num_attention_heads * hd),
            "k": (cfg.hidden_size, cfg.kv_heads * hd),
            "v": (cfg.hidden_size, cfg.kv_heads * hd),
            "o": (cfg.num_attention_heads * hd, cfg.hidden_size),
            "gate": (cfg.hidden_size, cfg.intermediate_size),
            "up": (cfg.hidden_size, cfg.intermediate_size),
            "down": (cfg.intermediate_size, cfg.hidden_size),
        }
        unknown = [t for t in targets if t not in dims]
        if unknown:
            raise ValueError(
                f"unknown lora target(s) {unknown}; supported: "
                f"{sorted(dims)}")
        return cfg.num_hidden_layers, {t: dims[t] for t in targets}

    def forward_with_cache(self, input_ids, caches, pos, lora=None):
        """(logits [B, S, V], caches): a fresh prefill (pos == 0), a chunk
        of a prefill at ``pos`` (an int or a 0-d device tensor, passed
        through unchanged) or a one-token step at ``pos`` (see
        LlamaAttention.forward_with_cache). ``lora`` (every serving forward
        below too) is the optional batched-adapter input ``(bank,
        adapter_idx)``, see :func:`_lora_add`."""
        hidden, caches = self.model.forward_with_cache(input_ids, caches, pos,
                                                       lora)
        return self.logits(hidden), caches

    def forward_decode_ragged(self, input_ids, caches, lens, live,
                              lora=None):
        """(logits [B, 1, V], caches): one decode step with per-row lengths
        over dense caches (see LlamaAttention.forward_decode_ragged)."""
        hidden, caches = self.model.forward_decode_ragged(input_ids, caches,
                                                          lens, live, lora)
        return self.logits(hidden), caches

    def init_paged_cache(self, num_pages: int, page_size: int,
                         kv_dtype: str = "bf16"):
        return self.model.init_paged_cache(num_pages, page_size, kv_dtype)

    def forward_decode_paged(self, input_ids, caches, page_table, lens,
                             live, lora=None):
        """(logits [B, 1, V], caches): one paged decode step (see
        LlamaAttention.forward_decode_paged)."""
        hidden, caches = self.model.forward_decode_paged(
            input_ids, caches, page_table, lens, live, lora)
        return self.logits(hidden), caches

    def forward_decode_spec(self, input_ids, caches, lens, live, lora=None):
        """(logits [B, W, V], caches): a speculative verify step of W
        tokens per row at per-row offsets over dense caches (see
        LlamaAttention.forward_decode_spec)."""
        hidden, caches = self.model.forward_decode_spec(input_ids, caches,
                                                        lens, live, lora)
        return self.logits(hidden), caches

    def forward_decode_spec_paged(self, input_ids, caches, page_table, lens,
                                  live, snapshots=None, lora=None):
        """(logits [B, W, V], caches, aux): a speculative verify step over
        page pools; ``aux`` per layer is None on pools in the model's dtype
        and the int8 window's snapshot and rows otherwise, for the engine's
        post-acceptance commit (see
        LlamaAttention.forward_decode_spec_paged; ``snapshots``, per layer,
        are the buffers the snapshot is written into)."""
        hidden, caches, aux = self.model.forward_decode_spec_paged(
            input_ids, caches, page_table, lens, live, snapshots, lora)
        return self.logits(hidden), caches, aux
