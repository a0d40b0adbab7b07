"""Attention functions (port of
``paddle_tpu/nn/functional/flash_attention.py``), paddle's ``[B, S, H, D]``
layout.

- :func:`flash_attention` goes over the port's
  ``ops.attention.flash_attention``: on the card K3 forward
  (``csrc/flash_fwd.cu``) and K5/K6 backward (``csrc/flash_bwd.cu``), on
  the CPU their plain versions; GQA (fewer key/value heads), bottom-right
  causal alignment, and dropout by the kernels' counter hash, the same mask
  in the forward and the backward. The reference routes it to its Pallas
  flash kernel on the TPU and, with dropout, in interpret mode elsewhere.
  The dropout seed is ``fixed_seed_offset`` where the caller gives one (an
  int, or a tensor whose first element is the seed), else one draw from
  the port's generator, per call also in compiled and recorded programs
  (:func:`_seed`); at the same seed the dropped positions are the Pallas
  kernel's.
- :func:`scaled_dot_product_attention`, :func:`flash_attn_unpadded` and
  :func:`sparse_attention` are the reference's own compositions in torch
  ops (``_sdpa_ref``, the segment mask, the CSR gather): the reference
  routes none of them to a kernel. Their dropout draws from the port's
  generator.
- :class:`sdp_kernel` is a no-op context, as in the reference.
"""
from __future__ import annotations

import torch

from ...core.dispatch import is_symbolic, recording
from ...core.random import draw_seed, traced_seed, uniform
from ...ops.attention import flash_attention as _flash

__all__ = ["flash_attention", "flash_attn_unpadded",
           "scaled_dot_product_attention", "sdp_kernel", "sparse_attention"]


def _sdpa_ref(q, k, v, mask=None, causal=False, dropout_p=0.0, scale=None):
    """[B, S, H, D] composition with an fp32 softmax; K/V with fewer heads
    are repeated up to Q's head count."""
    s = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if k.shape[2] != q.shape[2]:
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    scores = (torch.matmul(qt, kt.transpose(-1, -2)) * s).float()
    neg = torch.tensor(float("-inf"), device=q.device)
    if causal:
        sq, sk = scores.shape[-2], scores.shape[-1]
        cmask = torch.ones(sq, sk, dtype=torch.bool,
                           device=q.device).tril(sk - sq)
        scores = torch.where(cmask, scores, neg)
    if mask is not None:
        mask = mask.detach()            # a constant, as in the reference
        if mask.dtype == torch.bool:
            scores = torch.where(mask, scores, neg)
        else:
            scores = scores + mask.to(scores.dtype)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    if dropout_p > 0.0:
        u = uniform(probs.shape, q.device)
        probs = torch.where(u < 1.0 - dropout_p, probs / (1.0 - dropout_p),
                            torch.zeros((), dtype=probs.dtype,
                                        device=q.device))
    return torch.matmul(probs, vt).transpose(1, 2)


def _seed(fixed_seed_offset, query):
    """The dropout seed: ``fixed_seed_offset`` where the caller gives one
    (an int, or a tensor whose first element is the seed); else one draw
    from the port's generator, made where the attention runs: eagerly on
    the host now; in a compiled program from the seed ``to_static`` hands
    each call (``core.random.traced_seed``), an input of the kernel op; in
    a program being recorded as a recorded draw, fresh on each
    ``Executor.run``."""
    if fixed_seed_offset is None:
        if torch.compiler.is_compiling():
            return traced_seed()
        if recording() and is_symbolic(query):
            from ...static.record import symbolic_seed

            return symbolic_seed()
        return draw_seed()
    if isinstance(fixed_seed_offset, torch.Tensor):
        return int(fixed_seed_offset.reshape(-1)[0].item())
    return int(fixed_seed_offset)


def flash_attention(query, key, value, dropout: float = 0.0,
                    causal: bool = False, return_softmax: bool = False,
                    fixed_seed_offset=None, rng_name: str = "",
                    training: bool = True, name=None):
    """paddle.nn.functional.flash_attention parity: ``(out, None)``."""
    p = dropout if training else 0.0
    seed = _seed(fixed_seed_offset, query) if p > 0.0 else None
    out = _flash(query, key, value, causal=causal, dropout_p=p, seed=seed)
    return out, None


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale: float,
                        dropout: float = 0.0, causal: bool = False,
                        return_softmax: bool = False, fixed_seed_offset=None,
                        rng_name: str = "", training: bool = True, name=None):
    """Varlen attention over [total_tokens, H, D] and cumulative sequence
    offsets, as a segment-masked dense attention (the reference's form)."""
    cq = torch.as_tensor(cu_seqlens_q, device=query.device).long()
    ck = torch.as_tensor(cu_seqlens_k, device=query.device).long()

    def segments(cu, t):
        seg = torch.zeros(t, dtype=torch.long, device=query.device)
        if cu.shape[0] > 2:
            seg.index_add_(0, cu[1:-1], torch.ones_like(cu[1:-1]))
        return seg.cumsum(0)

    tq, tk = query.shape[0], key.shape[0]
    seg_q, seg_k = segments(cq, tq), segments(ck, tk)
    scores = (torch.einsum("qhd,khd->hqk", query, key) * scale).float()
    mask = seg_q[:, None] == seg_k[None, :]
    if causal:
        pos_q = torch.arange(tq, device=query.device) - cq[seg_q]
        pos_k = torch.arange(tk, device=query.device) - ck[seg_k]
        mask = mask & (pos_q[:, None] >= pos_k[None, :])
    scores = scores.masked_fill(~mask[None], float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(query.dtype)
    probs = probs.masked_fill(~mask[None], 0.0)
    return torch.einsum("hqk,khd->qhd", probs, value), None


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True, name=None):
    """[B, S, H, D]; ``attn_mask`` broadcasts to [B, H, Sq, Sk] (bool:
    keep where true; float: added to the scores). Inputs of mixed float
    dtypes compute in their promoted dtype, as jnp promotes them (an
    incremental cache made in fp32 and extended in bf16 under AMP)."""
    dt = torch.promote_types(torch.promote_types(query.dtype, key.dtype),
                             value.dtype)
    query, key, value = (t.to(dt) for t in (query, key, value))
    return _sdpa_ref(query, key, value, mask=attn_mask, causal=is_causal,
                     dropout_p=dropout_p if training else 0.0)


class sdp_kernel:
    """Attention backend selection (API parity; a no-op)."""

    def __init__(self, enable_flash=True, enable_math=True,
                 enable_mem_efficient=True):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """Attention over the (q, k) pairs of a CSR pattern, q/k/v [B, H, S, D]
    and the pattern per (batch, head). Where the densest row holds at most
    S / 2 keys, keys and values are gathered per row at a capacity of that
    row length rounded up to 8 (memory O(S R D)); else the pattern becomes
    a dense mask (the reference's two paths)."""
    offs = torch.as_tensor(sparse_csr_offset, device=query.device).long()
    cols = torch.as_tensor(sparse_csr_columns, device=query.device).long()
    b, h, s, d = query.shape
    bh = b * h
    offs2 = offs.reshape(bh, s + 1)
    cols2 = cols.reshape(bh, -1)
    nnz = cols2.shape[-1]
    lens = offs2[:, 1:] - offs2[:, :-1]
    r_max = int(lens.max().item()) if lens.numel() else 0
    q2, k2, v2 = (t.reshape(bh, s, d) for t in (query, key, value))
    if 0 < r_max <= s // 2:
        cap = min(s, -(-r_max // 8) * 8)
        r = torch.arange(cap, device=query.device)
        base = offs2[:, :-1, None] + r[None, None, :]
        idx = torch.gather(cols2[:, None, :].expand(bh, s, nnz), 2,
                           base.clamp(0, max(nnz - 1, 0)))
        valid = r[None, None, :] < lens[:, :, None]
        rows = torch.arange(bh, device=query.device)[:, None, None]
        kg, vg = k2[rows, idx], v2[rows, idx]            # [bh, s, cap, d]
        scores = torch.einsum("bqd,bqrd->bqr", q2.float(),
                              kg.float()) / (d ** 0.5)
        scores = scores.masked_fill(~valid, float("-inf"))
        m = scores.amax(dim=-1, keepdim=True)
        p = torch.exp(scores - torch.where(torch.isfinite(m), m,
                                           torch.zeros_like(m)))
        p = p.masked_fill(~valid, 0.0)
        denom = p.sum(-1, keepdim=True).clamp(min=1e-30)
        out = torch.einsum("bqr,bqrd->bqd", (p / denom).to(value.dtype), vg)
        return out.reshape(b, h, s, d)
    pos = torch.arange(nnz, device=query.device)
    row_of = torch.searchsorted(offs2.contiguous(),
                                pos[None, :].expand(bh, nnz).contiguous(),
                                right=True) - 1
    valid = pos[None, :] < offs2[:, -1:]
    mask2 = torch.zeros(bh, s, s, dtype=torch.bool, device=query.device)
    bidx = torch.arange(bh, device=query.device)[:, None].expand(bh, nnz)
    mask2[bidx[valid], row_of.clamp(0, s - 1)[valid], cols2[valid]] = True
    mask = mask2.reshape(b, h, s, s)
    scores = torch.matmul(query, key.transpose(-1, -2)) / (d ** 0.5)
    scores = scores.float().masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).masked_fill(~mask, 0.0)
    return torch.matmul(probs.to(query.dtype), value)
