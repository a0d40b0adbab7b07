"""Prompt-lookup n-gram draft proposers for speculative decoding.

Port of ``paddle_tpu/inference/ngram.py``. The draft source of LOSSLESS
n-gram speculative decoding: continue the longest recent suffix match found
earlier in the context. Drafts only decide how many tokens one verify
forward yields; every emitted token is the model's own greedy pick.

- :class:`NgramIndex` — the incremental n-gram -> continuation index over a
  token list the caller owns (pure Python, the reference's);
- :class:`NgramProposer` — one sequence's state (context + index), seeded
  with the prompt, ``extend()``-ed with each accepted token and asked to
  ``propose()`` drafts: the host draft source of ``generate_speculative``
  and of the engines' ``spec_mode="host"``. A preempted or replayed request
  rebuilds it from ``prompt + generated`` (the index is a pure function of
  the context);
- :func:`propose_device` — the same lookup as a batched, fixed-shape torch
  function over per-slot history rings on the device: the draft source of
  ``spec_mode="device"``. It syncs nothing with the host (no ``.item()``,
  no ``nonzero``, no boolean-mask indexing), so it runs inside a captured
  CUDA graph.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

__all__ = ["NgramIndex", "NgramProposer", "propose_device"]


class NgramIndex:
    """Incremental prompt-lookup index: maps each n-gram (n <= ngram_max)
    to the continuation start of its most recent occurrence. Registration
    lags one position behind the context tail so the current suffix never
    matches itself; amortized O(ngram_max) per appended token."""

    def __init__(self, ngram_max: int):
        if not isinstance(ngram_max, (int, np.integer)) or ngram_max < 1:
            raise ValueError(
                f"ngram_max must be a positive int, got {ngram_max!r}")
        self.n_max = int(ngram_max)
        self.maps = {n: {} for n in range(1, self.n_max + 1)}
        self._reg = 0          # grams ending before this index are in

    def _register_upto(self, ctx, end):
        for j in range(self._reg, end):
            for n in range(1, min(self.n_max, j + 1) + 1):
                self.maps[n][tuple(ctx[j - n + 1:j + 1])] = j + 1
        self._reg = max(self._reg, end)

    def propose(self, ctx, k: int):
        """Up to ``k`` draft tokens continuing the longest recent suffix of
        ``ctx`` seen earlier in ``ctx`` (padded with the last draft, or the
        tail token on a total miss, to exactly k)."""
        L = len(ctx)
        self._register_upto(ctx, L - 1)   # exclude the current tail
        for n in range(min(self.n_max, L - 1), 0, -1):
            start = self.maps[n].get(tuple(ctx[L - n:]))
            if start is not None:
                cont = ctx[start:start + k]
                if cont:
                    return (cont + [cont[-1]] * (k - len(cont)))[:k]
        return [ctx[-1]] * k


class NgramProposer:
    """One sequence's draft proposer: context (prompt + every accepted
    token so far) plus its :class:`NgramIndex`, updated incrementally, so
    per-step host work stays O(ngram_max * k) whatever the context length.
    ``proposed`` / ``accepted`` count draft tokens for the engines'
    accounting."""

    def __init__(self, tokens, draft_k: int, ngram_max: int = 3):
        if not isinstance(draft_k, (int, np.integer)) or draft_k < 1:
            raise ValueError(
                f"draft_k must be a positive int, got {draft_k!r}")
        self.k = int(draft_k)
        self.ctx: List[int] = [int(t) for t in np.asarray(tokens)
                               .reshape(-1)]
        self._index = NgramIndex(ngram_max)
        self.proposed = 0
        self.accepted = 0

    def extend(self, tokens) -> None:
        """Append accepted tokens to the context (the index registers them
        lazily at the next ``propose``)."""
        self.ctx.extend(int(t) for t in tokens)

    def propose(self, k=None) -> List[int]:
        """Draft ``k`` (default: this proposer's ``draft_k``) tokens from
        the current context."""
        k = self.k if k is None else int(k)
        self.proposed += k
        return self._index.propose(self.ctx, k)


def propose_device(hist: torch.Tensor, hl: torch.Tensor, k: int,
                   ngram_max: int) -> torch.Tensor:
    """Batched device twin of :meth:`NgramIndex.propose`. ``hist`` [B, H]
    int32 holds each row's LAST ``hl[b] <= H`` context tokens, left-aligned;
    returns [B, k] int32 drafts. For a row whose whole context fits its
    window the drafts are EXACTLY the host proposer's: longest suffix match
    first, the most recent occurrence within a length, the continuation
    padded with its own last token, a total miss giving the tail token. The
    two out-of-range sides read distinct sentinels (-1 before the window,
    -2 before the tail), so padding never fakes a match. O(B * H *
    ngram_max) work, whatever the context length; no host sync."""
    B, H = hist.shape
    n_max, k = int(ngram_max), int(k)
    dev = hist.device
    hist = hist.to(torch.int32)
    hl = hl.to(torch.int64)
    j = torch.arange(H, device=dev)
    i = torch.arange(n_max, device=dev)
    # the gram ending at window position j, read back to front: token at
    # j - i, against the tail suffix's token at hl - 1 - i
    pos = j[:, None] - i[None, :]                              # [H, n]
    tokj = hist[:, pos.clamp(0, H - 1)]                        # [B, H, n]
    tokj = torch.where(pos[None] >= 0, tokj, torch.full_like(tokj, -1))
    tpos = hl[:, None] - 1 - i[None, :]                        # [B, n]
    tail = hist.gather(1, tpos.clamp(0, H - 1))
    tail = torch.where(tpos >= 0, tail, torch.full_like(tail, -2))
    eq = (tokj == tail[:, None, :]).to(torch.int32)
    run = torch.cumprod(eq, dim=2)                 # run[b, j, n-1]: match
    n_arr = i + 1
    # a valid length-n match lies inside the window (j >= n - 1) and is
    # not the current suffix itself (j <= hl - 2: the host index
    # registers one behind the tail)
    ok = ((run > 0) & (j[None, :, None] >= n_arr[None, None, :] - 1)
          & (j[None, :, None] <= hl[:, None, None] - 2))
    score = torch.where(ok, n_arr[None, None, :] * H + j[None, :, None],
                        torch.full_like(run, -1, dtype=torch.int64))
    # longest n wins, the most recent j breaks ties: the host loop's
    # order (n descending, each map holding the latest occurrence)
    best, at = score.reshape(B, -1).max(dim=1)
    start = torch.where(best >= 0, at // n_max + 1, hl - 1)
    # clamping to the tail pads with the last token, and on a total miss
    # (start = hl - 1) gives [tail] * k
    idx = (start[:, None] + torch.arange(k, device=dev)[None]).clamp(
        min=0)
    idx = torch.minimum(idx, (hl - 1).clamp(min=0)[:, None])
    return hist.gather(1, idx.clamp(max=H - 1))
