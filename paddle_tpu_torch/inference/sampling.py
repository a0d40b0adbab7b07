"""Per-request sampling on the device: the port of the sampled branch of
``paddle_tpu/inference/generation.py::_sample`` / ``_sample_rows``
(:300-370).

Every sampling parameter is a per-row device vector (:class:`SlotSampling`:
temperature, top-k, top-p, sample-or-greedy and seed), so one program serves
any mix of per-request configs, as in the reference. The filter is the
reference's, in its order: logits / max(temperature, 1e-6), then top-k (keep
the logits >= the k-th largest; k = 0 keeps all), then top-p over the
top-k-filtered logits (keep the smallest prefix of the sorted probabilities
whose mass before each kept entry is < top_p).

The draw differs from the reference's by design: JAX's threefry keys are not
reproducible with torch's generators, and a ``torch.Generator`` would keep
state a CUDA graph cannot replay. Each row draws the Gumbel-max way: the
argmax of the filtered logits plus Gumbel noise ``-log(-log(u))``, where u
comes from a counter hash of (the row's seed, the absolute position of the
token being drawn, the vocabulary index), the murmur3 finalizer of
``ops/flash_attention_kernel.py::_mix``, taken to 23 bits in the open
interval (0, 1). So a request's tokens depend on its own config and
position only, never on its batch-mates or on whether the program was
captured, and the draw is a categorical sample from softmax(filtered
logits). Greedy rows are the plain argmax of the raw logits, bitwise the
greedy path's.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.flash_attention_kernel import _mix

__all__ = ["SlotSampling", "filtered_logits", "gumbel_noise", "sample_rows"]

_U32 = 0xFFFFFFFF
_POS_KEY = 0x9E3779B9       # golden-ratio odd constants: the position's and
_VOCAB_KEY = 0x632BE5AB     # the vocabulary index's part of the hash


class SlotSampling:
    """Sampling parameters of ``n`` rows as device vectors, allocated once
    and written in place (a captured program holds their addresses):
    ``temp`` fp32 (1), ``top_k`` int32 (0: off), ``top_p`` fp32 (1: off),
    ``sample`` bool (False: greedy) and ``seed`` int64 (0); the defaults in
    brackets are the greedy row's."""

    def __init__(self, n: int, device):
        dev = torch.device(device)
        self.temp = torch.ones(n, dtype=torch.float32, device=dev)
        self.top_k = torch.zeros(n, dtype=torch.int32, device=dev)
        self.top_p = torch.ones(n, dtype=torch.float32, device=dev)
        self.sample = torch.zeros(n, dtype=torch.bool, device=dev)
        self.seed = torch.zeros(n, dtype=torch.int64, device=dev)

    def tensors(self):
        return (self.temp, self.top_k, self.top_p, self.sample, self.seed)

    def set(self, rows, cfg, seed) -> None:
        """Rows ``rows`` (an index or a slice) take ``cfg``'s parameters
        and the stream seed(s) ``seed`` (an int, or a tensor of one per
        row)."""
        self.temp[rows] = cfg.temperature
        self.top_k[rows] = cfg.top_k
        self.top_p[rows] = cfg.top_p
        self.sample[rows] = cfg.do_sample
        self.seed[rows] = seed

    def reset(self) -> None:
        """Every row greedy again, in place."""
        self.temp.fill_(1.0)
        self.top_k.zero_()
        self.top_p.fill_(1.0)
        self.sample.zero_()
        self.seed.zero_()

    def view(self, rows) -> "SlotSampling":
        """The parameters of ``rows`` (a slice or an index), as views."""
        out = SlotSampling.__new__(SlotSampling)
        for name, t in zip(("temp", "top_k", "top_p", "sample", "seed"),
                           self.tensors()):
            setattr(out, name, t[rows].reshape(-1))
        return out


def filtered_logits(logits: torch.Tensor, temp: torch.Tensor,
                    top_k: torch.Tensor, top_p: torch.Tensor
                    ) -> torch.Tensor:
    """The reference's filter of [B, V] logits with per-row parameters:
    fp32 logits / max(temp, 1e-6), -inf below the top-k and outside the
    top-p set (rows with top_k == 0 / top_p == 1 skip those filters).
    The support of a row's draw is where the result is finite."""
    vocab = logits.shape[-1]
    neg = float("-inf")
    scaled = logits.float() / temp.clamp_min(1e-6)[:, None]
    desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = desc.gather(1, (top_k.clamp(1, vocab).long() - 1)[:, None])
    cut_k = (top_k > 0)[:, None]
    scaled = scaled.masked_fill(cut_k & (scaled < kth), neg)
    # the sorted top-k-filtered logits: the same cut applied to desc
    desc = desc.masked_fill(cut_k & (desc < kth), neg)
    probs = torch.softmax(desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = cum - probs < top_p[:, None]
    cutoff = torch.where(keep, desc, float("inf")).amin(-1, keepdim=True)
    return scaled.masked_fill((top_p < 1.0)[:, None] & (scaled < cutoff),
                              neg)


def _uniform(bits: torch.Tensor) -> torch.Tensor:
    """fp32 u in the open interval (0, 1) from 32-bit hashes (int64):
    u = (the top 23 bits + 1/2) / 2^23. The sum needs at most 24
    significant bits, so it is exact in fp32, and u runs from 2^-24 to
    1 - 2^-24. (With 24 bits the sum would round 2^24 - 1/2 up to 2^24,
    and u to 1.)"""
    return ((bits >> 9).float() + 0.5) * (2.0 ** -23)


def gumbel_noise(seed: torch.Tensor, pos: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """[B, V] fp32 Gumbel noise -log(-log(u)), a function of (seed[b],
    pos[b], vocabulary index) alone; u (:func:`_uniform`) never reaches 0
    or 1, so the noise is finite, between -2.8 and 16.7."""
    s = _mix((seed & _U32) ^ (((pos.long() & _U32) * _POS_KEY) & _U32))
    v = torch.arange(vocab, dtype=torch.int64, device=seed.device)
    bits = _mix(_mix((s[:, None] + v) & _U32) ^ _VOCAB_KEY)
    return -torch.log(-torch.log(_uniform(bits)))


def sample_rows(logits: torch.Tensor, samp: Optional[SlotSampling] = None,
                pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next token per row of [B, V] logits, int32 [B]. Without ``samp``:
    the greedy argmax (the first maximum on ties, as ``jnp.argmax``). With
    it: rows whose ``samp.sample`` is set draw from their filtered
    distribution with the noise of (``samp.seed``, ``pos``), ``pos`` [B]
    the absolute position of the token being drawn; the other rows keep
    the greedy argmax."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if samp is None:
        return greedy
    filt = filtered_logits(logits, samp.temp, samp.top_k, samp.top_p)
    noise = gumbel_noise(samp.seed, pos.expand(logits.shape[0]),
                         logits.shape[-1])
    drawn = torch.argmax(filt + noise, dim=-1).to(torch.int32)
    return torch.where(samp.sample, drawn, greedy)
