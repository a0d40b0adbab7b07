"""Viterbi decoding (port of ``paddle_tpu/text/viterbi_decode.py``): the
best-scoring tag path of a linear-chain CRF, as a loop over time on the
device of the inputs. With ``include_bos_eos_tag`` the last tag is BOS
(its transition row starts every path) and the second to last is EOS (its
transition column ends it). A step past a row's length keeps its scores
and points each tag back at itself. Ties go to the lowest tag index, as
``argmax`` gives them."""
from __future__ import annotations

import torch

from ..nn import Layer

__all__ = ["viterbi_decode", "ViterbiDecoder"]


def viterbi_decode(potentials, transition_params, lengths,
                   include_bos_eos_tag=True, name=None):
    """Highest-scoring tag sequence. potentials [B, L, N], transitions
    [N, N], lengths [B] -> (scores [B], paths [B, max(lengths)] int64, zero
    past each row's length)."""
    pot, trans = potentials, transition_params.to(potentials.device)
    b, seq_len, n = pot.shape
    lengths = lengths.to(pot.device)
    alpha = pot[:, 0]
    if include_bos_eos_tag:
        alpha = alpha + trans[n - 1][None, :]
    tags = torch.arange(n, device=pot.device)[None, :].expand(b, n)
    bps = []
    for t in range(1, seq_len):
        # scores[b, i, j] = alpha[b, i] + trans[i, j]; then + emit[b, t, j]
        best, prev = (alpha[:, :, None] + trans[None, :, :]).max(dim=1)
        live = (t < lengths)[:, None]
        alpha = torch.where(live, best + pot[:, t], alpha)
        bps.append(torch.where(live, prev, tags))
    if include_bos_eos_tag:
        alpha = alpha + trans[:, n - 2][None, :]
    scores, last = alpha.max(dim=-1)
    path = [last]
    for bp in reversed(bps):
        path.append(torch.gather(bp, 1, path[-1][:, None])[:, 0])
    path = torch.stack(path[::-1], 1)                         # [B, L]
    tpos = torch.arange(seq_len, device=pot.device)[None, :]
    path = torch.where(tpos < lengths[:, None], path, 0)
    return scores, path[:, :int(lengths.max())].to(torch.int64)


class ViterbiDecoder(Layer):
    """``viterbi_decode`` with the transitions held by the layer."""

    def __init__(self, transitions, include_bos_eos_tag=True, name=None):
        super().__init__()
        self.transitions = transitions
        self.include_bos_eos_tag = include_bos_eos_tag

    def forward(self, potentials, lengths):
        return viterbi_decode(potentials, self.transitions, lengths,
                              self.include_bos_eos_tag)
