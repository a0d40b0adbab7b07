"""Sequence and classification losses (port of
``paddle_tpu/nn/functional/sequence_loss.py``): ``gather_tree``,
``hsigmoid_loss``, ``rnnt_loss``, ``multi_margin_loss`` and
``margin_cross_entropy``.

Each ``lax.scan`` of the reference is a loop over time on device tensors,
with the same recursion in log space: ``gather_tree`` walks the beams back
from the last step, ``rnnt_loss`` runs the alpha recursion over T with the
inner one over U. RNN-T's FastEmit term keeps the reference's construction
(a zero-valued term whose gradient flows only through the label
log-probabilities: the blank ones ``.detach()`` ed), so the loss value is
the plain transducer NLL and the emission gradient is ``1 + lambda``
times. Labels, lengths, path tables and codes are constants.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ._op import amp_op
from .loss import _reduce

__all__ = ["gather_tree", "hsigmoid_loss", "rnnt_loss",
           "multi_margin_loss", "margin_cross_entropy"]

_NEG = -1e30


def gather_tree(ids, parents):
    """Backtrace beam-search ids along parent pointers; ``ids`` and
    ``parents`` are [max_time, batch, beam]."""
    ids = torch.as_tensor(ids)
    parents = torch.as_tensor(parents, device=ids.device)
    T = ids.shape[0]
    beam = torch.arange(ids.shape[2], device=ids.device).to(parents.dtype)
    beam = beam[None, :].expand(ids.shape[1:]).contiguous()
    out = [None] * T
    for t in range(T - 1, -1, -1):
        idx = beam.long()
        out[t] = ids[t].gather(1, idx)
        beam = parents[t].gather(1, idx)
    return torch.stack(out) if T else ids.clone()


def _simple_code(labels, num_classes, max_len):
    """Paddle's SimpleCode (the complete binary tree): for class c walk
    m = c + num_classes from the top bit: node ids (m >> k) - 1, branch
    bits (m >> (k - 1)) & 1."""
    m = labels + num_classes
    nbits = torch.floor(torch.log2(m.float())).long()
    j = torch.arange(max_len, device=labels.device)
    shift = nbits[:, None] - j[None, :]
    valid = shift >= 1
    node = torch.where(valid, (m[:, None] >> shift.clamp(min=1)) - 1,
                       torch.zeros_like(shift))
    bit = torch.where(valid, (m[:, None] >> (shift - 1).clamp(min=0)) & 1,
                      torch.zeros_like(shift))
    return node, bit.float(), valid


@amp_op("hsigmoid_loss")
def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid loss, [N, 1]: the complete-binary-tree code
    by default, or ``path_table`` (node ids, [N, L]) and ``path_code``
    (branch bits, [N, L], -1 padded)."""
    max_len = int(math.ceil(math.log2(max(num_classes, 2))))
    dev = input.device
    if path_table is not None:
        pt_ = torch.as_tensor(path_table, device=dev).long()
        pc = torch.as_tensor(path_code, device=dev).float()
        valid = pc >= 0
        pc = pc.clamp(min=0.0)
    else:
        lbl = torch.as_tensor(label, device=dev).reshape(-1).long()
        pt_, pc, valid = _simple_code(lbl, num_classes, max_len)
    logit = torch.einsum("nld,nd->nl", weight[pt_], input)
    if bias is not None:
        logit = logit + bias.reshape(-1)[pt_]
    loss = TF.softplus(logit) - pc * logit
    loss = torch.where(valid, loss, torch.zeros_like(loss)).sum(-1)
    return loss.reshape(-1, 1)


def _rnnt_nll(blank_lp, y_lp, ilen, llen):
    """-log P(y | x) per row by the alpha recursion: blank_lp [B, T, U+1],
    y_lp [B, T, U]."""
    B, T, U1 = blank_lp.shape
    dev = blank_lp.device
    neg = torch.full((B,), _NEG, dtype=blank_lp.dtype, device=dev)
    first = torch.full((B, U1), _NEG, dtype=blank_lp.dtype, device=dev)
    first[:, 0] = 0.0
    alpha_prev = torch.full((B, U1), _NEG, dtype=blank_lp.dtype, device=dev)
    alphas = []
    for t in range(T):
        from_left = first if t == 0 else alpha_prev + blank_lp[:, t - 1]
        cols, cur = [], neg
        for u in range(U1):
            cur = (from_left[:, 0] if u == 0 else
                   torch.logaddexp(from_left[:, u], cur + y_lp[:, t, u - 1]))
            cols.append(cur)
        alpha_prev = torch.stack(cols, 1)
        alphas.append(alpha_prev)
    alphas = torch.stack(alphas, 1)                         # [B, T, U+1]
    rows = torch.arange(B, device=dev)
    t_last = ilen.long() - 1
    u_last = llen.long()
    return -(alphas[rows, t_last, u_last] + blank_lp[rows, t_last, u_last])


@amp_op("rnnt_loss")
def rnnt_loss(input, label, input_lengths, label_lengths, blank=0,
              fastemit_lambda=0.001, reduction="mean", name=None):
    """RNN-Transducer loss; ``input`` [B, T, U+1, V] logits (log-softmax
    applied here, in fp32), ``label`` [B, U]."""
    dev = input.device
    logp = torch.log_softmax(input.float(), dim=-1)
    U = logp.shape[2] - 1
    blank_lp = logp[..., blank]
    lbl = torch.as_tensor(label, device=dev).long()
    y_lp = logp[:, :, :U, :].gather(
        -1, lbl[:, None, :, None].expand(-1, logp.shape[1], -1, 1))[..., 0]
    ilen = torch.as_tensor(input_lengths, device=dev)
    llen = torch.as_tensor(label_lengths, device=dev)
    nll = _rnnt_nll(blank_lp, y_lp, ilen, llen)
    if fastemit_lambda > 0.0:
        emit = _rnnt_nll(blank_lp.detach(), y_lp, ilen, llen)
        nll = nll + fastemit_lambda * (emit - emit.detach())
    return _reduce(nll, reduction)


@amp_op("multi_margin_loss")
def multi_margin_loss(input, label, p: int = 1, margin: float = 1.0,
                      weight=None, reduction: str = "mean", name=None):
    """Multi-class hinge loss."""
    C = input.shape[1]
    lbl = torch.as_tensor(label, device=input.device).reshape(-1).long()
    x_y = input.gather(1, lbl[:, None])
    diff = torch.clamp(margin - x_y + input, min=0.0) ** p
    if weight is not None:
        w = torch.as_tensor(weight, device=input.device).reshape(-1)
        diff = diff * w[lbl][:, None]
    mask = torch.arange(C, device=input.device)[None, :] != lbl[:, None]
    loss = torch.where(mask, diff, torch.zeros_like(diff)).sum(1) / C
    return _reduce(loss, reduction)


@amp_op("margin_cross_entropy")
def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean"):
    """ArcFace-family margin softmax: the target cosine becomes
    cos(m1 theta + m2) - m3, everything scaled by ``scale``."""
    lbl = torch.as_tensor(label, device=logits.device).reshape(-1).long()
    cos = logits.clamp(-1.0, 1.0)
    theta = torch.arccos(cos.gather(1, lbl[:, None])[:, 0])
    target = torch.cos(margin1 * theta + margin2) - margin3
    onehot = TF.one_hot(lbl, logits.shape[1]).to(logits.dtype)
    z = (cos * (1 - onehot) + target[:, None] * onehot) * scale
    logp = torch.log_softmax(z, dim=-1)
    nll = -logp.gather(1, lbl[:, None])[:, 0]
    if reduction == "mean":
        loss = nll.mean()
    elif reduction == "sum":
        loss = nll.sum()
    else:
        loss = nll[:, None]
    return (loss, torch.exp(logp)) if return_softmax else loss
