"""Loss functions (port of ``paddle_tpu/nn/functional/loss.py``).

The reference's formulas, term for term, as plain torch: each function is
differentiable in its input tensors; labels, class weights, ``pos_weight``
and normalizers are constants, as they are in the reference. Each function
enters the AMP policy under the reference's op name (``cross_entropy``,
``nll_loss``, ``kl_div`` and ``binary_cross_entropy`` are on the black
list, so they compute in fp32 under ``auto_cast``; the rest are gray, cast
to the AMP dtype only at O2) and its output is checked under
``FLAGS_check_nan_inf``. ``ctc_loss`` (a scan over time) is not ported yet.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ...framework.amp_state import cast_inputs, check_outputs

__all__ = [
    "cross_entropy", "softmax_with_cross_entropy", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "nll_loss", "l1_loss", "mse_loss",
    "smooth_l1_loss", "kl_div", "margin_ranking_loss", "hinge_embedding_loss",
    "cosine_embedding_loss", "triplet_margin_loss",
    "triplet_margin_with_distance_loss", "multi_label_soft_margin_loss",
    "soft_margin_loss", "sigmoid_focal_loss", "dice_loss", "log_loss",
    "square_error_cost", "poisson_nll_loss", "gaussian_nll_loss",
]


def _reduce(v, reduction: str):
    if reduction == "mean":
        return v.mean()
    if reduction == "sum":
        return v.sum()
    return v


def _op(op_name: str, fn, *tensors):
    """``fn(*tensors)`` with the tensors cast by the AMP policy for
    ``op_name`` and the result checked."""
    out = fn(*cast_inputs(op_name, *tensors))
    check_outputs(op_name, out)
    return out


def _const(x, like: torch.Tensor):
    """A label or weight as a tensor on ``like``'s device."""
    if x is None:
        return None
    return torch.as_tensor(x, device=like.device)


def cross_entropy(input, label, weight=None, ignore_index: int = -100,
                  reduction: str = "mean", soft_label: bool = False,
                  axis: int = -1, use_softmax: bool = True,
                  label_smoothing: float = 0.0, name=None):
    lbl = _const(label, input)
    w = _const(weight, input)

    def f(logits):
        logp = (torch.log_softmax(logits, dim=axis) if use_softmax
                else torch.log(torch.clamp(logits, min=1e-30)))
        n_classes = logits.shape[axis]
        if soft_label or (lbl.dim() == logits.dim()
                          and lbl.shape == logits.shape):
            tgt = lbl.to(logp.dtype)
            if label_smoothing > 0.0:
                tgt = ((1 - label_smoothing) * tgt
                       + label_smoothing / n_classes)
            loss = -torch.sum(tgt * logp, dim=axis)
            mask = None
        else:
            ids = lbl
            if ids.dim() == logits.dim():        # a trailing 1 dim
                ids = ids.squeeze(axis)
            mask = ids != ignore_index
            safe = torch.where(mask, ids, 0).long()
            picked = torch.take_along_dim(
                logp, safe.unsqueeze(axis), dim=axis).squeeze(axis)
            if label_smoothing > 0.0:
                smooth = logp.mean(dim=axis)
                picked = ((1 - label_smoothing) * picked
                          + label_smoothing * smooth)
            loss = -torch.where(mask, picked, 0.0)
            if w is not None:
                wsel = torch.where(mask, w[safe], 0.0)
                loss = loss * wsel
                if reduction == "mean":
                    return loss.sum() / torch.clamp(wsel.sum(), min=1e-12)
        if reduction == "mean" and mask is not None:
            denom = torch.clamp(mask.to(logp.dtype).sum(), min=1.0)
            return loss.sum() / denom
        return _reduce(loss, reduction)

    return _op("cross_entropy", f, input)


def softmax_with_cross_entropy(logits, label, soft_label: bool = False,
                               ignore_index: int = -100,
                               numeric_stable_mode: bool = True,
                               return_softmax: bool = False, axis: int = -1):
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis).unsqueeze(axis)   # a trailing dim kept
    if return_softmax:
        return loss, _op("softmax", lambda z: torch.softmax(z, dim=axis),
                         logits)
    return loss


def binary_cross_entropy(input, label, weight=None, reduction: str = "mean",
                         name=None):
    lbl, w = _const(label, input), _const(weight, input)

    def f(p):
        eps = 1e-12
        loss = -(lbl * torch.log(torch.clamp(p, min=eps))
                 + (1 - lbl) * torch.log(torch.clamp(1 - p, min=eps)))
        if w is not None:
            loss = loss * w
        return _reduce(loss, reduction)

    return _op("binary_cross_entropy", f, input)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction: str = "mean",
                                     pos_weight=None, name=None):
    lbl, w = _const(label, logit), _const(weight, logit)
    pw = _const(pos_weight, logit)

    def f(z):
        soft = torch.log1p(torch.exp(-torch.abs(z)))
        if pw is not None:
            log_weight = 1 + (pw - 1) * lbl
            base = (1 - lbl) * z + log_weight * (soft + torch.clamp(-z, min=0))
        else:
            base = torch.clamp(z, min=0) - z * lbl + soft
        if w is not None:
            base = base * w
        return _reduce(base, reduction)

    return _op("bce_with_logits", f, logit)


def nll_loss(input, label, weight=None, ignore_index: int = -100,
             reduction: str = "mean", name=None):
    lbl, w = _const(label, input), _const(weight, input)

    def f(logp):
        mask = lbl != ignore_index
        safe = torch.where(mask, lbl, 0).long()
        picked = torch.take_along_dim(logp, safe.unsqueeze(1),
                                      dim=1).squeeze(1)
        loss = -torch.where(mask, picked, 0.0)
        if w is not None:
            wsel = torch.where(mask, w[safe], 0.0)
            loss = loss * wsel
            if reduction == "mean":
                return loss.sum() / torch.clamp(wsel.sum(), min=1e-12)
        if reduction == "mean":
            denom = torch.clamp(mask.to(logp.dtype).sum(), min=1.0)
            return loss.sum() / denom
        return _reduce(loss, reduction)

    return _op("nll_loss", f, input)


def l1_loss(input, label, reduction: str = "mean", name=None):
    return _op("l1_loss", lambda a, b: _reduce(torch.abs(a - b), reduction),
               input, label)


def mse_loss(input, label, reduction: str = "mean", name=None):
    return _op("mse_loss", lambda a, b: _reduce((a - b) ** 2, reduction),
               input, label)


def square_error_cost(input, label):
    return _op("square_error_cost", lambda a, b: (a - b) ** 2, input, label)


def smooth_l1_loss(input, label, reduction: str = "mean", delta: float = 1.0,
                   name=None):
    def f(a, b):
        d = a - b
        abs_d = torch.abs(d)
        loss = torch.where(abs_d < delta, 0.5 * d * d,
                           delta * (abs_d - 0.5 * delta))
        return _reduce(loss, reduction)

    return _op("smooth_l1_loss", f, input, label)


def kl_div(input, label, reduction: str = "mean", log_target: bool = False,
           name=None):
    def f(logp, tgt):
        if log_target:
            loss = torch.exp(tgt) * (tgt - logp)
        else:
            loss = torch.where(tgt > 0, tgt * (torch.log(
                torch.clamp(tgt, min=1e-12)) - logp), 0.0)
        if reduction == "batchmean":
            return loss.sum() / logp.shape[0]
        return _reduce(loss, reduction)

    return _op("kl_div", f, input, label)


def margin_ranking_loss(input, other, label, margin: float = 0.0,
                        reduction: str = "mean", name=None):
    def f(a, b, y):
        return _reduce(torch.clamp(-y * (a - b) + margin, min=0.0),
                       reduction)

    return _op("margin_ranking_loss", f, input, other, label)


def hinge_embedding_loss(input, label, margin: float = 1.0,
                         reduction: str = "mean", name=None):
    def f(a, y):
        loss = torch.where(y == 1, a, torch.clamp(margin - a, min=0.0))
        return _reduce(loss, reduction)

    return _op("hinge_embedding_loss", f, input, label)


def cosine_embedding_loss(input1, input2, label, margin: float = 0.0,
                          reduction: str = "mean", name=None):
    def f(a, b, y):
        cos = (a * b).sum(-1) / torch.clamp(
            torch.linalg.vector_norm(a, dim=-1)
            * torch.linalg.vector_norm(b, dim=-1), min=1e-12)
        loss = torch.where(y == 1, 1 - cos, torch.clamp(cos - margin,
                                                        min=0.0))
        return _reduce(loss, reduction)

    return _op("cosine_embedding_loss", f, input1, input2, label)


def soft_margin_loss(input, label, reduction: str = "mean", name=None):
    return _op("soft_margin_loss", lambda a, y: _reduce(
        torch.log1p(torch.exp(-y * a)), reduction), input, label)


def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction: str = "mean", name=None):
    w = _const(weight, input)

    def f(z, y):
        loss = -(y * F.logsigmoid(z) + (1 - y) * F.logsigmoid(-z))
        if w is not None:
            loss = loss * w
        return _reduce(loss.mean(-1), reduction)

    return _op("multi_label_soft_margin_loss", f, input, label)


def _p_dist(a, b, p, epsilon):
    return torch.sum(torch.abs(a - b) ** p + epsilon, -1) ** (1 / p)


def triplet_margin_loss(input, positive, negative, margin: float = 1.0,
                        p: float = 2.0, epsilon: float = 1e-6,
                        swap: bool = False, reduction: str = "mean",
                        name=None):
    def f(a, pos, neg):
        dp = _p_dist(a, pos, p, epsilon)
        dn = _p_dist(a, neg, p, epsilon)
        if swap:
            dn = torch.minimum(dn, _p_dist(pos, neg, p, epsilon))
        return _reduce(torch.clamp(dp - dn + margin, min=0.0), reduction)

    return _op("triplet_margin_loss", f, input, positive, negative)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None,
                                      margin: float = 1.0, swap: bool = False,
                                      reduction: str = "mean", name=None):
    if distance_function is None:
        return triplet_margin_loss(input, positive, negative, margin=margin,
                                   swap=swap, reduction=reduction)
    dp = distance_function(input, positive)
    dn = distance_function(input, negative)
    if swap:
        dn = torch.minimum(dn, distance_function(positive, negative))
    return _op("triplet_margin_with_distance_loss", lambda a, b: _reduce(
        torch.clamp(a - b + margin, min=0.0), reduction), dp, dn)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha: float = 0.25,
                       gamma: float = 2.0, reduction: str = "sum",
                       name=None):
    norm = _const(normalizer, logit)

    def f(z, y):
        p = torch.sigmoid(z)
        ce = torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(
            -torch.abs(z)))
        p_t = p * y + (1 - p) * (1 - y)
        loss = ce * ((1 - p_t) ** gamma)
        if alpha >= 0:
            loss = (alpha * y + (1 - alpha) * (1 - y)) * loss
        if norm is not None:
            loss = loss / norm
        return _reduce(loss, reduction)

    return _op("sigmoid_focal_loss", f, logit, label)


def dice_loss(input, label, epsilon: float = 1e-5, name=None):
    lbl = _const(label, input)

    def f(p):
        y = F.one_hot(lbl.squeeze(-1).long(), p.shape[-1]).to(p.dtype)
        dims = tuple(range(1, p.dim()))
        inter = (p * y).sum(dims)
        union = p.sum(dims) + y.sum(dims)
        return (1 - (2 * inter + epsilon) / (union + epsilon)).mean()

    return _op("dice_loss", f, input)


def log_loss(input, label, epsilon: float = 1e-4, name=None):
    return _op("log_loss", lambda p, y: -y * torch.log(p + epsilon) - (
        1 - y) * torch.log(1 - p + epsilon), input, label)


def poisson_nll_loss(input, label, log_input: bool = True,
                     full: bool = False, epsilon: float = 1e-8,
                     reduction: str = "mean", name=None):
    def f(x, y):
        if log_input:
            loss = torch.exp(x) - y * x
        else:
            loss = x - y * torch.log(x + epsilon)
        if full:
            stirling = y * torch.log(y) - y + 0.5 * torch.log(2 * math.pi * y)
            loss = loss + torch.where(y > 1, stirling, 0.0)
        return _reduce(loss, reduction)

    return _op("poisson_nll_loss", f, input, label)


def gaussian_nll_loss(input, label, variance, full: bool = False,
                      epsilon: float = 1e-6, reduction: str = "mean",
                      name=None):
    def f(mu, y, var):
        var = torch.clamp(var, min=epsilon)
        loss = 0.5 * (torch.log(var) + (y - mu) ** 2 / var)
        if full:
            loss = loss + 0.5 * math.log(2 * math.pi)
        return _reduce(loss, reduction)

    return _op("gaussian_nll_loss", f, input, label, variance)
