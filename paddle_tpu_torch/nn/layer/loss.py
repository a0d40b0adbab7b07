"""Loss layers (port of ``paddle_tpu/nn/layer/loss.py``): ``nn.Module``
wrappers of ``nn.functional.loss``. The reference's ``CTCLoss``,
``HSigmoidLoss``, ``MultiMarginLoss`` and ``RNNTLoss``, whose functions the
port does not have yet, are not ported."""
from __future__ import annotations

from torch.nn import Module as Layer

from ..functional import loss as F

__all__ = [
    "CrossEntropyLoss", "NLLLoss", "BCELoss", "BCEWithLogitsLoss", "MSELoss",
    "L1Loss", "SmoothL1Loss", "KLDivLoss", "MarginRankingLoss",
    "HingeEmbeddingLoss", "CosineEmbeddingLoss",
    "TripletMarginLoss", "TripletMarginWithDistanceLoss",
    "MultiLabelSoftMarginLoss", "SoftMarginLoss", "PoissonNLLLoss",
    "GaussianNLLLoss",
]


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self.weight = weight
        self.a = dict(ignore_index=ignore_index, reduction=reduction,
                      soft_label=soft_label, axis=axis, use_softmax=use_softmax,
                      label_smoothing=label_smoothing)

    def forward(self, input, label):
        return F.cross_entropy(input, label, weight=self.weight, **self.a)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean", name=None):
        super().__init__()
        self.weight, self.ignore_index, self.reduction = weight, ignore_index, reduction

    def forward(self, input, label):
        return F.nll_loss(input, label, self.weight, self.ignore_index, self.reduction)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight, self.reduction = weight, reduction

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, self.weight, self.reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None, name=None):
        super().__init__()
        self.weight, self.reduction, self.pos_weight = weight, reduction, pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, self.weight, self.reduction, self.pos_weight)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, self.reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.l1_loss(input, label, self.reduction)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self.reduction, self.delta = reduction, delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, self.reduction, self.delta)


class KLDivLoss(Layer):
    def __init__(self, reduction="mean", log_target=False):
        super().__init__()
        self.reduction, self.log_target = reduction, log_target

    def forward(self, input, label):
        return F.kl_div(input, label, self.reduction, self.log_target)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label, self.margin, self.reduction)


class HingeEmbeddingLoss(Layer):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input, label):
        return F.hinge_embedding_loss(input, label, self.margin, self.reduction)


class CosineEmbeddingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label, self.margin, self.reduction)


class TripletMarginLoss(Layer):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.a = (margin, p, epsilon, swap, reduction)

    def forward(self, input, positive, negative):
        return F.triplet_margin_loss(input, positive, negative, *self.a)


class TripletMarginWithDistanceLoss(Layer):
    def __init__(self, distance_function=None, margin=1.0, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.distance_function = distance_function
        self.margin, self.swap, self.reduction = margin, swap, reduction

    def forward(self, input, positive, negative):
        return F.triplet_margin_with_distance_loss(
            input, positive, negative, self.distance_function, self.margin,
            self.swap, self.reduction)


class MultiLabelSoftMarginLoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight, self.reduction = weight, reduction

    def forward(self, input, label):
        return F.multi_label_soft_margin_loss(input, label, self.weight, self.reduction)


class SoftMarginLoss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.soft_margin_loss(input, label, self.reduction)


class PoissonNLLLoss(Layer):
    def __init__(self, log_input=True, full=False, epsilon=1e-8,
                 reduction="mean", name=None):
        super().__init__()
        self.a = (log_input, full, epsilon, reduction)

    def forward(self, input, label):
        return F.poisson_nll_loss(input, label, *self.a)


class GaussianNLLLoss(Layer):
    def __init__(self, full=False, epsilon=1e-6, reduction="mean", name=None):
        super().__init__()
        self.full, self.epsilon, self.reduction = full, epsilon, reduction

    def forward(self, input, label, variance):
        return F.gaussian_nll_loss(input, label, variance, self.full,
                                   self.epsilon, self.reduction)
