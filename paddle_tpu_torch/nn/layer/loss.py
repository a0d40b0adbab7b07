"""Loss layers (port of ``paddle_tpu/nn/layer/loss.py``): ``Layer``
wrappers of ``nn.functional``'s losses and sequence losses.
``HSigmoidLoss`` owns the ``[num_classes - 1, feature_size]`` weights of
the tree's inner nodes (and their bias unless ``bias_attr=False``)."""
from __future__ import annotations

from ..functional import loss as F
from ..functional import sequence_loss as S
from .layers import Layer

__all__ = [
    "CrossEntropyLoss", "NLLLoss", "BCELoss", "BCEWithLogitsLoss", "MSELoss",
    "L1Loss", "SmoothL1Loss", "KLDivLoss", "MarginRankingLoss",
    "HingeEmbeddingLoss", "CosineEmbeddingLoss",
    "TripletMarginLoss", "TripletMarginWithDistanceLoss",
    "MultiLabelSoftMarginLoss", "SoftMarginLoss", "PoissonNLLLoss",
    "GaussianNLLLoss", "CTCLoss", "HSigmoidLoss", "MultiMarginLoss",
    "RNNTLoss",
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


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank, self.reduction = blank, reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self.blank, self.reduction, norm_by_times)


class HSigmoidLoss(Layer):
    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None):
        super().__init__()
        if num_classes < 2:
            raise ValueError("num_classes must be >= 2")
        self.num_classes = num_classes
        self.is_custom = is_custom
        self.weight = self.create_parameter(
            shape=[num_classes - 1, feature_size], attr=weight_attr)
        self.bias = None if bias_attr is False else self.create_parameter(
            shape=[num_classes - 1], attr=bias_attr, is_bias=True)

    def forward(self, input, label, path_table=None, path_code=None):
        return S.hsigmoid_loss(input, label, self.num_classes, self.weight,
                               self.bias, path_table=path_table,
                               path_code=path_code)


class MultiMarginLoss(Layer):
    def __init__(self, p: int = 1, margin: float = 1.0, weight=None,
                 reduction: str = "mean", name=None):
        super().__init__()
        self.p, self.margin = p, margin
        self.weight, self.reduction = weight, reduction

    def forward(self, input, label):
        return S.multi_margin_loss(input, label, p=self.p, margin=self.margin,
                                   weight=self.weight,
                                   reduction=self.reduction)


class RNNTLoss(Layer):
    def __init__(self, blank=0, fastemit_lambda=0.001, reduction="mean",
                 name=None):
        super().__init__()
        self.blank = blank
        self.fastemit_lambda = fastemit_lambda
        self.reduction = reduction

    def forward(self, input, label, input_lengths, label_lengths):
        return S.rnnt_loss(input, label, input_lengths, label_lengths,
                           blank=self.blank,
                           fastemit_lambda=self.fastemit_lambda,
                           reduction=self.reduction)
