"""AMP op allow/deny lists: a copy of ``paddle_tpu/amp/amp_lists.py``.

Names are the op names the port's ops pass to
``framework.amp_state.cast_inputs``, the reference's ``apply_op`` op names
where the port has the same op. The lists are the reference's, unchanged:
``torch.autocast``'s own lists differ, and it never sees the port's
kernels.
"""
from __future__ import annotations

# ops that benefit from low precision (MXU-bound)
WHITE_LIST = {
    "matmul", "mm", "bmm", "mv", "linear", "conv2d", "conv1d", "conv3d",
    "conv2d_transpose", "einsum", "flash_attention", "sdpa",
    "fused_linear", "addmm",
}

# numerically sensitive — keep fp32
BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "logsumexp",
    "softmax", "log_softmax", "cross_entropy", "softmax_with_cross_entropy",
    "c_softmax_with_cross_entropy", "nll_loss", "kl_div",
    "layer_norm", "batch_norm", "instance_norm", "group_norm", "rms_norm",
    "mean", "sum", "cumsum", "prod", "norm", "dist", "cosine_similarity",
    "erf", "erfinv", "pow", "rsqrt", "softplus", "square",
    "sigmoid_cross_entropy_with_logits", "binary_cross_entropy",
    "lm_loss_mean",
}

# everything else runs in whatever dtype its inputs already have ("gray")

FP16_WHITE_LIST = set(WHITE_LIST)
FP16_BLACK_LIST = set(BLACK_LIST)
BF16_WHITE_LIST = set(WHITE_LIST)
BF16_BLACK_LIST = set(BLACK_LIST)


def white_list(dtype="bfloat16"):
    return BF16_WHITE_LIST if "bf" in str(dtype) else FP16_WHITE_LIST


def black_list(dtype="bfloat16"):
    return BF16_BLACK_LIST if "bf" in str(dtype) else FP16_BLACK_LIST
