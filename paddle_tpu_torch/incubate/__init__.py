"""paddle.incubate counterpart (port of ``paddle_tpu/incubate``): the
fused layers and functions under ``incubate.nn``, the MoE layer under
``incubate.distributed.models.moe``; and, loaded on first access as in the
JAX package, ``asp``, ``autograd``, ``optimizer`` (DistributedFusedLamb)
and the top-level functions of ``_api`` (the segment and graph ops, the
fused softmax masks, ``identity_loss``, ``LookAhead``, ``ModelAverage``)."""
import importlib

from . import distributed, nn

__all__ = ["distributed", "nn", "asp", "autograd", "optimizer",
           "segment_sum", "segment_mean", "segment_min", "segment_max",
           "graph_send_recv", "graph_reindex", "graph_sample_neighbors",
           "graph_khop_sampler", "softmax_mask_fuse",
           "softmax_mask_fuse_upper_triangle", "identity_loss",
           "LookAhead", "ModelAverage"]

_LAZY = {"asp", "optimizer", "autograd", "_api"}
_API = ("segment_sum", "segment_mean", "segment_min", "segment_max",
        "graph_send_recv", "graph_reindex", "graph_sample_neighbors",
        "graph_khop_sampler", "softmax_mask_fuse",
        "softmax_mask_fuse_upper_triangle", "identity_loss",
        "LookAhead", "ModelAverage")


def __getattr__(name):
    if name in _LAZY:
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    if name in _API:
        mod = importlib.import_module("._api", __name__)
        for n in _API:
            globals()[n] = getattr(mod, n)
        return globals()[name]
    raise AttributeError(
        f"module 'paddle_tpu_torch.incubate' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | _LAZY | set(_API))
