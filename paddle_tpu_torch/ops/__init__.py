"""The port's kernels and the plain PyTorch versions beside them.

Every kernel wrapper carries a ``launches`` integer that it increments
where it launches its kernel and nowhere else; ``KERNELS`` names them.
The two routes onto kernels of another row of the TPU table, the
head-batched flash route and the stock ``paged_attention``, count their
calls in ``calls`` (``ROUTES``).
"""
from __future__ import annotations

from typing import Dict

from ._decode import gqa_decode_attention
from .attention import flash_attention
from .decode_attention import decode_mha, decode_mha_ref
from .flash_attention_hb import flash_attention_bshd_hb, supports_hb
from .flash_attention_kernel import (flash_attention_bshd,
                                     flash_attention_bshd_ref,
                                     prefix_chunk_attention,
                                     prefix_chunk_attention_ref,
                                     flash_attention_bwd,
                                     flash_attention_bwd_dkv,
                                     flash_attention_bwd_dq,
                                     flash_attention_bwd_ref)
from .fused_kernels import (fused_layer_norm, fused_layer_norm_ref,
                            fused_rope, fused_rope_ref, rms_norm,
                            rms_norm_ref)
from .grad_add import (fused_linear_param_grad_add,
                       fused_linear_param_grad_add_ref)
from .grouped_matmul import grouped_matmul, grouped_matmul_ref
from .paged_attention import (paged_attention, paged_attention_ref,
                              paged_decode_mha, paged_decode_mha_ref)

__all__ = ["KERNELS", "ROUTES", "launch_counts", "reset_launch_counts",
           "route_calls", "flash_attention", "flash_attention_bshd",
           "flash_attention_bshd_ref", "prefix_chunk_attention",
           "prefix_chunk_attention_ref",
           "flash_attention_bwd",
           "flash_attention_bwd_ref", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv", "flash_attention_bshd_hb",
           "supports_hb", "fused_rope", "fused_rope_ref",
           "rms_norm", "rms_norm_ref", "paged_decode_mha",
           "paged_decode_mha_ref", "paged_attention", "paged_attention_ref",
           "decode_mha", "decode_mha_ref",
           "gqa_decode_attention", "fused_layer_norm",
           "fused_layer_norm_ref", "fused_linear_param_grad_add",
           "fused_linear_param_grad_add_ref", "grouped_matmul",
           "grouped_matmul_ref"]

KERNELS = {
    "rms_norm": rms_norm,
    "fused_rope": fused_rope,
    "flash_fwd": flash_attention_bshd,
    "flash_fwd_prefix": prefix_chunk_attention,
    "paged_decode": paged_decode_mha,
    "flash_bwd_dq": flash_attention_bwd_dq,
    "flash_bwd_dkv": flash_attention_bwd_dkv,
    "decode_mha": decode_mha,
    "fused_layer_norm": fused_layer_norm,
    "grad_add": fused_linear_param_grad_add,
    "grouped_matmul": grouped_matmul,
}
ROUTES = {
    "flash_hb": flash_attention_bshd_hb,
    "paged_attention": paged_attention,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def route_calls() -> Dict[str, int]:
    return {name: fn.calls for name, fn in ROUTES.items()}


def reset_launch_counts() -> None:
    """Set every kernel's launch count and every route's call count to 0."""
    for fn in KERNELS.values():
        fn.launches = 0
    for fn in ROUTES.values():
        fn.calls = 0
