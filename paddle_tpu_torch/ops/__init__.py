"""The port's kernels and the plain PyTorch versions beside them.

Every kernel wrapper carries a ``launches`` integer that it increments
where it launches its kernel and nowhere else; ``KERNELS`` names them.
"""
from __future__ import annotations

from typing import Dict

from ._decode import gqa_decode_attention
from .attention import flash_attention
from .decode_attention import decode_mha, decode_mha_ref
from .flash_attention_kernel import (flash_attention_bshd,
                                     flash_attention_bshd_ref,
                                     flash_attention_bwd,
                                     flash_attention_bwd_dkv,
                                     flash_attention_bwd_dq,
                                     flash_attention_bwd_ref)
from .fused_kernels import (fused_layer_norm, fused_layer_norm_ref,
                            fused_rope, fused_rope_ref, rms_norm,
                            rms_norm_ref)
from .paged_attention import paged_decode_mha, paged_decode_mha_ref

__all__ = ["KERNELS", "launch_counts", "reset_launch_counts",
           "flash_attention", "flash_attention_bshd",
           "flash_attention_bshd_ref", "flash_attention_bwd",
           "flash_attention_bwd_ref", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv", "fused_rope", "fused_rope_ref",
           "rms_norm", "rms_norm_ref", "paged_decode_mha",
           "paged_decode_mha_ref", "decode_mha", "decode_mha_ref",
           "gqa_decode_attention", "fused_layer_norm",
           "fused_layer_norm_ref"]

KERNELS = {
    "rms_norm": rms_norm,
    "fused_rope": fused_rope,
    "flash_fwd": flash_attention_bshd,
    "paged_decode": paged_decode_mha,
    "flash_bwd_dq": flash_attention_bwd_dq,
    "flash_bwd_dkv": flash_attention_bwd_dkv,
    "decode_mha": decode_mha,
    "fused_layer_norm": fused_layer_norm,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
