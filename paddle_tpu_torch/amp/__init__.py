"""``paddle.amp`` (port of ``paddle_tpu/amp/__init__.py``): ``auto_cast``
with the reference's op lists and O1/O2 levels, ``decorate``,
``GradScaler`` and the numerical ``debugging`` tools. bf16 is the default
AMP dtype; fp16 with the dynamic ``GradScaler`` is the path for scaled
training."""
from . import debugging
from .amp_lists import BLACK_LIST, WHITE_LIST, black_list, white_list
from .auto_cast import amp_decorate, amp_guard, auto_cast, decorate
from .grad_scaler import AmpScaler, GradScaler, OptimizerState

__all__ = ["auto_cast", "decorate", "GradScaler", "AmpScaler", "amp_guard",
           "amp_decorate", "debugging", "white_list", "black_list",
           "is_float16_supported", "is_bfloat16_supported"]


def is_float16_supported(device=None) -> bool:
    return True


def is_bfloat16_supported(device=None) -> bool:
    return True
