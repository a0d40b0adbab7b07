"""``paddle.nn.functional``: activations, common functions, norms,
attention, the extension functions, the losses, the convolutions, pooling
and the sequence losses (ports of ``paddle_tpu/nn/functional/``)."""
from . import loss
from .activation import *  # noqa: F401,F403
from .activation import __all__ as _activation_all
from .common import *  # noqa: F401,F403
from .common import __all__ as _common_all
from .conv import *  # noqa: F401,F403
from .conv import __all__ as _conv_all
from .extension import *  # noqa: F401,F403
from .extension import __all__ as _extension_all
from .flash_attention import *  # noqa: F401,F403
from .flash_attention import __all__ as _attention_all
from .loss import *  # noqa: F401,F403
from .loss import __all__ as _loss_all
from .norm import *  # noqa: F401,F403
from .norm import __all__ as _norm_all
from .pooling import *  # noqa: F401,F403
from .pooling import __all__ as _pooling_all
from .sequence_loss import *  # noqa: F401,F403
from .sequence_loss import __all__ as _sequence_loss_all

__all__ = (["loss"] + _activation_all + _common_all + _norm_all + _loss_all
           + _extension_all + _attention_all + _conv_all + _pooling_all
           + _sequence_loss_all)
