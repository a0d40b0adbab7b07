"""``paddle.nn``'s layers (ports of ``paddle_tpu/nn/layer/``). The
convolution, pooling, recurrent and transformer layers are not ported yet
(ROADMAP A14b)."""
from . import activation, common, container, loss, norm
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .container import *  # noqa: F401,F403
from .layers import Layer
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403

__all__ = (["Layer", "loss"] + activation.__all__ + common.__all__
           + container.__all__ + loss.__all__ + norm.__all__)
