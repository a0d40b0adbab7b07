"""``paddle.vision`` (port of ``paddle_tpu/vision/``): ``models``, the
ResNet and classic families. ``vision.ops`` (detection ops),
``transforms``, ``datasets``, ``image`` (``get_image_backend``,
``set_image_backend``, ``image_load``) and ``classic2.py``'s models are not
ported yet (ROADMAP A14d)."""
from . import models

__all__ = ["models"]
