"""``paddle.vision`` (port of ``paddle_tpu/vision/``): ``models`` (the
ResNet, classic and classic2 families), ``ops`` (the detection operators),
``transforms``, ``datasets`` and the image backend (``get_image_backend``,
``set_image_backend``, ``image_load``)."""
from . import datasets, models, ops, transforms
from .image import get_image_backend, image_load, set_image_backend

__all__ = ["datasets", "models", "transforms", "ops",
           "get_image_backend", "set_image_backend", "image_load"]
