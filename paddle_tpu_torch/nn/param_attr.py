"""``ParamAttr``, a parameter's configuration (port of
``paddle_tpu/nn/param_attr.py``): the name, initializer, learning-rate
multiplier, regularizer and trainable flag that ``Layer.create_parameter``
reads."""
from __future__ import annotations

from typing import Optional

__all__ = ["ParamAttr"]


class ParamAttr:
    def __init__(self, name: Optional[str] = None, initializer=None,
                 learning_rate: float = 1.0, regularizer=None,
                 trainable: bool = True, do_model_average: bool = True,
                 need_clip: bool = True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """None, False, a name, an initializer or a ``ParamAttr`` as a
        ``ParamAttr``; ``False`` (no parameter) as None."""
        if attr is None:
            return ParamAttr()
        if attr is False:
            return None
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        return ParamAttr(initializer=attr)
