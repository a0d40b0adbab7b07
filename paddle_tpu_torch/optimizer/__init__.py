"""``paddle.optimizer`` (port of ``paddle_tpu/optimizer/__init__.py``): the
eager optimizers, the ``lr`` schedulers and the regularizers, beside the
functional AdamW of ``build_train_step`` (``optimizer.functional``)."""
from . import lr
from .functional import (AdamWState, adamw_init, adamw_update,
                         clip_by_global_norm, sgd_update)
from .optimizer import (LBFGS, SGD, Adadelta, Adagrad, Adam, Adamax, AdamW,
                        L1Decay, L2Decay, Lamb, Momentum, Optimizer, RMSProp)

__all__ = ["AdamWState", "adamw_init", "adamw_update", "sgd_update",
           "clip_by_global_norm", "lr", "Optimizer", "SGD", "Momentum",
           "Adagrad", "Adadelta", "RMSProp", "Adam", "AdamW", "Adamax",
           "Lamb", "LBFGS", "L1Decay", "L2Decay"]
