from .functional import (AdamWState, adamw_init, adamw_update,
                         clip_by_global_norm, sgd_update)

__all__ = ["AdamWState", "adamw_init", "adamw_update", "sgd_update",
           "clip_by_global_norm"]
