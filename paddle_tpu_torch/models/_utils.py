"""Shared model helpers (port of ``paddle_tpu/models/_utils.py``)."""
from __future__ import annotations

import torch

from ..framework.amp_state import cast_inputs

IGNORE_INDEX = -100


def masked_lm_loss(loss: torch.Tensor, labels: torch.Tensor,
                   ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    """Mean of per-token losses over NON-ignored positions only (ignored
    positions contribute 0 to the sum; dividing by the total count would
    scale the loss with the pad fraction). Black under AMP (fp32), as
    the reference's ``lm_loss_mean``."""
    (loss,) = cast_inputs("lm_loss_mean", loss)
    n = (labels != ignore_index).sum().clamp_min(1)
    return loss.sum() / n.to(loss.dtype)
