"""Shared model helpers (port of ``paddle_tpu/models/_utils.py``)."""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from ..core import place
from ..core.dtype import get_default_dtype, set_default_dtype
from ..core.place import resolve_device, set_device
from ..framework.amp_state import cast_inputs
from ..nn.layer.norm import LayerNorm

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


@contextlib.contextmanager
def building_on(device, dtype):
    """Build a model's layers on ``device`` in ``dtype``: a ``Layer``
    creates its parameters on the current place in the default dtype, so
    both are set for the construction and restored after it (the
    reference sets the default dtype around its constructors the same
    way). Yields the resolved device."""
    dev = resolve_device(device)
    prev_place, prev_dtype = place._current[0], get_default_dtype()
    set_device(dev)
    set_default_dtype(dtype)
    try:
        yield dev
    finally:
        place._current[0] = prev_place
        set_default_dtype(prev_dtype)


def here() -> dict:
    """The place and dtype a plain ``torch.nn.Module`` layer is built in
    (the tensor-parallel layers take them as keywords): the current ones,
    as a ``Layer`` takes them."""
    return dict(device=resolve_device(), dtype=get_default_dtype())


def seeded(generator: Optional[torch.Generator],
           device: torch.device) -> torch.Generator:
    """``generator``, or a generator on ``device`` seeded with 0."""
    return (generator if generator is not None
            else torch.Generator(device=device).manual_seed(0))


@torch.no_grad()
def init_normal(model: torch.nn.Module, generator: torch.Generator,
                std: float = 0.02) -> None:
    """Weights normal(0, std) from ``generator``, biases 0, LayerNorm
    scales 1."""
    norms = {id(m.weight) for m in model.modules()
             if isinstance(m, LayerNorm)}
    for name, p in model.named_parameters():
        if id(p) in norms:
            p.fill_(1.0)
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.normal_(0.0, std, generator=generator)
