"""Gate base class (port of ``.../moe/gate/base_gate.py``).

A gate maps tokens ``[T, d]`` to ``(weights, expert ids)``, each
``[T, k]``, and may stash an auxiliary load-balancing loss with
:meth:`set_loss`, which the model collects with :meth:`get_loss`. The
random gates draw their uniforms through :meth:`_uniform`, from the port's
generator (``core.random.default_generator``), so ``paddle.seed`` repeats
them; the streams are torch's, not the reference's.
"""
from __future__ import annotations

import torch

from ......core.random import default_generator
from ......nn.layer.layers import Layer

__all__ = ["BaseGate", "one_hot"]


def one_hot(idx: torch.Tensor, n: int,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.nn.one_hot``: ``[..., n]`` with a 1 at each index and an
    all-zero row for an index outside [0, n) (a dropped choice's -1);
    no host sync, unlike ``torch.nn.functional.one_hot``'s range check."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


class BaseGate(Layer):
    def __init__(self, num_expert: int, world_size: int):
        super().__init__()
        self.world_size = max(int(world_size), 1)
        self.num_expert = int(num_expert)
        self.tot_expert = self.world_size * self.num_expert
        self.loss = None

    def forward(self, x):
        raise NotImplementedError("Base gate cannot be called")

    def set_loss(self, loss):
        self.loss = loss

    def get_loss(self, clear=True):
        loss = self.loss
        if clear:
            self.loss = None
        return loss

    def _uniform(self, shape, like: torch.Tensor, low: float = 0.0,
                 high: float = 1.0) -> torch.Tensor:
        """fp32 uniforms in [low, high) of ``shape`` on ``like``'s
        device."""
        u = torch.rand(shape, generator=default_generator.generator(
            like.device), device=like.device)
        return low + (high - low) * u
