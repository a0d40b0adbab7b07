"""The generator the tensor surface's random ops draw from.

Port of ``paddle_tpu/core/random.py``. The reference folds a counter into a
JAX PRNG key; here :class:`Generator` holds explicit ``torch.Generator``
objects, one for the CPU and one per CUDA device, each made at its first
use and seeded with the generator's seed. Every random op of the surface
draws from :data:`default_generator` and from nothing else, and
:func:`seed` seeds it alone: torch's global generators, which the engines'
per-request sampling streams do not read either, never move.

The streams are torch's (Philox on CUDA, Mersenne Twister on the CPU), not
JAX's threefry: a seed gives repeatable draws port against port, and the
same distributions as the reference, not its numbers.
"""
from __future__ import annotations

import threading
from typing import Dict

import torch

__all__ = ["Generator", "default_generator", "seed", "get_rng_state",
           "set_rng_state"]


class Generator:
    def __init__(self, seed_: int = 0):
        self._seed = int(seed_)
        self._gens: Dict[torch.device, torch.Generator] = {}
        self._lock = threading.Lock()

    def manual_seed(self, seed_: int) -> "Generator":
        with self._lock:
            self._seed = int(seed_)
            for g in self._gens.values():
                g.manual_seed(self._seed)
        return self

    def initial_seed(self) -> int:
        return self._seed

    def generator(self, device) -> torch.Generator:
        """The ``torch.Generator`` for ``device``, made and seeded at its
        first use."""
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        with self._lock:
            g = self._gens.get(dev)
            if g is None:
                g = torch.Generator(device=dev).manual_seed(self._seed)
                self._gens[dev] = g
            return g

    def get_state(self):
        """The seed and every device generator's state."""
        with self._lock:
            return {"seed": self._seed,
                    "states": {str(d): g.get_state()
                               for d, g in self._gens.items()}}

    def set_state(self, state) -> None:
        with self._lock:
            self._seed = int(state["seed"])
            self._gens.clear()
        for dev, st in state["states"].items():
            self.generator(dev).set_state(st)


default_generator = Generator(0)


def seed(s: int) -> Generator:
    """paddle.seed parity: seed :data:`default_generator` (every device's
    generator) with ``s``."""
    return default_generator.manual_seed(s)


def get_rng_state():
    return [default_generator.get_state()]


def set_rng_state(state) -> None:
    default_generator.set_state(state[0])
