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

A compiled program (``jit.to_static``) cannot draw from a
``torch.Generator`` without breaking its graph. So ``to_static`` draws one
seed a call from :data:`default_generator` on the host and hands it to the
program as a tensor (:func:`push_trace_seed`), as the reference draws one
key a call and passes it into its ``jax.jit`` (``trace_key_scope``); the
program's draws (:func:`uniform`) are then a counter hash of (that seed,
the draw's place in the program, the element's index). They repeat under
``seed(s)``, are fresh on every call and have the plain draw's
distribution, but not its numbers.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List

import torch

# the reference's names; the compiled programs' seed helpers below are the
# port's own and stay out of the surface
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


def uniform(shape, device) -> torch.Tensor:
    """fp32 uniforms in [0, 1) of ``shape`` on ``device``: from
    :data:`default_generator`, or while compiling from the program's seed
    (:func:`traced_uniform`)."""
    if torch.compiler.is_compiling():
        return traced_uniform(shape, device)
    return torch.rand(shape, generator=default_generator.generator(device),
                      device=device)


def draw_seed() -> int:
    """One seed in [0, 2^31 - 1) from :data:`default_generator`'s CPU
    stream (the seed a ``to_static`` call hands its program)."""
    return int(torch.randint(0, 2 ** 31 - 1, (1,),
                             generator=default_generator.generator("cpu"))
               .item())


# the programs being run or traced: [seed tensor, draws made so far]
_trace_seeds: List[list] = []
_M32 = 0xFFFFFFFF


def push_trace_seed(seed: torch.Tensor) -> None:
    """Start a compiled program's draws from ``seed`` (a 0-d int64
    tensor, one a call)."""
    _trace_seeds.append([seed, 0])


def pop_trace_seed() -> None:
    _trace_seeds.pop()


def _mix(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64 tensors holding uint32 values
    (a product's low 32 bits survive int64 wrap-around): the flash
    kernels' dropout hash (``ops/flash_attention_kernel.py``) and the
    compiled programs' draws."""
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _M32
    return x ^ (x >> 16)


def traced_uniform(shape, device) -> torch.Tensor:
    """fp32 uniforms in [0, 1) of ``shape``, 24 bits each, from the seed of
    the program being traced: a hash of (seed, this draw's place among the
    program's draws, the element's index). Raises outside ``to_static``,
    where no seed was handed in."""
    if not _trace_seeds:
        raise RuntimeError(
            "a random draw while compiling needs the seed that "
            "paddle_tpu_torch.jit.to_static hands its program; compile "
            "through jit.to_static, or draw outside the compiled region")
    slot = _trace_seeds[-1]
    site = slot[1]
    slot[1] = site + 1
    n = math.prod(shape)
    seed = slot[0].to(device=device, dtype=torch.int64) & _M32
    s0 = _mix(seed ^ ((site * 0x9E3779B9) & _M32))
    idx = torch.arange(n, device=device, dtype=torch.int64)
    bits = _mix((_mix(s0 ^ (idx & _M32)) + (idx >> 32)) & _M32)
    u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return u.reshape(shape)
