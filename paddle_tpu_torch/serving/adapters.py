"""Multi-tenant LoRA: the adapter registry and its device bank (S-LoRA style).

Port of ``paddle_tpu/serving/adapters.py``. One engine serves many
fine-tunes: every resident adapter's low-rank factors are stacked into
fixed-shape device tensors per target projection, ``A: [L, K+1, r, d_in]``
and ``B: [L, K+1, d_out, r]`` (L model layers, K = ``capacity``, r the bank
rank), and every decode and prefill program gathers each slot's factors by
its adapter-index device vector (``models/llama.py::_lora_add``). Index 0
is the base model: its rows are zeros, so the gathered delta is exactly 0.0
and a base row stays bit for bit what a LoRA-free engine gives.

The bank is allocated ONCE, at construction, and written in place: a load
copies an adapter's rows into ``A[:, idx]`` / ``B[:, idx]`` and never
rebinds a tensor. The reference swaps in new arrays on every install and
hands them to jit as arguments; here the decode programs are captured CUDA
graphs that hold the bank's addresses, so a rebind after ``warmup()`` would
leave every graph reading freed or stale memory without an error. Loading
or unloading an adapter therefore captures nothing.

The registry is the host-side half: name -> bank index, per-index
reference counts (live slots decoding under the adapter), hot ``load`` /
``unload`` with UNLOAD DEFERRAL (an unload while a live slot references the
index marks it draining; the index frees, and may be recycled, when the
last reference goes), and a per-load GENERATION salt for the prefix cache
(chain hashes are salted with ``name@generation``, so KV cached under one
adapter, or under an earlier load of the same name, never serves another).

Thread model: every mutating call runs on the thread that drives the engine,
between decode segments (``Server.load_adapter`` / ``unload_adapter``
marshal into the inter-segment gap). ``stage``, the host half of a load,
reads no registry state and runs on any thread: ``Server.load_adapter``
stages on the caller's, so the gap only copies rows. Readers on other
threads (``/healthz`` through ``engine.load()``) take atomic snapshots only.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import monitor
from .. import tracing as trace
from ..device import resolve_device

__all__ = ["AdapterRegistry"]


class AdapterRegistry:
    """Registry and device bank for up to ``capacity`` resident LoRA
    adapters (bank index 0 is the base model, its rows pinned to zeros).

    ``shapes`` maps each target projection to its ``(d_in, d_out)`` (the
    model's ``lora_shapes`` gives it); ``num_layers`` is the depth of the
    per-layer factor stacks; ``dtype`` and ``device`` are the bank's (the
    engine passes its model's). ``rank`` is the BANK rank: an adapter of a
    smaller rank is zero-padded up to it (padded rows add exactly 0), a
    larger one is refused, since the bank's shapes are the captured
    programs' shapes."""

    def __init__(self, capacity: int, rank: int, targets, num_layers: int,
                 shapes: Dict[str, Tuple[int, int]], dtype,
                 engine_label: str, device=None):
        if not isinstance(capacity, int) or isinstance(capacity, bool) \
                or capacity < 1:
            raise ValueError(
                f"lora capacity must be an int >= 1, got {capacity!r}")
        if not isinstance(rank, int) or isinstance(rank, bool) \
                or rank < 1:
            raise ValueError(
                f"lora rank must be an int >= 1, got {rank!r}")
        targets = tuple(targets)
        if not targets:
            raise ValueError("lora needs at least one target projection")
        missing = [t for t in targets if t not in shapes]
        if missing:
            raise ValueError(
                f"model provides no lora shapes for target(s) {missing}")
        self.capacity = int(capacity)
        self.rank = int(rank)
        self.targets = targets
        self.num_layers = int(num_layers)
        self.shapes = {t: shapes[t] for t in targets}
        self.dtype = dtype
        self.device = resolve_device(device)
        self._engine = engine_label
        K, L = self.capacity, self.num_layers
        # allocated once and only ever written in place (see the module
        # docstring): a captured decode program holds these addresses
        self.bank = {
            t: (torch.zeros((L, K + 1, self.rank, d_in), dtype=dtype,
                            device=self.device),
                torch.zeros((L, K + 1, d_out, self.rank), dtype=dtype,
                            device=self.device))
            for t, (d_in, d_out) in self.shapes.items()}
        # guarded-by: the engine-driving thread (readers elsewhere take
        # atomic snapshots: __contains__, resident())
        self._names: Dict[str, int] = {}       # name -> bank index
        self._name_of: Dict[int, str] = {}     # index -> name
        self._salt: Dict[int, bytes] = {}      # index -> prefix salt
        self._refs: Dict[int, int] = {}        # index -> live slots
        self._draining: set = set()            # unloads deferred
        self._free: List[int] = list(range(1, K + 1))
        self._gen = 0                          # per-load generation

    # -- lifecycle (engine-driving thread, between segments) -----------------
    def load(self, name: str, params: Dict, alpha=None) -> int:
        """Install one adapter into a free bank index; returns the index.

        ``params`` maps target names (a subset of ``targets``) to ``(A, B)``
        factor pairs: ``A`` is ``[r_a, d_in]`` (shared by every layer) or
        ``[L, r_a, d_in]`` (per layer), ``B`` likewise ``[d_out, r_a]`` /
        ``[L, d_out, r_a]``, with ``r_a <= rank`` (zero-padded up). The
        scaling ``alpha / r_a`` (``alpha`` defaults to ``r_a``: scale 1.0)
        is folded into ``B`` here, so serving pays no extra multiply.
        Raises ValueError for an unknown or duplicate name, a full
        registry, or malformed factors; the bank is untouched on any
        failure. It is :meth:`stage` then :meth:`install`."""
        self._check_free(name)     # the reference's order: name, then factors
        return self.install(name, self.stage(name, params, alpha))

    def _check_free(self, name: str) -> None:
        if not isinstance(name, str) or not name or len(name) > 256:
            # the bound GenerationConfig.adapter enforces: a name loadable
            # here but unreachable by any request would hold an index
            raise ValueError(f"adapter name must be a non-empty str "
                             f"(<= 256 chars), got {name!r}")
        if name in self._names:
            state = ("still unloading (live requests reference it)"
                     if self._names[name] in self._draining
                     else "already loaded")
            raise ValueError(f"adapter {name!r} {state}; unload first")
        if not self._free:
            raise ValueError(
                f"adapter registry full ({self.capacity} resident); "
                f"unload one first")

    def stage(self, name: str, params: Dict, alpha=None) -> Dict:
        """The host half of :meth:`load`, which reads no registry state and
        so may run on any thread (``Server.load_adapter`` runs it on the
        caller's, so the scheduler's gap only copies rows): validate
        ``params``, zero-pad the rank, fold ``alpha / r_a`` into B and
        convert to the bank's dtype. Returns ``{target: (A, B)}`` host
        tensors ``[L, rank, d]``, pinned when the bank is on CUDA, for
        :meth:`install`; raises ValueError for malformed factors."""
        if not isinstance(params, dict) or not params:
            raise ValueError(
                "adapter params must be a non-empty dict "
                "{target: (A, B)}")
        unknown = sorted(set(params) - set(self.targets))
        if unknown:
            raise ValueError(
                f"adapter {name!r} targets {unknown} not in the "
                f"engine's lora_targets {self.targets}")
        # validate and normalize EVERYTHING before touching the bank: a
        # half-installed adapter must be impossible
        pin = self.device.type == "cuda"
        staged = {}
        for t, ab in params.items():
            a, b = (torch.from_numpy(x).to(self.dtype)
                    for x in self._stage_target(name, t, ab, alpha))
            staged[t] = (a.pin_memory(), b.pin_memory()) if pin else (a, b)
        return staged

    def install(self, name: str, staged: Dict) -> int:
        """The device half of :meth:`load`, on the engine-driving thread:
        take a free index and copy the rows :meth:`stage` returned into it
        in place; returns the index. Raises ValueError for a bad or duplicate
        name or a full registry, the bank untouched."""
        self._check_free(name)
        idx = self._free.pop(0)
        for t in self.targets:
            # a recycled index may hold an earlier adapter's rows for the
            # targets this one does not provide: they are zeroed, or the
            # new adapter would inherit stale deltas
            a, b = staged.get(t, (None, None))
            self._install(t, idx, a, b)
        self._gen += 1
        self._names[name] = idx
        self._name_of[idx] = name
        # generation-salted: a later reload of the same NAME gets a new
        # salt, so pages cached under the old weights never warm-hit
        self._salt[idx] = f"{name}@{self._gen}".encode()
        self._refs[idx] = 0
        if monitor.enabled():
            self._resident_gauge().labels(engine=self._engine).set(
                len(self._names))
        if trace.enabled():
            trace.event("lora.load", adapter=name, index=idx,
                        engine=self._engine)
        return idx

    def _install(self, t: str, idx: int, a, b) -> None:
        """Write bank row ``idx`` of target ``t`` IN PLACE: the staged
        factors (host ``[L, r, d]`` in the bank's dtype), or zeros when
        ``a`` is None. The program ``lora_install`` (one per target's bank
        shapes, owned by the engine) in the program ledger."""
        A, B = self.bank[t]
        monitor.monitored_eager(
            "lora_install", self._write_row, A, B, idx, a, b,
            owner=self._engine, signature=f"{self.dtype}",
            device=self.device, key=(tuple(A.shape), tuple(B.shape)))

    @staticmethod
    def _write_row(A, B, idx: int, a, b) -> None:
        with torch.no_grad():
            if a is None:
                A[:, idx].zero_()
                B[:, idx].zero_()
            else:
                A[:, idx].copy_(a)
                B[:, idx].copy_(b)

    def _stage_target(self, name: str, t: str, ab, alpha):
        """Validate one target's (A, B) pair and return the padded,
        scale-folded per-layer host arrays (fp32, contiguous)."""
        try:
            a_raw, b_raw = ab
        except Exception:
            raise ValueError(
                f"adapter {name!r} target {t!r} must be an (A, B) "
                f"pair, got {type(ab).__name__}")
        a = np.asarray(a_raw, np.float32)
        b = np.asarray(b_raw, np.float32)
        L = self.num_layers
        d_in, d_out = self.shapes[t]
        if a.ndim == 2:
            a = np.broadcast_to(a, (L,) + a.shape)
        if b.ndim == 2:
            b = np.broadcast_to(b, (L,) + b.shape)
        if a.ndim != 3 or a.shape[0] != L or a.shape[2] != d_in:
            raise ValueError(
                f"adapter {name!r} target {t!r}: A must be "
                f"[r, {d_in}] or [{L}, r, {d_in}], got "
                f"{tuple(np.asarray(a_raw).shape)}")
        r_a = a.shape[1]
        if r_a < 1 or r_a > self.rank:
            raise ValueError(
                f"adapter {name!r} target {t!r}: rank {r_a} exceeds "
                f"the bank rank {self.rank} (or is < 1)")
        if b.ndim != 3 or b.shape != (L, d_out, r_a):
            raise ValueError(
                f"adapter {name!r} target {t!r}: B must be "
                f"[{d_out}, {r_a}] or [{L}, {d_out}, {r_a}] to match "
                f"A's rank, got {tuple(np.asarray(b_raw).shape)}")
        scale = 1.0 if alpha is None else float(alpha) / r_a
        b = b * scale
        if r_a < self.rank:
            # zero-padded rank rows add exactly 0 to the delta
            a = np.concatenate(
                [a, np.zeros((L, self.rank - r_a, d_in), np.float32)],
                axis=1)
            b = np.concatenate(
                [b, np.zeros((L, d_out, self.rank - r_a), np.float32)],
                axis=2)
        # copies: a broadcast view is read-only and shares its rows
        return np.array(a, np.float32), np.array(b, np.float32)

    def unload(self, name: str) -> bool:
        """Unload an adapter. Returns True when its index freed NOW; False
        when live slots still reference it: the unload DEFERS (the name
        leaves the registry at once, so new requests naming it are refused)
        and the index frees when the last live reference goes. A live slot
        is never corrupted: the rows stay until a later load recycles the
        index."""
        idx = self._names.get(name)
        if idx is None:
            raise ValueError(f"adapter {name!r} is not loaded")
        del self._names[name]
        if monitor.enabled():
            self._resident_gauge().labels(engine=self._engine).set(
                len(self._names))
        if self._refs.get(idx, 0) > 0:
            self._draining.add(idx)
            if trace.enabled():
                trace.event("lora.unload", adapter=name, index=idx,
                            deferred=True, refs=self._refs[idx],
                            engine=self._engine)
            return False
        self._free_index(idx)
        if trace.enabled():
            trace.event("lora.unload", adapter=name, index=idx,
                        deferred=False, engine=self._engine)
        return True

    def _free_index(self, idx: int) -> None:
        self._name_of.pop(idx, None)
        self._salt.pop(idx, None)
        self._refs.pop(idx, None)
        self._draining.discard(idx)
        self._free.append(idx)
        self._free.sort()

    # -- per-request references (admission / retirement) ---------------------
    def acquire(self, name: str) -> int:
        """Resolve ``name`` to its bank index and take one live reference
        (one admitted request). Raises ValueError for an unknown name or
        one mid-unload: a REQUEST-scoped verdict (the admission fails that
        request; the engine is untouched)."""
        idx = self._names.get(name)
        if idx is None:
            raise ValueError(
                f"unknown adapter {name!r} (resident: "
                f"{sorted(self._names) or 'none'})")
        self._refs[idx] = self._refs.get(idx, 0) + 1
        if monitor.enabled():
            self._requests_counter().labels(
                engine=self._engine, adapter=name).inc()
        return idx

    def release(self, idx: int) -> None:
        """Drop one live reference (the request retired, was cancelled or
        preempted); the last one completes a deferred unload."""
        if idx == 0 or idx not in self._refs:
            return
        self._refs[idx] -= 1
        if self._refs[idx] <= 0 and idx in self._draining:
            name = self._name_of.get(idx)
            self._free_index(idx)
            if trace.enabled():
                trace.event("lora.unload", adapter=name, index=idx,
                            deferred=False, engine=self._engine)

    def release_all(self) -> None:
        """Drop EVERY live reference (the engine's ``reset_state``: every
        slot was just forgotten). Deferred unloads complete; the bank and
        the name map stay: adapters are weights, and a supervised restart
        must not lose them."""
        for idx in list(self._refs):
            self._refs[idx] = 0
            if idx in self._draining:
                self._free_index(idx)

    # -- lookups (atomic reads; safe from other threads) ---------------------
    def __contains__(self, name) -> bool:
        return name in self._names

    def salt(self, idx: int) -> bytes:
        """Prefix-cache chain salt of bank index ``idx`` (b"" for the base
        model: base hashes keep their values, so a LoRA engine's base
        traffic still warm-hits KV cached before any adapter existed)."""
        return self._salt.get(idx, b"")

    def resident(self) -> dict:
        """Host-side snapshot for ``engine.load()`` and ``/healthz``:
        ``{"capacity", "resident", "free", "adapters": [names],
        "draining": [names]}``. Read from other threads, so every
        container is copied atomically (``list()`` / ``dict()`` / ``tuple()``
        of the live one) before it is walked."""
        names = list(self._names)
        name_of = dict(self._name_of)
        return {
            "capacity": self.capacity,
            "resident": len(names),
            "free": len(self._free),
            "adapters": sorted(names),
            "draining": sorted(name_of[i] for i in tuple(self._draining)
                               if i in name_of),
        }

    # -- warmup / monitor ----------------------------------------------------
    def warmup(self) -> None:
        """The row install's first use for every target (a value-neutral
        zero write into base row 0), so the first hot ``load`` in a serving
        gap pays no first-use cost."""
        for t in self.targets:
            self._install(t, 0, None, None)

    @staticmethod
    def _requests_counter():
        return monitor.counter(
            "paddle_tpu_lora_requests_total",
            "requests admitted per engine and adapter (adapter = the "
            "fine-tune the request decoded under)",
            ("engine", "adapter"))

    @staticmethod
    def _resident_gauge():
        return monitor.gauge(
            "paddle_tpu_lora_adapters_resident",
            "LoRA adapters currently resident in the engine's device "
            "bank", ("engine",))

    def close(self) -> None:
        """Retire this registry's monitor series (idempotent; by engine
        label, since the adapter label is open-ended)."""
        for name in ("paddle_tpu_lora_requests_total",
                     "paddle_tpu_lora_adapters_resident"):
            try:
                monitor.remove_series(name, engine=self._engine)
            except Exception:
                pass

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
