"""Deterministic fault injection at the serving-path seams.

Port of ``paddle_tpu/testing/faults.py``. The fault-isolated serving
layer (per-request containment, supervised engine recovery, the stall
watchdog: ``paddle_tpu_torch.serving``) is only
trustworthy if its failure paths are exercised deterministically; this
module is the harness that does it. A :class:`FaultPlan` is a schedule
of site-named injections (raise / hang / fail-on-nth-call, plus a
seeded probabilistic mode for chaos soaks), and :class:`FaultyEngine`
is a transparent proxy over a generation engine that consults the plan
at each seam before delegating.

Sites (the seams a serving scheduler drives):

- ``"admit"``   — ``add_request`` / ``begin_admit`` (the admission call
  seam: the fault fires BEFORE the engine claims any capacity);
- ``"prefill"`` — the engine's internal prefill dispatch
  (``_run_prefill``), i.e. INSIDE ``add_request`` after the slot (and,
  paged, the page reservation) was claimed — exercises the admission
  abort guards, not just the call seam;
- ``"chunk"``   — ``admit_chunk`` (one chunk of a chunked admission);
- ``"decode"``  — ``decode_segment`` (the batch-wide seam: an injected
  :class:`~paddle_tpu_torch.inference.generation.EngineFault` here drives the
  supervised-recovery path, a hang drives the stall watchdog);
- ``"collect"`` — ``collect_finished``;
- ``"preempt"`` — ``preempt_request`` (the paged engine's
  memory-pressure victim reclaim): an injected fault here fails the
  scheduler's pressure-relief loop mid-preemption, the window where a
  victim's handle is between the engine and the replay list.

Determinism: every seam call increments a per-site counter under a
lock, and rules fire on exact 1-based call indices (``nth``/``times``),
so a single-threaded scheduler drives a bit-identical fault schedule
run over run. The probabilistic mode (:meth:`FaultPlan.random_raises`)
draws from a seeded ``random.Random`` per rule — deterministic given
the seed and the call sequence.

Usage::

    from paddle_tpu_torch.testing.faults import FaultPlan, FaultyEngine
    from paddle_tpu_torch.inference.generation import EngineFault

    plan = FaultPlan()
    plan.raise_at("prefill", nth=2)                  # request-scoped
    plan.raise_at("decode", nth=3,
                  exc=EngineFault("injected"))       # engine-scoped
    plan.hang_at("decode", nth=5, seconds=2.0)       # stall watchdog
    eng = FaultyEngine(inner_engine, plan)
    srv = Server(eng, ...)
    ...
    assert plan.injected == [("prefill", 2, "raise"), ...]
"""
from __future__ import annotations

import random
import threading
from typing import List, Optional, Sequence

from .. import tracing as trace

__all__ = ["SITES", "NET_SITES", "FaultPlan", "NetworkFaultPlan",
           "FaultyEngine", "InjectedFault"]

SITES = ("admit", "prefill", "chunk", "decode", "collect", "preempt")

# network seams (cross-process serving, paddle_tpu_torch.serving.remote):
# a SEPARATE namespace from the engine SITES — a RemoteReplica's
# failure modes are the wire's (delay / drop / mid-stream half-close),
# not the engine's, and the two plans never share counters
NET_SITES = ("generate", "kv_import")


class InjectedFault(RuntimeError):
    """Default exception an injection raises. Deliberately NOT a
    :class:`RequestFault`/:class:`EngineFault` subclass: it takes the
    site-default classification, like any unrecognized error — pass
    ``exc=EngineFault(...)`` to force the engine-scoped path."""


class _Rule:
    __slots__ = ("site", "first", "times", "action", "exc", "seconds",
                 "rate", "rng", "fired", "after", "mode")

    def __init__(self, site: str, first: int, times: int, action: str,
                 exc=None, seconds: float = 0.0,
                 rate: Optional[float] = None, seed: int = 0,
                 after: int = 0, mode: Optional[str] = None,
                 valid_sites: Sequence[str] = SITES):
        if site not in valid_sites:
            raise ValueError(
                f"unknown site {site!r}; one of {tuple(valid_sites)}")
        if first < 1 or times < 1:
            raise ValueError("nth and times must be >= 1")
        self.site = site
        self.first = first        # 1-based call index the rule arms at
        self.times = times        # injections before the rule retires
        self.action = action      # "raise" | "hang"
        self.exc = exc            # instance, class, or None (default)
        self.seconds = seconds
        self.rate = rate          # probabilistic (chaos-soak) rule
        self.rng = random.Random(seed) if rate is not None else None
        self.fired = 0
        self.after = after        # half_close/corrupt: lines to relay
        self.mode = mode          # corrupt: "flip" | "truncate"


class FaultPlan:
    """A deterministic schedule of injections, shared by every seam of
    one (or several) :class:`FaultyEngine`.

    - :meth:`raise_at` — raise at the ``nth`` call to a site (and the
      ``times - 1`` calls after it);
    - :meth:`hang_at` — block the calling (scheduler) thread for
      ``seconds`` — bounded, and releasable early via
      :meth:`release_hangs`, so a chaos test can never wedge the suite;
    - :meth:`random_raises` — seeded per-call coin flip, the chaos-soak
      mode (the reference's ``tools/serve_bench.py --fault-rate``);
    - ``plan.injected`` — the ``(site, call_index, action)`` log, for
      assertions and BENCH records;
    - ``plan.calls`` — per-site call counters (how often each seam ran).
    """

    VALID_SITES: Sequence[str] = SITES

    def __init__(self):
        self._lock = threading.Lock()
        self._rules: List[_Rule] = []
        self.calls = {s: 0 for s in self.VALID_SITES}
        self.injected: List[tuple] = []
        self._release = threading.Event()

    # -- schedule construction (chainable) -----------------------------------
    def raise_at(self, site: str, nth: int = 1, exc=None,
                 times: int = 1) -> "FaultPlan":
        """Raise ``exc`` (default :class:`InjectedFault`) at calls
        ``nth .. nth+times-1`` to ``site``."""
        with self._lock:
            self._rules.append(_Rule(site, nth, times, "raise", exc,
                                     valid_sites=self.VALID_SITES))
        return self

    def hang_at(self, site: str, nth: int = 1, seconds: float = 1.0,
                times: int = 1) -> "FaultPlan":
        """Block for ``seconds`` at calls ``nth .. nth+times-1`` to
        ``site`` (then delegate normally — a hang is a stall, not a
        failure). :meth:`release_hangs` ends every hang early."""
        with self._lock:
            self._rules.append(
                _Rule(site, nth, times, "hang", seconds=seconds,
                      valid_sites=self.VALID_SITES))
        return self

    def random_raises(self, sites: Sequence[str], rate: float,
                      seed: int = 0, exc=None) -> "FaultPlan":
        """Chaos-soak mode: at every call to each of ``sites``, raise
        with probability ``rate`` (seeded — deterministic given the
        call sequence)."""
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {rate}")
        with self._lock:
            for i, site in enumerate(sites):
                self._rules.append(
                    _Rule(site, 1, 2 ** 31, "raise", exc,
                          rate=rate, seed=seed + i,
                          valid_sites=self.VALID_SITES))
        return self

    def kill(self, site: str = "decode", nth: int = 1, exc=None,
             action: str = "raise",
             seconds: float = 3600.0) -> "FaultPlan":
        """REPLICA-KILL seam: from call ``nth`` (1-based; relative to
        calls already made, so a mid-run ``plan.kill()`` fires on the
        very next seam call) the replica is DEAD — every subsequent
        call to ``site`` raises a fresh
        :class:`~paddle_tpu_torch.inference.generation.EngineFault` (default
        ``exc``; pass a class/factory to change it). Behind a
        ``Server(max_restarts=0)`` the first fault kills the replica's
        scheduler; with restarts left, every recovery re-faults until
        the budget exhausts — either way the replica ends ``failed``,
        which is what a router's supervision and failover must absorb.
        ``action="hang"`` is the WEDGED variant (each call blocks
        ``seconds``, releasable via :meth:`release_hangs`) — drives
        the watchdog-degraded path a router abandons without the
        replica ever announcing failure.

        Callable mid-run from any thread: the rule lands under the plan
        lock like any other."""
        if action not in ("raise", "hang"):
            raise ValueError(
                f"action must be 'raise' or 'hang', got {action!r}")
        if exc is None and action == "raise":
            from ..inference.generation import EngineFault
            exc = (lambda: EngineFault(
                f"replica killed (injected @ {site})"))
        with self._lock:
            # arm relative to the CURRENT call count: "kill now" means
            # the next call, not the nth since the dawn of the plan
            first = self.calls.get(site, 0) + nth
            self._rules.append(
                _Rule(site, first, 2 ** 31, action, exc,
                      seconds=seconds, valid_sites=self.VALID_SITES))
        return self

    def release_hangs(self) -> None:
        """End every in-flight (and future) hang immediately."""
        self._release.set()

    # -- the seam hook -------------------------------------------------------
    def _consume(self, site: str):
        """Count a call to ``site`` and consume the first matching
        un-retired rule: bump ``calls``, log to ``injected``, trace.
        Returns ``(action, exc, seconds, after, mode, n)`` or
        ``None``."""
        with self._lock:
            self.calls[site] = self.calls.get(site, 0) + 1
            n = self.calls[site]
            rule = None
            for r in self._rules:
                if r.site != site or r.fired >= r.times:
                    continue
                if r.rate is not None:
                    if r.rng.random() < r.rate:
                        rule = r
                        break
                elif n >= r.first:
                    rule = r
                    break
            if rule is None:
                return None
            rule.fired += 1
            self.injected.append((site, n, rule.action))
            hit = (rule.action, rule.exc, rule.seconds, rule.after,
                   rule.mode, n)
        if trace.enabled():
            # injections are part of the story a flight dump tells: a
            # chaos postmortem must distinguish injected faults from
            # organic ones
            trace.event("fault.injected", site=site, call=n,
                        action=hit[0])
        return hit

    def fire(self, site: str) -> None:
        """Called by :class:`FaultyEngine` before delegating a seam
        call: count the call, and perform the first matching un-retired
        rule's action (raise / hang)."""
        hit = self._consume(site)
        if hit is None:
            return
        action, exc, seconds, _after, _mode, n = hit
        if action == "hang":
            # outside the lock: a hung scheduler must not also wedge
            # every other seam's bookkeeping
            self._release.wait(seconds)
            return
        if exc is None:
            raise InjectedFault(f"injected fault @ {site} (call {n})")
        if isinstance(exc, BaseException):
            # an INSTANCE is re-raised as-is — fine for single-shot
            # deterministic rules; repeating rules (times>1, random)
            # should pass a class or zero-arg factory so every
            # injection gets a fresh instance (re-raising one object
            # chains tracebacks onto it forever)
            raise exc
        raise exc()   # class or zero-arg factory


class NetworkFaultPlan(FaultPlan):
    """Deterministic injections at the WIRE seams of a
    :class:`~paddle_tpu_torch.serving.remote.RemoteReplica` — the failure
    modes a cross-process fleet must absorb are the network's, not the
    engine's, so they get their own site namespace (:data:`NET_SITES`)
    and their own plan (never share counters with an engine-side
    :class:`FaultPlan`).

    Sites:

    - ``"generate"``  — one ``POST /generate`` submission (counted at
      the client, before the request hits the wire);
    - ``"kv_import"`` — one ``POST /kv/import`` KV-page shipment (the
      disaggregated prefill→decode handoff).

    Actions, same nth/times discipline as the base plan:

    - :meth:`delay_at` — bounded stall before the call proceeds
      (releasable early via :meth:`release_hangs`, like a hang);
    - :meth:`drop_at` — the connection never happens: raises
      ``ConnectionResetError`` (or ``exc``) at the seam, which the
      client surfaces exactly like a refused/reset socket;
    - :meth:`half_close_at` — the INSIDIOUS one: the request goes
      through, the server streams, and the client-side reader kills
      the socket after relaying ``after`` stream lines — a mid-stream
      half-close the router's failover replay must absorb without the
      handle ever seeing a gap;
    - :meth:`corrupt_at` — the payload arrives, but WRONG: a
      deterministic byte-flip (well-framed, bit-rotted — only a
      checksum can tell) or truncation of the KV ship / token stream.
      The injection the integrity-checked wire is tested against.

    The seam hook is :meth:`fire`, which unlike the base plan RETURNS
    the half-close/corrupt spec (``{"action": "half_close", "after":
    n}`` / ``{"action": "corrupt", "mode": m, "after": n}``) instead
    of raising — the mangling happens later, inside the reader thread
    or the payload path, not at the call site. ``delay`` blocks then
    returns ``None``; ``drop`` raises. Inherited :meth:`raise_at` /
    :meth:`hang_at` also work against :data:`NET_SITES` (validation is
    class-driven)."""

    VALID_SITES = NET_SITES

    # -- schedule construction (chainable) -----------------------------------
    def delay_at(self, site: str, nth: int = 1, seconds: float = 0.05,
                 times: int = 1) -> "NetworkFaultPlan":
        """Bounded network delay: block ``seconds`` at calls
        ``nth .. nth+times-1`` to ``site``, then proceed normally.
        :meth:`release_hangs` ends every delay early."""
        with self._lock:
            self._rules.append(
                _Rule(site, nth, times, "delay", seconds=seconds,
                      valid_sites=self.VALID_SITES))
        return self

    def drop_at(self, site: str, nth: int = 1, exc=None,
                times: int = 1) -> "NetworkFaultPlan":
        """Drop the connection at calls ``nth .. nth+times-1``:
        raises ``ConnectionResetError`` (or ``exc``) at the seam."""
        with self._lock:
            self._rules.append(
                _Rule(site, nth, times, "drop", exc,
                      valid_sites=self.VALID_SITES))
        return self

    def half_close_at(self, site: str = "generate", nth: int = 1,
                      after: int = 1,
                      times: int = 1) -> "NetworkFaultPlan":
        """Mid-stream half-close: the ``nth`` call to ``site``
        proceeds, but the client tears the socket down after relaying
        ``after`` stream lines (1-based; ``after=2`` lets two ndjson
        lines through, then cuts)."""
        if after < 1:
            raise ValueError("after must be >= 1")
        with self._lock:
            self._rules.append(
                _Rule(site, nth, times, "half_close", after=after,
                      valid_sites=self.VALID_SITES))
        return self

    def corrupt_at(self, site: str, nth: int = 1, mode: str = "flip",
                   after: int = 1,
                   times: int = 1) -> "NetworkFaultPlan":
        """Deterministic payload corruption at the wire seam — the
        injection the KV integrity layer is tested against. Same
        no-real-sockets discipline as the other actions: the bytes are
        mangled at the client seam, never by a real middlebox.

        - ``mode="flip"`` — a byte-flip that keeps the framing intact:
          on ``kv_import`` the last payload byte (array bytes, past
          the header) is XOR'd, so only the checksum can tell; on
          ``generate`` the stream line after ``after`` relayed tokens
          arrives garbled (the reader sees torn ndjson).
        - ``mode="truncate"`` — the payload/stream ends early: on
          ``kv_import`` the framed body loses its tail (the receiver's
          geometry validation sees a truncated layer); on ``generate``
          it behaves like a half-close after ``after`` lines."""
        if mode not in ("flip", "truncate"):
            raise ValueError(
                f"mode must be 'flip' or 'truncate', got {mode!r}")
        if after < 1:
            raise ValueError("after must be >= 1")
        with self._lock:
            self._rules.append(
                _Rule(site, nth, times, "corrupt", after=after,
                      mode=mode, valid_sites=self.VALID_SITES))
        return self

    # -- the seam hook -------------------------------------------------------
    def fire(self, site: str):
        """Network-seam variant: ``delay`` blocks then returns
        ``None``; ``drop`` (and inherited ``raise``) raises;
        ``half_close`` / ``corrupt`` return their spec dict for the
        caller to carry into the stream reader / payload path.
        Returns ``None`` when no rule fires."""
        hit = self._consume(site)
        if hit is None:
            return None
        action, exc, seconds, after, mode, n = hit
        if action in ("hang", "delay"):
            self._release.wait(seconds)
            return None
        if action == "half_close":
            return {"action": "half_close", "after": after}
        if action == "corrupt":
            return {"action": "corrupt", "mode": mode, "after": after}
        if exc is None:
            if action == "drop":
                raise ConnectionResetError(
                    f"injected network drop @ {site} (call {n})")
            raise InjectedFault(f"injected fault @ {site} (call {n})")
        if isinstance(exc, BaseException):
            raise exc
        raise exc()   # class or zero-arg factory


class FaultyEngine:
    """Transparent proxy over a continuous-batching engine that fires
    ``plan`` at each serving-path seam before delegating. Everything
    else (capacity probes, ``partial_tokens``, ``warmup``,
    ``reset_state``, attributes) passes straight through, so a serving
    :class:`~paddle_tpu_torch.serving.Server` drives it unchanged.

    The ``"prefill"`` site is hooked INSIDE the wrapped engine (its
    ``_run_prefill`` dispatch is shadowed on the instance) so the fault
    fires after admission capacity was claimed — the path that must
    prove the abort guards reclaim the slot and pages. ``warmup`` is
    unaffected (it drives the jitted programs directly, not the
    dispatch helpers)."""

    _SEAMS = {"add_request": "admit", "begin_admit": "admit",
              "admit_chunk": "chunk", "decode_segment": "decode",
              "collect_finished": "collect"}

    def __init__(self, engine, plan: FaultPlan):
        object.__setattr__(self, "_engine", engine)
        object.__setattr__(self, "plan", plan)
        orig = engine._run_prefill

        def faulty_prefill(*a, **kw):
            self.plan.fire("prefill")
            return orig(*a, **kw)

        engine._run_prefill = faulty_prefill

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def __setattr__(self, name, value):
        # proxy-owned state stays on the proxy (reassigning ``plan``
        # between scenarios must rearm the seams, not write a dead
        # attribute onto the engine); every OTHER write routes to the
        # wrapped engine (e.g. the Server's admission_mode convenience
        # setter) — a proxy-local shadow would leave the inner engine
        # on its old policy while reads through the proxy claimed
        # otherwise
        if name in ("plan", "_engine"):
            object.__setattr__(self, name, value)
        else:
            setattr(self._engine, name, value)

    def add_request(self, *a, **kw):
        self.plan.fire("admit")
        return self._engine.add_request(*a, **kw)

    def begin_admit(self, *a, **kw):
        self.plan.fire("admit")
        return self._engine.begin_admit(*a, **kw)

    def admit_chunk(self, *a, **kw):
        self.plan.fire("chunk")
        return self._engine.admit_chunk(*a, **kw)

    def decode_segment(self, *a, **kw):
        self.plan.fire("decode")
        return self._engine.decode_segment(*a, **kw)

    def collect_finished(self, *a, **kw):
        self.plan.fire("collect")
        return self._engine.collect_finished(*a, **kw)

    def preempt_request(self, *a, **kw):
        self.plan.fire("preempt")
        return self._engine.preempt_request(*a, **kw)
