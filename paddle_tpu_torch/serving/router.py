"""Fleet-level fault tolerance: a health-aware replica router.

Port of ``paddle_tpu/serving/router.py``, whole: pure host Python over
Server-shaped replicas (in-process :class:`Server` instances, or the
HTTP clients of ``serving/remote.py``); it never touches an engine or the
device.

Everything below this module is ONE ``serving.Server`` on one engine —
survivable on its own (supervised recovery, pressure degradation, the
stall watchdog), but a wedged or restarting engine still stalls every
request in the process. THIS module is the scale-out half of the
millions-of-users shape: a :class:`Router` owns N replicas (in-process
:class:`~paddle_tpu_torch.serving.scheduler.Server` instances built from a
:class:`ReplicaSpec` factory — the same seam later fronts remote HTTP
replicas) and turns "engine fault → backoff + replay" into "engine
fault → traffic shifts, users never notice":

- **health- and load-aware routing** — every pick reads each
  replica's lock-light load-snapshot fields (the same host-side reads
  ``Server.load()``/``/healthz`` report: status, queue depth, active
  slots, free pages; no HTTP, no device sync) and routes to the
  least-loaded replica whose status is ``ok`` — ``warming``,
  ``degraded``, ``failed``, draining and restarting replicas are
  excluded before a request ever touches them;
- **per-replica circuit breakers** — ``breaker_threshold`` consecutive
  submit/request failures OPEN the breaker (routing skips the replica
  — no more hammering a dying engine while its own watchdog is still
  counting down); after an exponential backoff the breaker goes
  HALF-OPEN and admits exactly ONE probe request: success closes it,
  failure re-opens with the backoff doubled;
- **failover replay** — a request whose replica dies or degrades
  mid-flight is resubmitted to a healthy replica as
  ``prompt + tokens already streamed`` with the budget reduced by what
  the client already has, so greedy failover is BITWISE-identical to
  an unfaulted run (the same bar as the Server's in-engine replay: a
  causal re-prefill of the same prefix). The router-level
  :class:`RouterHandle` keeps ONE stable request id and ONE
  uninterrupted ``stream()`` across replicas — the client never sees
  the seam. Bounded by ``max_failovers``; past it the request fails
  with :class:`FailoverBudgetExceeded` as its typed cause;
- **replica supervision** — a monitor thread restarts crashed/failed
  replicas from their spec with exponential backoff, bounded by
  ``max_replica_restarts`` per replica (past it the replica is DEAD
  and the fleet serves on what remains); :meth:`Router.drain` /
  :meth:`Router.restart_replica` / :meth:`Router.rolling_restart`
  drain ONE replica at a time while the rest serve — the fleet-level
  analogue of ``engine.reset_state()``;
- **one front door** — ``serve_http(router)`` proxies
  ``POST /generate`` (streaming preserved across failover — the ndjson
  stream rides the RouterHandle, not any one replica), aggregates
  fleet ``GET /healthz`` (per-replica states + breaker status +
  flight-dump paths via :meth:`Router.load`), and exports fleet
  ``/metrics`` (the monitor registry is process-wide — every replica's
  series plus the router's own land on one scrape endpoint).

Thread model: ``submit`` spawns one daemon PUMP thread per request
that owns that request's routing (pick replica → submit → relay the
inner stream → fail over); the monitor thread only restarts replicas
and never touches a live request; breaker/replica state transitions
all happen under the router lock. Replica ``Server`` objects keep
their own scheduler threads — the router never touches an engine.

What counts against a replica (breaker + failover): submit rejections
for REPLICA reasons (degraded / shutdown), an inner handle that FAILED
with an engine-side cause, a replica that cancelled the request on its
way down, and a replica observed ``degraded``/``failed`` mid-stream.
What does NOT: request-scoped verdicts that would fail identically on
any replica of the same spec — a prompt that can never fit
(``ValueError`` / :class:`PagePoolExhausted`) fails the request, not
the replica.
"""
from __future__ import annotations

import statistics
import threading
import time
from typing import List, Optional, Sequence, Union

import numpy as np

from .. import monitor
from .. import tracing as trace
from ..monitor import slo as _slo
from ..inference.generation import (GenerationConfig, PagePoolExhausted,
                                    _prompt_ids, _prompt_len)
from .control import ControlPolicy, ElasticController, max_burn
from .queue import (CANCELLED, EXPIRED, FAILED, FINISHED, _TERMINAL,
                    RequestFailed, RequestHandle, RequestRejected)
from .scheduler import PreemptionBudgetExceeded, Server

__all__ = ["Router", "ReplicaSpec", "RouterHandle",
           "FailoverBudgetExceeded", "FleetUnavailable",
           "BREAKER_CLOSED", "BREAKER_HALF_OPEN", "BREAKER_OPEN"]

# circuit-breaker states (the `paddle_tpu_router_breaker_state` gauge
# exports the numeric value; `load()` exports the name)
BREAKER_CLOSED = 0
BREAKER_HALF_OPEN = 1
BREAKER_OPEN = 2
_BREAKER_NAMES = {BREAKER_CLOSED: "closed",
                  BREAKER_HALF_OPEN: "half_open",
                  BREAKER_OPEN: "open"}


class FailoverBudgetExceeded(RuntimeError):
    """A request failed over more than ``max_failovers`` times: every
    replica it landed on died under it. Clients see it as the
    ``RequestFailed.__cause__`` of ``result()`` — a typed terminal
    failure, not an endless migration."""


class FleetUnavailable(RuntimeError):
    """No replica can ever serve this request again: every replica is
    permanently dead (its ``max_replica_restarts`` budget exhausted).
    Distinct from a transient all-busy/all-restarting state, which the
    router WAITS through."""


class ReplicaSpec:
    """Recipe for building one replica: an ``engine_factory`` callable
    (returns a fresh engine each call) plus the ``Server(...)``
    keyword arguments every build uses. The factory must build a
    fresh MODEL per replica too — replica scheduler threads capture and
    replay their CUDA graphs concurrently, and a graph holds the
    addresses of its own model's weights and pools; seed the
    construction (``generator=torch.Generator(dev).manual_seed(k)``) and
    the deterministic init gives every replica bitwise-identical weights,
    which is what makes greedy failover exact. The same seam later
    fronts remote HTTP replicas: anything with
    ``build() -> Server-shaped object`` routes.

    Engine knobs mirror through ``server_kwargs`` — e.g.
    ``server_kwargs={"kv_dtype": "int8"}`` builds every replica on
    quantized KV pages (greedy failover replay stays exact across the
    fleet: identical weights + identical quantization make every
    replica's bounded numerics the SAME numerics).

    ``devices`` pins THIS replica to a device subset (a list of
    ``torch.device``; on one card every replica's list names the same
    ``cuda:0``): the factory is then called as
    ``engine_factory(devices)`` and owns forwarding them (builds its
    model there), so an N-replica fleet partitions the cards instead of
    every replica claiming device 0::

        specs = [ReplicaSpec(make_engine,
                             devices=[torch.device(f"cuda:{i}")])
                 for i in range(torch.cuda.device_count())]
        router = Router(specs)
    """

    def __init__(self, engine_factory, server_kwargs: Optional[dict]
                 = None, devices: Optional[Sequence] = None):
        if not callable(engine_factory):
            raise ValueError("engine_factory must be callable "
                             f"(got {engine_factory!r})")
        self.engine_factory = engine_factory
        self.server_kwargs = dict(server_kwargs or {})
        self.devices = None if devices is None else list(devices)
        if self.devices is not None and not self.devices:
            raise ValueError("devices must be a non-empty sequence "
                             "or None (any device)")

    def build(self) -> Server:
        """Build (and start) one fresh replica Server. With ``devices``
        pinned the factory is called with them — every supervised
        rebuild of this replica lands back on ITS device subset."""
        eng = (self.engine_factory(self.devices)
               if self.devices is not None else self.engine_factory())
        return Server(eng, **self.server_kwargs)


class RouterHandle(RequestHandle):
    """One router-level request: the SAME client surface as
    :class:`RequestHandle` (``result()`` / ``stream()`` / ``cancel()``
    / ``timeline()``), but the request id, the token stream, and the
    trace timeline are all ROUTER-scoped — they survive any number of
    replica failovers underneath. ``replica`` is the index currently
    (or last) serving it; ``failovers`` counts migrations."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._inner: Optional[RequestHandle] = None   # current replica
        #                                               handle (pump)
        self._failovers = 0
        self._ever_admitted = False   # once True the admission
        #                               deadline no longer applies to
        #                               resubmits (it was met once —
        #                               same contract as the Server's
        #                               replay)
        self.replica: Optional[int] = None

    @property
    def failovers(self) -> int:
        return self._failovers

    def cancel(self) -> None:
        """Cancel the request (idempotent): flags the router pump AND
        forwards to whichever replica currently runs it, so the slot
        (and pages) there reclaim at its next gap."""
        super().cancel()            # sets the flag + wakes the pump
        inner = self._inner
        if inner is not None:
            inner.cancel()


class _Replica:
    """Router-side record for one replica slot (all mutable state is
    guarded by the router lock)."""

    __slots__ = ("index", "spec", "server", "breaker", "failures",
                 "opens", "open_until", "backoff_mult", "probing",
                 "restarts", "deliberate_restarts", "restart_at",
                 "draining", "dead", "slow", "scaled_down")

    def __init__(self, index: int, spec: ReplicaSpec, server):
        self.index = index
        self.spec = spec
        self.server = server
        self.breaker = BREAKER_CLOSED
        self.failures = 0          # consecutive failures (reset on
        #                            success)
        self.opens = 0             # lifetime breaker-open count
        self.open_until = 0.0
        self.backoff_mult = 1.0    # doubles per consecutive open,
        #                            resets when the breaker closes
        self.probing = False       # half-open: one probe in flight
        self.restarts = 0          # supervised restarts consumed
        #                            (the max_replica_restarts budget)
        self.deliberate_restarts = 0   # rolling-restart rebuilds
        #                                (budget-exempt: operator-run)
        self.restart_at: Optional[float] = None   # backoff deadline
        #                            while a restart is pending
        self.draining = False      # deliberately excluded (drain /
        #                            rolling restart)
        self.dead = False          # restart budget exhausted
        self.slow = False          # skew detector verdict: rolling
        #                            TPOT p50 > skew_factor x fleet
        #                            median — ALIVE but lagging; routed
        #                            last, never walled off (slow !=
        #                            open breaker)
        self.scaled_down = False   # elastically parked: drained +
        #                            shut down by the autoscaler, slot
        #                            kept so a scale-up revives it
        #                            from ITS spec (and device subset)

    # both helpers mutate breaker/supervision state: caller holds the
    # router lock
    def reset_health(self, server=None) -> None:
        """Back to a clean routable state (fresh build / deliberate
        restart): failures forgotten, breaker closed, no probe, no
        pending restart."""
        if server is not None:
            self.server = server
        self.failures = 0
        self.breaker = BREAKER_CLOSED
        self.backoff_mult = 1.0
        self.probing = False
        self.restart_at = None
        self.dead = False
        self.slow = False     # a fresh server has a fresh engine: the
        #                       old skew verdict is stale evidence

    def mark_dead(self) -> None:
        """Restart budget exhausted: permanently out of rotation,
        breaker pinned open."""
        self.dead = True
        self.breaker = BREAKER_OPEN
        self.open_until = float("inf")
        self.restart_at = None
        self.slow = False     # dead outranks slow; the gauge reads 0


class Router:
    """Front tier spreading requests over N replica Servers.

    Usage::

        model = LlamaForCausalLM(cfg)          # ONE model, N engines
        spec = ReplicaSpec(
            lambda: PagedContinuousBatchingEngine(
                model, max_batch=4, num_pages=64, page_size=16,
                max_pages=32),
            server_kwargs={"segment_steps": 8})
        router = Router(spec, replicas=3)
        h = router.submit(prompt_ids, GenerationConfig(max_new_tokens=64))
        for tok in h.stream():     # uninterrupted even if a replica dies
            ...
        router.shutdown()

    Knobs:

    - ``max_failovers`` — replica migrations any ONE request may
      survive; past it: :class:`FailoverBudgetExceeded`;
    - ``breaker_threshold`` / ``breaker_backoff_s`` /
      ``breaker_backoff_max_s`` — consecutive failures before a
      replica's breaker OPENs, and the (exponential, capped) backoff
      before its half-open probe;
    - ``max_replica_restarts`` / ``replica_backoff_s`` /
      ``replica_backoff_max_s`` — supervised restarts per replica and
      their exponential backoff; past the budget the replica is DEAD;
    - ``monitor_interval_s`` — supervisor poll period (detection
      latency for a crashed replica is at most one period + the
      backoff);
    - ``degraded_poll_s`` — how often a pump waiting on a silent
      replica re-checks its health (a replica observed ``degraded`` /
      ``failed`` mid-stream is abandoned and the request fails over);
    - ``retry_wait_s`` — pump back-off while NO replica is routable
      (all warming/restarting/open): the request waits instead of
      failing, bounded by its own deadline and by the fleet going
      permanently dead;
    - ``skew_factor`` / ``skew_min_requests`` / ``skew_interval_s`` —
      the SLOW-REPLICA skew detector: every ``skew_interval_s`` the
      monitor thread compares each replica's rolling-window TPOT p50
      (>= ``skew_min_requests`` observations required) against the
      median of its PEERS' p50s (leave-one-out); above
      ``skew_factor``× that median the replica flips
      SLOW — deprioritized in routing (scored behind every non-slow
      candidate) but still routable, surfaced in ``load()`` /
      ``GET /stats``, flight-recorder dump on the flip. Slow is the
      state breakers cannot see: the replica answers everything,
      just late;
    - ``elastic`` / ``elastic_interval_s`` — ELASTIC FLEET sizing
      (``serving.control``): pass a :class:`ControlPolicy` (or a
      pre-built :class:`ElasticController`) and the supervisor
      thread grows/shrinks the serving replica count from queue
      depth + burn rate, between 1 and ``len(specs)``. Scale-down
      DRAINS the least-loaded replica (in-flight work always
      finishes — the rolling-restart bar) and parks its slot;
      scale-up revives a parked slot from its own spec. Decisions
      are streak-gated and cooldown-rate-limited (flap-resistant);
      :meth:`scale_to` is the deliberate operator override.
    """

    def __init__(self,
                 specs: Union[ReplicaSpec, Sequence[ReplicaSpec]],
                 replicas: Optional[int] = None, *,
                 max_failovers: int = 2,
                 breaker_threshold: int = 3,
                 breaker_backoff_s: float = 0.25,
                 breaker_backoff_max_s: float = 8.0,
                 max_replica_restarts: int = 3,
                 replica_backoff_s: float = 0.05,
                 replica_backoff_max_s: float = 2.0,
                 monitor_interval_s: float = 0.05,
                 degraded_poll_s: float = 0.25,
                 retry_wait_s: float = 0.02,
                 tight_headroom_s: float = 0.25,
                 skew_factor: float = 2.0,
                 skew_min_requests: int = 5,
                 skew_interval_s: float = 1.0,
                 elastic=None,
                 elastic_interval_s: float = 0.5,
                 start: bool = True):
        if isinstance(specs, ReplicaSpec):
            n = 1 if replicas is None else replicas
            if n < 1:
                raise ValueError(f"replicas must be >= 1, got {n}")
            specs = [specs] * n
        else:
            specs = list(specs)
            if replicas is not None and replicas != len(specs):
                raise ValueError(
                    f"replicas={replicas} contradicts the {len(specs)} "
                    "specs passed; give one spec + replicas=N, or a "
                    "list of specs")
            if not specs:
                raise ValueError("need at least one ReplicaSpec")
        if max_failovers < 0 or max_replica_restarts < 0:
            raise ValueError(
                "max_failovers/max_replica_restarts must be >= 0")
        if breaker_threshold < 1:
            raise ValueError(
                f"breaker_threshold must be >= 1, got "
                f"{breaker_threshold}")
        for name, v in (("breaker_backoff_s", breaker_backoff_s),
                        ("replica_backoff_s", replica_backoff_s),
                        ("monitor_interval_s", monitor_interval_s),
                        ("degraded_poll_s", degraded_poll_s),
                        ("retry_wait_s", retry_wait_s),
                        ("skew_interval_s", skew_interval_s)):
            if not v > 0:
                raise ValueError(f"{name} must be > 0, got {v!r}")
        if not skew_factor > 1.0:
            # factor <= 1 would flag roughly half a healthy,
            # noise-jittered fleet slow at every check
            raise ValueError(
                f"skew_factor must be > 1.0, got {skew_factor!r}")
        if skew_min_requests < 1:
            raise ValueError(
                f"skew_min_requests must be >= 1, got "
                f"{skew_min_requests!r}")
        if not elastic_interval_s > 0:
            raise ValueError(
                f"elastic_interval_s must be > 0, got "
                f"{elastic_interval_s!r}")
        # elastic fleet sizing (serving.control.ElasticController):
        # the supervisor thread grows/shrinks the ROUTABLE replica
        # count between 1 and the spec list's length — scale-down
        # DRAINS (the rolling-restart machinery: in-flight work always finishes, the
        # slot parks scaled_down), scale-up revives a parked slot from
        # ITS spec, so devices=... partitions are honoured on the way
        # back. Pass a ControlPolicy (wrapped here) or a pre-built
        # ElasticController; None = fixed fleet.
        if isinstance(elastic, ControlPolicy):
            elastic = ElasticController(elastic, min_replicas=1,
                                        max_replicas=len(specs))
        elif elastic is not None and not isinstance(elastic,
                                                    ElasticController):
            raise ValueError(
                f"elastic must be a ControlPolicy, an "
                f"ElasticController, or None, got {elastic!r}")
        self._elastic = elastic
        self.elastic_interval_s = elastic_interval_s
        self.max_failovers = max_failovers
        self.breaker_threshold = breaker_threshold
        self.breaker_backoff_s = breaker_backoff_s
        self.breaker_backoff_max_s = breaker_backoff_max_s
        self.max_replica_restarts = max_replica_restarts
        self.replica_backoff_s = replica_backoff_s
        self.replica_backoff_max_s = replica_backoff_max_s
        self.monitor_interval_s = monitor_interval_s
        self.degraded_poll_s = degraded_poll_s
        self.retry_wait_s = retry_wait_s
        # SLO-headroom tiebreak: below this remaining
        # deadline, failover/route scoring drops the adapter-affinity
        # term — a warm LoRA bank row saves milliseconds, and a
        # request this close to its deadline needs the least-loaded
        # replica, not the warmest one
        self.tight_headroom_s = tight_headroom_s
        # Retry-After honor windows: replica index -> monotonic time
        # before which _acquire deprioritizes it (it told us when to
        # come back — believe it, unless nobody else is routable)
        self._reject_until = {}
        self.skew_factor = skew_factor
        self.skew_min_requests = skew_min_requests
        self.skew_interval_s = skew_interval_s
        self.monitor_router = monitor.instance_label("router")
        # one spec shared by every replica: a capacity verdict
        # (ValueError / PagePoolExhausted) from one replica holds for
        # all of them; a heterogeneous list must try each spec before
        # declaring a request unservable
        self._homogeneous = all(s is specs[0] for s in specs)
        self._lock = threading.Lock()
        self._idle_cv = threading.Condition()
        self._next_id = 0                 # guarded-by: self._lock
        self._handles: set = set()        # guarded-by: self._lock
        #                                   live RouterHandles (pumps
        #                                   remove on terminal)
        self._failovers_total = 0         # guarded-by: self._lock
        self._draining = False            # guarded-by: self._lock
        self._stopping = False            # guarded-by: self._lock
        self._flight_dumps = []           # guarded-by: self._lock
        #                                   router-level flight-recorder
        #                                   dump paths (skew flips)
        self._stop_evt = threading.Event()
        # building a replica compiles nothing by itself (Server warmup
        # is a spec knob) but does allocate device state — build them
        # serially, before any thread exists, so a constructor failure
        # leaves nothing half-started
        self._replicas: List[_Replica] = []
        try:
            for i, spec in enumerate(specs):
                if not isinstance(spec, ReplicaSpec):
                    raise ValueError(
                        f"specs[{i}] is not a ReplicaSpec: {spec!r}")
                self._replicas.append(_Replica(i, spec, spec.build()))
        except BaseException:
            for rep in self._replicas:
                try:
                    rep.server.shutdown(drain=False, timeout=5.0)
                except Exception:
                    pass
            raise
        for rep in self._replicas:
            self._breaker_metric(rep)
            self._slow_metric(rep)
        self._replicas_metric()
        self._monitor_thread = threading.Thread(
            target=self._monitor_loop, daemon=True,
            name=f"paddle_tpu-router-monitor-{self.monitor_router}")
        if start:
            self._monitor_thread.start()

    # -- client surface ------------------------------------------------------
    def submit(self, prompt, cfg: Optional[GenerationConfig] = None,
               priority: int = 0,
               timeout_s: Optional[float] = None,
               tenant: Optional[str] = None) -> RouterHandle:
        """Route one request into the fleet; returns its
        :class:`RouterHandle`. Raises
        :class:`~paddle_tpu_torch.serving.queue.RequestRejected` (reason
        ``draining`` / ``shutdown`` / ``unavailable`` — the last only
        when EVERY replica is permanently dead), ValueError for a
        prompt that can never fit the replica engines. A fleet that is
        merely busy/restarting ACCEPTS the request — the pump waits
        for a routable replica (bounded by ``timeout_s``)."""
        cfg = cfg or GenerationConfig()
        plen = _prompt_len(prompt)
        with self._lock:
            if self._stopping:
                raise RequestRejected("shutdown",
                                      "router is shut down")
            if self._draining:
                raise RequestRejected(
                    "draining",
                    "router is draining; not accepting new requests")
            if all(rep.dead for rep in self._replicas):
                raise RequestRejected(
                    "unavailable",
                    "every replica is permanently dead "
                    "(max_replica_restarts exhausted fleet-wide)")
            # same-spec replicas share max_len: fail a can-never-fit
            # prompt fast, before a pump cycles it through the fleet
            max_len = max(getattr(rep.server.engine, "max_len", 1 << 30)
                          for rep in self._replicas if not rep.dead)
            if plen + cfg.max_new_tokens > max_len:
                raise ValueError(
                    f"prompt({plen}) + max_new_tokens"
                    f"({cfg.max_new_tokens}) exceeds replica "
                    f"max_len({max_len})")
            deadline = (None if timeout_s is None
                        else time.monotonic() + timeout_s)
            h = RouterHandle(self._next_id, prompt, plen, cfg,
                             priority, deadline, tenant=tenant)
            h._trace_rid = f"{self.monitor_router}:{h.id}"
            self._next_id += 1
            self._handles.add(h)
        pump = threading.Thread(
            target=self._run_request, args=(h,), daemon=True,
            name=f"paddle_tpu-router-pump-{self.monitor_router}-{h.id}")
        pump.start()
        return h

    def request_timeline(self, request_id: int):
        """One router request's ordered trace timeline by its public id
        — spans BOTH replicas across a failover (the router stamps its
        stable rid into every replica submit). Same contract as
        ``RequestHandle.timeline()``."""
        return trace.timeline(f"{self.monitor_router}:{request_id}")

    def num_active(self) -> int:
        """Router-level in-flight requests (pumps not yet terminal)."""
        with self._lock:
            return len(self._handles)

    @property
    def failovers(self) -> int:
        """Total failovers performed over the router's lifetime."""
        with self._lock:
            return self._failovers_total

    @property
    def status(self) -> str:
        """``ok`` (every replica routable) / ``degraded`` (some — or
        transiently all — replicas down while the fleet lives:
        restarting/warming/breaker-open replicas come back) /
        ``failed`` (every replica PERMANENTLY dead — restart budgets
        exhausted, nothing will ever route again) / ``draining`` /
        ``stopped``. The HTTP 200/503 verdict is the separate
        ``load()["healthy"]`` flag: >= 1 replica routable right
        now."""
        return self.load()["status"]

    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        """Block until every (non-dead) replica finished warmup."""
        end = (None if timeout is None
               else time.monotonic() + timeout)
        for rep in list(self._replicas):
            t = (None if end is None
                 else max(0.0, end - time.monotonic()))
            if not rep.server.wait_ready(t):
                return False
        return True

    def load(self) -> dict:  # lint: hot-path
        """The FLEET health/load snapshot — what ``/healthz`` serves
        (the router quacks like a Server to ``serve_http``): top-level
        ``{"status", "healthy", "router", "replicas": [...],
        "queue_depth", "active_requests", "free_slots",
        "inflight_requests", "failovers", "breaker_opens"}`` with one
        entry per replica carrying its state (``dead`` / ``restarting``
        / ``draining`` / the Server's own status), its breaker
        ``{"state", "failures", "opens"}``, supervised ``restarts``,
        its ``Server.load()`` numbers, and its flight-recorder dump
        paths. ``healthy`` (the HTTP 200 verdict) is ">= 1 routable
        replica and not stopping" — one dead replica degrades the
        fleet, it does not fail it."""
        with self._lock:
            reps = list(self._replicas)
            stopping = self._stopping
            draining = self._draining
            inflight = len(self._handles)
            failovers = self._failovers_total
        now = time.monotonic()
        entries = []
        routable = agg_q = agg_a = agg_f = opens = 0
        for rep in reps:
            try:
                snap = rep.server.load()
            except Exception:   # mid-swap / torn replica: skip numbers
                snap = {"status": "unknown"}
            if rep.dead:
                state = "dead"
            elif rep.scaled_down:
                state = "scaled_down"
            elif rep.restart_at is not None:
                state = "restarting"
            elif rep.draining:
                state = "draining"
            else:
                state = snap["status"]
            breaker = rep.breaker
            if breaker == BREAKER_OPEN and now >= rep.open_until:
                breaker = BREAKER_HALF_OPEN   # display-only: the next
                #                               pick makes it official
            entry = {
                "replica": rep.index,
                "status": state,
                "slow": rep.slow,
                "breaker": {"state": _BREAKER_NAMES[breaker],
                            "failures": rep.failures,
                            "opens": rep.opens},
                "restarts": rep.restarts,
                "deliberate_restarts": rep.deliberate_restarts,
                "load": {k: snap[k] for k in
                         ("queue_depth", "active_requests",
                          "free_slots", "free_pages", "occupancy")
                         if k in snap},
            }
            if "tp" in snap:
                # mesh shape per replica: fleet /healthz shows how a
                # scale-up (TP) x scale-out (replicas) topology
                # partitions the slice
                entry["tp"] = snap["tp"]
            dumps = []
            try:
                dumps = rep.server.flight_dumps
            except Exception:
                pass
            if dumps:
                entry["flight_dumps"] = dumps
            entries.append(entry)
            opens += rep.opens
            if not rep.dead:
                # queued/active work is real wherever it sits (a
                # draining replica still finishes its requests) — but
                # a dead server's finalizer reclaimed everything, so
                # counting it would be phantom load
                agg_q += snap.get("queue_depth", 0)
                agg_a += snap.get("active_requests", 0)
            if state == "ok" and breaker != BREAKER_OPEN:
                routable += 1
                # advertised capacity is ROUTABLE capacity only: a
                # dead/draining/restarting/walled-off replica's free
                # slots can't serve new traffic, and an autoscaler
                # reading the aggregate must not see them
                agg_f += snap.get("free_slots", 0)
        if stopping:
            status = "stopped"
        elif all(r.dead for r in reps):
            status = "failed"
        elif draining:
            status = "draining"
        elif routable == sum(1 for r in reps if not r.scaled_down):
            # a deliberately parked (scaled-down) replica is capacity
            # the autoscaler CHOSE not to run — the fleet it sized is
            # fully routable, so it reads ok, not degraded
            status = "ok"
        else:
            # routable == 0 but not all dead reads "degraded", not
            # "failed": restarting/warming/breaker-open replicas come
            # back on their own (an all-warming fleet at boot is not
            # an outage) — `healthy` carries the take-no-traffic fact
            status = "degraded"
        healthy = (not stopping and routable >= 1
                   and not all(r.dead for r in reps))
        out = {"status": status, "healthy": healthy,
               "router": self.monitor_router, "replicas": entries,
               "queue_depth": agg_q, "active_requests": agg_a,
               "free_slots": agg_f, "inflight_requests": inflight,
               "failovers": failovers, "breaker_opens": opens,
               "slow_replicas": [e["replica"] for e in entries
                                 if e.get("slow")],
               "scaled_down": [r.index for r in reps
                               if r.scaled_down]}
        with self._lock:
            if self._flight_dumps:
                out["flight_dump"] = self._flight_dumps[-1]
        return out

    def stats(self) -> dict:
        """The fleet SLO rollup — ``GET /stats``. EXACT by
        construction: per-(metric, tenant) latency percentiles come
        from MERGING every live replica's fixed-log-bucket digests
        (identical bucketization → elementwise counter add → the
        merged digest IS the digest of the concatenated request
        streams), and per-tenant goodput/burn come from SUMMING the
        replicas' met/missed counters — never from averaging replica
        percentiles or rates, which is the classic fleet-dashboard
        lie this endpoint exists to replace. Shape::

            {"router", "policy", "window_s",
             "tenants": {tenant: {requests, met, missed, failed,
                                  goodput, burn_fast, burn_slow,
                                  tokens, kv_page_seconds}},
             "metrics": {metric: {tenant: {count, mean, p50, p90,
                                           p99, max},
                                  "*": <exact all-tenant merge>}},
             "replicas": [{replica, slow, dead, tpot_p50_s,
                           metrics: <per-replica percentiles>}],
             "skew": {"factor", "min_requests",
                      "slow_replicas": [...]}}

        The per-replica ``metrics`` blocks are what the fleet-vs-
        replica comparison in ``tools/monitor_report.py --slo`` reads
        — the gap between a replica's p99 and the fleet's is the skew
        detector's story told in percentiles."""
        with self._lock:
            reps = list(self._replicas)
        shards, entries = [], []
        for rep in reps:
            entry = {"replica": rep.index, "slow": rep.slow,
                     "dead": rep.dead}
            tracker = getattr(rep.server, "slo", None)
            if tracker is not None and not rep.dead:
                try:
                    shard = tracker.digests_dict()
                    entry["tpot_p50_s"] = tracker.rolling_tpot_p50()
                    entry["metrics"] = tracker.percentiles()
                except Exception:   # mid-swap replica: skip its shard
                    shard = None
                if shard is not None:
                    shards.append(shard)
            entries.append(entry)
        out = _slo.fleet_rollup(shards)
        out["router"] = self.monitor_router
        out["replicas"] = entries
        out["skew"] = {"factor": self.skew_factor,
                       "min_requests": self.skew_min_requests,
                       "slow_replicas": [e["replica"] for e in entries
                                         if e.get("slow")]}
        return out

    def profile(self, top_k: Optional[int] = None) -> dict:
        """The fleet program-ledger rollup (``GET /profile``), exact the
        way :meth:`stats` is: every live replica's ``Server.profile`` shard
        is merged per program id (digest buckets add, dispatch and compile
        counters sum, the cost comes from the first shard that has it),
        never an average of per-replica MFUs. Dead and mid-swap replicas
        are skipped."""
        from ..monitor import ledger as _ledger

        with self._lock:
            reps = list(self._replicas)
        shards = []
        for rep in reps:
            if rep.dead:
                continue
            fn = getattr(rep.server, "profile", None)
            if fn is None:
                continue
            try:
                shards.append(fn())
            except Exception:   # mid-swap replica: skip its shard
                pass
        out = _ledger.merge_profiles(shards, top_k=top_k)
        out["router"] = self.monitor_router
        out["replicas"] = len(shards)
        return out

    # -- drain / rolling restart ---------------------------------------------
    def drain(self, index: Optional[int] = None,
              timeout: Optional[float] = None) -> bool:
        """``drain()`` — FLEET drain: stop accepting new submissions
        and wait for every in-flight router handle to reach a terminal
        state (replays and failovers included). ``drain(i)`` — drain
        ONE replica while the rest serve: exclude it from routing,
        then ``Server.drain`` it (its queued + active requests run to
        completion). A drained replica stays excluded until
        :meth:`restart_replica` rebuilds it — ``Server.drain`` is
        one-way, which is exactly the rolling-restart contract.
        Returns True when everything finished in time."""
        if index is not None:
            rep = self._replicas[index]
            with self._lock:
                rep.draining = True
            if trace.enabled():
                trace.event("replica.drain", replica=index,
                            router=self.monitor_router)
            return rep.server.drain(timeout)
        with self._lock:
            self._draining = True
        with self._idle_cv:
            # lint: allow-unlocked(atomic emptiness probe inside the
            # cv predicate — re-evaluated on every notify; pumps hold
            # _lock for the actual mutation and notify after)
            return self._idle_cv.wait_for(
                lambda: not self._handles, timeout)

    def restart_replica(self, index: int,
                        timeout: Optional[float] = None,
                        drain: bool = True) -> bool:
        """Deliberately restart ONE replica: drain it (in-flight work
        finishes; routing already excludes it), shut the old Server
        down, build a fresh one from the spec, wait for its warmup,
        and put it back in rotation with a CLOSED breaker. Returns the
        drain verdict (True = nothing was cut short). The supervisor
        thread ignores replicas mid-deliberate-restart, so the two
        never fight over one slot."""
        rep = self._replicas[index]
        with self._lock:
            # fence the supervisor off this slot for the WHOLE
            # deliberate restart — with drain=False nothing else would
            # set the flag, and a supervisor tick observing the old
            # server "stopped" mid-swap would burn a supervised-restart
            # budget unit and race-build a duplicate server
            rep.draining = True
        drained = self.drain(index, timeout) if drain else True
        old = rep.server
        try:
            old.shutdown(drain=False, timeout=timeout)
        except Exception:
            pass
        new = rep.spec.build()
        new.wait_ready(timeout)
        with self._lock:
            # the operator's restart WINS a race against a concurrent
            # supervisor install (possible with drain=False, where the
            # draining flag never fenced the supervisor off) — but the
            # interloper server must be stopped, not silently leaked
            interloper = rep.server if rep.server is not old else None
            rep.reset_health(server=new)
            rep.draining = False
            rep.deliberate_restarts += 1
        if interloper is not None:
            try:
                interloper.shutdown(drain=False, timeout=5.0)
            except Exception:
                pass
        self._breaker_metric(rep)
        # reset_health cleared rep.slow OUT OF BAND (a fresh engine's
        # skew verdict starts over) — the gauge must follow, or it
        # exports a phantom slow=1 the next _check_skew never corrects
        # (it only writes on a flag CHANGE)
        self._slow_metric(rep)
        if monitor.enabled():
            self._restarts_counter().labels(
                router=self.monitor_router,
                replica=str(index)).inc()
        if trace.enabled():
            trace.event("replica.restart", replica=index,
                        deliberate=True, router=self.monitor_router)
        return drained

    def rolling_restart(self, timeout: Optional[float] = None) -> bool:
        """Restart every replica ONE AT A TIME (drain → rebuild →
        ready → next) while the rest keep serving — config/weight
        rollouts without a maintenance window. Returns True when every
        per-replica drain completed cleanly."""
        if trace.enabled():
            trace.event("rolling_restart", router=self.monitor_router,
                        replicas=len(self._replicas))
        ok = True
        for i in range(len(self._replicas)):
            ok = self.restart_replica(i, timeout) and ok
        return ok

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop the fleet: optionally drain (bounded by ``timeout``),
        then stop the supervisor, shut every replica down (their
        finalizers cancel whatever remains — pumps observe it and
        finish their handles), and retire the router's metric
        series."""
        if drain:
            self.drain(timeout=timeout)
        with self._lock:
            self._stopping = True
            self._draining = True
        self._stop_evt.set()
        if self._monitor_thread.is_alive():
            self._monitor_thread.join(timeout=5.0)
        for rep in self._replicas:
            try:
                rep.server.shutdown(drain=False, timeout=timeout)
            except Exception:
                pass
            # the router built these engines (engine_factory), so it
            # closes them: per-engine monitor series AND the program
            # ledger rows they own retire here — Router.shutdown()
            # leaves zero {program=...} series behind
            try:
                eng = getattr(rep.server, "engine", None)
                if eng is not None:
                    eng.close()
            except Exception:
                pass
        # pumps unwind on their cancelled/failed inner handles; give
        # them a bounded window so no handle is left non-terminal
        with self._idle_cv:
            # lint: allow-unlocked(same atomic cv-predicate probe as
            # drain(); the terminal sweep below re-reads under _lock)
            self._idle_cv.wait_for(lambda: not self._handles, 10.0)
        with self._lock:
            leftovers = list(self._handles)
        for h in leftovers:   # belt and braces: a wedged pump must not
            #                   strand its client
            h._finish(CANCELLED)
        for name in ("paddle_tpu_router_requests_total",
                     "paddle_tpu_router_failovers_total",
                     "paddle_tpu_router_breaker_state",
                     "paddle_tpu_router_replica_restarts_total",
                     "paddle_tpu_router_replica_slow",
                     # elastic fleet: the replicas gauge would
                     # export a stale fleet size forever
                     "paddle_tpu_router_scale_events_total",
                     "paddle_tpu_router_replicas"):
            try:
                monitor.remove_series(name, router=self.monitor_router)
            except Exception:
                pass

    def close(self) -> None:
        self.shutdown(drain=False)

    # -- monitor helpers -----------------------------------------------------
    @staticmethod
    def _requests_counter():
        return monitor.counter(
            "paddle_tpu_router_requests_total",
            "router-level requests by replica and outcome "
            "(completed/failed/cancelled/expired/failover — one "
            "terminal count per request plus one per migration; "
            "per-attempt backpressure lives on the replicas' "
            "serving_requests_total{event=rejected_*})",
            ("router", "replica", "outcome"))

    @staticmethod
    def _failovers_counter():
        return monitor.counter(
            "paddle_tpu_router_failovers_total",
            "requests migrated to another replica after their replica "
            "died or degraded mid-flight", ("router",))

    @staticmethod
    def _breaker_gauge():
        return monitor.gauge(
            "paddle_tpu_router_breaker_state",
            "per-replica circuit breaker: 0 closed, 1 half-open, "
            "2 open", ("router", "replica"))

    @staticmethod
    def _restarts_counter():
        return monitor.counter(
            "paddle_tpu_router_replica_restarts_total",
            "replica Servers rebuilt from their spec (supervised "
            "crash recovery + deliberate rolling restarts)",
            ("router", "replica"))

    @staticmethod
    def _scale_counter():
        return monitor.counter(
            "paddle_tpu_router_scale_events_total",
            "elastic fleet scale decisions applied "
            "(action=up revives a parked slot, action=down drains "
            "one replica and parks it)", ("router", "action"))

    @staticmethod
    def _replicas_gauge():
        return monitor.gauge(
            "paddle_tpu_router_replicas",
            "replica slots currently in the serving fleet (not "
            "parked by the autoscaler, not permanently dead)",
            ("router",))

    @staticmethod
    def _slow_gauge():
        return monitor.gauge(
            "paddle_tpu_router_replica_slow",
            "skew-detector verdict: 1 while the replica's rolling "
            "TPOT p50 exceeds the fleet median by skew_factor "
            "(slow-but-alive — deprioritized in routing, breaker "
            "untouched), else 0", ("router", "replica"))

    def _count(self, outcome: str, replica) -> None:
        if monitor.enabled():
            self._requests_counter().labels(
                router=self.monitor_router,
                replica=("none" if replica is None else str(replica)),
                outcome=outcome).inc()

    def _breaker_metric(self, rep: _Replica) -> None:
        if monitor.enabled():
            self._breaker_gauge().labels(
                router=self.monitor_router,
                replica=str(rep.index)).set(rep.breaker)

    def _slow_metric(self, rep: _Replica) -> None:
        if monitor.enabled():
            self._slow_gauge().labels(
                router=self.monitor_router,
                replica=str(rep.index)).set(int(rep.slow))

    def _replicas_metric(self) -> None:
        if monitor.enabled():
            with self._lock:
                n = sum(1 for r in self._replicas
                        if not r.dead and not r.scaled_down)
            self._replicas_gauge().labels(
                router=self.monitor_router).set(n)

    def _flight_dump(self, reason: str):
        """Router-level flight-recorder dump (no-op while tracing is
        off), mirroring the Server's: the skew detector fires one when
        a replica flips SLOW — a lagging-but-alive replica is exactly
        the postmortem the breakers never capture (they only see
        failures). Never raises."""
        if not trace.enabled():
            return None
        try:
            path = trace.dump(reason)
        except Exception:
            return None
        if path is not None:
            with self._lock:
                self._flight_dumps.append(path)
        return path

    @property
    def flight_dumps(self):
        """Router-level flight-recorder dump paths (newest last)."""
        with self._lock:
            return list(self._flight_dumps)

    # -- breaker transitions (router lock) -----------------------------------
    def _replica_failure(self, rep: _Replica, srv, err,
                         probe: bool) -> None:
        """Record one replica-attributed failure: bump the consecutive
        count, OPEN the breaker at the threshold (or immediately on a
        failed half-open probe, with the backoff doubled). Failures
        against an already-replaced Server are dropped — they must not
        trip the fresh replica's breaker."""
        with self._lock:
            if rep.server is not srv:
                return
            if probe:
                rep.probing = False
            rep.failures += 1
            opened = False
            if (rep.breaker != BREAKER_OPEN
                    and (probe
                         or rep.failures >= self.breaker_threshold)):
                if rep.breaker == BREAKER_HALF_OPEN:
                    rep.backoff_mult *= 2.0
                rep.breaker = BREAKER_OPEN
                rep.opens += 1
                backoff = min(
                    self.breaker_backoff_s * rep.backoff_mult,
                    self.breaker_backoff_max_s)
                rep.open_until = time.monotonic() + backoff
                opened = True
        if opened:
            self._breaker_metric(rep)
            if trace.enabled():
                trace.event("breaker", replica=rep.index, state="open",
                            failures=rep.failures, cause=repr(err),
                            router=self.monitor_router)

    def _clear_probe(self, rep: _Replica, srv, probe: bool) -> None:
        """Release a half-open probe slot on a verdict that is neither
        replica-success nor replica-failure (user cancel, deadline
        expiry, request-scoped terminal): the breaker stays HALF-OPEN
        and the NEXT request becomes the new probe — without this the
        abandoned probe would block every future pick forever. Same
        server-identity guard as the other transition helpers: a
        STALE probe's late verdict must not clear the slot a fresh
        server's probe currently holds (two concurrent probes would
        double the load on a recovering replica)."""
        if not probe:
            return
        with self._lock:
            if rep.server is srv:
                rep.probing = False

    def _replica_success(self, rep: _Replica, srv,
                         probe: bool) -> None:
        """A request made real progress on the replica (first token or
        completion): reset the consecutive-failure count and CLOSE a
        half-open breaker (the probe succeeded)."""
        with self._lock:
            if rep.server is not srv:
                return
            if probe:
                rep.probing = False
            rep.failures = 0
            closed = rep.breaker != BREAKER_CLOSED
            rep.breaker = BREAKER_CLOSED
            rep.backoff_mult = 1.0
        if closed:
            self._breaker_metric(rep)
            if trace.enabled():
                trace.event("breaker", replica=rep.index,
                            state="closed",
                            router=self.monitor_router)

    # -- routing -------------------------------------------------------------
    def _acquire(self, exclude, hard=frozenset(), adapter=None,
                 headroom_s=None):
        """Pick the least-loaded routable replica: status ``ok``
        (warming/degraded/failed/draining/restarting/dead excluded),
        breaker not OPEN (an elapsed OPEN transitions to HALF-OPEN
        here and admits this caller as its ONE probe). ``exclude``
        skips the replica a failure just came from — unless it is the
        only candidate; ``hard`` (replicas this request can NEVER fit
        — heterogeneous fleets) is skipped unconditionally.
        ``adapter`` biases the pick with ADAPTER AFFINITY: replicas
        with the named LoRA adapter RESIDENT score ahead of those
        without (an atomic registry-membership read — no HTTP, no
        device sync), falling back to plain least-loaded when nobody
        has it; the load tie-break still applies within each class,
        so affinity never pins a tenant to one overloaded replica
        while an idle adapter-resident peer exists. ``headroom_s``
        (remaining SLO deadline) below ``tight_headroom_s`` drops the
        affinity term entirely — the deadline-tight pick is purely
        least-loaded (deadline headroom outranks warmth).
        Returns ``(rep, server, probe)`` or ``(None, None, False)``."""
        if (headroom_s is not None
                and headroom_s < self.tight_headroom_s):
            adapter = None
        now = time.monotonic()
        flipped = []
        with self._lock:
            cands = []
            for rep in self._replicas:
                if rep.index in hard:
                    continue
                if rep.dead or rep.draining or rep.restart_at is not None:
                    continue
                if rep.breaker == BREAKER_OPEN:
                    if now < rep.open_until:
                        continue
                    rep.breaker = BREAKER_HALF_OPEN
                    flipped.append(rep)
                    half = True
                else:
                    half = rep.breaker == BREAKER_HALF_OPEN
                if half and rep.probing:
                    continue   # one probe at a time
                cands.append((rep, half))
            picks = [(r, hf) for r, hf in cands
                     if r.index not in exclude] or cands
            # replicas inside a Retry-After honor window lose to any
            # sibling outside one — same only-candidate fallback as
            # ``exclude`` so the hint never starves a request
            picks = [(r, hf) for r, hf in picks
                     if self._reject_until.get(r.index, 0.0) <= now
                     ] or picks
            best = None
            best_score = None
            best_half = False
            for rep, half in picks:
                # the same host-side fields Server.load() reports,
                # read directly: this runs per candidate per pick
                # (and on every waiting pump's retry tick) under the
                # router lock — materializing the whole /healthz
                # payload here would serialize healthy routing behind
                # the spin
                srv2 = rep.server
                try:
                    if srv2.status != "ok":
                        continue
                    alloc = getattr(srv2.engine, "alloc", None)
                    # adapter affinity first (0 = resident, 1 = not:
                    # an admission on a resident replica reuses its
                    # bank row AND its adapter-salted prefix cache),
                    # then least-loaded: what's queued + what's
                    # decoding now; free pages break ties toward the
                    # roomier KV pool
                    # skew first, THEN adapter affinity, then load: a
                    # slow replica with the adapter resident loses to a
                    # healthy one without it — a warm bank row saves
                    # milliseconds, a skewed replica costs the whole
                    # TPOT gap, and the SLO is the thing being served.
                    # Slow stays a candidate (routable of last resort;
                    # slow != open breaker).
                    reg = getattr(srv2.engine, "adapters", None)
                    afar = int(not (adapter is not None
                                    and reg is not None
                                    and adapter in reg))
                    score = (int(rep.slow),
                             afar if adapter is not None else 0,
                             srv2.queue.depth + srv2.num_active(),
                             -(alloc.free_pages if alloc is not None
                               else 0))
                except Exception:
                    continue
                if best_score is None or score < best_score:
                    best, best_score, best_half = rep, score, half
            if best is not None and best_half:
                best.probing = True
            srv = best.server if best is not None else None
        for rep in flipped:   # gauge reflects the OPEN -> HALF_OPEN
            #                   flip even for candidates not picked
            self._breaker_metric(rep)
            if trace.enabled():
                trace.event("breaker", replica=rep.index,
                            state="half_open",
                            router=self.monitor_router)
        if best is None:
            return None, None, False
        return best, srv, best_half

    def _all_dead(self) -> bool:
        with self._lock:
            return all(rep.dead for rep in self._replicas)

    def _live_indices(self) -> set:
        with self._lock:
            return {rep.index for rep in self._replicas
                    if not rep.dead}

    # -- the per-request pump ------------------------------------------------
    def _run_request(self, h: RouterHandle) -> None:
        try:
            self._pump(h)
        except BaseException as e:   # noqa: BLE001 - client must not hang
            h._finish(FAILED, e)
            self._count("failed", h.replica)
        finally:
            with self._lock:
                self._handles.discard(h)
            with self._idle_cv:
                self._idle_cv.notify_all()

    def _pump(self, h: RouterHandle) -> None:
        """Own one request end to end: pick a replica, submit
        ``prompt + tokens streamed so far`` with the remaining budget,
        relay the inner stream into the router handle, and on a
        replica-attributed failure park nothing — fail over
        immediately (bounded by ``max_failovers``). Greedy failover is
        bitwise-identical to an unfaulted run: the resubmit is a
        causal re-prefill of the exact emitted prefix, the same
        argument (and test bar) as the in-engine replay."""
        last_err = None
        exclude: set = set()
        nofit: set = set()   # replicas whose CAPACITY verdict said
        #                      this request can never fit there
        #                      (heterogeneous fleets: per-spec, not
        #                      per-fleet)
        while True:
            with self._lock:
                stopping = self._stopping
            if stopping or h._cancel_requested:
                h._finish(CANCELLED)
                self._count("cancelled", h.replica)
                return
            if (h.deadline is not None and not h._ever_admitted
                    and time.monotonic() >= h.deadline):
                h._finish(EXPIRED)
                self._count("expired", h.replica)
                return
            done = h.tokens_so_far()
            remaining = h.cfg.max_new_tokens - len(done)
            if remaining < 1:   # budget fully streamed before the
                #                 failover landed: simply finished
                h._finish(FINISHED)
                self._count("completed", h.replica)
                return
            rep, srv, probe = self._acquire(
                exclude, hard=frozenset(nofit),
                adapter=getattr(h.cfg, "adapter", None),
                headroom_s=(None if h.deadline is None
                            else h.deadline - time.monotonic()))
            if rep is None:
                if self._all_dead():
                    h._finish(FAILED, FleetUnavailable(
                        f"request {h.id}: every replica is permanently "
                        f"dead (last error: {last_err!r})"))
                    self._count("failed", h.replica)
                    return
                if nofit and self._live_indices() <= nofit:
                    # every replica that could ever come back has
                    # already given a capacity verdict: terminal
                    h._finish(FAILED, last_err or RequestFailed(
                        f"request {h.id} fits no replica"))
                    self._count("failed", h.replica)
                    return
                # transient: all replicas warming / restarting /
                # breaker-open — wait, bounded by the deadline check
                # at the top of the loop
                time.sleep(self.retry_wait_s)
                exclude = set()
                continue
            ids = (np.concatenate(
                [_prompt_ids(h.prompt)[0],
                 np.asarray(done, np.int32)])
                if done else h.prompt)
            kw = dict(vars(h.cfg))
            kw["max_new_tokens"] = remaining
            rcfg = GenerationConfig(**kw)
            # admission deadline: only until the FIRST successful
            # admission (the replay semantics — met once is met)
            t_s = None
            if h.deadline is not None and not h._ever_admitted:
                t_s = max(h.deadline - time.monotonic(), 1e-3)
            try:
                inner = srv.submit(ids, rcfg, priority=h.priority,
                                   timeout_s=t_s,
                                   trace_rid=h._trace_rid,
                                   tenant=h.tenant)
            except RequestRejected as e:
                # replica-attributed only when the REPLICA is the
                # problem; queue_full is load, not sickness — routing
                # just looks elsewhere
                if e.reason in ("degraded", "shutdown"):
                    self._replica_failure(rep, srv, e, probe)
                else:
                    self._clear_probe(rep, srv, probe)
                last_err = e
                exclude = {rep.index}
                # NOT counted on the router requests counter: every
                # other outcome there is per-request-terminal, and a
                # waiting pump retries ~50x/s — the replica's own
                # serving_requests_total{event=rejected_*} already
                # counts backpressure per attempt
                # honor the replica's Retry-After before re-routing to
                # IT: the reject window keeps _acquire off this
                # replica until the hint elapses (bounded), while the
                # pump itself stays on its fast tick so a healthy
                # sibling picks the request up immediately
                if getattr(e, "retry_after_s", None) is not None:
                    with self._lock:
                        self._reject_until[rep.index] = (
                            time.monotonic()
                            + min(max(float(e.retry_after_s), 0.0),
                                  2.0))
                # a rejection (queue_full on every replica, say) must
                # not busy-spin the pump: one retry tick of backoff
                time.sleep(self.retry_wait_s)
                continue
            except ValueError as e:   # capacity verdict: this request
                #                       can never fit THIS replica
                self._clear_probe(rep, srv, probe)
                if self._homogeneous:
                    # same spec everywhere: the verdict is fleet-wide
                    h._finish(FAILED, e)
                    self._count("failed", rep.index)
                    return
                nofit.add(rep.index)
                last_err = e
                continue   # a larger-spec replica may still hold it;
                #            the no-replica branch above terminals
                #            once every live replica has said no
            except Exception as e:    # server died mid-submit
                self._replica_failure(rep, srv, e, probe)
                last_err = e
                exclude = {rep.index}
                continue
            h._inner = inner
            h.replica = rep.index
            if h._cancel_requested:
                inner.cancel()
            if trace.enabled():
                trace.event("route", rid=h._trace_rid,
                            replica=rep.index,
                            failovers=h._failovers,
                            resubmit=bool(done),
                            router=self.monitor_router)
            verdict, err = self._relay(h, rep, srv, inner, probe)
            if verdict == "finished":
                h._finish(FINISHED)
                self._count("completed", rep.index)
                return
            if verdict == "cancelled":
                self._clear_probe(rep, srv, probe)
                h._finish(CANCELLED)
                self._count("cancelled", rep.index)
                return
            if verdict == "expired":
                self._clear_probe(rep, srv, probe)
                h._finish(EXPIRED)
                self._count("expired", rep.index)
                return
            if verdict == "terminal":
                self._clear_probe(rep, srv, probe)
                if not self._homogeneous:
                    # per-replica capacity verdict (PagePoolExhausted
                    # is pool-size-dependent): a roomier spec may
                    # still serve the request
                    nofit.add(rep.index)
                    last_err = err
                    continue
                h._finish(FAILED, err)
                self._count("failed", rep.index)
                return
            # verdict == "failover" (the replica died/degraded under a
            # live request — breaker-accountable) or "overload" (a
            # pressure verdict: migrate, but the replica stays in good
            # standing). Both consume the failover budget: a request
            # bouncing between pressured pools must still terminate,
            # and FailoverBudgetExceeded chains the pressure cause.
            if verdict == "overload":
                self._clear_probe(rep, srv, probe)
            else:
                self._replica_failure(rep, srv, err, probe)
            with self._lock:
                stopping = self._stopping
            if stopping or h._cancel_requested:
                continue   # loop head finishes it CANCELLED (a fleet
                #            shutdown is not a failover)
            h._failovers += 1
            with self._lock:
                self._failovers_total += 1
            self._count("failover", rep.index)
            if monitor.enabled():
                self._failovers_counter().labels(
                    router=self.monitor_router).inc()
            if trace.enabled():
                trace.event("failover", rid=h._trace_rid,
                            replica=rep.index, n=h._failovers,
                            emitted=len(h.tokens_so_far()),
                            cause=repr(err),
                            router=self.monitor_router)
            if h._failovers > self.max_failovers:
                h._finish(FAILED, FailoverBudgetExceeded(
                    f"request {h.id} failed over {h._failovers} times "
                    f"(max_failovers={self.max_failovers}); last "
                    f"replica fault: {err!r}"))
                self._count("failed", rep.index)
                return
            last_err = err
            exclude = {rep.index}

    @staticmethod
    def _wait_progress(inner, sent: int, timeout: float):
        """Wait (bounded) for the inner handle to grow past ``sent``
        tokens or reach a terminal state; returns
        ``(delta, status, err)`` read atomically under the handle's
        condition — at a terminal state the delta IS everything that
        remains, so a failover's resubmit prefix is never torn."""
        with inner._cv:
            inner._cv.wait_for(
                lambda: (len(inner._tokens) > sent
                         or inner._status in _TERMINAL), timeout)
            return (list(inner._tokens[sent:]), inner._status,
                    inner._error)

    def _relay(self, h: RouterHandle, rep: _Replica, srv, inner,
               probe: bool):
        """Relay one inner handle's tokens into the router handle.
        Returns ``(verdict, err)`` with verdict one of ``finished`` /
        ``cancelled`` (user cancel) / ``expired`` / ``terminal``
        (request-scoped failure any replica would repeat) /
        ``failover`` (replica-attributed — resubmit elsewhere)."""
        sent = 0
        got_any = False
        while True:
            delta, status, err = self._wait_progress(
                inner, sent, self.degraded_poll_s)
            if (inner.engine_rid is not None
                    and h.engine_rid != inner.engine_rid):
                # the replica COMPLETED this request's admission: the
                # admission deadline is met (the replay semantics —
                # met once is met), so a later failover must REPLAY,
                # never expire, it — even if the replica dies between
                # admission and the first token reaching the pump.
                # The ROUTER handle goes RUNNING here too, tracking
                # the CURRENT engine rid (same client surface as
                # RequestHandle: status must not read "queued" while
                # tokens stream)
                h._ever_admitted = True
                h._mark_running(inner.engine_rid)
            if delta:
                sent += len(delta)
                h._push(delta)
                h._n_pushed += len(delta)
                if not got_any:
                    got_any = True
                    # first token = the replica admitted AND decoded:
                    # the half-open probe's success signal (don't hold
                    # the breaker hostage to a long generation)
                    self._replica_success(rep, srv, probe)
            if status == FINISHED:
                self._replica_success(rep, srv, probe)
                return "finished", None
            if status == CANCELLED:
                # either the user asked, or the replica cancelled it
                # on its way down (shutdown finalizer) — the latter is
                # a failover
                if h._cancel_requested:
                    return "cancelled", None
                return "failover", RuntimeError(
                    f"replica {rep.index} cancelled the request on "
                    "its way down")
            if status == EXPIRED:
                return "expired", None
            if status == FAILED:
                if isinstance(err, (ValueError, PagePoolExhausted)):
                    # request-scoped capacity verdict: identical
                    # replicas would all repeat it — fail the request,
                    # spare the fleet
                    return "terminal", err
                if isinstance(err, PreemptionBudgetExceeded):
                    # a LOAD verdict, not sickness (the replica is
                    # healthy, its pool is just thrashing): migrate
                    # the request — another replica may have room —
                    # but do NOT blame the breaker, or a pressured
                    # fleet walls off its own healthy replicas and
                    # cascades the load onto equally pressured peers
                    return "overload", err
                return "failover", (err if err is not None
                                    else RequestFailed(
                                        f"replica {rep.index} failed "
                                        "the request"))
            if not delta:
                # a silent poll tick: re-check the replica's health
                # instead of waiting on a corpse — this is how a
                # DEGRADED (stalled) replica loses its live requests
                # before its own watchdog even recovers
                st = srv.status
                if st in ("degraded", "failed", "stopped"):
                    inner.cancel()   # if it un-wedges, reclaim there
                    return "failover", RuntimeError(
                        f"replica {rep.index} {st} mid-stream")
                if h._cancel_requested:
                    inner.cancel()

    # -- replica supervision (monitor thread) --------------------------------
    def _monitor_loop(self) -> None:
        """Restart crashed/failed replicas from their spec with
        exponential backoff. Detection: ``Server.status`` in
        ``failed``/``stopped`` outside a deliberate drain/restart.
        Budget: ``max_replica_restarts`` per replica; past it the
        replica is DEAD (breaker pinned open, fleet serves on).
        The SKEW DETECTOR rides the same thread on its own (coarser)
        cadence — reading N rolling digests is host work, but not
        every-50ms work."""
        last_skew = 0.0
        last_elastic = 0.0
        while not self._stop_evt.wait(self.monitor_interval_s):
            for rep in list(self._replicas):
                self._supervise(rep)
            now = time.monotonic()
            if now - last_skew >= self.skew_interval_s:
                last_skew = now
                try:
                    self._check_skew()
                except Exception:
                    # skew is ADVISORY: a torn read off a mid-rebuild
                    # replica (or a dump-path surprise) must never
                    # kill the supervision thread that restarts
                    # crashed replicas
                    pass
            if (self._elastic is not None
                    and now - last_elastic >= self.elastic_interval_s):
                last_elastic = now
                try:
                    self._elastic_tick(now)
                except Exception:
                    # same bar as skew: sizing is advisory, crash
                    # supervision must keep running
                    pass

    def _check_skew(self) -> None:
        """Slow-replica skew detection (monitor thread): compare each
        live replica's rolling-window TPOT p50 (the SLO tracker's
        :meth:`~paddle_tpu_torch.monitor.slo.SLOTracker.rolling_tpot_p50`)
        against the fleet median of the OTHER judged replicas' p50s —
        leave-one-out, so a lagging replica cannot drag its own
        baseline up, and a 2-replica fleet stays detectable (a global
        median over two is the mean of both, which ``p > factor ×
        median`` could never exceed at ``factor >= 2``). A replica
        above ``skew_factor``× its peers' median flips SLOW. This is the failure
        mode the circuit breakers are blind to: a replica that is
        *slow but alive* (thermal throttling, a neighbour hogging the
        host, a wedged-but-recovering pool) answers every request and
        never trips a failure counter — but it drags the fleet p99.
        SLOW is a ROUTING HINT, not a wall: the replica scores behind
        every non-slow candidate in ``_acquire`` yet stays routable
        (slow ≠ open breaker), surfaces in ``load()``/``GET /stats``,
        and the flip dumps the flight recorder (one dump per flip —
        the black box alongside the Server's storm/stall triggers).

        A replica needs ``skew_min_requests`` TPOT observations inside
        the rolling window to be judged (a starved or freshly
        restarted replica reads UNKNOWN → not slow), and a verdict
        needs >= 1 OTHER judged replica — a fleet of one has nothing
        to skew against."""
        with self._lock:
            reps = list(self._replicas)
        p50s = {}
        for rep in reps:
            if rep.dead or rep.restart_at is not None:
                continue
            tracker = getattr(rep.server, "slo", None)
            if tracker is None:
                continue
            try:
                p = tracker.rolling_tpot_p50(
                    min_count=self.skew_min_requests)
            except Exception:   # mid-swap replica: skip this round
                p = None
            if p is not None:
                p50s[rep.index] = p
        for rep in reps:
            p = p50s.get(rep.index)
            others = [v for i, v in p50s.items() if i != rep.index]
            med = statistics.median(others) if others else None
            slow = (med is not None and med > 0 and p is not None
                    and p > self.skew_factor * med)
            with self._lock:
                changed = (not rep.dead and rep.slow != slow)
                if changed:
                    rep.slow = slow
            if not changed:
                continue
            self._slow_metric(rep)
            if trace.enabled():
                trace.event("replica.slow", replica=rep.index,
                            slow=slow,
                            tpot_p50_s=(None if p is None
                                        else round(p, 6)),
                            fleet_median_s=(None if med is None
                                            else round(med, 6)),
                            factor=self.skew_factor,
                            router=self.monitor_router)
            if slow:
                self._flight_dump(f"replica_slow_{rep.index}")

    # -- elastic fleet sizing (monitor thread / scale_to) --------------------
    def _elastic_signals(self):
        """Host-side autoscaler inputs: the currently-serving replica
        records, their summed queue depth + active work, and the
        hottest tenant fast-burn rate across their SLO trackers (0.0
        while the monitor is off or no window has data). All
        lock-light reads — same discipline as routing."""
        with self._lock:
            serving = [rep for rep in self._replicas
                       if not (rep.dead or rep.draining
                               or rep.scaled_down
                               or rep.restart_at is not None)]
        depth = 0
        burn = 0.0
        for rep in serving:
            try:
                depth += rep.server.queue.depth + rep.server.num_active()
            except Exception:   # mid-swap replica: skip its numbers
                continue
            if monitor.enabled():
                tracker = getattr(rep.server, "slo", None)
                if tracker is not None:
                    try:
                        burn = max(burn,
                                   max_burn(tracker.tenant_stats()))
                    except Exception:
                        pass
        return serving, depth, burn

    def _elastic_tick(self, now: float) -> None:
        """One autoscaler pass (supervisor thread): feed occupancy +
        queue depth + burn into the :class:`ElasticController` —
        which owns the hysteresis (consecutive-signal streaks) and
        the rate limit (cooldown) — and apply at most ONE replica of
        change. Scale-down drains (never kills in-flight work);
        scale-up revives a parked slot from its own spec."""
        serving, depth, burn = self._elastic_signals()
        d = self._elastic.decide(now, routable=len(serving),
                                 queue_depth=depth, burn_max=burn)
        if d > 0:
            self._scale_up(depth=depth, burn=burn)
        elif d < 0:
            self._scale_down(depth=depth, burn=burn)

    def _scale_down(self, depth: int = 0, burn: float = 0.0):
        """Park the least-loaded serving replica: excluded from
        routing immediately (draining), then drained WITHOUT a
        timeout on a helper thread — every queued + in-flight request
        runs to completion (the rolling-restart bar: elastic
        scale-down never fails a handle) — and only then shut down.
        The slot stays in the fleet as ``scaled_down`` so a later
        scale-up revives it from ITS spec (device pinning included).
        Returns the drain thread, or None if no replica can be
        spared."""
        with self._lock:
            cands = [rep for rep in self._replicas
                     if not (rep.dead or rep.draining
                             or rep.scaled_down
                             or rep.restart_at is not None)]
            if len(cands) < 2:   # never park the last serving replica
                return None

            def _load(rep):
                try:
                    return (rep.server.queue.depth
                            + rep.server.num_active())
                except Exception:
                    return 0

            # least-loaded victim (fewest requests to wait out), ties
            # to the highest index — deterministic under equal load
            victim = min(cands, key=lambda r: (_load(r), -r.index))
            victim.draining = True
            victim.scaled_down = True
            srv = victim.server
        if trace.enabled():
            trace.event("control.scale", action="down",
                        replica=victim.index,
                        queue_depth=depth, burn=round(burn, 3),
                        router=self.monitor_router)
        if monitor.enabled():
            self._scale_counter().labels(
                router=self.monitor_router, action="down").inc()
        self._replicas_metric()
        t = threading.Thread(
            target=self._finish_scale_down, args=(victim, srv),
            daemon=True,
            name=f"paddle_tpu-router-scaledown-{self.monitor_router}"
                 f"-{victim.index}")
        t.start()
        return t

    def _finish_scale_down(self, rep: _Replica, srv) -> None:
        """Drain-then-stop half of a scale-down (helper thread): the
        unbounded drain is the point — in-flight work finishes no
        matter how long it decodes; only an empty server stops."""
        try:
            srv.drain(None)
        except Exception:
            pass
        try:
            srv.shutdown(drain=False, timeout=5.0)
        except Exception:
            pass
        try:
            eng = getattr(srv, "engine", None)
            if eng is not None:
                eng.close()
        except Exception:
            pass

    def _scale_up(self, depth: int = 0, burn: float = 0.0,
                  timeout: Optional[float] = None) -> bool:
        """Revive the lowest-index parked (scaled-down) slot: rebuild
        from its spec OUTSIDE the lock (same as supervised restarts —
        routing never blocks on a build), wait for warmup, swap it in
        with a clean breaker. Returns True when a slot was revived
        (False: nothing parked, or a racing shutdown/restart won)."""
        with self._lock:
            parked = [rep for rep in self._replicas
                      if rep.scaled_down and not rep.dead]
            if not parked or self._stopping:
                return False
            rep = min(parked, key=lambda r: r.index)
            old = rep.server
        new = rep.spec.build()
        new.wait_ready(timeout)
        with self._lock:
            if (self._stopping or rep.dead or not rep.scaled_down
                    or rep.server is not old):
                stale = new   # a shutdown/deliberate-restart won the
                #               race mid-build: its server stays
            else:
                stale = None
                rep.reset_health(server=new)
                rep.draining = False
                rep.scaled_down = False
        if stale is not None:
            try:
                stale.shutdown(drain=False, timeout=5.0)
            except Exception:
                pass
            return False
        self._breaker_metric(rep)
        self._slow_metric(rep)
        self._replicas_metric()
        if trace.enabled():
            trace.event("control.scale", action="up",
                        replica=rep.index,
                        queue_depth=depth, burn=round(burn, 3),
                        router=self.monitor_router)
        if monitor.enabled():
            self._scale_counter().labels(
                router=self.monitor_router, action="up").inc()
        return True

    def scale_to(self, n: int, timeout: Optional[float] = None) -> int:
        """Deliberately size the fleet to ``n`` serving replicas
        (clamped to ``[1, len(specs)]``), bypassing the autoscaler's
        hysteresis — the operator knob (and the deterministic test
        surface). Scale-downs drain on helper threads; with
        ``timeout`` the call waits (bounded) for those drains. Returns
        the serving-replica count after the call."""
        n = max(1, min(n, len(self._replicas)))
        threads = []
        while True:
            with self._lock:
                serving = sum(1 for r in self._replicas
                              if not (r.dead or r.draining
                                      or r.scaled_down
                                      or r.restart_at is not None))
            if serving > n:
                t = self._scale_down()
                if t is None:
                    break
                threads.append(t)
            elif serving < n:
                if not self._scale_up(timeout=timeout):
                    break
            else:
                break
        for t in threads:
            t.join(timeout)
        with self._lock:
            return sum(1 for r in self._replicas
                       if not (r.dead or r.draining or r.scaled_down
                               or r.restart_at is not None))

    def _supervise(self, rep: _Replica) -> None:
        now = time.monotonic()
        with self._lock:
            if (self._stopping or rep.dead or rep.draining):
                return
            srv = rep.server
            pending = rep.restart_at
        if pending is None:
            if srv.status not in ("failed", "stopped"):
                return
            with self._lock:
                if rep.server is not srv or rep.draining:
                    return
                if rep.restarts >= self.max_replica_restarts:
                    rep.mark_dead()
                    self._breaker_metric(rep)
                    self._slow_metric(rep)   # mark_dead cleared slow
                    if trace.enabled():
                        trace.event(
                            "replica.dead", replica=rep.index,
                            restarts=rep.restarts,
                            router=self.monitor_router)
                    return
                rep.restarts += 1
                delay = self._backoff_delay(rep.restarts)
                rep.restart_at = now + delay
            if trace.enabled():
                trace.event("replica.backoff", replica=rep.index,
                            restarts=rep.restarts,
                            delay_s=round(delay, 4),
                            router=self.monitor_router)
            return
        if now < pending:
            return
        # backoff elapsed: rebuild OUTSIDE the lock (engine/device
        # construction takes real time; routing must not block on it).
        # The dead replica's engine is closed first: its monitor series
        # retire before the fresh engine publishes its own
        try:
            try:
                srv.shutdown(drain=False, timeout=2.0)
            except Exception:
                pass
            try:
                eng = getattr(srv, "engine", None)
                if eng is not None:
                    eng.close()
            except Exception:
                pass
            new = rep.spec.build()
        except Exception as e:
            with self._lock:
                if (rep.server is not srv or rep.draining
                        or self._stopping):
                    return   # the slot changed hands mid-build (a
                    #          deliberate restart/shutdown): not ours
                    #          to mark dead or re-schedule
                if rep.restarts >= self.max_replica_restarts:
                    rep.mark_dead()
                else:
                    rep.restarts += 1
                    rep.restart_at = (time.monotonic()
                                      + self._backoff_delay(
                                          rep.restarts))
            self._breaker_metric(rep)
            self._slow_metric(rep)   # the mark_dead branch cleared slow
            if trace.enabled():
                trace.event("replica.rebuild_failed",
                            replica=rep.index, cause=repr(e),
                            router=self.monitor_router)
            return
        with self._lock:
            if rep.server is not srv or rep.draining or self._stopping:
                stale = new   # a deliberate restart_replica (or a
                #               shutdown) won the race while we built:
                #               ITS server stays — ours must not
                #               silently replace and leak it
            else:
                stale = None
                rep.reset_health(server=new)
        if stale is not None:
            try:
                stale.shutdown(drain=False, timeout=5.0)
            except Exception:
                pass
            return
        self._breaker_metric(rep)
        self._slow_metric(rep)   # reset_health cleared slow out of band
        if monitor.enabled():
            self._restarts_counter().labels(
                router=self.monitor_router,
                replica=str(rep.index)).inc()
        if trace.enabled():
            trace.event("replica.restart", replica=rep.index,
                        restarts=rep.restarts, deliberate=False,
                        router=self.monitor_router)

    def _backoff_delay(self, restarts: int) -> float:
        """Exponential supervised-restart backoff before attempt
        ``restarts`` (1-based), capped at
        ``replica_backoff_max_s``."""
        return min(self.replica_backoff_s * (2 ** (restarts - 1)),
                   self.replica_backoff_max_s)
