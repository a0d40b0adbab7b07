"""Online continuous-batching scheduler: :class:`Server`.

Port of ``paddle_tpu/serving/scheduler.py``. A dedicated scheduler THREAD
owns a ``ContinuousBatchingEngine`` / ``PagedContinuousBatchingEngine`` and
drives the stepwise API (``add_request`` / ``decode_segment`` /
``collect_finished``) in an Orca-style iteration loop:

    gap:   apply cancellations → advance an in-flight CHUNKED admission
           by ONE fixed-shape prefill chunk → reap expired → re-admit
           REPLAYS surviving an engine restart → admit from the queue
           (capacity probed via the engine's public ``can_admit`` /
           ``free_slots``, never by catching add_request's
           RuntimeError); prompts longer than the engine's
           ``prefill_chunk`` admit chunk-by-chunk across gaps, so a
           long prompt never monopolizes the gap and running requests'
           TPOT stays flat → relieve KV memory pressure (optimistic
           paged admission: grow every live slot's pages for the coming
           segment, preempting victims while the pool is dry)
    step:  one decode segment over every occupied slot (on the card, the
           replay of the segment's captured CUDA graph)
    drain: stream new tokens to handles, finish retired requests

Admission happens only in the inter-segment gap, so a transiently full
pool defers work instead of failing it; cancellation retires the slot in
the same gap, so the pool is reclaimed, never leaked. Backpressure is
the bounded queue: ``submit`` on a full queue raises
:class:`~paddle_tpu_torch.serving.queue.QueueFull` (the HTTP layer's 429).

FAULT ISOLATION (the blast-radius contract):

- a REQUEST-scoped fault (a prompt the engine chokes on, a prefill error:
  :func:`~paddle_tpu_torch.inference.generation.classify_fault`) finishes
  ONLY that handle as FAILED with its cause; the engine's admission abort
  guards already reclaimed the slot and pages, and the loop keeps
  serving everyone else;
- an ENGINE-scoped fault (an error inside ``decode_segment``) triggers
  SUPERVISED RECOVERY: exponential backoff, then ``engine.reset_state()``
  resets the device state in place (captured graphs kept), and every
  in-flight request REPLAYS, re-prefilling ``prompt + tokens emitted so
  far`` through the same bucketed/chunked admission and continuing where
  it left off. Restarts are bounded by ``max_restarts`` (server lifetime)
  and per-request replays by ``max_replays``; past either bound the fatal
  ``_finalize`` path fails what remains, loudly;
- a STALL (a wedged step that can't announce itself) is caught by the
  watchdog thread: ``stall_timeout_s`` without a loop heartbeat flips
  ``status``/``/healthz`` to ``degraded`` (503) until the loop beats
  again.

Recovery covers faults that leave the CUDA context usable: an injected
fault, or a Python exception raised at a seam. A sticky CUDA error (an
illegal address, a device-side assert) poisons the context: the decode
segment's read-back raises, recovery's ``reset_state()`` raises again, and
the loop ends in ``_finalize``, which fails every handle it holds with the
cause (and touches the engine no more). It never hangs.

MEMORY PRESSURE (paged engine, ``admission_mode="optimistic"``): a
preempted request's slot and pages are reclaimed at once and its handle
parks on the same replay list as an engine restart's, re-admitting through
the normal bucketed/chunked prefill with its tokens intact; a request is
preempted at most ``max_preemptions`` times (past that it fails with
:class:`PreemptionBudgetExceeded`), and one the pool cannot hold even alone
fails ALONE with ``PagePoolExhausted``. ``pressure()``/``/healthz`` report
occupancy, parked-waiting counts, the preemption total and the prefix
cache's counters.

Replays. A greedy replay re-prefills prompt plus emitted tokens as one
longer prompt, at another bucket width than the tokens were decoded at;
on the card cuBLAS picks its GEMM algorithms by M, so a replayed greedy
stream can part from the uninterrupted one at a near-tie
(``chip_smoke.py`` reports where; on the CPU, with the plain kernels, the
tests hold them equal). A SAMPLED request differs from the reference: the
port draws a token by a hash of (seed, position) (``inference/sampling.py``),
so a replayed sampled request continues on the SAME stream it was on,
where the reference's continues on a fresh noise stream.

Thread model: the engine is touched by the scheduler thread ONLY (warmup,
graph capture and replay, recovery and replay included: PyTorch's current
stream is per thread, and the engine's graphs run on that thread's).
The watchdog thread only reads the heartbeat and flips flags.
``submit``/``cancel``/``drain``/``shutdown`` are thread-safe entry points
that communicate through the queue, handle flags, and a wake event.

Multi-tenant LoRA: :meth:`Server.load_adapter` / ``unload_adapter`` are
thread-safe; each is queued and applied by the scheduler thread as the first
step of the next inter-segment gap (before cancellations and admissions,
so a load is visible to that gap's admissions), and its result or error
goes back to the caller. The engine needs ``lora_capacity > 0``.

KV-page handoff: :meth:`Server.export_kv` / ``import_kv`` are admin ops of
the same kind, applied in the gap (a paged engine with ``prefix_cache=True``).

The program ledger (``FLAGS_enable_ledger``): :meth:`Server.profile` is the
engine's shard of ``monitor.ledger.profile`` (``GET /profile``), and
:meth:`Server.load` carries a compact block of it.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Optional

import numpy as np

from .. import monitor
from .. import tracing as trace
from ..monitor import ledger as _ledger
from ..monitor import slo as _slo
from ..inference.generation import (ADMISSION_MODES, SPEC_MODES,
                                    GenerationConfig, PagePoolExhausted,
                                    _prompt_ids, _prompt_len,
                                    classify_fault)
from .control import RUNG_ACTIONS, ControlPlane, ControlPolicy
from .queue import (CANCELLED, EXPIRED, FAILED, FINISHED, QueueFull,
                    RequestHandle, RequestQueue, RequestRejected)

__all__ = ["Server", "PreemptionBudgetExceeded"]


class PreemptionBudgetExceeded(RuntimeError):
    """A request was preempted under KV memory pressure more often than
    its ``max_preemptions`` budget allows: it is THRASHING (admitted,
    preempted, replayed, preempted again...) and fails with this as its
    cause instead of cycling through the pool forever."""


class _EngineFaultSignal(Exception):
    """Internal: an engine-scoped fault crossing from a guarded seam to
    the loop's recovery handler (never escapes the Server). ``handle``
    rides along when a specific request's admission triggered it — that
    request joins the replay set instead of being stranded."""

    def __init__(self, site: str, cause: BaseException,
                 handle: Optional[RequestHandle] = None):
        super().__init__(f"engine fault at {site}: {cause!r}")
        self.site = site
        self.cause = cause
        self.handle = handle


class Server:
    """Thread-driven online server over a continuous-batching engine.

    Usage::

        eng = PagedContinuousBatchingEngine(model, max_batch=4,
                                            num_pages=64, page_size=16,
                                            max_pages=32)
        srv = Server(eng, max_queue=64, segment_steps=8)
        h = srv.submit(prompt_ids, GenerationConfig(max_new_tokens=64))
        for tok in h.stream():      # tokens arrive segment by segment
            ...
        srv.shutdown()

    ``submit`` rejects (raises) when the queue is full or the server is
    draining/degraded — the reject-with-reason backpressure contract; a
    request whose prompt can NEVER fit the engine fails fast with
    ValueError. ``drain()`` stops admission of new submissions and
    waits for in-flight + queued work to finish; ``shutdown()``
    optionally drains, then cancels whatever remains and stops the
    thread.

    ``warmup=True`` runs ``engine.warmup(segment_steps)`` in the
    scheduler thread before the loop starts: the decode segment of this
    server's length captured (greedy and sampled), every prefill bucket
    and the chunk program run once, so no user request pays a capture
    or a first launch.
    ``status``/``/healthz`` report ``warming`` until done (submissions
    queue meanwhile); gate traffic on :meth:`wait_ready`. When the
    engine was built with ``prefill_chunk``, prompts longer than the
    chunk admit one fixed-shape chunk per inter-segment gap with decode
    segments interleaved — a long prompt never stalls running requests.

    Fault-isolation knobs:

    - ``max_restarts`` — supervised engine restarts the server will
      attempt over its LIFETIME before an engine-scoped fault falls
      through to the fatal path (like a supervisor's restart
      intensity);
    - ``restart_backoff_s`` / ``restart_backoff_max_s`` — exponential
      backoff before restart *n* sleeps
      ``min(restart_backoff_s * 2**(n-1), restart_backoff_max_s)``;
    - ``max_replays`` — engine restarts any ONE request may survive;
      past it the request fails with the fault as its cause;
    - ``stall_timeout_s`` — arm the stall watchdog (None = off): a
      scheduler step exceeding it flips status to ``degraded`` until
      the loop beats again. Without ``warmup=True`` the first segment's
      graph capture runs inside a step: set the timeout above it, or
      warm up. The watchdog never arms during warmup.

    Engine knobs:

    - ``admission_mode`` — convenience mirror of the paged engine's
      knob (``"reserved"``/``"optimistic"``), set on an idle engine;
    - ``max_preemptions`` — memory-pressure preemptions any ONE request
      may survive (optimistic mode); past it the request fails with
      :class:`PreemptionBudgetExceeded`;
    - ``kv_dtype`` — convenience mirror of the paged engine's KV
      storage dtype (``"bf16"``/``"int8"``; None leaves the engine's
      own setting), through its idle-only ``set_kv_dtype``. ``"int8"``
      stores KV pages int8 with per-(page, kv head) scales: half the
      decode read bytes at a BOUNDED (not bitwise) numerics contract;
      the swap rebuilds the pools and drops the captured graphs;
    - ``age_after_s`` — queue priority aging (None = strict static
      priority): a waiting request's effective priority improves one
      level per ``age_after_s`` seconds queued, so low-priority work
      cannot starve forever under sustained high-priority load.

    Speculative-decoding knobs (engines built with ``draft_k > 0``, or
    given one here; see the engines' ``decode_segment``):

    - ``draft_k`` — mirror of the engine's draft window (0 turns
      speculation off), set on an idle engine so warmup captures the
      verify program;
    - ``spec_mode`` — mirror of the engine's execution mode, ``"host"``
      (host proposers, one read a verify step) or ``"device"`` (one
      program a segment, drafts from the per-slot history ring);
    - ``speculative`` — True makes speculation the server's DEFAULT for
      greedy requests (``submit`` copies the config with
      ``speculative=True``); sampled requests decode plain, and a request
      can always opt in with ``GenerationConfig.speculative``. Brownout
      rung 3 (``spec_off``) clears it on future admissions.

    SLO & goodput (``paddle_tpu_torch.monitor.slo``, gated like every
    monitor seam on ``FLAGS_enable_monitor``):

    - the server always carries an :class:`SLOTracker` (``self.slo``)
      digesting TTFT / TPOT / queue-wait / e2e per (metric, tenant)
      into mergeable fixed-log-bucket digests, plus per-tenant token
      and KV-page-second cost counters — tenant is the ``submit``
      argument, defaulting to the request's LoRA ``cfg.adapter``;
      untenanted traffic aggregates under ``"-"``;
    - ``slo_policy`` (an :class:`~paddle_tpu_torch.monitor.slo.SLOPolicy`)
      additionally scores every service-terminal request: **goodput**
      (fraction meeting the thresholds; FAILED requests miss by
      definition, cancelled/expired are client verdicts and don't
      count) and fast/slow **burn-rate** windows per tenant;
    - read it via ``load()``'s ``slo`` block (``/healthz``) or
      :meth:`stats` (the ``GET /stats`` shape, which a fleet rollup
      merges with a JAX replica's: the digests' wire format is the
      reference's).

    ``control_policy`` (a :class:`~paddle_tpu_torch.serving.control.
    ControlPolicy`) turns on the overload control plane: burn-rate
    shedding at submit (429 + Retry-After), the brownout ladder and quota
    tightening, all host-side in the gap.

    Tracing & flight recorder (``paddle_tpu_torch.tracing``, enabled via
    ``FLAGS_enable_trace``): every lifecycle seam the scheduler drives
    records a structured event keyed by the request — queue
    enqueue/dequeue/expire, the admission span (with the prefill
    bucket) and each chunked-prefill chunk, gap spans, decode segments
    (with the live request set), replay / restart / backoff, and fault
    classification. Read one request's ordered timeline via
    ``handle.timeline()`` / :meth:`request_timeline` / HTTP
    ``GET /trace?rid=``. The scheduler AUTO-DUMPS the trace ring (the
    flight recorder) on engine-scoped faults, watchdog ``degraded``
    flips, a dying scheduler and shed storms; dump paths surface in
    :meth:`fault_stats` under ``flight_dumps`` and as ``/healthz``'s
    ``flight_dump`` field. Neither the monitor nor the trace seams read
    the device, and none catches an error of the engine's.
    """

    # preemption-storm flight-dump trigger: this many preemptions inside
    # the sliding window dumps the ring once per window — no single
    # preemption is a fault, but a thrashing pool is a postmortem's state
    STORM_PREEMPTS = 8
    STORM_WINDOW_S = 5.0

    # shed-storm flight-dump trigger (control plane): this many shed
    # 429s inside the sliding window dumps the ring once per window —
    # each 429 is the control plane working as intended, but a reject
    # STORM is exactly the overload postmortem the black box exists for
    SHED_STORM = 8
    SHED_STORM_WINDOW_S = 5.0

    def __init__(self, engine, max_queue: int = 64,
                 segment_steps: int = 8,
                 idle_wait_s: float = 0.02, start: bool = True,
                 warmup: bool = False,
                 max_restarts: int = 3,
                 restart_backoff_s: float = 0.05,
                 restart_backoff_max_s: float = 2.0,
                 max_replays: int = 2,
                 stall_timeout_s: Optional[float] = None,
                 max_preemptions: int = 5,
                 admission_mode: Optional[str] = None,
                 age_after_s: Optional[float] = None,
                 draft_k: Optional[int] = None,
                 spec_mode: Optional[str] = None,
                 speculative: bool = False,
                 kv_dtype: Optional[str] = None,
                 tenant_quotas=None,
                 slo_policy=None,
                 control_policy=None):
        if stall_timeout_s is not None and stall_timeout_s <= 0:
            raise ValueError(
                f"stall_timeout_s must be > 0 or None, got "
                f"{stall_timeout_s!r}")
        if stall_timeout_s is not None \
                and stall_timeout_s < 2 * idle_wait_s:
            # an IDLE loop only beats every idle_wait_s (the _wake
            # wait), so a timeout at/below that cadence would flap a
            # perfectly healthy idle server into degraded
            raise ValueError(
                f"stall_timeout_s({stall_timeout_s}) must be >= twice "
                f"idle_wait_s({idle_wait_s}) — the idle loop only "
                "beats once per idle_wait_s")
        if max_restarts < 0 or max_replays < 0:
            raise ValueError("max_restarts/max_replays must be >= 0")
        if max_preemptions < 0:
            raise ValueError("max_preemptions must be >= 0")
        if draft_k is not None:
            # convenience mirror of the engine's draft window, set before
            # the scheduler thread starts so warmup captures the verify
            # program. getattr/setattr so a FaultyEngine proxy routes to
            # the wrapped engine.
            if (isinstance(draft_k, bool) or not isinstance(draft_k, int)
                    or not 0 <= draft_k <= 256):
                raise ValueError(
                    f"draft_k must be an int in [0, 256], got "
                    f"{draft_k!r}")
            if getattr(engine, "draft_k", None) is None:
                raise ValueError(
                    "draft_k needs a continuous-batching engine")
            if getattr(engine, "_slot_req", None):
                raise ValueError(
                    "draft_k can only be set on an idle engine")
            engine.draft_k = draft_k
        if spec_mode is not None:
            # convenience mirror of the engine's speculative execution
            # mode: "device" runs propose, verify and accept for a whole
            # segment in one program (drafts from the per-slot history
            # ring), so the gap no longer drives per-step host proposals.
            # Set before the scheduler thread starts so warmup captures
            # the mode's program (the fused segment needs segment_steps,
            # which warmup passes).
            if spec_mode not in SPEC_MODES:
                raise ValueError(
                    f"spec_mode must be one of {SPEC_MODES}, got "
                    f"{spec_mode!r}")
            if getattr(engine, "spec_mode", None) is None:
                raise ValueError(
                    "spec_mode needs a continuous-batching engine")
            if getattr(engine, "_slot_req", None):
                raise ValueError(
                    "spec_mode can only be set on an idle engine")
            engine.spec_mode = spec_mode
        if speculative and not getattr(engine, "draft_k", 0):
            raise ValueError(
                "speculative=True needs an engine built with "
                "draft_k > 0 (or pass Server(draft_k=...))")
        # speculative=True makes speculation the server's DEFAULT: every
        # eligible (greedy, not explicitly opted) request decodes
        # speculatively; a request's own GenerationConfig.speculative
        # still opts it in on a server without the default
        self.speculative = bool(speculative)
        if admission_mode is not None:
            # convenience mirror of the paged engine's knob: set it
            # here (before the scheduler thread starts) instead of at
            # engine construction. getattr/setattr so a FaultyEngine
            # proxy routes to the wrapped engine.
            if admission_mode not in ADMISSION_MODES:
                raise ValueError(
                    f"admission_mode must be one of {ADMISSION_MODES}, "
                    f"got {admission_mode!r}")
            if getattr(engine, "admission_mode", None) is None:
                raise ValueError(
                    "admission_mode needs a paged engine "
                    "(PagedContinuousBatchingEngine)")
            if getattr(engine, "_slot_req", None):
                raise ValueError(
                    "admission_mode can only be set on an idle engine")
            engine.admission_mode = admission_mode
        if kv_dtype is not None:
            # convenience mirror of the paged engine's KV storage
            # dtype (see PagedContinuousBatchingEngine kv_dtype):
            # routed through the engine's idle-only set_kv_dtype hook
            # — a dtype swap REBUILDS the pools, so a plain attribute
            # set would silently serve bf16 pools labeled int8.
            # Set before the scheduler thread starts so warmup
            # captures the new pools' segment programs.
            from ..quantization.kv import KV_DTYPES

            if kv_dtype not in KV_DTYPES:
                raise ValueError(
                    f"kv_dtype must be one of {KV_DTYPES}, got "
                    f"{kv_dtype!r}")
            set_fn = getattr(engine, "set_kv_dtype", None)
            if set_fn is None:
                raise ValueError(
                    "kv_dtype needs a paged engine "
                    "(PagedContinuousBatchingEngine)")
            if getattr(engine, "_slot_req", None):
                raise ValueError(
                    "kv_dtype can only be set on an idle engine")
            set_fn(kv_dtype)
        # per-tenant admission quotas (None = off): an int caps every
        # tenant's concurrently ADMITTED requests uniformly; a dict
        # caps the named tenants (others unlimited). A tenant over its
        # quota DEFERS in the queue — tenants behind it still admit
        # (RequestQueue.pop_admittable skips quota-deferred entries,
        # never capacity-blocked ones) — so one noisy tenant cannot
        # monopolize the engine's slots or starve its neighbours.
        if tenant_quotas is not None:
            if isinstance(tenant_quotas, bool) or not (
                    isinstance(tenant_quotas, int)
                    or isinstance(tenant_quotas, dict)):
                raise ValueError(
                    f"tenant_quotas must be None, a positive int, or a "
                    f"dict {{tenant: cap}}, got {tenant_quotas!r}")
            caps = (tenant_quotas.values()
                    if isinstance(tenant_quotas, dict)
                    else (tenant_quotas,))
            if any(isinstance(c, bool) or not isinstance(c, int)
                   or c < 1 for c in caps):
                raise ValueError(
                    f"tenant quota caps must be ints >= 1, got "
                    f"{tenant_quotas!r}")
        self.tenant_quotas = tenant_quotas
        if slo_policy is not None and not isinstance(slo_policy,
                                                     _slo.SLOPolicy):
            raise ValueError(
                f"slo_policy must be a monitor.slo.SLOPolicy or None, "
                f"got {slo_policy!r}")
        # SLO/goodput tracker (monitor.slo): mergeable
        # per-(metric, tenant) latency digests + per-tenant cost
        # accounting, always constructed (a cheap host object) but
        # only FED while FLAGS_enable_monitor is on — the disabled
        # serving path pays one bool branch per seam, nothing else.
        # slo_policy additionally scores each finished request into
        # goodput + fast/slow burn-rate windows. Read via load()'s
        # ``slo`` block and stats().
        self.slo = _slo.SLOTracker(policy=slo_policy)
        if control_policy is not None and not isinstance(
                control_policy, ControlPolicy):
            raise ValueError(
                f"control_policy must be a serving.control.ControlPolicy "
                f"or None, got {control_policy!r}")
        # SLO-driven overload control plane (serving.control): consumes
        # the tracker's burn windows + queue occupancy in the gap and
        # actuates burn-rate shedding (429 + Retry-After at submit),
        # the brownout ladder, and quota tightening. Entirely host-side
        # — engaging any rung captures nothing. None = no control.
        self.control = (None if control_policy is None
                        else ControlPlane(
                            control_policy,
                            fast_window_s=(slo_policy.fast_window_s
                                           if slo_policy is not None
                                           else 60.0)))
        self.engine = engine
        self.segment_steps = segment_steps
        self.idle_wait_s = idle_wait_s
        self.warmup = warmup
        self.max_restarts = max_restarts
        self.restart_backoff_s = restart_backoff_s
        self.restart_backoff_max_s = restart_backoff_max_s
        self.max_replays = max_replays
        self.max_preemptions = max_preemptions
        self.stall_timeout_s = stall_timeout_s
        self.queue = RequestQueue(max_queue, age_after_s=age_after_s)
        # per-server label: concurrent servers (multi-model processes)
        # publish their serving metrics side by side
        self.monitor_server = monitor.instance_label("server")
        self._wake = threading.Event()
        self._idle_cv = threading.Condition()
        self._lock = threading.Lock()     # submit/lifecycle flags
        self._next_id = 0                 # guarded-by: self._lock
        self._active = {}                 # engine rid -> RequestHandle
        self._admitting = False           # True for the whole inter-
        #                                   segment gap and recovery:
        #                                   handles pass through locals
        #                                   there, and drain must not
        #                                   miss those windows
        self._adm = None                  # in-flight chunked admission:
        #                                   (engine admission, handle) —
        #                                   advanced ONE chunk per gap
        self._replay = []                 # handles surviving an engine
        #                                   restart, awaiting
        #                                   re-admission (replay)
        self._faulted = False             # True while a handle rides an
        #                                   in-flight fault signal
        #                                   (between its seam and
        #                                   _recover) — drain must not
        #                                   report done in that window
        self._restarts = 0
        # guarded-by: self._lock
        self._flight_dumps = []           # flight-recorder dump paths
        #                                   (fault_stats / healthz
        #                                   read them)
        self._preempt_ts = []             # recent preemption stamps for
        #                                   the storm trigger (scheduler
        #                                   thread only)
        self._last_storm_dump = -1e18
        self._shed_lock = threading.Lock()
        self._shed_ts = []                # guarded-by: self._shed_lock
        #                                   recent shed-429 stamps for
        #                                   the shed-storm trigger
        #                                   (submit runs on CLIENT
        #                                   threads)
        self._last_shed_dump = -1e18      # guarded-by: self._shed_lock
        self._fault_counts = {}           # guarded-by: self._lock
        self._admin_ops = []              # guarded-by: self._lock
        #                                   pending adapter load/unload
        #                                   (op, args, event, result box)
        #                                   (kind, site) -> n, host-side
        #                                   (monitor-independent; see
        #                                   fault_stats())
        self._recovery_s = []             # guarded-by: self._lock
        self._waiting_on_pages = 0        # preempted handles parked on
        #                                   the replay list right now
        #                                   (pressure surface; scheduler
        #                                   thread writes, healthz reads
        #                                   — an int store is atomic)
        self._degraded_reason: Optional[str] = None   # guarded-by: self._lock
        self._stall_flag = False          # guarded-by: self._lock
        #                                   (degraded BY the watchdog)
        self._beat = time.monotonic()     # loop heartbeat the watchdog
        #                                   reads (float store: atomic)
        self._draining = False            # guarded-by: self._lock
        self._stopping = False            # guarded-by: self._lock
        self._fatal: Optional[BaseException] = None   # guarded-by: self._lock
        self._ready = threading.Event()   # warmup done (set immediately
        #                                   when warmup=False)
        self._stopped = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"paddle_tpu-serving-{self.monitor_server}")
        self._watchdog = None
        if stall_timeout_s is not None:
            self._watchdog = threading.Thread(
                target=self._watch, daemon=True,
                name=f"paddle_tpu-serving-watchdog-"
                     f"{self.monitor_server}")
        if start:
            self._thread.start()

    # -- client surface ------------------------------------------------------
    def submit(self, prompt, cfg: Optional[GenerationConfig] = None,
               priority: int = 0,
               timeout_s: Optional[float] = None,
               trace_rid: Optional[str] = None,
               tenant: Optional[str] = None) -> RequestHandle:
        """Enqueue one request; returns its :class:`RequestHandle`.

        ``cfg`` is the request's OWN GenerationConfig (validated at
        construction — malformed configs never reach a shared decode
        segment); ``priority`` orders admission (lower first);
        ``timeout_s`` sets an admission deadline — a request still
        queued when it passes is EXPIRED, never admitted.
        ``trace_rid`` overrides the trace key this request's lifecycle
        events are recorded under (default
        ``<server_label>:<handle id>``) — the replica router passes its
        OWN stable key here so one request's timeline stays whole
        across a failover to a different replica. ``tenant`` names the
        request's quota bucket (``Server(tenant_quotas=...)``); it
        defaults to the request's LoRA ``cfg.adapter`` (the fine-tune is
        the natural tenant), and a base request with no tenant is
        un-quotaed.

        Raises :class:`RequestRejected` (reason ``queue_full`` /
        ``draining`` / ``degraded`` / ``shutdown`` / ``shed`` — the
        last with ``retry_after_s`` set from the tenant's burn window,
        Server(control_policy=...) only) for backpressure,
        ValueError for a prompt that could never fit the engine. A
        degraded server (stalled step, mid-recovery) rejects
        IMMEDIATELY with the reason instead of queueing into a server
        that may never drain."""
        cfg = cfg or GenerationConfig()
        if self.speculative and not cfg.do_sample and not cfg.speculative:
            # the server's default opt-in: a copy, never the caller's
            # config (vars() so every field carries over)
            cfg = GenerationConfig(**dict(vars(cfg), speculative=True))
        plen = _prompt_len(prompt)
        if plen + cfg.max_new_tokens > self.engine.max_len:
            raise ValueError(
                f"prompt({plen}) + max_new_tokens({cfg.max_new_tokens}) "
                f"exceeds engine max_len({self.engine.max_len})")
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        eff_tenant = tenant if tenant is not None else cfg.adapter
        if self.control is not None and eff_tenant is not None:
            # burn-rate admission control: a tenant whose fast-burn
            # window fired is shed AT THE DOOR for the rest of the
            # window — its queued entries are deprioritized (not these;
            # see _control_tick) and new arrivals bounce with a
            # Retry-After telling the client when the window clears.
            # Checked OUTSIDE self._lock: the storm trigger below may
            # write a flight dump, which takes self._lock itself.
            ra = self.control.shed_check(eff_tenant, time.monotonic())
            if ra is not None:
                self._count("rejected_shed")
                self._note_shed(eff_tenant, "burn_rate")
                raise RequestRejected(
                    "shed",
                    f"tenant {eff_tenant!r} exceeded its SLO error "
                    f"budget (fast-burn window); retry in {ra:.1f}s",
                    retry_after_s=ra)
        # the put happens under the SAME lock as the stopping check:
        # otherwise a submit racing shutdown() could enqueue after the
        # scheduler's final queue drain and strand the handle QUEUED
        # forever (no thread left to ever finish it)
        with self._lock:
            if self._stopping or self._stopped.is_set():
                # covers clean shutdown AND a scheduler that died on an
                # exception — either way nobody will ever pop the queue
                self._count("rejected_shutdown")
                raise RequestRejected(
                    "shutdown",
                    "server is shut down"
                    + (f" (scheduler died: {self._fatal!r})"
                       if self._fatal is not None else ""))
            if self._draining:
                self._count("rejected_draining")
                # drain ETA: queued + active work at a rough
                # quarter-second-per-request decode pace — the same
                # honest-hint contract as the 429 Retry-After paths,
                # so a client (or the router) waits out the drain
                # instead of hammering a server that told it when
                eta = 0.5 + 0.25 * (self.queue.depth
                                    + len(self._active))
                raise RequestRejected(
                    "draining",
                    "server is draining; not accepting new requests",
                    retry_after_s=eta)
            if self._degraded_reason is not None:
                self._count("rejected_degraded")
                raise RequestRejected(
                    "degraded",
                    f"server is degraded ({self._degraded_reason}); "
                    "not accepting new requests")
            handle = RequestHandle(self._next_id, prompt, plen, cfg,
                                   priority, deadline,
                                   on_cancel=self._on_cancel,
                                   tenant=eff_tenant)
            # the trace key pairs the server label with the request id:
            # concurrent servers in one process restart their ids at 0,
            # and the process-wide ring must not merge their timelines
            # (a router-supplied key replaces it so a failover's second
            # replica keeps appending to the SAME timeline)
            handle._trace_rid = (trace_rid if trace_rid is not None
                                 else f"{self.monitor_server}:{handle.id}")
            # under a router-supplied rid this handle is replica-inner
            # plumbing: the ROUTER handle owns the one first_token
            # (TTFT) edge — a failover resubmit's first push here is
            # mid-stream, not a TTFT edge
            handle._trace_ttft = trace_rid is None
            self._next_id += 1
            try:
                self.queue.put(handle)
            except QueueFull:
                self._count("rejected_queue_full")
                raise
        self._count("queued")
        if trace.enabled():
            attrs = {}
            if cfg.adapter is not None:
                attrs["adapter"] = cfg.adapter
            trace.event("queue.enqueue", rid=handle._trace_rid,
                        plen=plen, priority=priority,
                        depth=self.queue.depth, **attrs)
        self._depth_gauge()
        self._wake.set()
        return handle

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop accepting NEW submissions, let queued + in-flight
        requests run to completion (replays included). Returns True
        when everything finished (False on timeout; the server keeps
        draining)."""
        with self._lock:
            self._draining = True
        self._wake.set()
        with self._idle_cv:
            return self._idle_cv.wait_for(
                lambda: (self.queue.depth == 0 and not self._active
                         and not self._admitting and self._adm is None
                         and not self._replay and not self._faulted)
                or self._stopped.is_set(), timeout)

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop the scheduler. ``drain=True`` finishes outstanding work
        first (bounded by ``timeout``); whatever remains afterwards —
        or everything, with ``drain=False`` — is cancelled BY THE
        SCHEDULER THREAD on its way out (the engine is never touched
        from the caller's thread — a segment still in flight, e.g. a
        first graph capture, finishes before cleanup runs)."""
        t0 = time.monotonic()
        if not self._thread.is_alive() and not self._stopped.is_set():
            # never-started server (``start=False``): no loop will ever
            # set _stopped — don't sit out the stop-wait below. (A
            # FINISHED loop sets _stopped in its finally before the
            # thread dies, so this cannot mask a real exit.)
            self._stopped.set()
        if drain:
            self.drain(timeout)
        with self._lock:
            self._stopping = True
            self._draining = True
        self._wake.set()
        # ``timeout`` bounds the WHOLE call: the stop-wait gets what the
        # drain left over, not a second full helping
        if timeout is None:
            self._stopped.wait(60.0)
        else:
            self._stopped.wait(max(0.0, timeout
                                   - (time.monotonic() - t0)))
        if not self._stopped.is_set():
            # the loop is still wedged (the stall scenario): leave the
            # per-server series alone — a live scheduler/watchdog tick
            # would just re-create anything removed here, and the
            # series still describe a real, running (if sick) server
            return
        if self._watchdog is not None and self._watchdog.is_alive():
            # a watchdog tick racing the removal below would re-create
            # the degraded/fault series; it exits within one poll
            # period of _stopped
            self._watchdog.join(timeout=2.0)
        try:
            self._queue_depth_gauge().remove(server=self.monitor_server)
            self._active_gauge().remove(server=self.monitor_server)
        except Exception:
            pass
        # per-server series retire with the server (the event/site
        # dimensions are open-ended; a dropped server must not export
        # its last degraded flag — or its lifecycle counters and
        # latency histograms — forever).
        for name in ("paddle_tpu_serving_faults_total",
                     "paddle_tpu_serving_restarts_total",
                     "paddle_tpu_serving_degraded",
                     "paddle_tpu_serving_recovery_seconds",
                     "paddle_tpu_serving_kv_pressure",
                     "paddle_tpu_serving_requests_total",
                     "paddle_tpu_serving_ttft_seconds",
                     "paddle_tpu_serving_tpot_seconds",
                     # SLO/goodput + per-tenant cost families:
                     # tenant is an open label dimension, retired by
                     # the server label alone
                     "paddle_tpu_serving_goodput",
                     "paddle_tpu_serving_slo_misses_total",
                     "paddle_tpu_serving_tenant_tokens_total",
                     "paddle_tpu_serving_tenant_kv_page_seconds_total",
                     # overload control plane: sheds carry an
                     # open tenant/reason dimension, the rung gauge
                     # would export a stale brownout forever
                     "paddle_tpu_serving_sheds_total",
                     "paddle_tpu_serving_brownout_rung"):
            try:
                monitor.remove_series(name, server=self.monitor_server)
            except Exception:
                pass

    def close(self) -> None:
        self.shutdown(drain=False)

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining

    def num_active(self) -> int:
        return len(self._active)

    @property
    def restarts(self) -> int:
        """Supervised engine restarts so far (lifetime count the
        ``max_restarts`` bound applies to)."""
        return self._restarts

    def fault_stats(self) -> dict:
        """Host-side fault/recovery accounting, monitor-independent
        (the chaos bench reads this even with the monitor off):
        ``{"faults": {(kind, site): n}, "restarts": n,
        "recovery_s": [per-restart wall seconds],
        "degraded": reason-or-None,
        "flight_dumps": [flight-recorder dump paths]}`` (dumps are
        written on engine-scoped faults, watchdog ``degraded`` flips,
        a dying scheduler, preemption storms (>= ``STORM_PREEMPTS``
        preemptions within ``STORM_WINDOW_S``) and shed storms — empty
        unless
        ``FLAGS_enable_trace`` was on when the trigger fired)."""
        with self._lock:
            return {"faults": dict(self._fault_counts),
                    "restarts": self._restarts,
                    "recovery_s": list(self._recovery_s),
                    "degraded": self._degraded_reason,
                    "flight_dumps": list(self._flight_dumps)}

    @property
    def flight_dumps(self):
        """Flight-recorder dump paths written so far (newest last)."""
        with self._lock:
            return list(self._flight_dumps)

    # -- multi-tenant LoRA admin (thread-safe; applied in the gap) ------------
    def load_adapter(self, name: str, params: dict, alpha=None,
                     timeout: Optional[float] = 30.0) -> int:
        """Hot-load a LoRA adapter into the engine's bank; returns its bank
        index. Thread-safe: the factors are validated, padded, scaled and
        converted here, on the caller's thread (``AdapterRegistry.stage``,
        which reads no registry state); only the copy of their rows into
        the bank is queued and APPLIED BY THE SCHEDULER THREAD in the next
        inter-segment gap, then the result, or the registry's ValueError,
        comes back here. Running requests are untouched; after ``warmup``
        a load captures nothing. See ``engine.load_adapter`` for the
        ``params`` format."""
        self._require_adapters()
        staged = self.engine.adapters.stage(name, params, alpha)
        return self._admin_op("load", (name, staged), timeout)

    def unload_adapter(self, name: str,
                       timeout: Optional[float] = 30.0) -> bool:
        """Hot-unload an adapter. Returns True when its index freed at
        once, False when live requests still decode under it: the unload
        DEFERS (new submissions naming it fail at admission; the index
        frees when the last of them retires). Marshalled as
        :meth:`load_adapter` is."""
        self._require_adapters()
        return self._admin_op("unload", (name,), timeout)

    def _require_adapters(self) -> None:
        if getattr(self.engine, "adapters", None) is None:
            raise RuntimeError(
                "engine built without lora_capacity; pass "
                "lora_capacity=K at engine construction")

    def _admin_op(self, op: str, args, timeout):
        evt = threading.Event()
        box: dict = {}
        entry = (op, args, evt, box)
        with self._lock:
            if self._stopping or self._stopped.is_set():
                raise RequestRejected(
                    "shutdown", "server is shut down; admin ops no "
                    "longer apply")
            self._admin_ops.append(entry)
        self._wake.set()
        if not evt.wait(timeout):
            # a timed-out op must not apply LATER with nobody waiting (the
            # caller was told it failed, and a late apply would make its
            # retry fail "already loaded"): withdraw it if the scheduler
            # has not taken it yet
            with self._lock:
                try:
                    self._admin_ops.remove(entry)
                    withdrawn = True
                except ValueError:
                    withdrawn = False   # mid-apply: the result is imminent
            if withdrawn:
                raise TimeoutError(
                    f"admin op {op} not applied within {timeout}s "
                    "(withdrawn; is the scheduler wedged?)")
            # the scheduler already owns it: a short grace, so the caller
            # gets the REAL verdict
            if not evt.wait(5.0):
                raise TimeoutError(
                    f"admin op {op} still applying after {timeout}s")
        if "error" in box:
            raise box["error"]
        return box["result"]

    _ADMIN_DISPATCH = {
        "load": lambda eng, name, staged: eng.adapters.install(name, staged),
        "unload": lambda eng, name: eng.unload_adapter(name),
        "kv_export": lambda eng, tokens, salt: eng.export_kv_pages(tokens,
                                                                   salt),
        "kv_import": lambda eng, payload: eng.import_kv_pages(payload)}

    def _apply_admin(self) -> None:
        """Apply the pending admin ops (adapter load / unload, KV-page export
        / import) on the scheduler thread, in the gap: the only place the
        registry or the pools may be touched. A failed op reports its error
        to its waiting caller; the engine and every running request are
        unharmed (a load is all-or-nothing, and a rejected import adopts
        nothing)."""
        with self._lock:
            ops, self._admin_ops = self._admin_ops, []
        for op, args, evt, box in ops:
            try:
                box["result"] = self._ADMIN_DISPATCH[op](self.engine, *args)
            except Exception as e:
                box["error"] = e
            finally:
                evt.set()

    # -- KV-page handoff admin (thread-safe; applied in the gap) -------------
    def export_kv(self, tokens, salt: bytes = b"",
                  timeout: Optional[float] = 30.0) -> dict:
        """The resident cached pages covering ``tokens``' longest full-block
        prefix (the ``engine.export_kv_pages`` payload). Thread-safe:
        marshalled into the scheduler thread's gap as adapter admin is,
        since a replay may be writing the pools on that thread's stream and
        no other thread may read them. The read half of a disaggregated
        prefill-to-decode handoff (``POST /kv/export``)."""
        self._require_kv_handoff()
        return self._admin_op("kv_export", (tokens, salt), timeout)

    def import_kv(self, payload: dict,
                  timeout: Optional[float] = 30.0) -> dict:
        """Install an exported payload into this engine's pools and prefix
        index (``engine.import_kv_pages``): chain-hash verified, idempotent
        on replay (resident blocks dedup). Marshalled as :meth:`export_kv`
        is. The write half of the handoff (``POST /kv/import``)."""
        self._require_kv_handoff()
        return self._admin_op("kv_import", (payload,), timeout)

    def _require_kv_handoff(self) -> None:
        if (getattr(self.engine, "export_kv_pages", None) is None
                or not getattr(self.engine, "prefix_cache", False)):
            raise RuntimeError(
                "KV-page handoff needs a paged engine with "
                "prefix_cache=True (the content index is what makes "
                "the handoff idempotent)")

    def profile(self, top_k: Optional[int] = None) -> dict:
        """This server's program-ledger shard, the per-program roofline
        table ``GET /profile`` serves and the fleet ``Router`` merges exactly
        across replicas: ``{"programs": {pid: cost/compiles/digest/MFU/
        bound}, "peaks", "top", "total_seconds", "server"}``. Scoped to the
        programs this server's engine owns (the whole process's when the
        engine has no monitor label). Empty while ``FLAGS_enable_ledger``
        is off."""
        own = getattr(self.engine, "_monitor_engine", None)
        prof = _ledger.profile(owners=[own] if own else None, top_k=top_k)
        prof["server"] = self.monitor_server
        return prof

    def request_timeline(self, request_id: int):
        """Ordered trace-event timeline for one of THIS server's
        requests by its public id (what ``/generate`` returned as
        ``request_id``) — the ``GET /trace?rid=`` surface. Same
        contract as ``RequestHandle.timeline()``: needs
        ``FLAGS_enable_trace`` on while the request ran, may be partial
        for old requests (bounded ring)."""
        return trace.timeline(f"{self.monitor_server}:{request_id}")

    def _flight_dump(self, reason: str):
        """Write a flight-recorder dump (no-op while tracing is off —
        no black box was recording) and remember its path for
        ``fault_stats``/healthz. Never raises: the dump is postmortem
        evidence, and failing to write it must not worsen the fault
        being recorded."""
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

    def load(self) -> dict:  # lint: hot-path
        """ONE lock-light, host-side load/health snapshot — the single
        source both ``/healthz`` and the replica router's least-loaded
        selection consume (no HTTP hop, no device sync):

        ``{"status", "healthy", "server", "queue_depth",
        "active_requests", "restarts", "free_slots", "active_slots",
        "max_batch"[, "free_pages", "total_pages", "occupancy"]
        [, "pressure"][, "slo"][, "profile"][, "control"]
        [, "flight_dump"]}``

        ``healthy`` is the HTTP readiness verdict (``status`` in
        ``ok``/``draining`` — what ``/healthz`` turns into 200 vs 503).
        Every field is host bookkeeping: the queue and status locks are
        held only for single reads/writes, never across engine work, and
        nothing reads the device, so this NEVER blocks behind a slow (or
        wedged) scheduler step."""
        status = self.status
        snap = {
            "status": status,
            "healthy": status in ("ok", "draining"),
            "server": self.monitor_server,
            "queue_depth": self.queue.depth,
            # len() of a dict the scheduler thread mutates is a single
            # atomic read — no lock, no torn state
            "active_requests": len(self._active),
            "restarts": self._restarts,
        }
        eload = getattr(self.engine, "load", None)
        if eload is not None:
            snap.update(eload())
        else:   # minimal engines: keep the probe surface alive
            snap["free_slots"] = self.engine.free_slots()
        p = self.pressure()
        if p is not None:
            snap["pressure"] = p
        if monitor.enabled():
            # SLO/goodput block (host dict walks only — the tracker's
            # lock is held per read, never across engine work): policy,
            # per-tenant goodput + fast/slow burn + token/KV-page-
            # second cost, headline ttft/tpot p50/p99 per tenant.
            # Absent while nothing was recorded or the monitor is off.
            s = self.slo.snapshot()
            if s is not None:
                snap["slo"] = s
        if _ledger.enabled():
            # compact program-ledger block: the top programs by total
            # seconds (host dict walk; the full table is /profile)
            prof = self.profile(top_k=5)
            if prof["programs"]:
                snap["profile"] = {
                    "programs": len(prof["programs"]),
                    "total_seconds": prof["total_seconds"],
                    "top": [{k: prof["programs"][pid].get(k)
                             for k in ("program", "total_seconds",
                                       "dispatches", "mfu", "bound")}
                            for pid in prof["top"]],
                }
        if self.control is not None:
            # overload-control block (host dict walk under the plane's
            # own lock): active brownout rung + its action name, per-
            # tenant shed counts by reason, currently-shed tenants
            snap["control"] = self.control.snapshot()
        with self._lock:
            if self._flight_dumps:
                snap["flight_dump"] = self._flight_dumps[-1]
        return snap

    def stats(self) -> dict:
        """Single-server SLO/goodput rollup — the reference fleet
        Router's ``GET /stats`` record shape (built through the SAME
        :func:`paddle_tpu_torch.monitor.slo.fleet_rollup` merge path, as
        a 1-shard fleet), so single-server and fleet tooling read one
        format: ``{"server", "policy", "window_s", "tenants":
        {tenant: goodput/burn/cost}, "metrics": {metric: {tenant:
        count/p50/p90/p99, "*": exact all-tenant merge}}}``."""
        out = _slo.fleet_rollup([self.slo.digests_dict()])
        out["server"] = self.monitor_server
        return out

    def pressure(self):
        """KV memory-pressure snapshot (None for a dense engine):
        ``{"admission_mode", "kv_dtype", "occupancy", "free_pages",
        "waiting_on_pages", "preemptions"}`` — what ``/healthz``
        reports so an operator can tell "degraded by memory pressure"
        (occupancy near 1.0, preemptions climbing, requests parked
        waiting on pages) apart from the stall/fault ``degraded``
        reason. int8 pools add ``kv_quant_bytes_saved``; with the prefix
        cache on the dict also carries ``{"prefix_cache": True,
        "cached_pages", "shared_pages", "prefix_hits", "prefix_lookups",
        "prefix_tokens_saved"}`` (parked pages are reclaimable capacity,
        not occupancy). Host-side and monitor-independent, like
        :meth:`fault_stats`."""
        alloc = getattr(self.engine, "alloc", None)
        if alloc is None:
            return None
        out = {
            "admission_mode": getattr(self.engine, "admission_mode",
                                      "reserved"),
            # storage dtype travels WITH the page numbers: at fixed
            # HBM an int8 pool holds ~2x the pages, so occupancy /
            # free_pages are only comparable dtype-attached
            "kv_dtype": getattr(alloc, "kv_dtype", "bf16"),
            "occupancy": round(alloc.occupancy, 4),
            "free_pages": alloc.free_pages,
            "waiting_on_pages": self._waiting_on_pages,
            "preemptions": alloc.preemptions,
        }
        if getattr(alloc, "kv_dtype", "bf16") == "int8":
            out["kv_quant_bytes_saved"] = alloc.quant_bytes_saved
        if getattr(alloc, "prefix_cache", False):
            # parked pages are reclaimable capacity (free + cached is
            # what admission can claim); shared counts the refcount > 1
            # multiplier; hits and tokens saved are lifetime totals
            out.update({
                "prefix_cache": True,
                "cached_pages": alloc.cached_pages,
                "shared_pages": alloc.shared_pages,
                "prefix_hits": alloc.prefix_hits,
                "prefix_lookups": alloc.prefix_lookups,
                "prefix_tokens_saved": alloc.prefix_tokens_saved,
            })
        return out

    # -- monitor helpers -----------------------------------------------------
    @staticmethod
    def _requests_counter():
        return monitor.counter(
            "paddle_tpu_serving_requests_total",
            "serving-layer requests by lifecycle event "
            "(queued/completed/cancelled/expired/failed/preempted/"
            "rejected_*)",
            ("server", "event"))

    @staticmethod
    def _queue_depth_gauge():
        return monitor.gauge(
            "paddle_tpu_serving_queue_depth",
            "requests waiting for admission, per server", ("server",))

    @staticmethod
    def _active_gauge():
        return monitor.gauge(
            "paddle_tpu_serving_active_requests",
            "requests currently occupying engine slots, per server",
            ("server",))

    @staticmethod
    def _ttft_hist():
        return monitor.histogram(
            "paddle_tpu_serving_ttft_seconds",
            "time to first token: submit() to the first generated "
            "token reaching the handle", ("server",))

    @staticmethod
    def _tpot_hist():
        return monitor.histogram(
            "paddle_tpu_serving_tpot_seconds",
            "time per output token after the first (decode cadence): "
            "(finish - first_token) / (n_tokens - 1)", ("server",))

    @staticmethod
    def _faults_counter():
        return monitor.counter(
            "paddle_tpu_serving_faults_total",
            "serving-path faults by blast-radius kind "
            "(request/engine/stall) and detection site",
            ("server", "kind", "site"))

    @staticmethod
    def _restarts_counter():
        return monitor.counter(
            "paddle_tpu_serving_restarts_total",
            "supervised engine restarts: device state rebuilt, "
            "in-flight requests replayed", ("server",))

    @staticmethod
    def _degraded_gauge():
        return monitor.gauge(
            "paddle_tpu_serving_degraded",
            "1 while the server is degraded (stalled step or "
            "mid-recovery), else 0", ("server",))

    @staticmethod
    def _recovery_hist():
        return monitor.histogram(
            "paddle_tpu_serving_recovery_seconds",
            "engine recovery wall time: fault caught -> backoff + "
            "state rebuilt + in-flight requests requeued for replay",
            ("server",))

    @staticmethod
    def _pressure_gauge():
        return monitor.gauge(
            "paddle_tpu_serving_kv_pressure",
            "requests preempted under KV memory pressure and parked "
            "on the replay list, waiting for pages, per server",
            ("server",))

    @staticmethod
    def _goodput_gauge():
        return monitor.gauge(
            "paddle_tpu_serving_goodput",
            "lifetime fraction of service-terminal requests meeting "
            "the server's SLOPolicy, per tenant (finished+failed; "
            "cancelled/expired excluded)", ("server", "tenant"))

    @staticmethod
    def _slo_miss_counter():
        return monitor.counter(
            "paddle_tpu_serving_slo_misses_total",
            "requests missing the SLO by dimension "
            "(ttft/tpot/e2e thresholds, or 'failed' for requests the "
            "service never delivered)", ("server", "tenant", "slo"))

    @staticmethod
    def _tenant_tokens_counter():
        return monitor.counter(
            "paddle_tpu_serving_tenant_tokens_total",
            "generated tokens per tenant (tenant defaults to the LoRA "
            "adapter name; '-' aggregates base traffic) — the compute "
            "half of per-tenant cost accounting",
            ("server", "tenant"))

    @staticmethod
    def _tenant_kv_counter():
        return monitor.counter(
            "paddle_tpu_serving_tenant_kv_page_seconds_total",
            "KV page-seconds held per tenant (trapezoid of the host "
            "page count over admit->finish; no device sync) — the "
            "memory half of per-tenant cost accounting",
            ("server", "tenant"))

    @staticmethod
    def _sheds_counter():
        return monitor.counter(
            "paddle_tpu_serving_sheds_total",
            "burn-rate shed rejections by tenant and reason — the "
            "control plane's 429-with-Retry-After path "
            "(Server(control_policy=...))",
            ("server", "tenant", "reason"))

    @staticmethod
    def _rung_gauge():
        return monitor.gauge(
            "paddle_tpu_serving_brownout_rung",
            "active brownout-ladder rung (0 = disengaged; order: "
            "quota_tighten, max_new_cap, spec_off, prefix_pause — see "
            "serving.control.RUNG_ACTIONS)", ("server",))

    def _count(self, event: str) -> None:
        if monitor.enabled():
            self._requests_counter().labels(
                server=self.monitor_server, event=event).inc()

    def _note_shed(self, tenant: str, reason: str) -> None:
        """Count + trace one shed rejection (runs on the SUBMITTING
        client thread) and feed the shed-storm flight trigger: each
        429 is the control plane working as intended, but a reject
        STORM is the overload postmortem the flight recorder exists
        for. Sliding window, re-armed only by a WRITTEN dump: the dump
        fires at most once per SHED_STORM_WINDOW_S even under
        concurrent submits (decision and re-arm share
        self._shed_lock)."""
        total = self.control.note_shed(tenant, reason)
        if monitor.enabled():
            self._sheds_counter().labels(
                server=self.monitor_server, tenant=tenant,
                reason=reason).inc()
        if trace.enabled():
            trace.event("control.shed", tenant=tenant, reason=reason,
                        total=total, server=self.monitor_server)
        now = time.monotonic()
        # lock order: self._shed_lock -> self._lock (via _flight_dump);
        # nothing takes them in the other order
        with self._shed_lock:
            self._shed_ts.append(now)
            cut = now - self.SHED_STORM_WINDOW_S
            while self._shed_ts and self._shed_ts[0] < cut:
                self._shed_ts.pop(0)
            if (len(self._shed_ts) >= self.SHED_STORM
                    and now - self._last_shed_dump
                    > self.SHED_STORM_WINDOW_S):
                if trace.enabled():
                    trace.event("control.shed_storm",
                                count=len(self._shed_ts),
                                window_s=self.SHED_STORM_WINDOW_S)
                if self._flight_dump("shed_storm") is not None:
                    self._last_shed_dump = now

    def _kv_page_seconds(self, h: RequestHandle, n_tokens: int) -> float:
        """Approximate KV page-seconds this request held (paged engine
        only): trapezoid of the host-side page count — pages grow
        roughly linearly from ceil(prompt/page_size) at admission to
        ceil((prompt+generated)/page_size) at retirement — times the
        admit->finish wall time. Pure host arithmetic (token counts
        the scheduler already tracks), no allocator walk, no device
        sync."""
        ps = getattr(self.engine, "page_size", None)
        if not ps or h.admit_ts is None or h.finish_ts is None:
            return 0.0
        p0 = math.ceil(h.prompt_len / ps)
        p1 = math.ceil((h.prompt_len + n_tokens) / ps)
        return (p0 + p1) / 2.0 * max(h.finish_ts - h.admit_ts, 0.0)

    def _slo_finish(self, h: RequestHandle, n_tokens: int) -> None:
        """Score one FINISHED request into the SLO tracker and the
        per-tenant cost/goodput series (scheduler thread)."""
        if not monitor.enabled():
            return
        ttft = (None if h.first_token_ts is None
                else h.first_token_ts - h.submit_ts)
        tpot = (None if (h.first_token_ts is None or n_tokens < 2)
                else (h.finish_ts - h.first_token_ts) / (n_tokens - 1))
        e2e = h.finish_ts - h.submit_ts
        kv_ps = self._kv_page_seconds(h, n_tokens)
        _met, misses = self.slo.record_finish(
            h.tenant, ttft, tpot, e2e, n_tokens, kv_ps)
        t = _slo.tenant_key(h.tenant)
        self._tenant_tokens_counter().labels(
            server=self.monitor_server, tenant=t).inc(n_tokens)
        if kv_ps > 0:
            self._tenant_kv_counter().labels(
                server=self.monitor_server, tenant=t).inc(kv_ps)
        for dim in misses:
            self._slo_miss_counter().labels(
                server=self.monitor_server, tenant=t, slo=dim).inc()
        g = self.slo.goodput(h.tenant)
        if g is not None:
            self._goodput_gauge().labels(
                server=self.monitor_server, tenant=t).set(g)

    def _slo_fail(self, h: RequestHandle) -> None:
        """A FAILED terminal is an SLO miss by definition (the service
        never delivered) — called right after the contained-failure
        ``_count("failed")`` sites. The fatal ``_finalize`` path does
        NOT score: a dying server's burn rate is not an alerting
        signal, it is an outage the healthz status already names."""
        if not monitor.enabled():
            return
        self.slo.record_failure(h.tenant)
        t = _slo.tenant_key(h.tenant)
        self._slo_miss_counter().labels(
            server=self.monitor_server, tenant=t, slo="failed").inc()
        g = self.slo.goodput(h.tenant)
        if g is not None:
            self._goodput_gauge().labels(
                server=self.monitor_server, tenant=t).set(g)

    def _depth_gauge(self) -> None:
        if monitor.enabled():
            self._queue_depth_gauge().labels(
                server=self.monitor_server).set(self.queue.depth)
            self._active_gauge().labels(
                server=self.monitor_server).set(len(self._active))
            if getattr(self.engine, "alloc", None) is not None:
                self._pressure_gauge().labels(
                    server=self.monitor_server).set(
                    self._waiting_on_pages)

    def _count_fault(self, kind: str, site: str) -> None:
        # called from the scheduler thread AND the watchdog — the host
        # dict needs the lock, the monitor counter has its own
        with self._lock:
            key = (kind, site)
            self._fault_counts[key] = self._fault_counts.get(key, 0) + 1
        if monitor.enabled():
            self._faults_counter().labels(
                server=self.monitor_server, kind=kind, site=site).inc()
        # one choke point gives every fault classification a trace
        # event BEFORE any flight dump fires — the dump's final events
        # name the faulting site
        if trace.enabled():
            trace.event("fault", kind=kind, site=site,
                        server=self.monitor_server)

    def _set_degraded(self, reason: str, stall: bool = False) -> None:
        with self._lock:
            self._degraded_reason = reason
            self._stall_flag = stall
        if monitor.enabled():
            self._degraded_gauge().labels(
                server=self.monitor_server).set(1)

    def _clear_degraded(self, stall_only: bool = False) -> None:
        with self._lock:
            if stall_only and not self._stall_flag:
                return
            self._degraded_reason = None
            self._stall_flag = False
        if monitor.enabled():
            self._degraded_gauge().labels(
                server=self.monitor_server).set(0)

    # -- stall watchdog (its own thread; flags only, never the engine) -------
    def _watch(self) -> None:
        """Detect a wedged scheduler step: ``stall_timeout_s`` without
        a loop heartbeat flips status to ``degraded`` (healthz 503) and
        counts a ``stall`` fault — a hung device call can't announce
        itself, so somebody else has to. Clears as soon as the loop
        beats again. Never arms during warmup (captures are not
        stalls), and never overwrites a recovery's degraded reason."""
        period = min(max(self.stall_timeout_s / 4.0, 0.005), 1.0)
        while not self._stopped.wait(period):
            if not self._ready.is_set():
                continue
            age = time.monotonic() - self._beat
            with self._lock:
                stalled = self._stall_flag
                degraded = self._degraded_reason is not None
            if age > self.stall_timeout_s:
                if not degraded:
                    self._count_fault("stall", "loop")
                    self._set_degraded(
                        f"scheduler step stalled > "
                        f"{self.stall_timeout_s}s", stall=True)
                    # the wedged scheduler thread can't dump its own
                    # black box — the watchdog does it (the ring's own
                    # lock makes the cross-thread read safe)
                    self._flight_dump("stall")
            elif stalled:
                self._clear_degraded(stall_only=True)

    # -- scheduler loop (single thread) --------------------------------------
    def _on_cancel(self, handle: RequestHandle) -> None:
        self._wake.set()

    def _loop(self) -> None:
        err: Optional[BaseException] = None
        if self._watchdog is not None and not self._watchdog.is_alive():
            try:
                self._watchdog.start()
            except RuntimeError:   # already started once
                pass
        try:
            if self.warmup:
                # capture the segment programs and run every prefill
                # width IN the engine-owning thread (the graphs run on
                # this thread's stream), off the request path: no user
                # request pays a capture. /healthz reports "warming"
                # until this finishes (submissions queue meanwhile).
                self.engine.warmup(self.segment_steps)
            self._beat = time.monotonic()
            self._ready.set()
            while True:
                with self._lock:
                    stopping = self._stopping
                if stopping:
                    break
                # heartbeat the watchdog reads: one "step" is
                # gap + decode segment + collect
                self._beat = time.monotonic()
                try:
                    self._gap()
                    if self._active or self._adm is not None:
                        # with only a chunked admission in flight the
                        # segment is a fast no-op and the loop spins
                        # straight back into _gap for the next chunk
                        sp = trace.NULL_SPAN
                        if trace.enabled() and self._active:
                            # batch-wide event: carries the live
                            # request set so each one's timeline()
                            # includes its segments, and the adapter
                            # mix decoding in it (which fine-tunes
                            # shared this program run)
                            ad = tuple(sorted(
                                {h.cfg.adapter for h
                                 in self._active.values()
                                 if h.cfg.adapter is not None}))
                            attrs = {"adapters": ad} if ad else {}
                            sp = trace.span(
                                "segment", steps=self.segment_steps,
                                rids=tuple(h._trace_rid for h
                                           in self._active.values()),
                                **attrs)
                        with sp:
                            self._guard(
                                "decode",
                                lambda: self.engine.decode_segment(
                                    self.segment_steps))
                        self._guard("collect", self._collect)
                    else:
                        with self._idle_cv:
                            self._idle_cv.notify_all()
                        self._wake.wait(self.idle_wait_s)
                        self._wake.clear()
                except _EngineFaultSignal as sig:
                    if not self._recover(sig):
                        raise RuntimeError(
                            f"engine fault at {sig.site} with the "
                            f"restart budget exhausted "
                            f"(max_restarts={self.max_restarts}): "
                            f"{sig.cause!r}") from sig.cause
        except BaseException as e:     # noqa: BLE001 - must not hang clients
            err = e
        finally:
            # terminal cleanup runs HERE, in the engine-owning thread:
            # a dead loop must never strand handles in a non-terminal
            # state (clients block in result()/stream() forever) or
            # leave drain() waiting on a condition nobody will signal.
            self._finalize(err)
            # unblock wait_ready() even when WARMUP itself died — the
            # fatal status is already recorded, and `status` reports
            # failed/stopped before it ever consults _ready
            self._ready.set()
            self._stopped.set()
            with self._idle_cv:
                self._idle_cv.notify_all()

    @property
    def status(self) -> str:
        """``warming`` (pre-compiling, not ready for traffic — requests
        still queue) / ``ok`` / ``degraded`` (stalled step or
        mid-recovery; submissions reject with reason) / ``draining`` /
        ``failed`` (scheduler died on an exception) / ``stopped`` —
        what ``/healthz`` reports (only ``ok``/``draining`` are HTTP
        200)."""
        # lint: allow-unlocked(single atomic ref read; _fatal is
        # written exactly once, on the scheduler's way out — a racing
        # read sees None or the final value, never a torn state)
        if self._fatal is not None:
            return "failed"
        if self._stopped.is_set():
            return "stopped"
        if not self._ready.is_set():
            return "warming"
        with self._lock:
            degraded = self._degraded_reason is not None
        if degraded:
            return "degraded"
        return "draining" if self.draining else "ok"

    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        """Block until warmup finished (immediately True when
        ``warmup=False``). Also returns when the scheduler DIED during
        warmup — check :attr:`status` (``"failed"``) before serving."""
        return self._ready.wait(timeout)

    def _finalize(self, err: Optional[BaseException]) -> None:
        fail = err is not None
        if fail:
            # the scheduler is dying on an exception: capture the black
            # box BEFORE the handles get their terminal states
            if trace.enabled():
                trace.event("fatal", server=self.monitor_server,
                            cause=repr(err))
            self._flight_dump("scheduler_fatal")
        with self._lock:
            # close the submit door BEFORE draining (on the crash path
            # _stopping is still False here — without this a racing
            # submit could enqueue after the final drain and strand its
            # handle QUEUED forever)
            self._stopping = True
            self._fatal = err
        wrapped = (RuntimeError(f"serving scheduler died: {err!r}")
                   if fail else None)
        # pending adapter admin ops must not strand their callers in
        # load_adapter()'s wait: they fail with the terminal state
        with self._lock:
            admin, self._admin_ops = self._admin_ops, []
        for _op, _args, evt, box in admin:
            box["error"] = (wrapped if fail else
                            RuntimeError("server stopped before the "
                                         "admin op applied"))
            evt.set()
        if self._adm is not None:
            adm, h = self._adm
            self._adm = None
            if not fail:
                try:    # engine coherent on a clean stop — reclaim
                    self.engine.abort_admit(adm)
                except Exception:
                    pass
            self._count("failed" if fail else "cancelled")
            h._finish(FAILED if fail else CANCELLED, wrapped)
        for h in self._replay:
            # replays never reached the rebuilt engine — no capacity to
            # reclaim, just a terminal state so result() can't hang
            self._count("failed" if fail else "cancelled")
            h._finish(FAILED if fail else CANCELLED, wrapped)
        self._replay = []
        for h in self.queue.drain_all():
            self._count("failed" if fail else "cancelled")
            h._finish(FAILED if fail else CANCELLED, wrapped)
        for rid, h in list(self._active.items()):
            if not fail:
                # engine state is coherent on a clean stop — reclaim
                try:
                    self.engine.cancel_request(rid)
                except Exception:
                    pass
            self._count("failed" if fail else "cancelled")
            h._finish(FAILED if fail else CANCELLED, wrapped)
        self._active.clear()

    # -- fault containment ---------------------------------------------------
    def _guard(self, site: str, fn):
        """Run one engine-touching step at a BATCH-wide seam
        (decode/collect/cancel): any non-fatal exception becomes an
        engine-scoped fault signal — there is no single request to
        contain it to, and the shared device state is suspect."""
        try:
            return fn()
        except _EngineFaultSignal:
            raise
        except Exception as e:
            if classify_fault(e, site) == "fatal":  # future-proofing;
                raise                               # fatal is Base-only
            self._count_fault("engine", site)
            self._faulted = True   # drain-visible until _recover ends
            raise _EngineFaultSignal(site, e) from e

    def _contain(self, h: RequestHandle, exc: Exception,
                 site: str) -> None:
        """Fault containment at a REQUEST-scoped seam (admission /
        chunk): classify the blast radius. A request-scoped fault
        finishes ONLY this handle as FAILED with its cause — the
        engine's abort guards already reclaimed the slot and pages —
        and the caller keeps serving everyone else. An engine-scoped
        one escalates to the loop's recovery handler with the
        triggering handle riding along for replay."""
        kind = classify_fault(exc, site)
        if kind == "fatal":
            raise exc
        self._count_fault(kind, site)
        if kind == "request":
            self._count("failed")
            h._finish(FAILED, exc)
            self._slo_fail(h)
            return
        # the handle now rides ONLY inside the signal until _recover
        # parks it — flag the window so a timed drain() can't report
        # "everything finished" while it unwinds
        self._faulted = True
        raise _EngineFaultSignal(site, exc, h) from exc

    def _recover(self, sig: _EngineFaultSignal) -> bool:
        """Supervised engine recovery (scheduler thread): back off
        exponentially, reset device state (``engine.reset_state`` —
        captured graphs survive), and requeue every in-flight request
        for REPLAY from its stored prompt + tokens emitted so far.
        Requests past their ``max_replays`` budget fail with the fault
        as cause; cancel-requested ones finish CANCELLED. Returns False
        when the lifetime ``max_restarts`` budget is exhausted, and
        RAISES (carrying the rebuild error) when ``reset_state`` itself
        fails — either way the caller falls through to the fatal
        ``_finalize`` path with an honest diagnosis."""
        # the flight recorder fires FIRST, before any recovery work
        # mutates state: the dump is "what the engine was doing in the
        # seconds before the fault", and it must be written even when
        # the restart budget is already exhausted (the seam's
        # _count_fault event naming the site is already in the ring)
        self._flight_dump(f"engine_fault_{sig.site}")
        try:
            return self._recover_inner(sig)
        finally:
            # every exit parked the signal's handle somewhere a
            # finalizer or the next gap reaches — the drain-visibility
            # window the seams flagged is over
            self._faulted = False

    def _recover_inner(self, sig: _EngineFaultSignal) -> bool:
        if self._restarts >= self.max_restarts:
            # the triggering handle may live in NO collection yet (an
            # admission-seam fault pops it from the queue first) — park
            # it where the fatal _finalize will fail it, never strand it
            if sig.handle is not None:
                self._replay.append(sig.handle)
            return False
        self._restarts += 1      # counts ATTEMPTED-and-allowed restarts
        t0 = time.monotonic()
        self._set_degraded(
            f"recovering from engine fault at {sig.site}: "
            f"{sig.cause!r}")
        if monitor.enabled():
            self._restarts_counter().labels(
                server=self.monitor_server).inc()
        # _admitting makes the whole recovery window visible to a timed
        # drain(): handles leave _active/_adm below and only land back
        # in _replay at the end — without this a drain timing out
        # mid-recovery would report "everything finished"
        self._admitting = True
        try:
            # snapshot in-flight work BEFORE touching the engine: its
            # device state is suspect, so no cancel_request/abort_admit
            # — reset_state reclaims every slot and page wholesale
            inflight = []
            if sig.handle is not None:
                inflight.append(sig.handle)
            if self._adm is not None:
                _, h = self._adm
                self._adm = None
                inflight.append(h)
            inflight.extend(self._active.values())
            self._active.clear()
            # transient device faults need breathing room before the
            # reset retries the device
            # — but the backoff must stay interruptible: a shutdown
            # racing a fault storm cannot wait out 2s sleeps
            end = time.monotonic() + min(
                self.restart_backoff_s * (2 ** (self._restarts - 1)),
                self.restart_backoff_max_s)
            with trace.span("backoff", site=sig.site,
                            restart=self._restarts):
                while True:
                    with self._lock:
                        stopping = self._stopping
                    rem = end - time.monotonic()
                    if stopping or rem <= 0:
                        break
                    time.sleep(min(0.05, rem))
            if stopping:
                # shutdown won the race: park the in-flight handles for
                # the loop's exit cleanup (clean stop → CANCELLED,
                # crash → FAILED; never stranded) — but still rebuild
                # best-effort: the engine is CALLER-owned and outlives
                # this server, so a raced stop must not hand back an
                # engine with poisoned device state and leaked
                # slots/pages (reset is cheap — no captures)
                self._replay.extend(inflight)
                self._clear_degraded()
                try:
                    self.engine.reset_state()
                except Exception:
                    pass
                return True
            try:
                self.engine.reset_state()
                if trace.enabled():
                    trace.event("restart", site=sig.site,
                                restarts=self._restarts,
                                inflight=len(inflight))
            except Exception as rebuild_err:
                # the rebuild itself failed — nothing left to try. The
                # snapshotted handles were already pulled out of
                # _active/_adm; park them in _replay so the fatal
                # _finalize reaches every one (result() must never
                # hang), drop the stale "recovering" degraded reason
                # (the terminal status is "failed", not failed-but-
                # mid-recovery), and DIAGNOSE honestly: the fatal error
                # must carry the rebuild failure, not claim a restart
                # budget that was never exhausted
                self._replay.extend(inflight)
                self._clear_degraded()
                self._count_fault("engine", "reset")
                raise RuntimeError(
                    f"engine rebuild (reset_state) failed during "
                    f"recovery from the {sig.site} fault "
                    f"{sig.cause!r}: {rebuild_err!r}") from rebuild_err
            for h in inflight:
                if h._cancel_requested:
                    self._count("cancelled")
                    h._finish(CANCELLED)
                    continue
                h._replays += 1
                if h._replays > self.max_replays:
                    h._finish(FAILED, RuntimeError(
                        f"request {h.id} exceeded its replay budget "
                        f"(max_replays={self.max_replays}) across "
                        f"engine restarts; last fault at {sig.site}: "
                        f"{sig.cause!r}"))
                    self._count("failed")
                    self._slo_fail(h)
                else:
                    self._replay.append(h)
        finally:
            self._admitting = False
        dt = time.monotonic() - t0
        with self._lock:
            self._recovery_s.append(dt)
        if monitor.enabled():
            self._recovery_hist().labels(
                server=self.monitor_server).observe(dt)
        if trace.enabled():
            trace.record("recover", dur_ns=int(dt * 1e9), site=sig.site,
                         restarts=self._restarts)
        # refresh the heartbeat BEFORE dropping the degraded flag: the
        # beat is stale by the whole recovery (backoff included), and a
        # watchdog tick landing between the clear and the loop's next
        # beat would record a phantom stall
        self._beat = time.monotonic()
        self._clear_degraded()
        self._depth_gauge()
        return True

    # -- admission helpers ---------------------------------------------------
    def _start_admission(self, h: RequestHandle, ids, cfg,
                         plen: int) -> bool:
        """Admit one request NOW (capacity already probed): one-shot,
        or begin a chunked admission for prompts longer than the
        engine's ``prefill_chunk``. Returns True when the request is
        live (or its chunked admission is in flight); False when a
        request-scoped fault failed the handle (capacity reclaimed by
        the engine's abort guards). Engine-scoped faults escalate via
        :meth:`_contain`."""
        chunk = getattr(self.engine, "prefill_chunk", None)
        # the adapter rides every admission span: a multi-tenant timeline
        # must say whose weights the prefill ran under
        t_attrs = ({"adapter": cfg.adapter} if cfg.adapter is not None
                   else {})
        if chunk is not None and plen > chunk:
            # long prompt: claim capacity now, prefill one fixed-shape
            # chunk per gap (decode segments run in between) instead of
            # one monopolizing prefill
            sp = trace.NULL_SPAN
            if trace.enabled():
                sp = trace.span("admit.begin", rid=h._trace_rid,
                                plen=plen, chunk=chunk,
                                replay=h._engine_base > 0, **t_attrs)
            with sp:
                try:
                    adm = self.engine.begin_admit(ids, cfg)
                except Exception as e:
                    self._contain(h, e, "admit")
                    return False
            self._adm = (adm, h)
            return True
        sp = trace.NULL_SPAN
        if trace.enabled():
            wfn = getattr(self.engine, "_prefill_width", None)
            sp = trace.span("admit", rid=h._trace_rid, plen=plen,
                            bucket=(wfn(plen) if wfn is not None
                                    else plen),
                            replay=h._engine_base > 0, **t_attrs)
        with sp:
            try:
                rid = self.engine.add_request(ids, cfg)
            except Exception as e:
                self._contain(h, e, "admit")
                return False
        h._mark_running(rid)
        self._active[rid] = h
        # admission prefill already sampled the first token: push it
        # now — the TTFT edge for the handle's stream
        toks = self.engine.partial_tokens(rid)
        if toks is not None:
            self._push_delta(h, toks)
        return True

    def _admit_replays(self) -> None:
        """Re-admit requests surviving an engine restart OR a
        memory-pressure preemption FIRST (before new queue work): they
        already held capacity when the fault or preemption hit. With
        reserved admission a replay reserves exactly what the original
        did (prompt + full budget), so the reset engine always has room;
        with optimistic admission the claim is prompt + one page and a
        replay defers while the pool is crowded (new-queue admission
        stays paused until every replay is back in). At worst a replay
        longer than ``prefill_chunk`` waits its turn behind the single
        in-flight chunked admission.

        A replay re-prefills ``prompt + tokens emitted so far`` (the
        bucketed/chunked machinery treats it like any prompt) with the
        budget reduced by what was already emitted. A greedy replay is
        the uninterrupted decode's causal prefill of the same prefix (on
        the card up to cuBLAS's choice of algorithm by width: see the
        module docstring); a sampled request continues on the SAME
        stream, since its draws are a hash of (seed, position) — the
        reference's moves to a fresh one. The admission deadline applies
        only to a handle that never COMPLETED an admission
        (``engine_rid is None`` — a pressure-abort of its in-flight
        chunked claim parked it here): once a request admitted, the
        deadline was met and a replay must not expire it. Deferral is
        O(1) — the O(plen) replay-prompt build only happens on the gap
        that actually admits."""
        pending, self._replay = self._replay, []
        still = []
        chunk = getattr(self.engine, "prefill_chunk", None)
        # drain visibility: the caller (_gap) holds _admitting for its
        # whole body, covering the window where handles live only in
        # these locals
        try:
            while pending:
                h = pending.pop(0)
                if h._cancel_requested:
                    self._count("cancelled")
                    h._finish(CANCELLED)
                    continue
                if (h.engine_rid is None and h.deadline is not None
                        and time.monotonic() >= h.deadline):
                    self._count("expired")
                    h._finish(EXPIRED)
                    continue
                n_toks = h._n_pushed    # == len(h._tokens): scheduler-
                #                         thread bookkeeping, O(1)
                remaining = h.cfg.max_new_tokens - n_toks
                if remaining < 1:
                    # fully emitted before the fault (retirement raced
                    # the crash) — it is simply finished
                    self._count("completed")
                    h._finish(FINISHED)
                    if monitor.enabled():
                        self._slo_finish(h, n_toks)
                    continue
                plen = h.prompt_len + n_toks
                if (chunk is not None and plen > chunk
                        and self._adm is not None):
                    still.append(h)     # waits behind the in-flight
                    continue            # chunked admission
                # every config field carries over verbatim (vars(), not
                # a hand-written field list — a field added to
                # GenerationConfig later must not silently reset to its
                # default on replay); only the budget shrinks
                kw = dict(vars(h.cfg))
                kw["max_new_tokens"] = remaining
                rcfg = GenerationConfig(**kw)
                if not self.engine.can_admit(plen, rcfg):
                    if (not self._active and self._adm is None
                            and self.engine.free_slots()
                            == self.engine.max_batch):
                        # the engine is completely IDLE and the replay
                        # still cannot fit: prompt + generated has
                        # outgrown what the pool can EVER hold (a
                        # preempted request's replay prompt includes
                        # every emitted token) — fail
                        # loudly with the typed cause instead of
                        # deferring forever against an empty engine
                        h._finish(FAILED, PagePoolExhausted(
                            [h.id],
                            f"replay of request {h.id} "
                            f"(prompt+generated={plen} tokens) can "
                            f"never be admitted: engine capacity "
                            f"(page pool / max_len) is too small "
                            f"even when idle"))
                        self._count("failed")
                        self._slo_fail(h)
                        continue
                    still.append(h)
                    continue
                # lint: allow-host-sync(host-list copy, no device
                # read: tokens_so_far() is the handle's python list)
                ids = np.concatenate(
                    [_prompt_ids(h.prompt)[0],
                     np.asarray(h.tokens_so_far(), np.int32)]) \
                    if n_toks else _prompt_ids(h.prompt)[0]
                # the engine's token list restarts at 0 for the
                # replayed rid; handle-side indices keep counting from
                # the full history
                h._engine_base = n_toks
                if trace.enabled():
                    # re-admission after an engine restart OR a
                    # memory-pressure preemption: the timeline shows
                    # replay -> admit(replay=True) -> segments
                    trace.event("replay", rid=h._trace_rid,
                                emitted=n_toks, replays=h._replays,
                                preempts=h._preempts)
                self._start_admission(h, ids, rcfg, plen)
        finally:
            # an engine-fault signal mid-iteration leaves the
            # unprocessed tail (and the deferred ones) queued for the
            # next recovery/gap — nothing is stranded or duplicated
            self._replay = still + pending + self._replay

    def _gap(self) -> None:  # lint: hot-path
        """The inter-segment gap: adapter admin first (hot LoRA loads and
        unloads), then cancellations (they free capacity), then ONE chunk
        of any in-flight chunked admission (bounded gap work — decode
        segments run between chunks), then
        expiry reaping, then replay re-admissions, then admission while
        the engine's capacity probe allows.

        ``_admitting`` is held for the WHOLE gap: at several points a
        handle lives only in locals (mid-admission, mid-replay, the
        chunk-abort window) and a timed ``drain()`` must never see
        "queue empty, nothing active" through one of them.

        Pressure relief runs LAST (optimistic paged mode): every slot the
        coming segment will write is grown now, preempting victims while
        the pool is dry, so ``decode_segment``'s own exhaustion guard
        (:class:`PagePoolExhausted`, an engine-scoped fault) never fires
        under this scheduler."""
        self._admitting = True
        # the gap span only when there is WORK: an idle loop gaps ~50x/s
        # and would drown the flight ring in empty spans
        busy = bool(trace.enabled()
                    and (self._active or self._adm is not None
                         or self._replay or self.queue.depth))
        try:
            with (trace.span("gap") if busy else trace.NULL_SPAN):
                self._gap_body()
            self._relieve_pressure()
            if self.control is not None:
                # observe->act loop last, on the post-admission state
                # (rate-limited inside ControlPlane.tick): pure host
                # bookkeeping, no engine work
                self._control_tick()
        finally:
            self._admitting = False
        self._depth_gauge()

    def _gap_body(self) -> None:
        # 0. adapter admin (hot load / unload) applies FIRST: "in the
        #    inter-segment gap" is the registry's whole thread contract,
        #    and a load must be visible to this gap's admissions (an
        #    unlocked emptiness probe; _apply_admin swaps the list under
        #    the lock)
        if self._admin_ops:
            self._apply_admin()
        # 1. cancellations of RUNNING requests retire their slots
        for rid, h in list(self._active.items()):
            if h._cancel_requested:
                toks = self._guard(
                    "cancel",
                    lambda rid=rid: self.engine.cancel_request(rid))
                del self._active[rid]
                if toks is not None:
                    self._push_delta(
                        h, list(toks[h._n_pushed - h._engine_base:]))
                self._count("cancelled")
                h._finish(CANCELLED)
        # 1b. advance the in-flight chunked admission by ONE fixed-shape
        #     chunk (or abandon it if its client cancelled / its
        #     admission deadline passed — chunked admission spans many
        #     gaps, so queue.reap alone no longer covers the whole wait
        #     for admission): admission work per gap stays bounded no
        #     matter how long the prompt
        if self._adm is not None:
            adm, h = self._adm
            # the deadline is an ADMISSION deadline: a chunked REPLAY
            # (_engine_base > 0 — the request already admitted once and
            # emitted tokens) met it the first time and must not expire
            # mid-recovery
            expired = (h.deadline is not None and h._engine_base == 0
                       and time.monotonic() >= h.deadline)
            if h._cancel_requested or expired:
                self._adm = None
                self._count("cancelled" if h._cancel_requested
                            else "expired")
                h._finish(CANCELLED if h._cancel_requested else EXPIRED)
                # the handle is terminal first: if the abort itself
                # faults, recovery reclaims capacity wholesale and the
                # client is not stranded behind the engine's health
                self._guard("cancel",
                            lambda: self.engine.abort_admit(adm))
            else:
                sp = trace.NULL_SPAN
                if trace.enabled():
                    sp = trace.span("prefill_chunk", rid=h._trace_rid,
                                    off=getattr(adm, "off", None))
                try:
                    with sp:
                        finished = self.engine.admit_chunk(adm)
                except Exception as e:
                    self._adm = None
                    # admit_chunk aborts itself on ITS failures, but a
                    # fault at the call seam (injection, wrapper bug)
                    # leaves the claim open — abort_admit is idempotent,
                    # so reclaim unconditionally before containment
                    try:
                        self.engine.abort_admit(adm)
                    except Exception:
                        pass   # engine-scoped path: reset reclaims all
                    self._contain(h, e, "chunk")
                else:
                    if finished:
                        self._adm = None
                        h._mark_running(adm.rid)
                        self._active[adm.rid] = h
                        if trace.enabled():
                            trace.event("admit.done", rid=h._trace_rid,
                                        chunked=True)
                        toks = self.engine.partial_tokens(adm.rid)
                        if toks is not None:
                            self._push_delta(h, toks)
        # 2. cancelled/expired queue entries never admit
        for h in self.queue.reap(time.monotonic()):
            if trace.enabled():
                trace.event("queue.expire", rid=h._trace_rid,
                            cancelled=h._cancel_requested)
            if h._cancel_requested:
                self._count("cancelled")
                h._finish(CANCELLED)
            else:
                self._count("expired")
                h._finish(EXPIRED)
        # 2b. replays surviving an engine restart re-admit before new
        #     queue work (their capacity claim predates the fault)
        if self._replay:
            self._admit_replays()
        if self._replay:
            # replays still pending (e.g. waiting behind the single
            # chunked admission): do NOT admit new queue work this gap
            # — fresh traffic would claim the pages/slots the replays'
            # pre-fault reservations are owed, starving them behind
            # arrivals that keep refilling the pool
            return
        # 3. admission: probe, never catch capacity — deferral is the
        #    scheduler path, add_request raising is the programmer-error
        #    path; a raise that happens anyway is a FAULT and goes
        #    through containment (_contain). The caller's _admitting
        #    span covers the whole pop→_active window.
        chunk = getattr(self.engine, "prefill_chunk", None)

        def admittable(h) -> bool:
            if not self.engine.can_admit(h.prompt_len, h.cfg):
                return False
            if (chunk is not None and h.prompt_len > chunk
                    and self._adm is not None):
                # one chunked admission at a time: a second long prompt
                # defers until the in-flight one completes (its slot and
                # pages are already claimed, so capacity stays honest)
                return False
            return True

        while True:
            if self.tenant_quotas is None:
                h = self.queue.pop_if(admittable)
            else:
                # quota-aware pop: a tenant over its cap defers ITS
                # entries only — tenants queued behind it still admit
                # (capacity-blocked heads still stop the scan: no
                # head-of-line bypass on capacity)
                h = self.queue.pop_admittable(admittable,
                                              self._tenant_ok)
            if h is None:
                # head (if any) does not fit RIGHT NOW. With the
                # engine completely idle it can never fit — fail it
                # loudly instead of wedging the queue forever. The
                # pop re-checks the probe under the queue lock: a
                # racing submit may have put a NEW, admittable head
                # in front, which must not be the one failed.
                if (self.queue.depth and not self._active
                        and self.engine.free_slots()
                        == self.engine.max_batch):
                    bad = self.queue.pop_if(
                        lambda h: not self.engine.can_admit(
                            h.prompt_len, h.cfg))
                    if bad is not None:
                        bad._finish(FAILED, RuntimeError(
                            f"request {bad.id} (prompt_len="
                            f"{bad.prompt_len}, max_new_tokens="
                            f"{bad.cfg.max_new_tokens}) can never "
                            "be admitted: engine capacity (page "
                            "pool / max_len) is too small even "
                            "when idle"))
                        self._count("failed")
                        self._slo_fail(bad)
                    continue
                break
            wait_s = time.monotonic() - h.submit_ts
            if monitor.enabled():
                # queue-wait digest: the admission-delay share of the
                # tenant's latency story (replays never pass here — a
                # replay wait is recovery, not queueing)
                self.slo.observe("queue_wait", h.tenant, wait_s)
            if trace.enabled():
                trace.event("queue.dequeue", rid=h._trace_rid,
                            wait_s=round(wait_s, 6))
            if self.control is not None:
                # brownout rungs 2/3 degrade the request AT admission
                # (cap max_new_tokens, strip speculation): the handle's
                # cfg is replaced so a
                # later replay uses the degraded budget — never the
                # original. Already-admitted requests are untouched
                # (rung transitions are bitwise-neutral for them); a
                # no-op rung returns cfg unchanged.
                h.cfg = self.control.degrade_cfg(h.cfg)
            self._start_admission(h, h.prompt, h.cfg, h.prompt_len)

    def _tenant_ok(self, h: RequestHandle) -> bool:
        """Per-tenant quota probe (scheduler thread): True when
        admitting ``h`` now keeps its tenant at or under its cap.
        Counts ADMITTED work — active slots plus the in-flight chunked
        admission; replays are exempt (they held capacity when the
        fault hit, and re-admission must not deadlock behind the quota
        they already consumed once)."""
        q = self.tenant_quotas
        if q is None or h.tenant is None:
            return True
        cap = q if isinstance(q, int) else q.get(h.tenant)
        if cap is None:
            return True
        if self.control is not None:
            # brownout rung 1: every quotaed tenant's effective cap is
            # halved (min 1) while the ladder is engaged — the gentlest
            # rung, shaving concurrency before any request degrades
            cap = self.control.quota_cap(cap)
        n = sum(1 for hh in self._active.values()
                if hh.tenant == h.tenant)
        if self._adm is not None and self._adm[1].tenant == h.tenant:
            n += 1
        return n < cap

    def _control_tick(self) -> None:
        """One control-plane pass in the gap (scheduler thread;
        rate-limited inside :meth:`ControlPlane.tick`): feed the SLO
        tracker's per-tenant burn windows + queue occupancy in, apply
        what comes out — shed windows deprioritize the tenant's
        ALREADY-QUEUED entries into the penalty band (new arrivals 429
        at submit), rung transitions trace/export and flip the one
        engine-side actuator (prefix-cache admission pause, a host
        bool — the paused path is the already warmed cold admission, so
        no rung captures anything)."""
        dec = self.control.tick(
            time.monotonic(),
            queue_depth=self.queue.depth,
            max_queue=self.queue.max_size,
            tenant_stats=(self.slo.tenant_stats()
                          if monitor.enabled() else None))
        if dec is None:
            return
        band = self.control.policy.penalty_band
        for tenant, until in dec["shed"]:
            self.queue.penalize(tenant, band, until)
            if trace.enabled():
                trace.event("control.shed", tenant=tenant,
                            reason="burn_window",
                            window_s=round(
                                until - time.monotonic(), 3),
                            server=self.monitor_server)
        for tenant in dec["unshed"]:
            self.queue.unpenalize(tenant)
        if dec["rung"] != dec["prev_rung"]:
            if trace.enabled():
                trace.event("control.rung", rung=dec["rung"],
                            prev=dec["prev_rung"],
                            action=RUNG_ACTIONS[dec["rung"]],
                            occupancy=round(dec["occupancy"], 4),
                            server=self.monitor_server)
            if monitor.enabled():
                self._rung_gauge().labels(
                    server=self.monitor_server).set(dec["rung"])
            if getattr(self.engine, "prefix_cache", False):
                # rung 4 actuator: pause prefix-cache admission (new
                # requests take the cold path). The scheduler thread
                # owns the engine; getattr/setattr routes through a
                # FaultyEngine proxy to the wrapped engine.
                self.engine.prefix_pause = dec["rung"] >= 4

    # -- memory pressure (optimistic paged mode; scheduler thread) -----------
    def _relieve_pressure(self) -> None:
        """Resolve KV memory pressure in the gap (optimistic admission
        only; nothing otherwise): grow every live slot's pages for the
        coming segment and, while the pool cannot cover the growth,
        PREEMPT victims — most SLO headroom first (no admission deadline
        before any deadline, then furthest from it), ties by lowest
        priority (highest value) then youngest, NEVER the oldest
        surviving request, so the head of the line always makes progress
        and pressure cannot deadlock or livelock the loop. A victim's
        slot and pages are reclaimed at once
        (``engine.preempt_request``) and its handle parks on the replay
        list (the engine-restart machinery), bounded per request by
        ``max_preemptions``. A request the pool cannot cover even ALONE
        fails with :class:`PagePoolExhausted` as its cause: a contained,
        request-scoped event, not an engine restart."""
        if getattr(self.engine, "admission_mode", None) != "optimistic":
            return
        sp = trace.NULL_SPAN
        if trace.enabled() and (self._active or self._adm is not None):
            sp = trace.span("gap.pressure", active=len(self._active))
        with sp:
            self._relieve_pressure_body()

    def _relieve_pressure_body(self) -> None:
        eng = self.engine
        while True:
            short = self._guard(
                "pressure",
                lambda: eng.grow_for_segment(self.segment_steps))
            if not short:
                break
            # age is the HANDLE's submit time, not the engine rid: a
            # replay re-admits under a fresh rid but keeps its seniority
            oldest = (min(self._active,
                          key=lambda r: (self._active[r].submit_ts,
                                         self._active[r].id))
                      if self._active else None)
            cands = [r for r in self._active if r != oldest]
            if cands:
                now = time.monotonic()
                victim = max(cands, key=lambda r: (
                    (float("inf") if self._active[r].deadline is None
                     else self._active[r].deadline - now),
                    self._active[r].priority,
                    self._active[r].submit_ts,
                    self._active[r].id))
                self._preempt(victim, "pressure")
                continue
            if self._adm is not None:
                # the last capacity holder left is the in-flight chunked
                # admission's claim: abort it (slot AND pages back) and
                # park its handle (before the abort guard: if the abort
                # faults, recovery finds it in _replay); the replay
                # restarts its prefill from the start
                adm, h = self._adm
                self._adm = None
                alloc = getattr(eng, "alloc", None)
                if alloc is not None:
                    alloc.count_preemption("pressure")
                self._park_preempted(h)
                self._guard("cancel", lambda: eng.abort_admit(adm))
                continue
            # nothing left to preempt: the short request cannot grow even
            # with the pool to itself, and a replay would meet the same
            # wall forever, so it fails with the typed cause
            progressed = False
            for rid in short:
                toks = self._guard(
                    "pressure",
                    lambda rid=rid: eng.preempt_request(
                        rid, reason="unsatisfiable"))
                h = self._active.pop(rid, None)
                if toks is None and h is None:
                    continue       # foreign or stale rid: nothing owned
                progressed = True
                if h is None:
                    continue       # a request driven outside this server
                if toks is not None:
                    self._push_delta(
                        h, list(toks[h._n_pushed - h._engine_base:]))
                h._finish(FAILED, PagePoolExhausted(
                    [rid],
                    f"request {h.id} cannot grow its KV mapping even with "
                    f"the pool to itself (prompt+generated="
                    f"{h.prompt_len + h._n_pushed} tokens, pool="
                    f"{eng.num_pages}x{eng.page_size} tokens) — grow "
                    f"num_pages or lower max_new_tokens"))
                self._count("failed")
                self._slo_fail(h)
            if not progressed:
                # a short rid this scheduler neither owns nor can
                # reclaim: decode_segment's own guard surfaces it
                break
        self._waiting_on_pages = sum(
            1 for h in self._replay if h._preempts > 0)

    def _preempt(self, rid: int, reason: str) -> None:
        """Preempt ONE active request: the engine reclaims its slot and
        pages (``preempt_request``), its tokens so far are pushed to the
        handle FIRST (the replay prompt is prompt + ALL generated
        tokens), then the handle parks for replay."""
        toks = self._guard(
            "pressure", lambda: self.engine.preempt_request(rid, reason))
        h = self._active.pop(rid, None)
        if h is None:
            return
        if toks is not None:
            self._push_delta(h, list(toks[h._n_pushed - h._engine_base:]))
        self._park_preempted(h)

    def _park_preempted(self, h: RequestHandle) -> None:
        """Park a preempted handle on the replay list (the next gap's
        ``_admit_replays`` re-prefills prompt + generated), enforcing its
        ``max_preemptions`` budget: past it the request fails with
        :class:`PreemptionBudgetExceeded`. A cancel-requested handle
        finishes CANCELLED instead. Dumps the flight ring once per
        ``STORM_WINDOW_S`` when ``STORM_PREEMPTS`` preemptions land in
        one window."""
        if h._cancel_requested:
            self._count("cancelled")
            h._finish(CANCELLED)
            return
        h._preempts += 1
        self._count("preempted")
        if trace.enabled():
            trace.event("preempt", rid=h._trace_rid, preempts=h._preempts,
                        emitted=h._n_pushed)
        now = time.monotonic()
        self._preempt_ts.append(now)
        cut = now - self.STORM_WINDOW_S
        while self._preempt_ts and self._preempt_ts[0] < cut:
            self._preempt_ts.pop(0)
        if (len(self._preempt_ts) >= self.STORM_PREEMPTS
                and now - self._last_storm_dump > self.STORM_WINDOW_S):
            if trace.enabled():
                trace.event("preempt.storm", count=len(self._preempt_ts),
                            window_s=self.STORM_WINDOW_S)
            # re-arm only on a WRITTEN dump: a trip with tracing off must
            # not burn the window before an operator turns tracing on
            if self._flight_dump("preemption_storm") is not None:
                self._last_storm_dump = now
        if h._preempts > self.max_preemptions:
            h._finish(FAILED, PreemptionBudgetExceeded(
                f"request {h.id} preempted {h._preempts} times under KV "
                f"memory pressure (max_preemptions={self.max_preemptions}):"
                f" the pool is too small for this request mix — grow "
                f"num_pages, lower kv_watermark, or raise max_preemptions"))
            self._count("failed")
            self._slo_fail(h)
            return
        self._replay.append(h)

    def _push_delta(self, h: RequestHandle, toks) -> None:
        """Push newly generated tokens (scheduler thread only);
        ``_n_pushed`` keeps each gap's copy O(delta), and the first
        push is the TTFT observation."""
        h._n_pushed += len(toks)
        if h._push(toks) and monitor.enabled():
            ttft = h.first_token_ts - h.submit_ts
            self._ttft_hist().labels(server=self.monitor_server).observe(
                ttft)
            # per-tenant TTFT digest (observed at the edge so /stats
            # reflects it while the request still streams; record_finish
            # scores the SLO verdict from the same stamps later)
            self.slo.observe("ttft", h.tenant, ttft)

    def _collect(self) -> None:
        """Post-segment: finish retired requests, stream deltas for the
        still-running ones. Engine-side token indices are offset by a
        replayed handle's ``_engine_base`` (tokens emitted before the
        last restart live only handle-side)."""
        for rid, seq in self.engine.collect_finished().items():
            h = self._active.pop(rid, None)
            if h is None:      # foreign request (user drove the engine)
                continue
            self._push_delta(
                h, list(seq[h._n_pushed - h._engine_base:]))
            self._count("completed")
            h._finish(FINISHED)
            if monitor.enabled():
                n = len(seq) + h._engine_base
                if h.first_token_ts is not None and n > 1:
                    self._tpot_hist().labels(
                        server=self.monitor_server).observe(
                        (h.finish_ts - h.first_token_ts) / (n - 1))
                self._slo_finish(h, n)
        for rid, h in list(self._active.items()):
            delta = self.engine.partial_tokens(
                rid, h._n_pushed - h._engine_base)
            if delta:
                self._push_delta(h, delta)
        self._depth_gauge()
