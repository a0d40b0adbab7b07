"""Request queue + per-request handles for the online serving layer.

Port of ``paddle_tpu/serving/queue.py`` (pure host Python, unchanged but
for the trace ring it records into). The reference server stack sits
above AnalysisPredictor and owns the
request lifecycle (accept → queue → schedule → stream → finish); this
module is the lifecycle half of our equivalent: a bounded, priority- and
deadline-aware :class:`RequestQueue` feeding the scheduler, and a
:class:`RequestHandle` the client holds — blocking ``result()``, an
incremental token-``stream()`` iterator, and ``cancel()``.

Thread model: clients (HTTP handler threads, user threads) touch ONLY
the handle's public surface and ``RequestQueue.put``; every state
transition (admit, push tokens, finish, expire) is driven by the single
scheduler thread, so the engine itself never needs a lock.
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from .. import tracing as trace

__all__ = [
    "RequestHandle", "RequestQueue", "RequestRejected", "QueueFull",
    "RequestCancelled", "DeadlineExpired", "RequestFailed",
    "QUEUED", "RUNNING", "FINISHED", "CANCELLED", "EXPIRED", "FAILED",
]

# handle lifecycle states
QUEUED = "queued"
RUNNING = "running"
FINISHED = "finished"
CANCELLED = "cancelled"
EXPIRED = "expired"
FAILED = "failed"
_TERMINAL = (FINISHED, CANCELLED, EXPIRED, FAILED)


class RequestRejected(RuntimeError):
    """Backpressure rejection at submit time (the HTTP layer maps this
    to 429/503). ``reason`` is machine-readable; the message says what
    the client should do about it. ``retry_after_s`` (when set) is the
    server's honest wait estimate — a shed rejection derives it from
    the remaining burn window and the HTTP layer turns it into a
    ``Retry-After`` header."""

    def __init__(self, reason: str, message: str,
                 retry_after_s: Optional[float] = None):
        super().__init__(message)
        self.reason = reason
        self.retry_after_s = retry_after_s


class QueueFull(RequestRejected):
    """The bounded request queue is at capacity — retry later (429)."""

    def __init__(self, max_size: int):
        super().__init__(
            "queue_full",
            f"request queue full ({max_size} waiting); retry later")


class RequestCancelled(RuntimeError):
    """``result()`` on a request that was cancelled; partial tokens stay
    readable via ``handle.tokens_so_far()``."""


class DeadlineExpired(RuntimeError):
    """``result()`` on a request whose deadline passed before admission."""


class RequestFailed(RuntimeError):
    """``result()`` on a request that FAILED: one the scheduler could
    never run (e.g. a prompt that cannot ever fit the engine's page
    pool), one whose admission hit a request-scoped fault (the cause
    rides in the message; everyone else kept serving), or one that
    exceeded its replay budget across engine restarts."""


class RequestHandle:
    """One submitted request's client-side handle.

    - ``result(timeout)`` blocks for the full generated ids (prompt NOT
      included, matching ``engine.serve()``), raising
      :class:`RequestCancelled` / :class:`DeadlineExpired` /
      :class:`RequestFailed` on the non-finish terminals;
    - ``stream(timeout)`` / iteration yields token ids INCREMENTALLY as
      decode segments emit them — the first token arrives long before
      the request finishes (that gap is the TTFT the bench reports);
    - ``cancel()`` flags the request; the scheduler retires its slot at
      the next inter-segment gap (capacity is reclaimed, not leaked).

    ``submit_ts`` / ``first_token_ts`` / ``finish_ts`` are
    ``time.monotonic()`` stamps the serving metrics (TTFT, TPOT) are
    derived from.
    """

    def __init__(self, req_id: int, prompt, prompt_len: int, cfg,
                 priority: int = 0, deadline: Optional[float] = None,
                 on_cancel: Optional[Callable[["RequestHandle"], None]]
                 = None, tenant: Optional[str] = None):
        self.id = req_id
        self.prompt = prompt
        self.prompt_len = prompt_len
        self.cfg = cfg
        self.priority = priority
        # tenant identity for per-tenant admission quotas (None =
        # untracked): the scheduler defaults it to the request's LoRA
        # adapter name — in multi-tenant LoRA serving the fine-tune IS
        # the tenant — but an explicit tenant can group requests across
        # adapters (or quota base-model traffic)
        self.tenant = tenant
        self.deadline = deadline          # absolute time.monotonic()
        self.engine_rid: Optional[int] = None
        self.submit_ts = time.monotonic()
        self.admit_ts: Optional[float] = None   # FIRST admission (the
        #                      SLO tracker's KV-page-second integral
        #                      starts here; replays keep the original)
        self.first_token_ts: Optional[float] = None
        self.finish_ts: Optional[float] = None
        self._cv = threading.Condition()
        self._tokens: List[int] = []
        self._n_pushed = 0   # scheduler-thread bookkeeping: tokens the
        #                      scheduler has already pushed, so each
        #                      segment pushes a delta (O(new tokens),
        #                      not a re-copy of the whole history)
        self._status = QUEUED
        self._error: Optional[BaseException] = None
        self._cancel_requested = False
        self._on_cancel = on_cancel
        # supervised-recovery bookkeeping (scheduler thread only):
        # _replays counts engine restarts this request survived (each
        # re-prefills prompt + tokens emitted so far; bounded by the
        # server's max_replays); _engine_base is the handle-side token
        # count at the LAST replay admission — the engine's token list
        # restarts at 0 there, so engine index = handle index - base.
        # _preempts counts memory-pressure preemptions (same replay
        # machinery, separate budget: the server's max_preemptions)
        self._replays = 0
        self._preempts = 0
        self._engine_base = 0
        # trace key (paddle_tpu_torch.tracing): the serving scheduler stamps
        # "<server_label>:<id>" at submit so concurrent servers' request
        # ids never collide in the process-wide ring; a bare handle
        # (tests driving the queue directly) traces under its raw id.
        # _trace_ttft: whether THIS handle's first push is the
        # client-visible TTFT edge — False for a replica-inner handle
        # living under a router-supplied rid (the RouterHandle emits
        # the one true first_token; a failover resubmit's first push
        # is mid-stream, not a TTFT edge)
        self._trace_rid = None
        self._trace_ttft = True

    # -- client surface ------------------------------------------------------
    @property
    def status(self) -> str:
        with self._cv:
            return self._status

    @property
    def done(self) -> bool:
        with self._cv:
            return self._status in _TERMINAL

    def cancel(self) -> None:
        """Request cancellation (idempotent). A queued request is dropped
        at the next admission pass; a running request's slot (and pages)
        is retired at the next inter-segment gap."""
        with self._cv:
            if self._status in _TERMINAL:
                return
            self._cancel_requested = True
        if self._on_cancel is not None:
            self._on_cancel(self)

    def tokens_so_far(self) -> List[int]:
        with self._cv:
            return list(self._tokens)

    def timeline(self) -> List[dict]:
        """This request's ordered trace-event timeline (see
        ``paddle_tpu_torch.tracing``): queue → admit → segments →
        (preempt → replay …) → finish, assembled on demand from the
        process-wide ring. Requires tracing to have been ENABLED while
        the request ran (``FLAGS_enable_trace``); returns ``[]``
        otherwise, and may be partial for a long-finished request (the
        ring is bounded). The timeline is keyed by the HANDLE id, not
        the engine rid, so it survives preempt-replay and engine
        restarts."""
        return trace.timeline(self._trace_rid if self._trace_rid
                              is not None else self.id)

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until terminal; returns generated ids [n] (np.int32).
        Raises TimeoutError if ``timeout`` elapses first."""
        with self._cv:
            if not self._cv.wait_for(
                    lambda: self._status in _TERMINAL, timeout):
                raise TimeoutError(
                    f"request {self.id} not finished within {timeout}s")
            status, err = self._status, self._error
            toks = np.asarray(self._tokens, np.int32)
        if status == FINISHED:
            return toks
        if status == CANCELLED:
            raise RequestCancelled(
                f"request {self.id} cancelled after {len(toks)} tokens")
        if status == EXPIRED:
            raise DeadlineExpired(
                f"request {self.id} deadline expired before admission")
        raise RequestFailed(str(err)) from err

    def stream(self, timeout: Optional[float] = None):
        """Yield generated token ids as they arrive; returns when the
        request reaches a terminal state (a CANCELLED stream simply ends
        after the partial tokens). ``timeout`` bounds each wait for the
        NEXT token, not the whole stream; expiry raises TimeoutError.
        EXPIRED/FAILED terminals re-raise like ``result()``.

        A raised TimeoutError ENDS the generator (Python generator
        semantics — a later ``next()`` returns StopIteration, it does
        not resume the wait): poll-style consumers should call
        ``stream()`` again, or read ``tokens_so_far()``/``status``
        directly the way the router's relay does."""
        sent = 0
        while True:
            with self._cv:
                if not self._cv.wait_for(
                        lambda: (len(self._tokens) > sent
                                 or self._status in _TERMINAL), timeout):
                    raise TimeoutError(
                        f"request {self.id}: no token within {timeout}s")
                chunk = self._tokens[sent:]
                status, err = self._status, self._error
            for t in chunk:
                yield t
            sent += len(chunk)
            if status in _TERMINAL and sent == len(self.tokens_so_far()):
                if status == EXPIRED:
                    raise DeadlineExpired(
                        f"request {self.id} deadline expired before "
                        "admission")
                if status == FAILED:
                    raise RequestFailed(str(err)) from err
                return

    __iter__ = stream

    # -- scheduler surface (single scheduler thread) -------------------------
    def _push(self, tokens) -> bool:
        """Append newly generated tokens; returns True when these are
        the request's FIRST tokens (TTFT edge)."""
        if not tokens:
            return False
        with self._cv:
            first = not self._tokens
            if first:
                self.first_token_ts = time.monotonic()
            self._tokens.extend(int(t) for t in tokens)
            self._cv.notify_all()
        if first and self._trace_ttft and trace.enabled():
            # the TTFT edge: serve_bench's trace-derived decomposition
            # splits submit->here into queue + prefill + gap shares
            trace.event("first_token",
                        rid=(self._trace_rid if self._trace_rid
                             is not None else self.id),
                        n=len(tokens))
        return first

    def _finish(self, status: str,
                error: Optional[BaseException] = None) -> None:
        with self._cv:
            if self._status in _TERMINAL:
                return
            self._status = status
            self._error = error
            self.finish_ts = time.monotonic()
            n = len(self._tokens)
            self._cv.notify_all()
        if trace.enabled():
            # one choke point covers EVERY terminal (finished /
            # cancelled / expired / failed) — the timeline's last event
            attrs = {"status": status, "n_tokens": n}
            if error is not None:
                attrs["error"] = repr(error)
            trace.event("finish",
                        rid=(self._trace_rid if self._trace_rid
                             is not None else self.id), **attrs)

    def _mark_running(self, engine_rid: int) -> None:
        with self._cv:
            self.engine_rid = engine_rid
            self._status = RUNNING
            if self.admit_ts is None:
                self.admit_ts = time.monotonic()


class RequestQueue:
    """Bounded priority queue of :class:`RequestHandle` (lower
    ``priority`` value = served first; FIFO within a priority).

    ``put`` applies BACKPRESSURE: a full queue raises :class:`QueueFull`
    (reject-with-reason — the 429 path) instead of growing without
    bound while the engine falls behind. Cancelled and deadline-expired
    entries are reaped at pop time and handed back to the scheduler for
    finalization — an expired request never admits.

    ``age_after_s`` enables PRIORITY AGING: a waiting request's
    effective priority improves by one level per ``age_after_s``
    seconds queued, so under sustained high-priority load a
    low-priority request is eventually served instead of starving
    forever. Aging is applied in :meth:`reap` (the scheduler calls it
    every inter-segment gap); FIFO order within an effective priority
    is preserved. ``None`` (default) keeps strict static priority.

    :meth:`penalize` pushes one tenant's entries into a PENALTY BAND
    (effective priority ``base + band``) until a deadline — the
    control plane's deprioritize-not-drop actuator for a tenant whose
    burn window fired. While the window is active, aging operates
    WITHIN the band: an aged penalized entry improves toward (but is
    clamped strictly above) its base priority, so a shed tenant's
    backlog can never age its way back to parity with healthy
    tenants before the window closes. Past the deadline the penalty
    clears and normal aging (from base) resumes.
    """

    def __init__(self, max_size: int,
                 age_after_s: Optional[float] = None):
        if max_size < 1:
            raise ValueError(f"max_size must be >= 1, got {max_size}")
        if age_after_s is not None and not age_after_s > 0:
            raise ValueError(
                f"age_after_s must be > 0 or None, got {age_after_s!r}")
        self.max_size = max_size
        self.age_after_s = age_after_s
        self._lock = threading.Lock()
        self._heap: List[Tuple[int, int, RequestHandle]] = []
        self._seq = itertools.count()
        # tenant -> (band, until_ts): active penalty windows
        self._penalty: dict = {}          # guarded-by: self._lock

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._heap)

    def put(self, handle: RequestHandle) -> None:
        with self._lock:
            if len(self._heap) >= self.max_size:
                raise QueueFull(self.max_size)
            eff = handle.priority
            pen = (self._penalty.get(handle.tenant)
                   if self._penalty else None)
            if pen is not None and time.monotonic() < pen[1]:
                eff += pen[0]
            heapq.heappush(self._heap,
                           (eff, next(self._seq), handle))

    def penalize(self, tenant: Optional[str], band: int,
                 until: float) -> None:
        """Deprioritize every queued (and future) entry of ``tenant``
        by ``band`` priority levels until ``until`` (absolute
        ``time.monotonic()``). Idempotent; re-penalizing extends or
        re-bases the window."""
        if tenant is None or band < 1:
            return
        with self._lock:
            self._penalty[tenant] = (int(band), float(until))
            changed = False
            for i, (eff, seq, h) in enumerate(self._heap):
                if h.tenant == tenant:
                    self._heap[i] = (h.priority + int(band), seq, h)
                    changed = True
            if changed:
                heapq.heapify(self._heap)

    def unpenalize(self, tenant: Optional[str]) -> None:
        """Clear a tenant's penalty window early and restore its
        queued entries to base priority (aging re-applies from there
        on the next :meth:`reap`)."""
        with self._lock:
            if self._penalty.pop(tenant, None) is None:
                return
            changed = False
            for i, (eff, seq, h) in enumerate(self._heap):
                if h.tenant == tenant and eff != h.priority:
                    self._heap[i] = (h.priority, seq, h)
                    changed = True
            if changed:
                heapq.heapify(self._heap)

    def reap(self, now: float) -> List[RequestHandle]:
        """Remove every cancelled/expired entry (anywhere in the queue,
        not just the head — a deep queue must not hold dead entries
        against ``max_size``) and return them for finalization. Also
        applies priority AGING (``age_after_s``): entries whose waited
        time crossed another aging step get their effective priority
        bumped and the heap re-ordered — penalized tenants age within
        their penalty band (clamped strictly above base priority)
        until the window expires."""
        with self._lock:
            expired_pen = [t for t, (_, until) in self._penalty.items()
                           if now >= until]
            if expired_pen:
                gone_pen = set(expired_pen)
                for t in expired_pen:
                    del self._penalty[t]
                changed = False
                for i, (eff, seq, h) in enumerate(self._heap):
                    if h.tenant in gone_pen and eff > h.priority:
                        self._heap[i] = (h.priority, seq, h)
                        changed = True
                if changed:
                    heapq.heapify(self._heap)
            if self.age_after_s is not None:
                aged = False
                for i, (eff, seq, h) in enumerate(self._heap):
                    credit = int((now - h.submit_ts) / self.age_after_s)
                    pen = self._penalty.get(h.tenant)
                    if pen is not None:
                        # age WITHIN the band: a shed tenant's entry
                        # improves but never reaches base parity while
                        # the window is open
                        new = max(h.priority + 1,
                                  h.priority + pen[0] - credit)
                    else:
                        new = h.priority - credit
                    if new < eff:
                        self._heap[i] = (new, seq, h)
                        aged = True
                if aged:
                    heapq.heapify(self._heap)
            dead = [h for _, _, h in self._heap
                    if h._cancel_requested
                    or (h.deadline is not None and now >= h.deadline)]
            if dead:
                gone = set(id(h) for h in dead)
                self._heap = [e for e in self._heap
                              if id(e[2]) not in gone]
                heapq.heapify(self._heap)
            return dead

    def pop_if(self, pred: Callable[[RequestHandle], bool]
               ) -> Optional[RequestHandle]:
        """Pop and return the head iff ``pred(head)`` — the scheduler's
        admission probe (no head-of-line bypass: requests admit in
        priority/FIFO order, like ``engine.serve()``'s pending list)."""
        with self._lock:
            if self._heap and pred(self._heap[0][2]):
                return heapq.heappop(self._heap)[2]
            return None

    def pop_admittable(self, fits: Callable[[RequestHandle], bool],
                       allowed: Callable[[RequestHandle], bool]
                       ) -> Optional[RequestHandle]:
        """Quota-aware admission pop: walk the queue in priority/FIFO
        order and pop the first entry that both ``fits`` (engine
        capacity) and is ``allowed`` (per-tenant quota). The scan STOPS
        at the first entry that does not fit — capacity keeps the
        no-head-of-line-bypass contract of :meth:`pop_if` — but entries
        deferred only by ``allowed`` are SKIPPED, so one tenant sitting
        over its quota defers its own work without starving every
        tenant queued behind it. O(n log n) over the waiting queue —
        bounded by ``max_size``, and only runs when quotas are
        configured."""
        with self._lock:
            for entry in sorted(self._heap):
                h = entry[2]
                if not fits(h):
                    return None
                if not allowed(h):
                    continue
                self._heap.remove(entry)
                heapq.heapify(self._heap)
                return h
            return None

    def drain_all(self) -> List[RequestHandle]:
        """Remove and return everything (shutdown path)."""
        with self._lock:
            out = [h for _, _, h in self._heap]
            self._heap = []
            return out
