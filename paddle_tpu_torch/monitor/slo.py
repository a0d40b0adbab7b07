"""SLO-aware serving observability: mergeable latency digests,
per-tenant goodput, and burn-rate windows.

Port of ``paddle_tpu/monitor/slo.py``: pure host arithmetic, the code
unchanged, so :meth:`SLOTracker.digests_dict` / :meth:`LatencyDigest.to_dict`
keep the reference's wire format and a JAX replica's shard merges with this
package's in :func:`fleet_rollup`.

The serving layer exports raw counters and per-server
latency histograms; this module adds the layer an operator actually
pages on:

- :class:`LatencyDigest` — a streaming latency digest over FIXED
  log-spaced buckets. Because the bucket boundaries are a pure function
  of the (lo, hi, buckets_per_decade) config — never of the data —
  merging two digests is an elementwise counter add, and a percentile
  read off the merged digest is EXACTLY the percentile of the
  concatenated streams at digest resolution (one bucket width,
  ``10**(1/buckets_per_decade)`` relative). This is the invariant the
  fleet ``GET /stats`` rollup rides: fleet p99 is computed by MERGING
  replica digests, never by averaging replica percentiles (averaging
  percentiles is statistically meaningless — the classic monitoring
  bug this module exists to make structurally impossible).
- :class:`RollingDigest` — the same digest over a sliding time window
  (sharded by epoch; old shards expire wholesale), for rates that must
  reflect NOW: the slow-replica skew detector reads each replica's
  rolling TPOT p50 from one of these.
- :class:`SLOPolicy` — per-request latency thresholds
  (``ttft_p99_s`` / ``tpot_p99_s`` / ``e2e_p99_s``) plus a goodput
  target. A request MEETS the SLO when every configured threshold
  holds; **goodput** is the fraction of service-terminal requests
  (finished + failed; cancelled/expired are client verdicts and don't
  count) that met it — the distserve/splitwise quantity serving
  actually optimizes, as opposed to raw throughput. **Burn rate** is
  the SRE-shaped ``miss_fraction / (1 - goodput_target)`` over a fast
  and a slow window: burn > 1 means the error budget is being spent
  faster than it accrues.
- :class:`SLOTracker` — the per-server aggregation point: one digest
  per (metric, tenant) for ``ttft`` / ``tpot`` / ``queue_wait`` /
  ``e2e``, per-tenant goodput + burn windows + token / KV-page-second
  cost counters, and a replica-wide rolling TPOT digest for skew.
  Tenant = the request's quota bucket (defaults to its LoRA adapter
  name); base-model traffic aggregates under ``"-"``.
- :func:`fleet_rollup` — merge N trackers' wire-format shards
  (:meth:`SLOTracker.digests_dict`) into one exact fleet view; the
  Router's ``GET /stats`` and ``Server.stats()`` both build their
  payload through this one function, so single-server and fleet
  records are merge-consistent by construction.

Cost model: every mutating entry point checks
``monitor.enabled()`` first — with ``FLAGS_enable_monitor`` off the
instrumented serving paths pay one bool branch and nothing else. With
it on, an observation is two ``math.log10`` calls and a couple of dict
pokes under an uncontended lock.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from . import enabled as _monitor_enabled

__all__ = [
    "LatencyDigest", "RollingDigest", "SLOPolicy", "SLOTracker",
    "SLO_METRICS", "fleet_rollup", "tenant_key", "ALL_TENANTS",
]

# the serving latency families one tracker digests, per tenant
SLO_METRICS = ("ttft", "tpot", "queue_wait", "e2e")

# label value base-model / un-tenanted traffic aggregates under (a
# tenant is normally a LoRA adapter name; None has no label form)
DEFAULT_TENANT = "-"
# the cross-tenant aggregate key in percentile/rollup views: the merge
# of every tenant's digest for a metric (exact — same bucketization)
ALL_TENANTS = "*"


def tenant_key(tenant: Optional[str]) -> str:
    """Normalize a tenant identity to its label/dict key (None/empty →
    ``"-"``, the base-traffic bucket)."""
    return tenant if tenant else DEFAULT_TENANT


class LatencyDigest:
    """Streaming latency digest over fixed log-spaced buckets.

    Bucket ``k`` (1-based) covers ``(lo * r**(k-1), lo * r**k]`` with
    ``r = 10 ** (1 / buckets_per_decade)``; bucket 0 is the underflow
    bin (``<= lo``) and bucket ``n+1`` the overflow bin (``> hi``).
    The boundaries depend only on the config, so two digests with the
    SAME config merge exactly: elementwise counter add, and every
    percentile read off the merge equals the percentile of the
    concatenated observation streams at digest resolution.

    :meth:`percentile` returns the UPPER edge of the bucket holding the
    requested rank (clamped into the observed [min, max]), so the
    estimate is conservative and within one bucket width — a factor of
    ``r`` (~15.5% at the default 16 buckets/decade) — of the true
    order statistic, for values inside [lo, hi]. Values outside the
    range land in the open under/overflow bins where only the exact
    tracked min/max bound them; size [lo, hi] to the latency family
    (the defaults span 0.1 ms .. 1000 s).
    """

    __slots__ = ("lo", "hi", "bpd", "n", "counts", "count", "sum",
                 "min", "max", "_log_lo")

    def __init__(self, lo: float = 1e-4, hi: float = 1e3,
                 buckets_per_decade: int = 16):
        if not (0 < lo < hi):
            raise ValueError(f"need 0 < lo < hi, got lo={lo!r} hi={hi!r}")
        if buckets_per_decade < 1:
            raise ValueError(
                f"buckets_per_decade must be >= 1, got "
                f"{buckets_per_decade!r}")
        self.lo = float(lo)
        self.hi = float(hi)
        self.bpd = int(buckets_per_decade)
        self.n = max(1, math.ceil(
            self.bpd * (math.log10(self.hi) - math.log10(self.lo))
            - 1e-9))
        self.counts = [0] * (self.n + 2)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._log_lo = math.log10(self.lo)

    # -- config / identity ---------------------------------------------------
    @property
    def config(self) -> Tuple[float, float, int]:
        return (self.lo, self.hi, self.bpd)

    def _index(self, value: float) -> int:
        if value <= self.lo:
            return 0
        if value > self.hi:
            return self.n + 1
        # bucket k covers (lo*r^(k-1), lo*r^k]: ceil of the log offset
        k = math.ceil((math.log10(value) - self._log_lo) * self.bpd
                      - 1e-12)
        return min(max(k, 1), self.n)

    def _upper(self, idx: int) -> float:
        """Upper edge of bucket ``idx`` (the percentile estimate)."""
        if idx <= 0:
            return self.lo
        if idx >= self.n + 1:
            return self.max if self.max is not None else self.hi
        return self.lo * (10.0 ** (idx / self.bpd))

    # -- mutation ------------------------------------------------------------
    def observe(self, value: float) -> None:
        value = float(value)
        self.counts[self._index(value)] += 1
        self.count += 1
        self.sum += value
        if self.min is None or value < self.min:
            self.min = value
        if self.max is None or value > self.max:
            self.max = value

    def merge(self, other: "LatencyDigest") -> "LatencyDigest":
        """Merge ``other`` into self (exact: identical configs add
        counter-by-counter). Returns self for chaining."""
        if other.config != self.config:
            raise ValueError(
                f"cannot merge digests with different configs: "
                f"{self.config} vs {other.config} — fleet digests must "
                f"share one bucketization for the merge to be exact")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum += other.sum
        if other.min is not None and (self.min is None
                                      or other.min < self.min):
            self.min = other.min
        if other.max is not None and (self.max is None
                                      or other.max > self.max):
            self.max = other.max
        return self

    # -- reads ---------------------------------------------------------------
    def percentile(self, q: float) -> Optional[float]:
        """The q-th percentile estimate (upper bucket edge, clamped to
        the observed [min, max]); None on an empty digest."""
        if self.count == 0:
            return None
        rank = min(self.count, max(1, math.ceil(q / 100.0 * self.count)))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                ub = self._upper(i)
                if self.max is not None:
                    ub = min(ub, self.max)
                if self.min is not None:
                    ub = max(ub, self.min)
                return ub
        return self.max   # unreachable when counters are consistent

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def summary(self) -> Dict[str, Any]:
        """Compact human/JSON view: count/mean/max + p50/p90/p99."""
        return {
            "count": self.count,
            "mean": (round(self.mean, 6)
                     if self.count else None),
            "max": (round(self.max, 6) if self.max is not None
                    else None),
            "p50": (round(self.percentile(50), 6)
                    if self.count else None),
            "p90": (round(self.percentile(90), 6)
                    if self.count else None),
            "p99": (round(self.percentile(99), 6)
                    if self.count else None),
        }

    # -- wire format (the /stats merge path) ---------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {"lo": self.lo, "hi": self.hi, "bpd": self.bpd,
                "count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max,
                "counts": list(self.counts)}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LatencyDigest":
        out = cls(lo=d["lo"], hi=d["hi"], buckets_per_decade=d["bpd"])
        counts = list(d["counts"])
        if len(counts) != len(out.counts):
            raise ValueError(
                f"digest wire dict has {len(counts)} buckets, config "
                f"implies {len(out.counts)}")
        out.counts = [int(c) for c in counts]
        out.count = int(d["count"])
        out.sum = float(d["sum"])
        out.min = None if d.get("min") is None else float(d["min"])
        out.max = None if d.get("max") is None else float(d["max"])
        return out


class _EpochWindow:
    """Sliding-window substrate shared by :class:`RollingDigest` and
    the burn-rate counters: the window is sharded into ``shards``
    epoch-aligned cells; a touch lands in the current epoch's cell and
    cells older than the window expire WHOLESALE on the next access —
    O(1) amortized, no per-sample timestamps. One implementation, one
    expiry semantics (a snapshot spans up to ``window_s`` +- one shard
    of granularity), however the cell contents differ."""

    __slots__ = ("shard_s", "shards", "_cell_factory", "_cells")

    def __init__(self, window_s: float, shards: int, cell_factory):
        if not window_s > 0 or shards < 1:
            raise ValueError(
                f"need window_s > 0 and shards >= 1, got "
                f"{window_s!r}/{shards!r}")
        self.shard_s = float(window_s) / int(shards)
        self.shards = int(shards)
        self._cell_factory = cell_factory
        self._cells: Dict[int, Any] = {}

    def _prune(self, epoch: int) -> None:
        cut = epoch - self.shards + 1
        for e in [e for e in self._cells if e < cut]:
            del self._cells[e]

    def cell(self, now: Optional[float] = None):
        """The current epoch's cell (created on first touch)."""
        now = time.monotonic() if now is None else now
        epoch = int(now // self.shard_s)
        self._prune(epoch)
        c = self._cells.get(epoch)
        if c is None:
            c = self._cells.setdefault(epoch, self._cell_factory())
        return c

    def live(self, now: Optional[float] = None) -> list:
        """Every cell still inside the window."""
        now = time.monotonic() if now is None else now
        self._prune(int(now // self.shard_s))
        return list(self._cells.values())


class RollingDigest:
    """A :class:`LatencyDigest` over a sliding time window (an
    :class:`_EpochWindow` of digest cells). :meth:`snapshot` merges
    the live shards (exact — same config), so a percentile read
    reflects the last ``window_s``-ish seconds (granularity: one
    shard, ``window_s / shards``)."""

    def __init__(self, window_s: float = 30.0, shards: int = 6,
                 **digest_kw):
        self.window_s = float(window_s)
        self._kw = dict(digest_kw)
        self._win = _EpochWindow(window_s, shards,
                                 lambda: LatencyDigest(**self._kw))

    def observe(self, value: float,
                now: Optional[float] = None) -> None:
        self._win.cell(now).observe(value)

    def snapshot(self, now: Optional[float] = None) -> LatencyDigest:
        """Merged digest over the live window (may be empty)."""
        out = LatencyDigest(**self._kw)
        for d in self._win.live(now):
            out.merge(d)
        return out


class SLOPolicy:
    """Per-request latency SLO: thresholds + goodput target.

    A request MEETS the SLO when every configured threshold holds for
    it (``ttft_p99_s``: time to first token; ``tpot_p99_s``: per-token
    decode cadence; ``e2e_p99_s``: end to end). The *_p99 naming states
    the operating intent — run the fleet so the p99 stays under the
    threshold, i.e. goodput >= ``goodput_target`` — while the verdict
    itself is per request (that is what makes goodput a simple met/total
    fraction that merges exactly across replicas). A metric a request
    has no value for (a 1-token request has no TPOT) is skipped, not
    missed; a request that FAILED misses by definition.

    ``burn_rate`` is the SRE alerting shape: miss fraction over a
    window divided by the budget fraction ``1 - goodput_target``.
    Burn > 1 means the window spends error budget faster than the
    target accrues it; the fast window (default 60 s) catches a cliff,
    the slow one (default 600 s) a smolder."""

    def __init__(self, ttft_p99_s: Optional[float] = None,
                 tpot_p99_s: Optional[float] = None,
                 e2e_p99_s: Optional[float] = None,
                 goodput_target: float = 0.99,
                 fast_window_s: float = 60.0,
                 slow_window_s: float = 600.0):
        if ttft_p99_s is None and tpot_p99_s is None \
                and e2e_p99_s is None:
            raise ValueError(
                "SLOPolicy needs at least one threshold "
                "(ttft_p99_s / tpot_p99_s / e2e_p99_s)")
        for name, v in (("ttft_p99_s", ttft_p99_s),
                        ("tpot_p99_s", tpot_p99_s),
                        ("e2e_p99_s", e2e_p99_s)):
            if v is not None and not v > 0:
                raise ValueError(f"{name} must be > 0 or None, got {v!r}")
        if not 0.0 < goodput_target < 1.0:
            raise ValueError(
                f"goodput_target must be in (0, 1), got "
                f"{goodput_target!r}")
        if not 0 < fast_window_s <= slow_window_s:
            raise ValueError(
                f"need 0 < fast_window_s <= slow_window_s, got "
                f"{fast_window_s!r}/{slow_window_s!r}")
        self.ttft_p99_s = ttft_p99_s
        self.tpot_p99_s = tpot_p99_s
        self.e2e_p99_s = e2e_p99_s
        self.goodput_target = goodput_target
        self.fast_window_s = fast_window_s
        self.slow_window_s = slow_window_s

    def misses(self, ttft_s: Optional[float], tpot_s: Optional[float],
               e2e_s: Optional[float]) -> List[str]:
        """Which configured dimensions this request missed (empty =
        SLO met). ``None`` values are not-applicable, never a miss."""
        out = []
        if self.ttft_p99_s is not None and ttft_s is not None \
                and ttft_s > self.ttft_p99_s:
            out.append("ttft")
        if self.tpot_p99_s is not None and tpot_s is not None \
                and tpot_s > self.tpot_p99_s:
            out.append("tpot")
        if self.e2e_p99_s is not None and e2e_s is not None \
                and e2e_s > self.e2e_p99_s:
            out.append("e2e")
        return out

    def burn_rate(self, met: int, missed: int) -> Optional[float]:
        """Error-budget burn over a window's (met, missed) counts;
        None on an empty window."""
        total = met + missed
        if not total:
            return None
        return (missed / total) / (1.0 - self.goodput_target)

    def to_dict(self) -> Dict[str, Any]:
        return {"ttft_p99_s": self.ttft_p99_s,
                "tpot_p99_s": self.tpot_p99_s,
                "e2e_p99_s": self.e2e_p99_s,
                "goodput_target": self.goodput_target,
                "fast_window_s": self.fast_window_s,
                "slow_window_s": self.slow_window_s}


class _Window:
    """Rolling (met, missed) pair over the shared epoch-shard window
    — the burn-rate substrate. Caller provides locking (the
    tracker's)."""

    __slots__ = ("_win",)

    def __init__(self, window_s: float, shards: int = 6):
        self._win = _EpochWindow(window_s, shards, lambda: [0, 0])

    def add(self, met: bool, now: Optional[float] = None) -> None:
        self._win.cell(now)[0 if met else 1] += 1

    def counts(self, now: Optional[float] = None) -> Tuple[int, int]:
        cells = self._win.live(now)
        return (sum(c[0] for c in cells), sum(c[1] for c in cells))


def _blank_tenant() -> Dict[str, Any]:
    return {"requests": 0, "met": 0, "missed": 0, "failed": 0,
            "tokens": 0, "kv_page_seconds": 0.0}


def _round_opt(v: Optional[float], nd: int = 4) -> Optional[float]:
    return None if v is None else round(v, nd)


def _tenant_record(counters: Dict[str, Any],
                   policy: Optional[SLOPolicy],
                   fast: Tuple[int, int],
                   slow: Tuple[int, int]) -> Dict[str, Any]:
    """The ONE per-tenant record builder every surface shares —
    ``load()``'s slo block, ``Server.stats()``, and the fleet rollup.
    Goodput is met/(met+missed) (None before any scored request);
    burn rates divide each window's miss fraction by the policy's
    error budget. A semantics change lands here once and every
    surface moves together (the can't-drift rule)."""
    rec = dict(counters)
    rec["kv_page_seconds"] = round(rec.get("kv_page_seconds", 0.0), 3)
    if policy is not None:
        total = counters["met"] + counters["missed"]
        rec["goodput"] = (round(counters["met"] / total, 4)
                          if total else None)
        rec["burn_fast"] = _round_opt(policy.burn_rate(*fast))
        rec["burn_slow"] = _round_opt(policy.burn_rate(*slow))
    return rec


class SLOTracker:
    """Per-server SLO/goodput aggregation (one per ``serving.Server``).

    Written by the scheduler thread (observes/records), read by
    healthz/router/stats threads — every mutation and read holds one
    small internal lock, never across engine work, so reads stay
    lock-light the way ``Server.load()`` promises. Every mutating
    entry point no-ops while ``FLAGS_enable_monitor`` is off (the
    near-zero disabled path; the scheduler's call sites branch on
    ``monitor.enabled()`` too, so the off path pays ONE bool check).

    ``policy=None`` still digests latencies and accounts per-tenant
    cost (tokens, KV-page-seconds) — goodput/burn need a policy, the
    digests and the skew detector's rolling TPOT do not."""

    def __init__(self, policy: Optional[SLOPolicy] = None,
                 window_s: float = 30.0,
                 lo: float = 1e-4, hi: float = 1e3,
                 buckets_per_decade: int = 16):
        if policy is not None and not isinstance(policy, SLOPolicy):
            raise ValueError(
                f"policy must be an SLOPolicy or None, got {policy!r}")
        self.policy = policy
        self.window_s = float(window_s)
        self._kw = dict(lo=lo, hi=hi,
                        buckets_per_decade=buckets_per_decade)
        self._lock = threading.Lock()
        self._dig: Dict[Tuple[str, str], LatencyDigest] = {}
        # replica-wide rolling TPOT: what the fleet skew detector reads
        self._roll = RollingDigest(window_s=window_s, **self._kw)
        self._ten: Dict[str, Dict[str, Any]] = {}
        self._fast: Dict[str, _Window] = {}
        self._slow: Dict[str, _Window] = {}

    # -- mutation (scheduler thread) -----------------------------------------
    def _digest(self, metric: str, tenant: str) -> LatencyDigest:
        d = self._dig.get((metric, tenant))
        if d is None:
            d = self._dig.setdefault((metric, tenant),
                                     LatencyDigest(**self._kw))
        return d

    def observe(self, metric: str, tenant: Optional[str],
                value: float) -> None:
        """One latency observation (``metric`` in :data:`SLO_METRICS`).
        No-op while the monitor is disabled."""
        if not _monitor_enabled():
            return
        t = tenant_key(tenant)
        with self._lock:
            self._digest(metric, t).observe(value)
            if metric == "tpot":
                self._roll.observe(value)

    def record_finish(self, tenant: Optional[str],
                      ttft_s: Optional[float],
                      tpot_s: Optional[float], e2e_s: float,
                      n_tokens: int, kv_page_seconds: float = 0.0
                      ) -> Tuple[bool, List[str]]:
        """Record one FINISHED request: digests its tpot/e2e (ttft and
        queue_wait were observed at their edges), applies the policy
        verdict, and accounts tokens + KV-page-seconds to its tenant.
        Returns ``(met, missed_dimensions)`` so the caller can emit
        monitor counters; ``(True, [])`` while disabled or policy-free.
        """
        if not _monitor_enabled():
            return True, []
        t = tenant_key(tenant)
        misses: List[str] = []
        if self.policy is not None:
            misses = self.policy.misses(ttft_s, tpot_s, e2e_s)
        met = not misses
        with self._lock:
            if tpot_s is not None:
                self._digest("tpot", t).observe(tpot_s)
                self._roll.observe(tpot_s)
            self._digest("e2e", t).observe(e2e_s)
            ten = self._ten.setdefault(t, _blank_tenant())
            ten["requests"] += 1
            ten["tokens"] += int(n_tokens)
            ten["kv_page_seconds"] += float(kv_page_seconds)
            if self.policy is not None:
                ten["met" if met else "missed"] += 1
                self._window(t).add(met)
                self._window(t, slow=True).add(met)
        return met, misses

    def record_failure(self, tenant: Optional[str]) -> None:
        """A request the service failed to deliver (FAILED terminal):
        an SLO miss by definition. Cancelled/expired requests are
        client verdicts and are NOT recorded."""
        if not _monitor_enabled():
            return
        t = tenant_key(tenant)
        with self._lock:
            ten = self._ten.setdefault(t, _blank_tenant())
            ten["requests"] += 1
            ten["failed"] += 1
            if self.policy is not None:
                ten["missed"] += 1
                self._window(t).add(False)
                self._window(t, slow=True).add(False)

    def _window(self, tenant: str, slow: bool = False) -> _Window:
        store = self._slow if slow else self._fast
        w = store.get(tenant)
        if w is None:
            span = (self.policy.slow_window_s if slow
                    else self.policy.fast_window_s)
            w = store.setdefault(tenant, _Window(span))
        return w

    # -- reads (any thread) --------------------------------------------------
    def goodput(self, tenant: Optional[str] = None) -> Optional[float]:
        """Lifetime goodput for one tenant (or the aggregate over all,
        ``tenant=None``...naming the default bucket needs ``"-"``);
        None without a policy or before any scored request."""
        if self.policy is None:
            return None
        with self._lock:
            if tenant is None:
                met = sum(v["met"] for v in self._ten.values())
                missed = sum(v["missed"] for v in self._ten.values())
            else:
                ten = self._ten.get(tenant_key(tenant))
                if ten is None:
                    return None
                met, missed = ten["met"], ten["missed"]
        total = met + missed
        return met / total if total else None

    def rolling_tpot_p50(self, min_count: int = 1) -> Optional[float]:
        """Rolling-window TPOT p50 (replica-wide, all tenants) — the
        skew detector's input. None until ``min_count`` observations
        sit in the window (a starved replica must read unknown, not
        fast)."""
        with self._lock:
            snap = self._roll.snapshot()
        if snap.count < max(1, min_count):
            return None
        return snap.percentile(50)

    def tenant_stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-tenant counters + goodput/burn (policy permitting) —
        the ``/healthz`` ``slo`` block's tenants table."""
        with self._lock:
            tens = {t: dict(v) for t, v in self._ten.items()}
            windows = {}
            if self.policy is not None:
                for t in tens:
                    windows[t] = (self._fast[t].counts()
                                  if t in self._fast else (0, 0),
                                  self._slow[t].counts()
                                  if t in self._slow else (0, 0))
        out = {}
        for t, v in tens.items():
            fast, slow = windows.get(t, ((0, 0), (0, 0)))
            out[t] = _tenant_record(v, self.policy, fast, slow)
        return out

    def percentiles(self) -> Dict[str, Dict[str, Dict[str, Any]]]:
        """{metric: {tenant: summary}} including the exact all-tenants
        aggregate under ``"*"`` (a digest merge, not an average)."""
        with self._lock:
            out: Dict[str, Dict[str, Dict[str, Any]]] = {}
            aggs: Dict[str, LatencyDigest] = {}
            for (metric, t), d in self._dig.items():
                out.setdefault(metric, {})[t] = d.summary()
                agg = aggs.get(metric)
                if agg is None:
                    aggs[metric] = agg = LatencyDigest(**self._kw)
                agg.merge(d)
            for metric, agg in aggs.items():
                out[metric][ALL_TENANTS] = agg.summary()
        return out

    def snapshot(self) -> Optional[Dict[str, Any]]:
        """Compact host-side view for ``Server.load()``/``/healthz``:
        policy, per-tenant goodput/burn/cost, and the headline p50/p99s
        per tenant. None while nothing has been recorded (an idle or
        monitor-off server adds no ``slo`` block)."""
        tens = self.tenant_stats()
        with self._lock:
            have_dig = bool(self._dig)
        if not tens and not have_dig:
            return None
        out: Dict[str, Any] = {"window_s": self.window_s,
                               "tenants": tens}
        if self.policy is not None:
            out["policy"] = self.policy.to_dict()
        with self._lock:
            for metric in ("ttft", "tpot"):
                per = {}
                for (m, t), d in self._dig.items():
                    if m == metric and d.count:
                        per[t] = {"p50": round(d.percentile(50), 6),
                                  "p99": round(d.percentile(99), 6),
                                  "count": d.count}
                if per:
                    out[metric] = per
        return out

    def digests_dict(self) -> Dict[str, Any]:
        """The mergeable WIRE format: everything a fleet rollup needs
        to reconstruct this server's contribution exactly — digests per
        (metric, tenant), the rolling TPOT digest, per-tenant counters,
        and the burn-window (met, missed) counts. Pure host data
        (JSON-serializable), the shape a future remote replica ships
        over HTTP."""
        with self._lock:
            metrics: Dict[str, Dict[str, Any]] = {}
            for (metric, t), d in self._dig.items():
                metrics.setdefault(metric, {})[t] = d.to_dict()
            out = {
                "config": dict(self._kw, window_s=self.window_s),
                "policy": (self.policy.to_dict()
                           if self.policy is not None else None),
                "metrics": metrics,
                "rolling_tpot": self._roll.snapshot().to_dict(),
                "tenants": {t: dict(v) for t, v in self._ten.items()},
                "windows": {
                    t: {"fast": list(self._fast[t].counts())
                        if t in self._fast else [0, 0],
                        "slow": list(self._slow[t].counts())
                        if t in self._slow else [0, 0]}
                    for t in self._ten} if self.policy is not None
                else {},
            }
        return out


def fleet_rollup(shards: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge N :meth:`SLOTracker.digests_dict` shards into one EXACT
    fleet view — the ``GET /stats`` payload body.

    Percentiles come from digest MERGES (identical bucketization →
    elementwise add → the merged digest is the digest of the
    concatenated streams); goodput/burn come from SUMMED met/missed
    counters. Both are exact merge semantics: no percentile averaging,
    no rate-of-averages. ``Server.stats()`` is a 1-shard rollup through
    this same function, so single-server and fleet records can never
    drift in shape or math."""
    merged: Dict[Tuple[str, str], LatencyDigest] = {}
    tenants: Dict[str, Dict[str, Any]] = {}
    windows: Dict[str, Dict[str, List[int]]] = {}
    policy_d: Optional[Dict[str, Any]] = None
    window_s: Optional[float] = None
    for sh in shards:
        if not sh:
            continue
        if policy_d is None:
            policy_d = sh.get("policy")
        if window_s is None:
            window_s = (sh.get("config") or {}).get("window_s")
        for metric, per_t in (sh.get("metrics") or {}).items():
            for t, dd in per_t.items():
                d = LatencyDigest.from_dict(dd)
                cur = merged.get((metric, t))
                if cur is None:
                    merged[(metric, t)] = d
                else:
                    cur.merge(d)
        for t, v in (sh.get("tenants") or {}).items():
            ten = tenants.setdefault(t, _blank_tenant())
            for k in ("requests", "met", "missed", "failed", "tokens"):
                ten[k] += int(v.get(k, 0))
            ten["kv_page_seconds"] += float(v.get("kv_page_seconds",
                                                  0.0))
        for t, w in (sh.get("windows") or {}).items():
            dst = windows.setdefault(t, {"fast": [0, 0],
                                         "slow": [0, 0]})
            for span in ("fast", "slow"):
                pair = w.get(span) or [0, 0]
                dst[span][0] += int(pair[0])
                dst[span][1] += int(pair[1])
    policy = (SLOPolicy(**policy_d)
              if policy_d and any(
                  policy_d.get(k) is not None
                  for k in ("ttft_p99_s", "tpot_p99_s", "e2e_p99_s"))
              else None)
    metrics: Dict[str, Dict[str, Dict[str, Any]]] = {}
    aggs: Dict[str, LatencyDigest] = {}
    for (metric, t), d in merged.items():
        metrics.setdefault(metric, {})[t] = d.summary()
        agg = aggs.get(metric)
        if agg is None:
            aggs[metric] = LatencyDigest(lo=d.lo, hi=d.hi,
                                         buckets_per_decade=d.bpd
                                         ).merge(d)
        else:
            agg.merge(d)
    for metric, agg in aggs.items():
        metrics[metric][ALL_TENANTS] = agg.summary()
    tstats: Dict[str, Dict[str, Any]] = {}
    for t, v in tenants.items():
        w = windows.get(t, {"fast": [0, 0], "slow": [0, 0]})
        tstats[t] = _tenant_record(v, policy, tuple(w["fast"]),
                                   tuple(w["slow"]))
    return {"policy": policy_d, "window_s": window_s,
            "tenants": tstats, "metrics": metrics}
