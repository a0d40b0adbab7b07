"""SLO-driven overload control plane: the observe→act loop, host-side.

Port of ``paddle_tpu/serving/control.py``, whole: pure host arithmetic
that imports nothing. The SLO tracker (``monitor/slo.py``) gives the
senses (per-tenant goodput, fast/slow burn-rate windows); the queue, the
tenant quotas and the engine's admission give the muscles. Without a
connection, under sustained overload the stack admits until the queue
rejects, and one hot tenant burns every tenant's error budget. This
module is the connection, three escalating actuators that each consume
signals that already exist and move levers that already exist:

- **Burn-rate admission control** (:meth:`ControlPlane.tick` →
  scheduler submit path): when a tenant's FAST burn window fires
  (``burn_fast >= shed_burn`` with at least ``shed_min_count`` scored
  requests — one unlucky request must not shed a tenant), new submits
  for that tenant are rejected with ``RequestRejected("shed")``
  carrying a ``retry_after_s`` derived from the burn window (HTTP 429
  + ``Retry-After``), and entries ALREADY queued are deprioritized
  into the queue's penalty band rather than dropped — admitted work is
  never degraded, queued work yields to other tenants, new work waits
  out the window.
- **Brownout ladder** (:attr:`ControlPlane.rung`): a fleet-wide
  ordered degradation ladder driven by queue occupancy (and forced to
  at least rung 1 by any tenant burning hot) —

      rung 1: tighten per-tenant quotas (effective cap halves)
      rung 2: cap ``max_new_tokens`` on FUTURE admissions
      rung 3: disable speculative decoding on FUTURE admissions
      rung 4: pause prefix-cache admission (no new CoW/shared pages)

  Rung 3 clears ``speculative`` on the configs of future admissions
  (including the ``Server``'s default opt-in); rung 4 flips the paged
  engine's ``prefix_pause``.

  Engagement is immediate (overload is urgent: the ladder can jump
  several rungs in one tick); DISENGAGEMENT is hysteretic — one rung
  at a time, only after occupancy drops ``rung_hysteresis`` below the
  rung's engage threshold AND the rung has been held ``rung_dwell_s``
  (a load oscillating around a threshold must not flap the ladder).
  Every transition is traced (``control.rung``) and visible in
  ``/healthz``. All four rungs are host-side decisions about FUTURE
  admissions: already-admitted requests keep their exact
  configuration, so rung transitions are bitwise-neutral for running
  greedy streams and no rung compiles a new program.
- **Elastic fleet** (:class:`ElasticController` → router supervisor
  tick): grow/shrink the replica count from queue depth per routable
  replica (+ fleet burn). Decisions are rate-limited (one scale event
  per ``scale_cooldown_s``) and hysteretic (``scale_signals``
  CONSECUTIVE agreeing ticks required), and scale-down always drains:
  never fail an in-flight handle. Its caller, the fleet router, is not
  ported yet (ROADMAP A10); the controller's decisions are.

Everything here is plain host arithmetic on snapshot dicts: zero
device work, zero new compiled programs, deterministic under an
explicit ``now`` (the flap-resistance tests drive synthetic clocks
through the same code paths production uses).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["ControlPolicy", "ControlPlane", "ElasticController",
           "RUNG_ACTIONS", "max_burn"]

# brownout ladder size (rungs 1..N_RUNGS; 0 = fully disengaged)
N_RUNGS = 4
RUNG_ACTIONS = ("off", "quota_tighten", "max_new_cap", "spec_off",
                "prefix_pause")


class ControlPolicy:
    """Thresholds + rate limits for the whole control plane.

    One policy object configures all three actuators so a deployment
    tunes overload behavior in one place; the server consumes the shed
    / brownout knobs, the router the elastic ones. Defaults are sized
    for the CPU-tiny bench fixtures — a real deployment should derive
    them from its SLO policy and fleet size."""

    def __init__(self, *,
                 shed_burn: float = 2.0,
                 shed_min_count: int = 8,
                 penalty_band: int = 8,
                 rung_up: Tuple[float, ...] = (0.5, 0.65, 0.8, 0.9),
                 rung_hysteresis: float = 0.15,
                 rung_dwell_s: float = 2.0,
                 brownout_max_new: int = 32,
                 tick_interval_s: float = 0.25,
                 scale_up_depth: float = 4.0,
                 scale_down_depth: float = 0.5,
                 scale_signals: int = 3,
                 scale_cooldown_s: float = 10.0):
        if not shed_burn > 0:
            raise ValueError(
                f"shed_burn must be > 0, got {shed_burn!r}")
        if shed_min_count < 1:
            raise ValueError(
                f"shed_min_count must be >= 1, got {shed_min_count!r}")
        if penalty_band < 1:
            raise ValueError(
                f"penalty_band must be >= 1, got {penalty_band!r}")
        if len(rung_up) != N_RUNGS:
            raise ValueError(
                f"rung_up needs {N_RUNGS} engage thresholds "
                f"(one per rung), got {rung_up!r}")
        if list(rung_up) != sorted(rung_up) or not rung_up[0] > 0:
            raise ValueError(
                f"rung_up thresholds must be positive and "
                f"non-decreasing, got {rung_up!r}")
        if not rung_hysteresis > 0:
            raise ValueError(
                f"rung_hysteresis must be > 0, got {rung_hysteresis!r}")
        if not rung_dwell_s >= 0:
            raise ValueError(
                f"rung_dwell_s must be >= 0, got {rung_dwell_s!r}")
        if brownout_max_new < 1:
            raise ValueError(
                f"brownout_max_new must be >= 1, got "
                f"{brownout_max_new!r}")
        if not tick_interval_s >= 0:
            raise ValueError(
                f"tick_interval_s must be >= 0, got "
                f"{tick_interval_s!r}")
        if not scale_up_depth > scale_down_depth >= 0:
            raise ValueError(
                f"need scale_up_depth > scale_down_depth >= 0, got "
                f"{scale_up_depth!r}/{scale_down_depth!r}")
        if scale_signals < 1:
            raise ValueError(
                f"scale_signals must be >= 1, got {scale_signals!r}")
        if not scale_cooldown_s >= 0:
            raise ValueError(
                f"scale_cooldown_s must be >= 0, got "
                f"{scale_cooldown_s!r}")
        self.shed_burn = float(shed_burn)
        self.shed_min_count = int(shed_min_count)
        self.penalty_band = int(penalty_band)
        self.rung_up = tuple(float(v) for v in rung_up)
        self.rung_hysteresis = float(rung_hysteresis)
        self.rung_dwell_s = float(rung_dwell_s)
        self.brownout_max_new = int(brownout_max_new)
        self.tick_interval_s = float(tick_interval_s)
        self.scale_up_depth = float(scale_up_depth)
        self.scale_down_depth = float(scale_down_depth)
        self.scale_signals = int(scale_signals)
        self.scale_cooldown_s = float(scale_cooldown_s)


class ControlPlane:
    """Per-server control state: shed windows + the brownout ladder.

    Driven from the scheduler's inter-segment gap (:meth:`tick`, which
    rate-limits itself to ``tick_interval_s``) and read from the
    submit path (:meth:`shed_check`) and the admission path
    (:attr:`rung`, :meth:`degrade_cfg`). All state is host dicts under
    one small lock — reads never wait on engine work, matching the
    ``Server.load()`` promise."""

    def __init__(self, policy: ControlPolicy, *,
                 fast_window_s: float = 60.0):
        if not isinstance(policy, ControlPolicy):
            raise ValueError(
                f"policy must be a ControlPolicy, got {policy!r}")
        self.policy = policy
        self.fast_window_s = float(fast_window_s)
        self._lock = threading.Lock()
        self.rung = 0                     # guarded-by: self._lock
        self._rung_since = -1e18          # guarded-by: self._lock
        self._shed_until: Dict[str, float] = {}  # guarded-by: _lock
        # lifetime shed counts per (tenant, reason) — the /healthz and
        # monitor-series source of truth
        self._shed_counts: Dict[Tuple[str, str], int] = {}
        self._last_tick = -1e18           # guarded-by: self._lock

    # -- submit-path reads ---------------------------------------------------
    def shed_check(self, tenant: Optional[str],
                   now: float) -> Optional[float]:
        """``retry_after_s`` when ``tenant`` is inside an active shed
        window (the submit path turns it into a 429), else None.
        Expired windows clear lazily here as well as in :meth:`tick`,
        so a quiet server un-sheds without waiting for a gap."""
        if tenant is None:
            return None
        with self._lock:
            until = self._shed_until.get(tenant)
            if until is None:
                return None
            if now >= until:
                del self._shed_until[tenant]
                return None
            return until - now

    def note_shed(self, tenant: str, reason: str) -> int:
        """Count one shed rejection; returns the tenant's new total
        (over every reason) for the storm detector."""
        with self._lock:
            key = (tenant, reason)
            self._shed_counts[key] = self._shed_counts.get(key, 0) + 1
            return sum(n for (t, _), n in self._shed_counts.items()
                       if t == tenant)

    # -- admission-path reads ------------------------------------------------
    def degrade_cfg(self, cfg):
        """Apply the active brownout rungs to a request ABOUT TO BE
        ADMITTED: rung >= 2 caps ``max_new_tokens``, rung >= 3 forces
        speculative decoding off. Returns ``cfg`` unchanged below rung
        2 (the common case allocates nothing); a degraded request gets
        a fresh config copy, so the client's object — and every
        already-admitted request — is never mutated."""
        with self._lock:
            rung = self.rung
        if rung < 2:
            return cfg
        kw = dict(vars(cfg))
        if rung >= 2:
            kw["max_new_tokens"] = min(int(kw["max_new_tokens"]),
                                       self.policy.brownout_max_new)
        if rung >= 3:
            kw["speculative"] = False
        return type(cfg)(**kw)

    def quota_cap(self, cap: int) -> int:
        """Rung >= 1 tightens a tenant's effective admission quota to
        half (floor 1) — queued work from every tenant keeps moving,
        just narrower."""
        with self._lock:
            rung = self.rung
        if rung >= 1:
            return max(1, cap // 2)
        return cap

    # -- the control tick (scheduler gap) ------------------------------------
    def tick(self, now: float, *, queue_depth: int, max_queue: int,
             tenant_stats: Optional[Dict[str, Dict[str, Any]]]
             ) -> Optional[Dict[str, Any]]:
        """One control decision pass. Returns None when rate-limited
        (< ``tick_interval_s`` since the last pass), else a decision
        dict the caller actuates (traces, metrics, queue penalties):

        ``{"shed": [(tenant, until), ...], "unshed": [tenants...],
        "rung": new, "prev_rung": old, "occupancy": float}``

        Shedding: any tenant whose fast burn crossed ``shed_burn``
        (with enough scored requests) gets a shed window one fast-burn
        window long from NOW — re-firing while hot keeps extending it.
        Ladder: occupancy = queue_depth / max_queue engages rungs
        immediately; disengage is one rung per dwell with hysteresis.
        """
        pol = self.policy
        with self._lock:
            if now - self._last_tick < pol.tick_interval_s:
                return None
            self._last_tick = now
            out: Dict[str, Any] = {"shed": [], "unshed": [],
                                   "prev_rung": self.rung}
            # -- burn-rate shed windows
            burn_max = 0.0
            for tenant, rec in (tenant_stats or {}).items():
                burn = rec.get("burn_fast")
                if burn is None:
                    continue
                scored = int(rec.get("met", 0)) + int(
                    rec.get("missed", 0))
                burn_max = max(burn_max, burn)
                if burn >= pol.shed_burn \
                        and scored >= pol.shed_min_count:
                    until = now + self.fast_window_s
                    if tenant not in self._shed_until:
                        out["shed"].append((tenant, until))
                    self._shed_until[tenant] = until
            for tenant in [t for t, u in self._shed_until.items()
                           if now >= u]:
                del self._shed_until[tenant]
                out["unshed"].append(tenant)
            # -- brownout ladder
            occ = (queue_depth / max_queue) if max_queue > 0 else 0.0
            sig = occ
            if burn_max >= pol.shed_burn:
                # any tenant burning hot forces at least rung 1 even
                # with a shallow queue (latency overload, not depth)
                sig = max(sig, pol.rung_up[0])
            target = 0
            for i, thr in enumerate(pol.rung_up):
                if sig >= thr:
                    target = i + 1
            if target > self.rung:
                self.rung = target        # engage immediately
                self._rung_since = now
            elif self.rung > 0:
                down_thr = (pol.rung_up[self.rung - 1]
                            - pol.rung_hysteresis)
                if sig < down_thr \
                        and now - self._rung_since >= pol.rung_dwell_s:
                    self.rung -= 1        # disengage one rung at a time
                    self._rung_since = now
            out["rung"] = self.rung
            out["occupancy"] = round(occ, 4)
            return out

    # -- observability -------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """The ``/healthz`` ``control`` block: active rung (+ its
        action name), per-tenant shed counts by reason, and the
        tenants currently inside a shed window."""
        with self._lock:
            sheds: Dict[str, Dict[str, int]] = {}
            for (tenant, reason), n in self._shed_counts.items():
                sheds.setdefault(tenant, {})[reason] = n
            return {"rung": self.rung,
                    "rung_action": RUNG_ACTIONS[self.rung],
                    "sheds": sheds,
                    "shed_active": sorted(self._shed_until)}


class ElasticController:
    """Deterministic scale decisions for the router's supervisor tick.

    Pure host arithmetic over fed signals with an explicit ``now`` —
    no clock reads, no I/O — so flap resistance is provable by driving
    a synthetic load trace through :meth:`decide`. Two guards make it
    flap-resistant by construction:

    - **hysteresis**: a scale verdict needs ``scale_signals``
      CONSECUTIVE agreeing ticks (any disagreeing tick resets the
      streak), so a load oscillating around a threshold never wins;
    - **rate limit**: at most one scale event per
      ``scale_cooldown_s``, regardless of how loud the signal is.

    The router actuates the returned delta: +1 builds/revives a
    replica, -1 drains one (never kills in-flight work).
    """

    def __init__(self, policy: ControlPolicy, *,
                 min_replicas: int = 1,
                 max_replicas: Optional[int] = None):
        if not isinstance(policy, ControlPolicy):
            raise ValueError(
                f"policy must be a ControlPolicy, got {policy!r}")
        if min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {min_replicas!r}")
        if max_replicas is not None and max_replicas < min_replicas:
            raise ValueError(
                f"max_replicas must be >= min_replicas, got "
                f"{max_replicas!r} < {min_replicas!r}")
        self.policy = policy
        self.min_replicas = int(min_replicas)
        self.max_replicas = (None if max_replicas is None
                             else int(max_replicas))
        self._up_streak = 0
        self._down_streak = 0
        self._last_scale = -1e18

    def decide(self, now: float, *, routable: int, queue_depth: int,
               burn_max: float = 0.0) -> int:
        """One tick's verdict: +1 (scale up), -1 (scale down), or 0.
        Signals: queue depth per routable replica against the up/down
        thresholds, with any tenant burning past ``shed_burn`` forcing
        the up side (burn is latency overload the queue may not
        show)."""
        pol = self.policy
        per = queue_depth / max(1, routable)
        want_up = (per >= pol.scale_up_depth
                   or burn_max >= pol.shed_burn)
        want_down = (not want_up) and per <= pol.scale_down_depth
        if want_up:
            self._up_streak += 1
            self._down_streak = 0
        elif want_down:
            self._down_streak += 1
            self._up_streak = 0
        else:
            self._up_streak = self._down_streak = 0
        if now - self._last_scale < pol.scale_cooldown_s:
            return 0
        if want_up and self._up_streak >= pol.scale_signals:
            if self.max_replicas is not None \
                    and routable >= self.max_replicas:
                return 0
            self._last_scale = now
            self._up_streak = 0
            return 1
        if want_down and self._down_streak >= pol.scale_signals \
                and routable > self.min_replicas:
            self._last_scale = now
            self._down_streak = 0
            return -1
        return 0


def max_burn(tenant_stats: Optional[Dict[str, Dict[str, Any]]],
             min_count: int = 1) -> float:
    """The hottest fast-burn rate across a tenant-stats table (0.0
    when nothing qualifies) — the fleet-level overload signal both the
    router's elastic tick and tests share."""
    out = 0.0
    for rec in (tenant_stats or {}).values():
        burn = rec.get("burn_fast")
        if burn is None:
            continue
        scored = int(rec.get("met", 0)) + int(rec.get("missed", 0))
        if scored >= min_count:
            out = max(out, burn)
    return out
