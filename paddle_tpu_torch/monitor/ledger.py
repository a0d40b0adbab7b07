"""paddle_tpu_torch.monitor.ledger: the process-wide program ledger.

Port of ``paddle_tpu/monitor/ledger.py``, with the same ``__all__``, series
names, help strings and wire format, so ``GET /profile`` bodies,
``tools/monitor_report.py --profile`` and a fleet's merge read the same
records. The SLO digests tell an operator *whether* serving is slow, the
trace ring *which request phase* was; this module answers *which program*
takes the time, and how far it is from the card's roofline.

A program here is one of the engines' entry points at one key: a captured
decode segment, verify step or ``generate`` step (``inference/_graphs.py``,
one per ``GraphCache`` key), or an eager program (a prefill bucket, a
prefill chunk width, a slot-state install, a scale reset, a LoRA row
install: :func:`paddle_tpu_torch.monitor.monitored_eager`). Each registers
under a **stable program id**, ``<name>:<8 hex>``: a blake2b digest of the
entry point's name, the program's key and the owning engine's static
signature (model configuration, dtype, batch, page geometry, KV dtype,
draft window, LoRA geometry). It is never Python's ``hash()``, which is
salted per process: the id is the same across restarts and replica
processes, and it leaves out the device index, so the shards of replicas of
one model on different cards merge exactly.

Per program the ledger holds:

- the cost, counted once (``monitor/_programs.py``, the port's counterpart
  of XLA's ``cost_analysis()``): FLOPs, bytes accessed, and where the
  program's buffers are known its argument and output bytes;
  ``donated_bytes`` stays None (PyTorch has no donation). A captured
  program first seen after its capture keeps None: it is never given a
  guessed number;
- compiles and compile seconds: a captured program's capture (its eager
  first run and the capture), an eager program's first ledger-seen
  dispatch (the counted run);
- dispatches, and a :class:`~paddle_tpu_torch.monitor.slo.LatencyDigest`
  of every later dispatch's seconds (one fixed bucketization, so replica
  ledgers merge exactly). On the card these are device seconds from CUDA
  events, resolved without a sync; on the CPU host wall time
  (``monitor/_programs.py`` says what each includes).

From these :func:`profile` derives achieved FLOP/s and bytes/s (total work
over total digest seconds), arithmetic intensity, MFU and bandwidth
utilization against the device's peaks (:mod:`paddle_tpu_torch.device.
peaks`) and the roofline verdict.

Cost model: with ``FLAGS_enable_ledger`` (and the monitor) off, a captured
program's dispatch and an eager program's call pay one bool branch. On, a
dispatch pays a dict lookup, two event records (the card) and a counter
bump; the cost is counted and the peaks read once per program, never per
dispatch.

Ownership and retirement: engines pass ``owner=<engine label>``;
``release(owner)`` (``engine.close()``) drops every program whose last owner
retired and removes its ``{program=...}`` series. Ownerless programs
(``CausalLMEngine``'s, as in the reference) live as long as the process.
The per-program ``paddle_tpu_jit_cache_miss_total{fn,program}`` compile
counters are compile history and survive an engine's close.
"""
from __future__ import annotations

import hashlib
import threading
from typing import Any, Dict, Hashable, List, Optional, Sequence, Set

from .slo import LatencyDigest

__all__ = [
    "enable", "disable", "enabled", "reset",
    "program_id", "record", "release", "owned_programs",
    "profile", "merge_profiles",
    "DISPATCH_COUNTER", "SECONDS_COUNTER", "MFU_GAUGE",
]

# one fixed digest configuration for every program digest: identical
# bucketization is what makes cross-replica merges exact
_DIGEST_KW = dict(lo=1e-6, hi=1e3, buckets_per_decade=16)

DISPATCH_COUNTER = "paddle_tpu_program_dispatches_total"
SECONDS_COUNTER = "paddle_tpu_program_seconds_total"
MFU_GAUGE = "paddle_tpu_program_mfu"

_enabled = False     # synced from FLAGS_enable_ledger below
_lock = threading.Lock()
_records: Dict[str, "_ProgramRecord"] = {}
_owners: Dict[str, Set[str]] = {}    # pid -> live owner labels
_peaks: Optional[Dict[str, Any]] = None
_ids: Dict[tuple, str] = {}          # (name, key, signature) -> pid


class _ProgramRecord:
    __slots__ = ("pid", "name", "signature", "owners_seen", "flops",
                 "bytes_accessed", "output_bytes", "donated_bytes",
                 "arg_bytes", "compiles", "compile_seconds",
                 "dispatches", "digest")

    def __init__(self, pid: str, name: str, signature: str):
        self.pid = pid
        self.name = name
        self.signature = signature
        self.owners_seen: Set[str] = set()
        self.flops: Optional[float] = None
        self.bytes_accessed: Optional[float] = None
        self.output_bytes: Optional[float] = None
        self.donated_bytes: Optional[int] = None
        self.arg_bytes: Optional[int] = None
        self.compiles = 0
        self.compile_seconds = 0.0
        self.dispatches = 0
        self.digest = LatencyDigest(**_DIGEST_KW)

    # -- wire format (what /profile serves; what Router merges) -------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "program": self.pid, "name": self.name,
            "signature": self.signature,
            "owners": sorted(self.owners_seen),
            "flops": self.flops, "bytes_accessed": self.bytes_accessed,
            "output_bytes": self.output_bytes,
            "donated_bytes": self.donated_bytes,
            "arg_bytes": self.arg_bytes,
            "compiles": self.compiles,
            "compile_seconds": round(self.compile_seconds, 6),
            "dispatches": self.dispatches,
            "digest": self.digest.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "_ProgramRecord":
        rec = cls(d["program"], d.get("name", d["program"]),
                  d.get("signature", ""))
        rec.owners_seen = set(d.get("owners") or ())
        for f in ("flops", "bytes_accessed", "output_bytes",
                  "donated_bytes", "arg_bytes"):
            setattr(rec, f, d.get(f))
        rec.compiles = int(d.get("compiles", 0))
        rec.compile_seconds = float(d.get("compile_seconds", 0.0))
        rec.dispatches = int(d.get("dispatches", 0))
        if d.get("digest"):
            rec.digest = LatencyDigest.from_dict(d["digest"])
        return rec

    def merge(self, other: "_ProgramRecord") -> "_ProgramRecord":
        """Exact cross-shard merge (same pid, same program, the same cost;
        counters add, digests add bucketwise)."""
        self.owners_seen |= other.owners_seen
        for f in ("flops", "bytes_accessed", "output_bytes",
                  "donated_bytes", "arg_bytes"):
            if getattr(self, f) is None:
                setattr(self, f, getattr(other, f))
        self.compiles += other.compiles
        self.compile_seconds += other.compile_seconds
        self.dispatches += other.dispatches
        self.digest.merge(other.digest)
        return self


# -- enable / disable --------------------------------------------------------


def enabled() -> bool:
    return _enabled


def _sync_enabled(value: bool) -> None:
    """Flag push target (``framework.flags.set_flags``): flips the one
    fast-path bool the programs branch on; enabling also reads the peaks,
    so a dispatch's MFU never calibrates on a serving path."""
    global _enabled
    _enabled = bool(value)
    if _enabled:
        _ensure_peaks()


def enable() -> None:
    """Turn the ledger on (equivalent to
    ``set_flags({"FLAGS_enable_ledger": True})``)."""
    from ..framework.flags import set_flags

    set_flags({"FLAGS_enable_ledger": True})


def disable() -> None:
    from ..framework.flags import set_flags

    set_flags({"FLAGS_enable_ledger": False})


def reset() -> None:
    """Drop every program record and owner binding (and the dispatches
    still being timed); the peak cache survives."""
    from . import _programs

    _programs.resolve()
    with _lock:
        pids = list(_records)
        _records.clear()
        _owners.clear()
    for pid in pids:
        _retire_series(pid)


def _ensure_peaks() -> Optional[Dict[str, Any]]:
    """The device's peaks, cached once final (a read before the card is up
    gives a provisional record, not kept)."""
    global _peaks
    with _lock:
        if _peaks is not None:
            return _peaks
    try:
        from ..device import peaks as peaks_mod

        rec = peaks_mod.peaks()
        final = peaks_mod._cache is rec
    except Exception:
        rec, final = None, False
    with _lock:
        if _peaks is None and final:
            _peaks = rec
        return _peaks if _peaks is not None else rec


# -- program identity --------------------------------------------------------


def program_id(name: str, key: Hashable = (), signature: str = "") -> str:
    """Stable program id for one (entry point, program key, engine
    signature): the name plus a blake2b digest (4 bytes) of the three
    canonical strings. A pure function of its inputs (keys are tuples of
    ints, strs and bools), so identical across processes and replicas."""
    memo = (name, key, signature)
    pid = _ids.get(memo)
    if pid is None:
        canon = "|".join([name, repr(key), signature])
        h = hashlib.blake2b(canon.encode(), digest_size=4).hexdigest()
        pid = _ids[memo] = f"{name}:{h}"
    return pid


def _has_record(pid: str) -> bool:
    return pid in _records


def _has_cost(pid: str) -> bool:
    rec = _records.get(pid)
    return rec is not None and rec.flops is not None


# -- recording (the ledger-enabled dispatch paths only) ----------------------


def record(pid: str, name: str, owner: Optional[str], dt: Optional[float],
           compiled: bool, cost: Optional[Dict[str, Any]] = None,
           signature: str = "") -> None:
    """One dispatch of program ``pid``: register it on first sight, count
    the dispatch, take ``cost`` where the program has none yet, and feed
    the digest with ``dt`` (not for the compiling call: its seconds are
    compile seconds). ``dt`` None means the seconds are still being timed
    on the card (:func:`_observe` takes them). Bumps the ``{program=...}``
    series."""
    if not _enabled:
        return
    from . import _programs

    _programs.resolve()
    with _lock:
        rec = _records.get(pid)
        if rec is None:
            rec = _records[pid] = _ProgramRecord(pid, name, signature)
        if owner:
            rec.owners_seen.add(owner)
            _owners.setdefault(pid, set()).add(owner)
        rec.dispatches += 1
        if cost and rec.flops is None:
            rec.flops = cost.get("flops")
            rec.bytes_accessed = cost.get("bytes_accessed")
            rec.output_bytes = cost.get("output_bytes")
            rec.arg_bytes = cost.get("arg_bytes")
        if compiled:
            rec.compiles += 1
            rec.compile_seconds += dt or 0.0
    from . import counter

    counter(DISPATCH_COUNTER,
            "ledger: dispatches per compiled program "
            "(compiling calls included)",
            ("program",)).labels(program=pid).inc()
    if compiled:
        counter(SECONDS_COUNTER,
                "ledger: host-observed dispatch wall seconds per "
                "compiled program (compile walls excluded — see "
                "paddle_tpu_jit_compile_seconds_total{program})",
                ("program",)).labels(program=pid).inc(0.0)
    elif dt is not None:
        _observe(pid, dt)


def _observe(pid: str, dt: float) -> None:
    """A dispatch's seconds, once known: into the digest, the seconds
    series and the latest-dispatch MFU gauge."""
    with _lock:
        rec = _records.get(pid)
        if rec is None:         # released or reset while being timed
            return
        rec.digest.observe(dt)
        flops = rec.flops
    if not _enabled:        # disabled since the dispatch: no series
        return
    from . import counter, gauge

    counter(SECONDS_COUNTER,
            "ledger: host-observed dispatch wall seconds per "
            "compiled program (compile walls excluded — see "
            "paddle_tpu_jit_compile_seconds_total{program})",
            ("program",)).labels(program=pid).inc(dt)
    pk = _peaks
    if pk is not None and flops and dt > 0:
        gauge(MFU_GAUGE,
              "ledger: model FLOP utilization of the LATEST "
              "dispatch vs the backend peak table",
              ("program",)).labels(program=pid).set(
                  round(flops / dt / pk["peak_flops"], 6))


# -- ownership / retirement --------------------------------------------------


def _retire_series(pid: str) -> None:
    from . import remove_series

    for series in (DISPATCH_COUNTER, SECONDS_COUNTER, MFU_GAUGE):
        try:
            remove_series(series, program=pid)
        except Exception:
            pass


def release(owner: str) -> int:
    """Retire one owner (engine) label: programs whose last live owner this
    was are dropped from the ledger and their ``{program=...}`` series
    removed. Programs still co-owned (a twin replica serving the same
    model) or ownerless are untouched. Returns the programs dropped.
    Idempotent."""
    dropped: List[str] = []
    with _lock:
        for pid in list(_owners):
            live = _owners[pid]
            if owner in live:
                live.discard(owner)
                if not live:
                    del _owners[pid]
                    _records.pop(pid, None)
                    dropped.append(pid)
    for pid in dropped:
        _retire_series(pid)
    return len(dropped)


def owned_programs(owner: str) -> List[str]:
    """Program ids currently owned by ``owner`` (test/debug surface)."""
    with _lock:
        return sorted(pid for pid, live in _owners.items()
                      if owner in live)


# -- read side ---------------------------------------------------------------


def _derived(d: Dict[str, Any], pk: Optional[Dict[str, Any]]
             ) -> Dict[str, Any]:
    """Roofline-derived view of one wire record: achieved FLOP/s and
    bytes/s over the digest's total seconds, arithmetic intensity, MFU
    and bandwidth utilization vs the device peaks, and the verdict
    (intensity under the machine balance is memory-bound)."""
    dig = LatencyDigest.from_dict(d["digest"])
    out = dict(d)
    out["summary"] = dig.summary()
    total_s = dig.sum
    out["total_seconds"] = round(total_s, 6)
    flops = d.get("flops")
    byts = d.get("bytes_accessed")
    if flops and byts:
        out["intensity"] = round(flops / byts, 4)
    else:
        out["intensity"] = None
    if total_s > 0 and dig.count:
        if flops:
            out["achieved_flops_per_s"] = flops * dig.count / total_s
        if byts:
            out["achieved_bytes_per_s"] = byts * dig.count / total_s
    if pk:
        af = out.get("achieved_flops_per_s")
        ab = out.get("achieved_bytes_per_s")
        if af:
            out["mfu"] = round(af / pk["peak_flops"], 6)
        if ab:
            out["bw_util"] = round(ab / pk["peak_bytes_per_s"], 6)
        if out["intensity"] is not None:
            out["bound"] = ("memory-bound"
                            if out["intensity"] < pk["machine_balance"]
                            else "compute-bound")
    return out


def profile(owners: Optional[Sequence[str]] = None,
            top_k: Optional[int] = None,
            derived: bool = True) -> Dict[str, Any]:
    """The ledger snapshot, what ``Server.profile()`` / ``GET /profile``
    serve and what :func:`merge_profiles` merges::

        {"programs": {pid: <record wire dict [+ derived roofline
                            fields when derived=True]>},
         "peaks": <device peak record or None>,
         "top": [pid, ...]   # by total digest seconds, descending
         "total_seconds": <sum over programs>}

    ``owners`` filters to programs owned by any of the given engine labels
    (a Server scopes to its engine; None: the whole process). ``top_k``
    truncates ``top``; ``programs`` always carries every matching record,
    since a truncated shard would make a fleet merge wrong. Completed
    dispatches still being timed are resolved first; none is waited for."""
    from . import _programs

    _programs.resolve()
    pk = _ensure_peaks() if derived else None
    with _lock:
        recs = list(_records.values())
        own = {p: set(s) for p, s in _owners.items()}
    if owners is not None:
        want = set(owners)
        recs = [r for r in recs
                if own.get(r.pid, set()) & want or r.owners_seen & want]
    wire = {r.pid: r.to_dict() for r in recs}
    if derived:
        wire = {pid: _derived(d, pk) for pid, d in wire.items()}
    totals = {pid: (d["total_seconds"] if derived
                    else LatencyDigest.from_dict(d["digest"]).sum)
              for pid, d in wire.items()}
    top = sorted(totals, key=lambda p: -totals[p])
    if top_k is not None:
        top = top[:top_k]
    return {"programs": wire, "peaks": pk, "top": top,
            "total_seconds": round(sum(totals.values()), 6)}


def merge_profiles(shards: Sequence[Optional[Dict[str, Any]]],
                   top_k: Optional[int] = None) -> Dict[str, Any]:
    """Exact fleet merge of per-replica :func:`profile` shards: the same
    program id adds its counters, its digests add bucketwise (one fixed
    bucketization), the cost comes from the first shard that has it; never
    an average of percentiles. ``None`` / empty shards (a replica mid
    restart) are skipped."""
    merged: Dict[str, _ProgramRecord] = {}
    pk = None
    for shard in shards:
        if not shard:
            continue
        if pk is None:
            pk = shard.get("peaks")
        for pid, d in (shard.get("programs") or {}).items():
            rec = _ProgramRecord.from_dict(d)
            if pid in merged:
                merged[pid].merge(rec)
            else:
                merged[pid] = rec
    wire = {pid: _derived(r.to_dict(), pk)
            for pid, r in merged.items()}
    top = sorted(wire, key=lambda p: -wire[p]["total_seconds"])
    if top_k is not None:
        top = top[:top_k]
    return {"programs": wire, "peaks": pk, "top": top,
            "total_seconds": round(
                sum(d["total_seconds"] for d in wire.values()), 6)}


# -- flag sync (import time): FLAGS_enable_ledger may already be set in the
#    environment; importing the module honors it ----------------------------
def _init_from_flags():
    from ..framework.flags import get_flags

    _sync_enabled(bool(
        get_flags("FLAGS_enable_ledger")["FLAGS_enable_ledger"]))


_init_from_flags()
