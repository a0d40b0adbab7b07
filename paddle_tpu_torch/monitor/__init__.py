"""paddle_tpu_torch.monitor: the process-wide metrics registry.

Port of ``paddle_tpu/monitor/__init__.py``, with the same metric names,
labels, help strings and export formats, so dashboards, scrapers and
``tools/monitor_report.py`` read this package's output as they read the
JAX package's. The profiler answers "where did this traced window go"
with spans; THIS package answers "what is the framework doing right now"
with a registry that is pull-based and cheap enough to leave on in
serving.

Three instrument kinds, all label-aware and lock-protected:

- :class:`Counter`: monotonically increasing (requests, tokens
  generated);
- :class:`Gauge`: point-in-time value, settable or computed at collect
  time via :func:`register_callback` (device memory, queue depth);
- :class:`Histogram`: bucketed distribution with sum/count (admission
  latency, TTFT, TPOT).

Cost model: every mutating call checks one module-level bool first, so
with ``FLAGS_enable_monitor`` off the instrumented paths pay a branch and
nothing else. Collection (:func:`snapshot`, :func:`render_prometheus`,
:func:`write_jsonl`) is pull-based: callback gauges (device memory) are
only evaluated when someone asks.

Enable via ``FLAGS_enable_monitor=1`` in the environment,
``paddle_tpu_torch.set_flags({"FLAGS_enable_monitor": True})``, or
:func:`enable` / :func:`disable` here.

Export surfaces:

- :func:`snapshot`: nested dict (name -> type/help/samples);
- :func:`render_prometheus`: Prometheus text exposition format 0.0.4;
- :func:`write_jsonl`: one ``{"metric":..., "value":..., "labels":...}``
  line per sample, the ``BENCH_*.json`` record shape;
- :func:`start_http_server`: stdlib ThreadingHTTPServer serving
  ``/metrics`` (Prometheus) and ``/metrics.json`` (snapshot).

The two built-in collectors change source. ``paddle_tpu_hbm_bytes`` (the
reference: XLA's allocator stats per device) reads PyTorch's caching
allocator per CUDA device: ``bytes_in_use`` and ``peak_bytes_in_use`` from
``torch.cuda.memory_stats`` and ``bytes_limit`` from the device's total
memory. ``paddle_tpu_live_array_bytes`` (the reference: bytes of live
``jax.Array`` objects, which it also reports on a CPU) is
``torch.cuda.memory_allocated`` per CUDA device, labelled ``device``. Both
read allocator counters only, never a CUDA API call, so a scrape from
another thread cannot disturb a graph capture; and both read only a CUDA
context that is already up, so a scrape never creates one. On the CPU (or
before CUDA is initialized) the port reports neither series, where the
reference reports a host live-array total.

Not ported yet (ROADMAP A9b): ``monitored_jit`` (its counterpart here is
the engines' ``programs``, :class:`~paddle_tpu_torch.inference._graphs.
GraphCache`, which counts captures per program) and the per-op latency hook
(``install_op_hook``; the port has no ``apply_op`` choke point).
"""
from __future__ import annotations

import bisect
import itertools
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram",
    "counter", "gauge", "histogram", "register_callback",
    "enable", "disable", "enabled",
    "snapshot", "render_prometheus", "write_jsonl", "reset",
    "remove_series",
    "start_http_server", "http_payload",
    "instance_label",
]

_instance_counters: Dict[str, "itertools.count"] = {}
_instance_lock = threading.Lock()


def instance_label(prefix: str) -> str:
    """Process-unique label value for one instrument-owning instance
    (``pool0``, ``loader3``, ``engine1`` …) — the shared idiom for
    gauges that would otherwise be clobbered across instances. Owners
    should ``remove()`` their series when the instance retires."""
    with _instance_lock:
        c = _instance_counters.setdefault(prefix, itertools.count())
        return f"{prefix}{next(c)}"

_lock = threading.RLock()
_REGISTRY: Dict[str, "_MetricBase"] = {}
_CALLBACKS: Dict[str, Tuple[str, Callable[[], Any]]] = {}
_enabled = False  # synced from FLAGS_enable_monitor below

# default buckets span sub-µs op dispatch to multi-second compiles
DEFAULT_BUCKETS = (
    1e-6, 5e-6, 1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
    1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0,
)


def _label_key(labelnames: Sequence[str], labels: Dict[str, str]
               ) -> Tuple[str, ...]:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"labels {sorted(labels)} do not match declared labelnames "
            f"{sorted(labelnames)}")
    return tuple(str(labels[n]) for n in labelnames)


class _MetricBase:
    kind = "untyped"

    def __init__(self, name: str, help_: str = "",
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help_
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()

    # -- labels ------------------------------------------------------------
    def labels(self, **labels):
        return _Bound(self, _label_key(self.labelnames, labels))

    def _unlabeled(self) -> Tuple[str, ...]:
        if self.labelnames:
            raise ValueError(
                f"{self.name} declares labels {self.labelnames}; use "
                f".labels(...)")
        return ()

    def remove(self, **labels) -> None:
        """Drop one label combination's series (idempotent) — owners of
        per-instance labels retire them here so dead instances don't
        export stale values forever."""
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._values.pop(key, None)

    def clear(self):
        raise NotImplementedError


class _Bound:
    """A metric bound to one label-value combination; proxies the
    mutators so call sites read ``m.labels(op="matmul").observe(dt)``."""

    __slots__ = ("_m", "_key")

    def __init__(self, metric, key):
        self._m = metric
        self._key = key

    def inc(self, amount: float = 1.0):
        self._m._inc(self._key, amount)

    def dec(self, amount: float = 1.0):
        self._m._inc(self._key, -amount)

    def set(self, value: float):
        self._m._set(self._key, value)

    def observe(self, value: float):
        self._m._observe(self._key, value)

    @property
    def value(self):
        return self._m._get(self._key)


class Counter(_MetricBase):
    kind = "counter"

    def __init__(self, name, help_="", labelnames=()):
        super().__init__(name, help_, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}

    def _inc(self, key, amount):
        if amount < 0:
            # validate BEFORE the enabled fast-path: a negative inc is a
            # call-site bug and must fail identically whether the
            # monitor is on or off (not only once ops enable it)
            raise ValueError(f"counter {self.name} cannot decrease")
        if not _enabled:
            return
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def inc(self, amount: float = 1.0):
        self._inc(self._unlabeled(), amount)

    def _get(self, key):
        with self._lock:
            return self._values.get(key, 0.0)

    @property
    def value(self) -> float:
        return self._get(self._unlabeled())

    def clear(self):
        with self._lock:
            self._values.clear()

    def _samples(self):
        with self._lock:
            return [(k, v) for k, v in self._values.items()]


class Gauge(_MetricBase):
    kind = "gauge"

    def __init__(self, name, help_="", labelnames=()):
        super().__init__(name, help_, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}

    def _set(self, key, value):
        if not _enabled:
            return
        with self._lock:
            self._values[key] = float(value)

    def _inc(self, key, amount):
        if not _enabled:
            return
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def set(self, value: float):
        self._set(self._unlabeled(), value)

    def inc(self, amount: float = 1.0):
        self._inc(self._unlabeled(), amount)

    def dec(self, amount: float = 1.0):
        self._inc(self._unlabeled(), -amount)

    def _get(self, key):
        with self._lock:
            return self._values.get(key, 0.0)

    @property
    def value(self) -> float:
        return self._get(self._unlabeled())

    def clear(self):
        with self._lock:
            self._values.clear()

    def _samples(self):
        with self._lock:
            return [(k, v) for k, v in self._values.items()]


class Histogram(_MetricBase):
    kind = "histogram"

    def __init__(self, name, help_="", labelnames=(),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help_, labelnames)
        self.buckets = tuple(sorted(buckets))
        # key -> [bucket_counts(list, len(buckets)+1 incl +Inf), sum, count]
        self._values: Dict[Tuple[str, ...], list] = {}

    def _observe(self, key, value):
        if not _enabled:
            return
        value = float(value)
        with self._lock:
            st = self._values.get(key)
            if st is None:
                st = [[0] * (len(self.buckets) + 1), 0.0, 0]
                self._values[key] = st
            # bisect over the sorted bounds: buckets[i-1] < v <= buckets[i]
            st[0][bisect.bisect_left(self.buckets, value)] += 1
            st[1] += value
            st[2] += 1

    def observe(self, value: float):
        self._observe(self._unlabeled(), value)

    def _get(self, key):
        with self._lock:
            st = self._values.get(key)
            if st is None:
                return {"count": 0, "sum": 0.0, "buckets": {}}
            cum = 0
            buckets = {}
            for i, ub in enumerate(self.buckets):
                cum += st[0][i]
                buckets[ub] = cum
            return {"count": st[2], "sum": st[1], "buckets": buckets}

    @property
    def value(self):
        return self._get(self._unlabeled())

    def clear(self):
        with self._lock:
            self._values.clear()

    def _samples(self):
        with self._lock:
            keys = list(self._values)
        return [(k, self._get(k)) for k in keys]


# -- registry ---------------------------------------------------------------


def _get_or_create(cls, name, help_, labelnames, **kw):
    with _lock:
        m = _REGISTRY.get(name)
        if m is not None:
            if not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            if tuple(labelnames) != m.labelnames:
                raise ValueError(
                    f"metric {name!r} registered with labelnames "
                    f"{m.labelnames}, requested {tuple(labelnames)}")
            return m
        m = cls(name, help_, labelnames, **kw)
        _REGISTRY[name] = m
        return m


def counter(name: str, help_: str = "", labelnames: Sequence[str] = ()
            ) -> Counter:
    return _get_or_create(Counter, name, help_, labelnames)


def gauge(name: str, help_: str = "", labelnames: Sequence[str] = ()
          ) -> Gauge:
    return _get_or_create(Gauge, name, help_, labelnames)


def histogram(name: str, help_: str = "", labelnames: Sequence[str] = (),
              buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
    return _get_or_create(Histogram, name, help_, labelnames,
                          buckets=buckets)


def register_callback(name: str, help_: str,
                      fn: Callable[[], Any]) -> None:
    """Register a pull-time gauge: ``fn`` runs at collect time and
    returns either a scalar or a list of ``(labels_dict, value)``.
    Exceptions inside ``fn`` drop that metric from the collection (a
    broken probe must not take snapshot() down with it)."""
    with _lock:
        _CALLBACKS[name] = (help_, fn)


def reset() -> None:
    """Zero every registered metric's values (the metric objects and
    callbacks stay registered — instrument modules hold references)."""
    with _lock:
        for m in _REGISTRY.values():
            m.clear()


def remove_series(name: str, **match) -> int:
    """Drop every label combination of metric ``name`` whose labels
    include ``match`` as a subset (idempotent; unknown metrics are a
    no-op). The instance-retirement idiom for metrics with OPEN label
    dimensions — an engine owning ``{engine=engineN, bucket=*}`` series
    can't enumerate the bucket values it emitted, so it retires by the
    ``engine`` label alone. Returns the number of series removed."""
    with _lock:
        metric = _REGISTRY.get(name)
    if metric is None:
        return 0
    removed = 0
    with metric._lock:
        for key in list(metric._values):
            labels = dict(zip(metric.labelnames, key))
            if all(labels.get(k) == v for k, v in match.items()):
                metric._values.pop(key, None)
                removed += 1
    return removed


# -- enable / disable -------------------------------------------------------


def enabled() -> bool:
    return _enabled


def _sync_enabled(value: bool) -> None:
    """Flag push target (framework.flags.set_flags): flips the fast-path
    bool."""
    global _enabled
    _enabled = bool(value)


def enable() -> None:
    """Turn the monitor on (equivalent to
    ``set_flags({"FLAGS_enable_monitor": True})``)."""
    from ..framework.flags import set_flags

    set_flags({"FLAGS_enable_monitor": True})


def disable() -> None:
    from ..framework.flags import set_flags

    set_flags({"FLAGS_enable_monitor": False})


# -- built-in callback gauges: device memory ---------------------------------


class _NoDevice(Exception):
    """Raised by a device-memory collector where there is nothing to read
    (no CUDA device, or no CUDA context yet): the collection drops the
    metric, as it drops any collector that raises."""


def _cuda_devices():
    """The CUDA devices to read, or raise :class:`_NoDevice`. Never
    initializes CUDA: a scrape must not create a context."""
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        raise _NoDevice("no initialized CUDA device")
    return range(torch.cuda.device_count())


def _collect_memory():
    """Allocator samples per CUDA device: bytes in use and their peak
    (PyTorch's caching allocator, ``torch.cuda.memory_stats``) and the
    device's total memory as ``bytes_limit``."""
    import torch

    out = []
    for i in _cuda_devices():
        ms = torch.cuda.memory_stats(i)
        dev = f"cuda:{i}"
        for kind, key in (("bytes_in_use", "allocated_bytes.all.current"),
                          ("peak_bytes_in_use", "allocated_bytes.all.peak")):
            if key in ms:
                out.append(({"device": dev, "kind": kind}, float(ms[key])))
        out.append(({"device": dev, "kind": "bytes_limit"},
                     float(torch.cuda.get_device_properties(i)
                           .total_memory)))
    return out


def _collect_live_bytes():
    """Bytes of live tensors per CUDA device (``memory_allocated``)."""
    import torch

    return [({"device": f"cuda:{i}"}, float(torch.cuda.memory_allocated(i)))
            for i in _cuda_devices()]


register_callback(
    "paddle_tpu_hbm_bytes",
    "PyTorch caching-allocator stats per CUDA device (absent on the "
    "CPU)",
    _collect_memory)
register_callback(
    "paddle_tpu_live_array_bytes",
    "bytes of live tensors per CUDA device (torch.cuda.memory_allocated; "
    "absent on the CPU)",
    _collect_live_bytes)


# -- collection / export ----------------------------------------------------


def _callback_samples():
    out = {}
    with _lock:
        cbs = list(_CALLBACKS.items())
    for name, (help_, fn) in cbs:
        try:
            val = fn()
        except Exception:
            continue  # a broken probe must not break collection
        if isinstance(val, (int, float)):
            samples = [({}, float(val))]
        else:
            samples = [(dict(lbl), float(v)) for lbl, v in val]
        out[name] = (help_, samples)
    return out


def snapshot() -> Dict[str, Any]:
    """One coherent read of every metric: ``{"ts": …, "metrics": {name:
    {"type", "help", "samples": [{"labels", …}]}}}``. Histograms carry
    count/sum/mean and cumulative buckets per sample."""
    metrics: Dict[str, Any] = {}
    with _lock:
        regs = list(_REGISTRY.items())
    for name, m in regs:
        samples = []
        for key, val in m._samples():
            labels = dict(zip(m.labelnames, key))
            if m.kind == "histogram":
                samples.append({
                    "labels": labels, "count": val["count"],
                    "sum": val["sum"],
                    "mean": (val["sum"] / val["count"]
                             if val["count"] else 0.0),
                    "buckets": {str(k): v
                                for k, v in val["buckets"].items()},
                })
            else:
                samples.append({"labels": labels, "value": val})
        metrics[name] = {"type": m.kind, "help": m.help,
                         "samples": samples}
    for name, (help_, samples) in _callback_samples().items():
        metrics[name] = {
            "type": "gauge", "help": help_,
            "samples": [{"labels": lbl, "value": v}
                        for lbl, v in samples],
        }
    return {"ts": time.time(), "metrics": metrics}


def _prom_escape(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _prom_labels(labels: Dict[str, str], extra: str = "") -> str:
    parts = [f'{k}="{_prom_escape(v)}"' for k, v in labels.items()]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def render_prometheus() -> str:
    """Prometheus text exposition format 0.0.4 of the full registry."""
    snap = snapshot()
    lines: List[str] = []
    for name, meta in sorted(snap["metrics"].items()):
        # HELP escaping per exposition format 0.0.4: \ and newline only
        help_ = str(meta["help"]).replace("\\", r"\\").replace("\n",
                                                               r"\n")
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {meta['type']}")
        for s in meta["samples"]:
            if meta["type"] == "histogram":
                for le, n in s["buckets"].items():
                    le_lbl = 'le="%s"' % le
                    lines.append(
                        f"{name}_bucket"
                        f"{_prom_labels(s['labels'], le_lbl)} {n}")
                inf_lbl = 'le="+Inf"'
                lines.append(
                    f"{name}_bucket"
                    f"{_prom_labels(s['labels'], inf_lbl)}"
                    f" {s['count']}")
                lines.append(f"{name}_sum{_prom_labels(s['labels'])}"
                             f" {_fmt(s['sum'])}")
                lines.append(f"{name}_count{_prom_labels(s['labels'])}"
                             f" {s['count']}")
            else:
                lines.append(f"{name}{_prom_labels(s['labels'])}"
                             f" {_fmt(s['value'])}")
    return "\n".join(lines) + "\n"


_UNIT_SUFFIXES = (
    ("_seconds_total", "s"), ("_seconds", "s"), ("_bytes", "bytes"),
    ("_per_sec", "1/s"), ("_ratio", "ratio"), ("_total", "count"),
    # serving-layer families (queue depth / in-flight request gauges)
    ("_depth", "reqs"), ("_requests", "reqs"),
)


def _unit_for(name: str) -> Optional[str]:
    for suffix, unit in _UNIT_SUFFIXES:
        if name.endswith(suffix):
            return unit
    return None


def write_jsonl(path: str, extra: Optional[Dict[str, Any]] = None) -> int:
    """Append one JSON line per sample to ``path`` — the same
    ``{"metric": …, "value": …, "unit": …}`` record shape the BENCH_*
    trajectory uses, plus ``labels`` and the snapshot timestamp.
    Histograms emit their count/sum/mean. Returns lines written."""
    snap = snapshot()
    n = 0
    with open(path, "a") as f:
        for name, meta in sorted(snap["metrics"].items()):
            for s in meta["samples"]:
                rec: Dict[str, Any] = {"metric": name, "ts": snap["ts"]}
                if meta["type"] == "histogram":
                    rec["value"] = s["mean"]
                    rec["count"] = s["count"]
                    rec["sum"] = s["sum"]
                else:
                    rec["value"] = s["value"]
                unit = _unit_for(name)
                if unit:
                    rec["unit"] = unit
                if s["labels"]:
                    rec["labels"] = s["labels"]
                if extra:
                    rec.update(extra)
                f.write(json.dumps(rec) + "\n")
                n += 1
    return n


def http_payload(path: str) -> Optional[Tuple[bytes, str]]:
    """(body, content_type) for the monitor's HTTP endpoints —
    ``/metrics.json`` (snapshot) and ``/metrics`` (Prometheus text) —
    or None for any other path. The ONE place the export payloads are
    built; every front-end (:func:`start_http_server`, the serving
    package's HTTP server) serves these bytes."""
    if path.startswith("/metrics.json"):
        return json.dumps(snapshot()).encode(), "application/json"
    if path.startswith("/metrics"):
        return (render_prometheus().encode(),
                "text/plain; version=0.0.4; charset=utf-8")
    return None


def start_http_server(port: int = 0, addr: str = "127.0.0.1"):
    """Serve ``/metrics`` (Prometheus text) and ``/metrics.json``
    (snapshot) on a daemon thread; returns the server (its bound port is
    ``server.server_address[1]`` — port=0 picks a free one)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            payload = http_payload(self.path)
            if payload is None:
                self.send_response(404)
                self.end_headers()
                return
            body, ctype = payload
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # no access-log spam on stderr
            pass

    server = ThreadingHTTPServer((addr, port), Handler)
    t = threading.Thread(target=server.serve_forever, daemon=True,
                         name="paddle_tpu-monitor-http")
    t.start()
    return server


# -- flag sync (import-time): FLAGS_enable_monitor may already be set via
#    the environment; importing the monitor honors it ------------------------
def _init_from_flags():
    from ..framework.flags import get_flags

    _sync_enabled(get_flags("FLAGS_enable_monitor")["FLAGS_enable_monitor"])


_init_from_flags()
