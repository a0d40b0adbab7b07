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

``paddle_tpu_kernel_launches`` has no counterpart in the reference (there a
Pallas kernel runs inside a compiled program and nothing counts it): the
launches of each of the port's hand-written kernels in this process so far
(:func:`paddle_tpu_torch.ops.launch_counts`, a graph replay credited with
the launches it captured), labelled ``kernel``. A scrape of a replica
process reads which kernels its traffic ran; the difference of two scrapes
is the launches between them.

The program ledger (``monitor/ledger.py``, ``FLAGS_enable_ledger``) counts
the engines' programs: the captured ones through
:class:`~paddle_tpu_torch.inference._graphs.GraphCache` (the counterpart of
the reference's ``monitored_jit`` cache: with the monitor on, its captures
feed the reference's ``paddle_tpu_jit_cache_miss_total{fn,program}`` and
``paddle_tpu_jit_compile_seconds_total{fn,program}``), and the eager ones
(prefill buckets and chunks, slot-state installs, scale resets, LoRA row
installs) through :func:`monitored_eager`.

The per-op latency histogram ``paddle_tpu_op_latency_seconds{op}``
(:func:`install_op_hook`, installed while the monitor is on) hangs on the
port's record point (``core/dispatch.py``), the counterpart of the
reference's ``apply_op``: one observation per outermost op, named as the
reference names it, chained with the profiler's span hook in either order
(``core/op_hooks.py``). :func:`monitored_jit` is the reference's compile
tracker over ``torch.compile``: cache misses and compile seconds per
program (``paddle_tpu_jit_cache_miss_total{fn,program}``,
``paddle_tpu_jit_compile_seconds_total{fn,program}``) and ledger rows while
the ledger is on; ``jit.to_static`` registers its programs through it.
"""
from __future__ import annotations

import bisect
import functools
import itertools
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..core import op_hooks as _op_hooks  # dependency-free leaf module

__all__ = [
    "Counter", "Gauge", "Histogram",
    "counter", "gauge", "histogram", "register_callback",
    "enable", "disable", "enabled",
    "snapshot", "render_prometheus", "write_jsonl", "reset",
    "remove_series",
    "start_http_server", "http_payload", "monitored_eager",
    "instance_label", "monitored_jit", "install_op_hook",
    "uninstall_op_hook",
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
    bool and installs/uninstalls the per-op hook."""
    global _enabled
    _enabled = bool(value)
    if _enabled:
        install_op_hook()
    else:
        uninstall_op_hook()


def enable() -> None:
    """Turn the monitor on (equivalent to
    ``set_flags({"FLAGS_enable_monitor": True})``)."""
    from ..framework.flags import set_flags

    set_flags({"FLAGS_enable_monitor": True})


def disable() -> None:
    from ..framework.flags import set_flags

    set_flags({"FLAGS_enable_monitor": False})


# -- per-op instrumentation (the record point's op_hooks slot) ---------------

_op_hist: Optional["Histogram"] = None
_op_children: Dict[str, "_Bound"] = {}  # op name -> bound series (fast path)
_chained_prev: Optional[Callable[[str, int, int], None]] = None
_in_chain = False  # True while _op_span_hook is reachable from the slot


def _op_span_hook(name: str, start_ns: int, end_ns: int) -> None:
    prev = _chained_prev
    if _enabled:
        if _op_hist is not None:
            # the bound series cached per op: this runs on every op
            child = _op_children.get(name)
            if child is None:
                child = _op_children.setdefault(
                    name, _op_hist.labels(op=name))
            child.observe((end_ns - start_ns) / 1e9)
    elif _op_hooks.op_span_hook is _op_span_hook:
        # disabled but still in the slot (a profiler's stop() restored us
        # after disable() could not reach us): leave now, so the slot
        # converges to None; prev was read above, so the event still
        # reaches the chain below us
        uninstall_op_hook()
    if prev is not None:
        prev(name, start_ns, end_ns)


def install_op_hook() -> None:
    """Install the per-op latency histogram on the record point, chaining
    to whatever hook was already there (the profiler chains the same way,
    so spans and histograms fan out from one op).

    Idempotent through ``_in_chain``: once our hook is reachable from the
    slot, even under a profiler hook that captured it as its prev,
    installing again is a no-op, or we would chain to a hook that already
    chains to us and every op would recurse forever."""
    global _op_hist, _chained_prev, _in_chain
    if _in_chain or _op_hooks.op_span_hook is _op_span_hook:
        return
    if _op_hist is None:
        _op_hist = histogram(
            "paddle_tpu_op_latency_seconds",
            "eager apply_op dispatch latency (host wall time) per op",
            ("op",))
    _chained_prev = _op_hooks.skip_dead(_op_hooks.op_span_hook)
    _in_chain = True
    _op_hooks.op_span_hook = _op_span_hook


def uninstall_op_hook() -> None:
    """Remove the monitor hook when the slot is ours. If another consumer
    (the profiler) installed on top of us, the chain is left intact: our
    hook no-ops while disabled and keeps forwarding to the hook below, and a
    later enable() just flips the bool back (``_in_chain`` stays True)."""
    global _chained_prev, _in_chain
    if _op_hooks.op_span_hook is _op_span_hook:
        # restore the chain below us, minus hooks of profiler windows that
        # stopped while we sat on top of them
        prev = _op_hooks.skip_dead(_chained_prev)
        _chained_prev = None
        _in_chain = False
        _op_hooks.op_span_hook = prev


# -- compiled programs ----------------------------------------------------------


def _arg_key(args, kwargs) -> tuple:
    """A program key of a call's arguments: each tensor's shape and dtype,
    each plain value itself (ints, strs, bools as ``program_id`` takes
    them)."""
    import torch
    from torch.utils import _pytree as pytree

    out = []
    for x in pytree.tree_leaves((args, kwargs)):
        if isinstance(x, torch.Tensor):
            out.append(str((tuple(x.shape), str(x.dtype).removeprefix(
                "torch."))))
        elif isinstance(x, (int, float, bool, str, type(None))):
            out.append(repr(x))
        else:
            out.append(type(x).__name__)
    return tuple(out)


def monitored_jit(fn: Optional[Callable] = None, *, name: Optional[str] = None,
                  owner: Optional[str] = None, **compile_kwargs):
    """``torch.compile`` that counts cache misses and compile seconds per
    PROGRAM and feeds the program ledger (the reference's wrapper over
    ``jax.jit``).

    A miss is a call whose graph reached the compile backend (torch
    compiles when the guards of every cached graph fail); the call's wall
    time (trace, compile, run) goes to
    ``paddle_tpu_jit_compile_seconds_total``. Both miss counters carry a
    ``program`` label beside ``fn``: one entry point compiles many
    programs (one per shape signature). The program id is
    ``ledger.program_id(name, <shapes and dtypes of the arguments>)``. With
    the monitor and the ledger off a call pays one bool test over plain
    ``torch.compile``. Calls run with the record point suspended
    (``core.dispatch.suspended``), so no op hook or recording enters the
    graph. ``owner`` ties the programs to an engine label for
    ``ledger.release``; ``compile_kwargs`` go to ``torch.compile``
    (``backend`` a name or a callable, default inductor). Usable as a
    decorator or called directly; ``name`` defaults to the function's
    ``__name__``. The wrapper's ``compiles`` counts its misses."""
    def wrap(fn):
        import torch

        from ..core import dispatch

        label = name or getattr(fn, "__name__", "jit")
        missed = threading.local()
        kw = dict(compile_kwargs)
        real = kw.pop("backend", None)
        if real is None or isinstance(real, str):
            real = torch._dynamo.lookup_backend(real or "inductor")

        def backend(gm, example_inputs):
            missed.flag = True
            call.compiles += 1
            return real(gm, example_inputs)

        compiled = torch.compile(fn, backend=backend, **kw)

        @functools.wraps(fn)
        def call(*a, **k):
            with dispatch.suspended():
                if not (_enabled or _ledger._enabled):
                    return compiled(*a, **k)
                missed.flag = False
                t0 = time.perf_counter()
                out = compiled(*a, **k)
                was_miss = missed.flag
                led = _ledger._enabled
                if not (was_miss or led):
                    return out
                dt = time.perf_counter() - t0
                pid = _ledger.program_id(label, _arg_key(a, k))
                if was_miss and _enabled:
                    counter("paddle_tpu_jit_cache_miss_total",
                            "jit traces+compiles (cache misses) per entry "
                            "point and program",
                            ("fn", "program")).labels(
                                fn=label, program=pid).inc()
                    counter("paddle_tpu_jit_compile_seconds_total",
                            "wall seconds spent tracing+compiling per entry "
                            "point and program",
                            ("fn", "program")).labels(
                                fn=label, program=pid).inc(dt)
                if led:
                    _ledger.record(pid, label, owner, dt, was_miss)
                return out

        call.compiles = 0
        call._compiled = compiled  # escape hatch: the torch.compile object
        return call

    return wrap(fn) if fn is not None else wrap


# -- eager programs -----------------------------------------------------------


def monitored_eager(name: str, fn: Callable, *args,
                    owner: Optional[str] = None, signature: str = "",
                    device="cpu", key=(), **kwargs):
    """Run ``fn(*args, **kwargs)`` as one dispatch of the eager program
    ``name`` (code that runs op by op, not captured) for the program
    ledger: the counterpart of the reference's ``monitored_jit``. ``key``
    (a tuple of ints, strs and bools, such as a prefill's bucket width) and
    the owning engine's ``signature`` go into the program id
    (``ledger.program_id``); ``owner`` (an engine label) ties the program
    to its engine, which ``ledger.release(owner)`` retires. The program's
    first ledger-seen dispatch is counted (FLOPs and bytes, argument and
    output bytes) and goes to ``compiles``; later ones are timed on
    ``device`` (CUDA events on the card, the host clock on the CPU) into
    its digest. A call inside another program, or while the thread
    captures a graph, runs untouched. With ``FLAGS_enable_ledger`` off a
    call pays one bool branch. Returns ``fn``'s result."""
    if not _ledger._enabled:
        return fn(*args, **kwargs)
    from . import _programs

    return _programs.run_eager(name, owner, signature, key, device, fn,
                               args, kwargs)


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


def _collect_launches():
    """Each hand-written kernel's launches in this process."""
    from .. import ops

    return [({"kernel": name}, float(n))
            for name, n in ops.launch_counts().items()]


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
register_callback(
    "paddle_tpu_kernel_launches",
    "launches of each hand-written kernel in this process "
    "(ops.launch_counts)",
    _collect_launches)


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

from . import ledger as _ledger  # noqa: E402 (it imports this package)
