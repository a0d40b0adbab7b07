"""paddle.profiler counterpart (port of ``paddle_tpu/profiler/__init__.py``;
reference python/paddle/profiler/profiler.py:349 Profiler, :79 scheduler
states, :817 export; profiler_statistic.py).

Two trace sources under one API:

- **host spans**: a host event recorder (the HostTracer / RecordEvent
  analog, profiler/host_event_recorder.h) fed by the record point's op
  hook (``core/dispatch.py``: one ``op::<name>`` span per outermost op,
  under the reference's names) and by user :class:`RecordEvent` scopes;
- **device**: with ``ProfilerTarget.GPU`` and a CUDA card,
  ``torch.profiler`` with CUDA activity (CUPTI) records the window's
  kernels; the port's hand-written kernels launch through ``ctypes`` onto
  the current stream and appear there under their CUDA function names
  (the JAX package traces its TPU target with ``jax.profiler``).

The Chrome-trace export keeps the reference's span taxonomy (``ph=X``,
``cat`` ``op`` / ``user``, and ``kernel`` for device events), so existing
tooling reads both. :func:`write_chrome_trace` is also the trace ring's
writer (``paddle_tpu_torch.tracing``).
"""
from __future__ import annotations

import json
import os
import threading
import time
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["Profiler", "ProfilerState", "ProfilerTarget", "RecordEvent",
           "make_scheduler", "export_chrome_tracing", "load_profiler_result",
           "SortedKeys", "SummaryView", "write_chrome_trace",
           "export_protobuf"]


def write_chrome_trace(path: str, events: List[dict],
                       other: Optional[Dict[str, Any]] = None) -> str:
    """Shared catapult-JSON writer (reference chrometracing_logger.cc
    contract: ``ph=X`` complete events with ts/dur in µs,
    ``displayTimeUnit: ms``). ``events`` are pre-built traceEvent dicts;
    every trace file the package writes goes through here, so it opens in
    chrome://tracing and Perfetto alike. ``other`` lands under
    ``otherData`` (the flight recorder records its dump reason there).
    Returns ``path``."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    doc: Dict[str, Any] = {"traceEvents": events,
                           "displayTimeUnit": "ms"}
    if other:
        doc["otherData"] = other
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


class ProfilerState(Enum):
    """reference profiler.py:79."""
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class ProfilerTarget(Enum):
    CPU = 0
    GPU = 1
    XPU = 2
    CUSTOM_DEVICE = 3
    TPU = 4


class SortedKeys(Enum):
    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    GPUTotal = 4
    GPUAvg = 5


class SummaryView(Enum):
    DeviceView = 0
    OverView = 1
    ModelView = 2
    DistributedView = 3
    KernelView = 4
    OperatorView = 5
    MemoryView = 6


class _HostEventRecorder:
    """Span recorder: (name, start_ns, end_ns, thread id) tuples, up to
    ``capacity``."""

    def __init__(self, capacity: int = 1_000_000):
        self.events: List[Tuple[str, int, int, int]] = []
        self.capacity = capacity
        self.active = False
        self._lock = threading.Lock()

    def record(self, name: str, start_ns: int, end_ns: int):
        with self._lock:
            if len(self.events) < self.capacity:
                self.events.append(
                    (name, start_ns, end_ns, threading.get_ident()))

    def drain(self) -> List[Tuple[str, int, int, int]]:
        with self._lock:
            out, self.events = self.events, []
        return out


_recorder = _HostEventRecorder()


class RecordEvent:
    """User-facing span (reference platform/profiler/event_tracing.h
    RecordEvent; python API paddle.profiler.RecordEvent)."""

    def __init__(self, name: str, event_type=None):
        self.name = name
        self._start = None

    def begin(self):
        self._start = time.perf_counter_ns()

    def end(self):
        if self._start is not None and _recorder.active:
            _recorder.record(self.name, self._start, time.perf_counter_ns())
        self._start = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


def make_scheduler(*, closed: int, ready: int, record: int, repeat: int = 0,
                   skip_first: int = 0) -> Callable[[int], ProfilerState]:
    """reference profiler.py make_scheduler: step_num -> state."""
    period = closed + ready + record

    def scheduler(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        if repeat and s >= repeat * period:
            return ProfilerState.CLOSED
        pos = s % period
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == period - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return scheduler


def _default_scheduler(step: int) -> ProfilerState:
    return ProfilerState.RECORD


def export_chrome_tracing(dir_name: str, worker_name: Optional[str] = None):
    """reference profiler.py export_chrome_tracing: an on_trace_ready
    callback writing catapult JSON."""

    def handle(prof: "Profiler"):
        os.makedirs(dir_name, exist_ok=True)
        name = worker_name or f"host_{os.getpid()}"
        path = os.path.join(dir_name, f"{name}_time_{int(time.time())}"
                                      ".paddle_trace.json")
        prof.last_export = prof.export(path, format="json")

    return handle


class Profiler:
    """reference profiler.py:349. ``targets`` CPU records host spans;
    GPU adds the card's kernels through ``torch.profiler`` (CUDA
    activity) while the window records, where a card is present."""

    def __init__(self, *, targets: Optional[Sequence[ProfilerTarget]] = None,
                 scheduler=None, on_trace_ready=None, record_shapes=False,
                 profile_memory=False, timer_only=False,
                 emit_nvtx=False, custom_device_types=None, with_flops=False):
        self.targets = list(targets or [ProfilerTarget.CPU])
        if scheduler is None:
            self.scheduler = _default_scheduler
        elif isinstance(scheduler, (tuple, list)):
            lo, hi = scheduler
            self.scheduler = make_scheduler(
                closed=max(lo, 0), ready=0, record=hi - lo, repeat=1)
        else:
            self.scheduler = scheduler
        self.on_trace_ready = on_trace_ready
        self.timer_only = timer_only
        self.step_num = 0
        self.current_state = ProfilerState.CLOSED
        self._events: List[Tuple[str, int, int, int]] = []
        # device events: (name, start_ns, end_ns, stream)
        self._device_events: List[Tuple[str, int, int, int]] = []
        self._step_marks: List[Tuple[int, int]] = []  # (step, start_ns)
        self._torch_prof = None
        self._torch_armed = False
        self._torch_t0 = 0
        self._prev_op_hook = None
        self._own_hook = None
        self.last_export = None

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        self._prepare_device()
        self.current_state = self.scheduler(self.step_num)
        if self.current_state in (ProfilerState.RECORD,
                                  ProfilerState.RECORD_AND_RETURN):
            self._arm()

    def _prepare_device(self):
        """With the GPU target and a card: a ``torch.profiler`` session
        whose CUPTI setup (``prepare_trace``) is done now, before the
        window, so that the window's first kernels are traced (the
        warm-up torch's own schedule keeps; a session started cold at the
        window's start was seen to miss its first milliseconds)."""
        if ProfilerTarget.GPU not in self.targets or self.timer_only:
            return
        import torch

        if torch.cuda.is_available() and self._torch_prof is None:
            self._torch_prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            self._torch_prof.prepare_trace()
            self._torch_armed = False

    def _arm(self):
        _recorder.active = True
        self._install_op_hook()
        if self._torch_prof is not None:
            import torch

            torch.cuda.synchronize()
            self._torch_prof.start_trace()
            self._torch_armed = True
            self._torch_t0 = time.perf_counter_ns()

    def _disarm(self):
        _recorder.active = False
        self._remove_op_hook()
        self._events.extend(_recorder.drain())
        if self._torch_prof is not None and self._torch_armed:
            import torch

            torch.cuda.synchronize()
            prof, self._torch_prof = self._torch_prof, None
            prof.stop_trace()
            self._device_events.extend(self._kernels_of(prof))

    def _release_device(self):
        """End a session that was prepared and never started."""
        if self._torch_prof is not None:
            prof, self._torch_prof = self._torch_prof, None
            prof.start_trace()
            prof.stop_trace()

    def _kernels_of(self, prof) -> List[Tuple[str, int, int, int]]:
        """The CUDA kernels of a ``torch.profiler`` window, on the host
        clock of the window's start."""
        from torch.autograd import DeviceType

        out = []
        for ev in prof.events():
            if ev.device_type != DeviceType.CUDA:
                continue
            tr = ev.time_range
            start = self._torch_t0 + int(tr.start * 1e3)
            out.append((ev.name, start, start + int(tr.elapsed_us() * 1e3),
                        int(getattr(ev, "device_index", 0) or 0)))
        return out

    def _install_op_hook(self):
        from ..core import op_hooks

        # skip over hooks of dead profiler windows (stranded in the chain
        # because a consumer installed on top before their stop())
        prev = op_hooks.skip_dead(op_hooks.op_span_hook)
        self._prev_op_hook = prev

        def hook(name, start, end):
            if hook.armed:  # per-window flag: stranded hooks stay dead
                _recorder.record(f"op::{name}", start, end)
            if prev is not None:  # fan out (the monitor's op histogram)
                prev(name, start, end)

        hook.armed = True
        hook.prev_hook = prev
        self._own_hook = hook
        op_hooks.op_span_hook = hook

    def _remove_op_hook(self):
        from ..core import op_hooks

        hook = self._own_hook
        if hook is not None:
            hook.armed = False  # dead even if stranded in the chain
        if op_hooks.op_span_hook is hook:
            # prune: with nested windows our saved prev may itself be a
            # hook that died while we were on top of it
            op_hooks.op_span_hook = op_hooks.skip_dead(self._prev_op_hook)
        # else: someone (the monitor) installed on top after we armed;
        # restoring our saved prev would rip them out. The chain stays:
        # this hook forwards but never records again, and later installs
        # prune it when they capture their prev.
        self._own_hook = None
        self._prev_op_hook = None

    def stop(self):
        if self.current_state in (ProfilerState.RECORD,
                                  ProfilerState.RECORD_AND_RETURN):
            self._disarm()
            if self.on_trace_ready:
                self.on_trace_ready(self)
        self._release_device()
        self.current_state = ProfilerState.CLOSED

    def step(self, num_samples: Optional[int] = None):
        """Advance the schedule one training step."""
        self._step_marks.append((self.step_num, time.perf_counter_ns()))
        prev = self.current_state
        self.step_num += 1
        new = self.scheduler(self.step_num)
        rec = (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN)
        if prev in rec and new not in rec:
            self._disarm()
            self._prepare_device()      # for a later window
            if self.on_trace_ready:
                self.on_trace_ready(self)
        elif prev not in rec and new in rec:
            self._arm()
        self.current_state = new

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- output -------------------------------------------------------------
    def export(self, path: str, format: str = "json"):
        """Chrome trace (catapult) export (reference chrometracing_logger.cc
        contract: ph=X complete events, ts/dur in µs): host spans on the
        process's threads, the card's kernels on a ``gpu`` process row."""
        pid = os.getpid()
        events = []
        for name, start, end, tid in self._events:
            events.append({
                "name": name, "ph": "X", "cat": "op" if name.startswith(
                    "op::") else "user",
                "ts": start / 1e3, "dur": (end - start) / 1e3,
                "pid": pid, "tid": tid,
            })
        for name, start, end, dev in self._device_events:
            events.append({
                "name": name, "ph": "X", "cat": "kernel",
                "ts": start / 1e3, "dur": (end - start) / 1e3,
                "pid": f"gpu:{dev}", "tid": 0,
            })
        return write_chrome_trace(path, events)

    def summary(self, sorted_by: SortedKeys = SortedKeys.CPUTotal,
                op_detail: bool = True, thread_sep: bool = False,
                time_unit: str = "ms"):
        """Aggregated per-name statistics table (profiler_statistic.py
        analog) over the host spans and the device kernels. Returns the
        stats dict."""
        stats: Dict[str, Dict[str, float]] = {}
        for name, start, end, _ in self._events + self._device_events:
            d = stats.setdefault(name, {"calls": 0, "total": 0.0,
                                        "max": 0.0, "min": float("inf")})
            dur = (end - start) / 1e6  # ms
            d["calls"] += 1
            d["total"] += dur
            d["max"] = max(d["max"], dur)
            d["min"] = min(d["min"], dur)
        div = {"ms": 1.0, "us": 1e-3, "s": 1e3}[time_unit]
        rows = sorted(stats.items(), key=lambda kv: -kv[1]["total"])
        print("-" * 75)
        print(f"{'Name':<38}{'Calls':>7}{'Total(' + time_unit + ')':>12}"
              f"{'Avg':>9}{'Max':>9}")
        print("=" * 75)
        for name, d in rows:
            total = d["total"] / div
            print(f"{name[:37]:<38}{d['calls']:>7}{total:>12.3f}"
                  f"{total / d['calls']:>9.3f}{d['max'] / div:>9.3f}")
        print("-" * 75)
        return stats


def load_profiler_result(filename: str):
    with open(filename) as f:
        return json.load(f)


def export_protobuf(dir_name: str, worker_name: Optional[str] = None):
    """on_trace_ready factory for the reference's protobuf export slot
    (reference profiler/profiler.py export_protobuf). The trace artifact
    here is the Chrome-trace JSON (the same data, an open format), written
    with a ``.pb.json`` suffix so tooling can tell the source apart."""

    def handler(prof):
        os.makedirs(dir_name, exist_ok=True)
        name = worker_name or f"worker_{os.getpid()}"
        prof.last_export = prof.export(
            os.path.join(dir_name, name + ".pb.json"), format="json")

    return handler
