"""The profiler's shared Chrome-trace writer.

The port's copy of ``paddle_tpu/profiler/__init__.py::write_chrome_trace``,
the one piece of the reference's profiler that the trace ring
(``paddle_tpu_torch.tracing``: its Chrome export and its flight-recorder
dumps) writes through. The rest of the profiler (``Profiler``,
``RecordEvent``, the summary tables) is not ported yet (ROADMAP A14).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

__all__ = ["write_chrome_trace"]


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
