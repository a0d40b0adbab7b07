"""Environment provenance stamp for bench records and flight dumps.

Port of ``paddle_tpu/monitor/provenance.py``. A bench record or a
flight-recorder dump is evidence, and evidence needs a chain of custody:
two records compare soundly only when both ran the same backend on
comparable machines, so every flight dump (and, with the port's bench,
every record) carries this ``env`` header, and ``tools/bench_diff.py``
warns when the headers disagree.

The stamp carries the reference's keys, filled from PyTorch: ``backend``
is ``"gpu"`` on a CUDA device (the word ``jax.devices()[0].platform``
gives there) and ``"cpu"`` without one, ``device_kind`` the card's name
(``torch.cuda.get_device_name``), ``device_count`` the CUDA devices; its
``jax`` key stays None, and ``torch`` and ``cuda`` give PyTorch's version
and the CUDA version it was built for.

The stamp is computed ONCE per process and cached (the fields cannot
change mid-run; ``git rev-parse`` forks a subprocess, which must not
happen per record). Every field degrades to ``None`` rather than raising:
a missing git binary must not take a bench down.
"""
from __future__ import annotations

import os
import socket
import sys
import threading
from typing import Any, Dict, Optional

__all__ = ["env_stamp"]

_lock = threading.Lock()
_cache: Optional[Dict[str, Any]] = None


def _git_rev() -> Optional[str]:
    import subprocess

    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))),
            capture_output=True, timeout=5)
        if out.returncode == 0:
            return out.stdout.decode().strip() or None
    except Exception:
        pass
    return None


def env_stamp(extra: Optional[Dict[str, Any]] = None,
              refresh: bool = False) -> Dict[str, Any]:
    """The cached provenance header::

        {"jax", "torch", "cuda", "python", "backend", "device_kind",
         "device_count", "hostname", "pid", "git_rev"}

    ``extra`` (e.g. a power limit) is merged into a COPY: the cache itself
    never mutates, so two callers with different extras cannot contaminate
    each other."""
    global _cache
    with _lock:
        cached = _cache
    if cached is None or refresh:
        stamp: Dict[str, Any] = {
            "jax": None, "torch": None, "cuda": None,
            "python": sys.version.split()[0],
            "backend": None, "device_kind": None, "device_count": None,
            "hostname": socket.gethostname(), "pid": os.getpid(),
            "git_rev": _git_rev(),
        }
        try:
            import torch

            stamp["torch"] = torch.__version__
            stamp["cuda"] = torch.version.cuda
            if torch.cuda.is_available():
                stamp["backend"] = "gpu"
                stamp["device_kind"] = torch.cuda.get_device_name(0)
                stamp["device_count"] = torch.cuda.device_count()
            else:
                stamp["backend"] = "cpu"
                stamp["device_kind"] = "cpu"
                stamp["device_count"] = 1
        except Exception:
            pass
        with _lock:
            _cache = stamp
        cached = stamp
    if extra:
        out = dict(cached)
        out.update(extra)
        return out
    return dict(cached)
