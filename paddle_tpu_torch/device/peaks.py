"""Peak compute and memory rates of the device: the roofline's ceiling.

Port of ``paddle_tpu/device/peaks.py``. The program ledger
(``paddle_tpu_torch.monitor.ledger``) turns a program's counted FLOPs and
bytes and its measured seconds into achieved FLOP/s and bytes/s; this module
supplies the denominator, the peak the hardware could do, so MFU and the
roofline verdict (memory-bound or compute-bound) mean the same thing on
every device:

- **CUDA cards in the table**: NVIDIA's datasheet figures, bf16 dense
  tensor-core FLOP/s and HBM bytes/s, keyed by a substring of
  ``torch.cuda.get_device_name()``. The H100 SXM5 row (989.4e12 FLOP/s,
  3.35e12 B/s) is the one ``chip_smoke.py``'s kernel bounds use.
- **Other CUDA cards**: calibrated once on the card, a timed bf16 matmul and
  a timed copy (``source: "calibrated"``).
- **CPU** (the tests' device): calibrated once per process with a timed fp32
  matmul and a timed copy. Calibrated MFU compares only within one host.
- The environment variables ``PADDLE_TPU_PEAK_FLOPS`` /
  ``PADDLE_TPU_PEAK_BYTES`` win over both (``source: "env"``).

A read never creates a CUDA context: while CUDA is available but not yet
initialized, :func:`peaks` returns a provisional record (``source:
"fallback"``) that it does not cache, and the first read after the card is
up takes its row. The ledger reads the peaks when it is enabled and when a
profile is read, never on a dispatch, so calibration never runs on a serving
thread's dispatch.

``machine_balance`` (peak FLOPs / peak bytes, FLOP per byte) is the roofline
ridge: a program whose arithmetic intensity is below it is memory-bound.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Optional

__all__ = ["peaks", "peak_flops", "machine_balance", "GPU_PEAKS"]

# (device-name substring, bf16 dense FLOP/s, HBM bytes/s), first match wins,
# from NVIDIA's H100 Tensor Core GPU datasheet (the dense rate is half the
# "with sparsity" figure there): H100 NVL 1,671 / 2 TFLOP/s and 3.9 TB/s,
# H100 PCIe 1,513 / 2 TFLOP/s and 2.0 TB/s, H100 SXM5 ("NVIDIA H100 80GB
# HBM3") 1,979 / 2 TFLOP/s and 3.35 TB/s
GPU_PEAKS = (
    ("H100 NVL", 835.5e12, 3.9e12),
    ("H100 PCIe", 756.5e12, 2.0e12),
    ("H100 80GB HBM3", 989.4e12, 3.35e12),
)

_lock = threading.Lock()
_cache: Optional[Dict[str, Any]] = None


def _timed(fn, sync, reps: int = 3) -> float:
    """Best of ``reps`` wall times of ``fn()``, each closed by ``sync()``;
    the first call (allocation, library set-up) is outside the clock."""
    fn()
    sync()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return max(best, 1e-9)


def _calibrate(device, dtype, n: int) -> Dict[str, float]:
    """One timed n x n matmul (2 n^3 FLOPs) and one timed copy of an n x n
    tensor (read and written: 2 nbytes), on ``device``. Runs once per
    process, on the reading thread's stream."""
    import torch

    x = torch.ones((n, n), dtype=dtype, device=device)
    if device.type == "cuda":
        stream = torch.cuda.current_stream(device)
        sync = stream.synchronize
    else:
        def sync():
            pass
    t_mm = _timed(lambda: x @ x, sync)
    t_cp = _timed(lambda: x.clone(), sync)
    return {"peak_flops": 2.0 * n ** 3 / t_mm,
            "peak_bytes_per_s": 2.0 * x.numel() * x.element_size() / t_cp}


def _probe():
    """(device_kind, platform, flops, bytes, source, final) of the device
    the port runs on; ``final`` is False for a provisional record."""
    import torch

    if torch.cuda.is_available():
        if not torch.cuda.is_initialized():
            return "unknown", "gpu", None, None, "fallback", False
        kind = torch.cuda.get_device_name()
        for sub, f, b in GPU_PEAKS:
            if sub in kind:
                return kind, "gpu", f, b, "table", True
        dev = torch.device("cuda", torch.cuda.current_device())
        cal = _calibrate(dev, torch.bfloat16, 4096)
        return (kind, "gpu", cal["peak_flops"], cal["peak_bytes_per_s"],
                "calibrated", True)
    cal = _calibrate(torch.device("cpu"), torch.float32, 512)
    return ("cpu", "cpu", cal["peak_flops"], cal["peak_bytes_per_s"],
            "calibrated", True)


def peaks(refresh: bool = False) -> Dict[str, Any]:
    """The device's peak record, cached per process::

        {"device_kind", "platform", "peak_flops", "peak_bytes_per_s",
         "machine_balance", "source": "table" | "calibrated" | "env"
                                      | "fallback"}

    Never raises: with no usable device it falls back to a nominal 1
    TFLOP/s and 100 GB/s (``source: "fallback"``), so a profile read cannot
    take serving down."""
    global _cache
    with _lock:
        if _cache is not None and not refresh:
            return _cache
    kind, platform = "unknown", "unknown"
    flops = byts = None
    source, final = "fallback", True
    try:
        kind, platform, flops, byts, source, final = _probe()
    except Exception:
        pass
    env_f = os.environ.get("PADDLE_TPU_PEAK_FLOPS")
    env_b = os.environ.get("PADDLE_TPU_PEAK_BYTES")
    if env_f or env_b:
        source = "env"
        if env_f:
            flops = float(env_f)
        if env_b:
            byts = float(env_b)
    if not flops or flops <= 0:
        flops = 1e12
    if not byts or byts <= 0:
        byts = 1e11
    rec = {"device_kind": kind, "platform": platform,
           "peak_flops": flops, "peak_bytes_per_s": byts,
           "machine_balance": flops / byts, "source": source}
    if final:
        with _lock:
            _cache = rec
    return rec


def peak_flops() -> float:
    """Shorthand for ``peaks()["peak_flops"]``."""
    return peaks()["peak_flops"]


def machine_balance() -> float:
    """The roofline ridge point in FLOP/byte: programs below it are
    memory-bound on this device, above it compute-bound."""
    return peaks()["machine_balance"]
