"""Cross-process fleet: HTTP replicas behind the same Router seam.

Port of ``paddle_tpu/serving/remote.py``. Everything the Router consumes
from a replica is duck-typed (see ``router.py``: anything with ``build()``
-> Server-shaped object routes), and everything a Server exposes is
already on the wire: ``/generate`` streams tokens, ``/healthz`` is
``Server.load()`` verbatim, ``/stats?shard=1`` is the mergeable
``digests_dict()`` shard, ``/profile`` is the program-ledger shard (a
replica process started with ``FLAGS_enable_ledger=1`` in its environment
records its programs). This module closes the loop with:

- :class:`RemoteReplica` — a Server-shaped **client**: ``submit()``
  POSTs a streaming ``/generate`` and relays the ndjson stream into a
  local :class:`~paddle_tpu_torch.serving.queue.RequestHandle`; ``load()``/
  ``status``/``queue.depth``/``num_active()``/``engine.*`` read a
  background-polled ``/healthz`` snapshot (NEVER the network — the
  router's pick loop runs under its lock); ``slo`` pulls the raw shards
  so the fleet rollup stays merge-exact. Breakers, slow-replica skew
  detection, failover replay and adapter-affinity routing work
  unchanged — zero Router forks.
- :class:`RemoteReplicaSpec` — a :class:`~.router.ReplicaSpec` whose
  ``build()`` spawns (or attaches to) a replica **process**; the
  Router's supervised restart becomes a respawn.
- ``encode_kv_payload``/``decode_kv_payload`` — the ``/kv/export`` →
  ``/kv/import`` octet-stream framing for disaggregated
  prefill/decode, byte for byte the reference's: finished KV pages (int8
  + per-page scales included) ship as raw pool bytes under a JSON header
  carrying the prefix-cache chain hashes. A page COPY, never a format
  conversion — and the chain hashes make the import idempotent and
  dedup-able fleet-wide. bf16 pages travel as their 16-bit patterns
  under the dtype name ``"bfloat16"`` and decode to ``torch.bfloat16``.
- :class:`DisaggregatedFront` — Splitwise/DistServe-shaped serving:
  a prefill replica runs chunked prefill to completion (budget 1),
  its finished pages ship to the decode replica, and decode continues
  from the warm prefix. If the decode replica dies mid-stream the
  front replays ``prompt + tokens emitted so far`` on the prefill
  replica — the same causal-replay argument (and stream bar) as the
  in-process failover.
- ``python -m paddle_tpu_torch.serving.remote`` — the replica
  entrypoint: builds a seeded Server on the card (``--device cpu`` for
  the CPU), serves HTTP, prints the bound port.

Every socket here carries an explicit timeout: a replica that stops
answering must surface as a breaker/failover event, never as a hung
router thread.
"""
import hashlib
import json
import os
import select
import signal
import socket
import subprocess
import sys
import threading
import time
import warnings
from typing import List, Optional

import numpy as np
import torch

from .. import tracing as trace
from ..inference.generation import (GenerationConfig, PagePoolExhausted,
                                    _prompt_len)
from .queue import (CANCELLED, EXPIRED, FAILED, FINISHED, RequestFailed,
                    RequestHandle, RequestRejected)
from .router import ReplicaSpec
from .scheduler import PreemptionBudgetExceeded

__all__ = ["RemoteReplica", "RemoteReplicaSpec", "DisaggregatedFront",
           "KVIntegrityError", "encode_kv_payload", "decode_kv_payload",
           "spawn_replica"]


# ---------------------------------------------------------------------------
# KV payload wire framing (/kv/export response == /kv/import request)
# ---------------------------------------------------------------------------
# [4-byte big-endian header length][JSON header][raw array bytes...]
#
# The header carries everything except the page bytes: version, the
# pool's kv_dtype + page_size, the export salt, the prefix-cache chain
# (hash, parent, tokens) per block, and per-layer array metadata
# (dtype name + shape). The arrays follow concatenated, C-contiguous,
# per layer in the fixed order k, v[, k_scale, v_scale]. JSON never
# touches the page bytes (a 2 MB page would balloon 4x as a number
# list and lose its dtype), and the receiver can validate the whole
# geometry before reading a single array byte.

_KV_MAGIC_VERSION = 1
_MAX_KV_HEADER_BYTES = 8 << 20
_ARRAY_KEYS = ("k", "v", "k_scale", "v_scale")
_KV_DIGEST_BYTES = 16


class KVIntegrityError(ValueError):
    """A KV payload arrived well-framed but WRONG: a checksum over the
    page bytes disagrees with the header's digests. Distinct from the
    plain framing ``ValueError`` so the import path can count it and
    the shipper can re-ship (chain-hash dedup makes the retry
    idempotent) instead of treating it as a validation bug."""


def _kv_digest(*parts: bytes) -> str:
    h = hashlib.blake2b(digest_size=_KV_DIGEST_BYTES)
    for p in parts:
        h.update(p)
    return h.hexdigest()


# wire dtype names (numpy's) of the torch dtypes a pool or scale can have
_WIRE_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                "float32": torch.float32, "float64": torch.float64,
                "int8": torch.int8, "uint8": torch.uint8,
                "int16": torch.int16, "int32": torch.int32,
                "int64": torch.int64, "bool": torch.bool}
_WIRE_NAMES = {v: k for k, v in _WIRE_DTYPES.items()}


def _wire_dtype(name: str) -> torch.dtype:
    """The torch dtype of a wire dtype name (``bfloat16`` included: no
    ml_dtypes needed, bf16 arrays travel as their 16-bit patterns)."""
    try:
        return _WIRE_DTYPES[name]
    except (KeyError, TypeError):
        raise ValueError(f"unknown KV payload dtype {name!r}") from None


def _host(arr) -> torch.Tensor:
    """A payload array (a torch tensor, or a numpy array of a plain dtype)
    as a contiguous host tensor."""
    if isinstance(arr, np.ndarray):
        arr = torch.from_numpy(np.ascontiguousarray(arr))
    return arr.detach().to("cpu").contiguous()


def _raw(t: torch.Tensor) -> memoryview:
    """A contiguous host tensor's bytes, uncopied (bf16 read as its int16
    bits): what the digests hash and the frame joins."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().data


def _from_raw(raw: bytes, dt: torch.dtype, count: int, offset: int,
              shape) -> torch.Tensor:
    """A read-only host tensor over ``count`` elements of ``raw`` at
    ``offset`` (no copy: the payload bytes back it, as the reference's
    ``np.frombuffer`` arrays do)."""
    storage = np.int16 if dt == torch.bfloat16 else _WIRE_NAMES[dt]
    arr = np.frombuffer(raw, dtype=storage, count=count,
                        offset=offset).reshape(shape)
    with warnings.catch_warnings():
        # the buffer is immutable bytes: the tensor is a read-only view
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(arr)
    return t.view(dt) if dt == torch.bfloat16 else t


def _block_hash_bytes(blocks) -> List[bytes]:
    """The chain hashes as bytes, defensively (a digestless manual
    payload may carry anything here — encode and decode must agree on
    the fallback so round-trips stay verifiable)."""
    out = []
    for b in (blocks if isinstance(blocks, list) else []):
        try:
            out.append(bytes.fromhex(b.get("hash", "")))
        except (AttributeError, TypeError, ValueError):
            out.append(b"")
    return out


def encode_kv_payload(payload: dict) -> bytes:
    """Frame one ``engine.export_kv_pages()`` payload for the wire.

    The header carries integrity digests (``blake2b`` over the chain
    hashes + raw pool bytes): one whole-payload checksum plus — when
    every array's leading dim is the block count, which is how the
    engine exports — a per-block checksum that lets the importer NAME
    the corrupted block. ``decode_kv_payload`` verifies them before a
    single page can install; payloads without digests (older writers,
    hand-built tests) still decode."""
    header = {k: payload[k] for k in ("version", "kv_dtype",
                                      "page_size", "salt", "coverage",
                                      "blocks")}
    metas, chunks, arrays = [], [], []
    for lay in payload["layers"]:
        meta = {}
        for key in _ARRAY_KEYS:
            if key not in lay:
                continue
            arr = _host(lay[key])
            meta[key] = {"dtype": _WIRE_NAMES[arr.dtype],
                         "shape": list(arr.shape)}
            chunks.append(_raw(arr))
            arrays.append(arr)
        metas.append(meta)
    header["layers"] = metas
    hashes = _block_hash_bytes(payload["blocks"])
    digests = {"algo": f"blake2b-{_KV_DIGEST_BYTES}",
               "payload": _kv_digest(*hashes, *chunks)}
    nblocks = len(hashes)
    if nblocks and all(a.ndim >= 1 and a.shape[0] == nblocks
                       for a in arrays):
        digests["blocks"] = [
            _kv_digest(hashes[b], *(_raw(a[b]) for a in arrays))
            for b in range(nblocks)]
    header["digests"] = digests
    hdr = json.dumps(header).encode()
    return b"".join([len(hdr).to_bytes(4, "big"), hdr] + chunks)


def decode_kv_payload(raw: bytes) -> dict:
    """Parse the framing back into the ``import_kv_pages()`` payload
    shape. Validates the frame exhaustively — this is the one spot
    untrusted bytes become arrays, and a short/torn body must be a
    ValueError (HTTP 400), never a numpy surprise inside the
    scheduler's gap."""
    if len(raw) < 4:
        raise ValueError("KV payload too short for its header length")
    n = int.from_bytes(raw[:4], "big")
    if n <= 0 or n > _MAX_KV_HEADER_BYTES or 4 + n > len(raw):
        raise ValueError(f"KV payload header length {n} out of bounds")
    try:
        header = json.loads(raw[4:4 + n])
    except json.JSONDecodeError as e:
        raise ValueError(f"KV payload header is not JSON: {e}") from e
    if not isinstance(header, dict):
        raise ValueError("KV payload header must be a JSON object")
    if header.get("version") != _KV_MAGIC_VERSION:
        raise ValueError(
            f"KV payload version {header.get('version')!r} "
            f"(expected {_KV_MAGIC_VERSION})")
    for key in ("kv_dtype", "page_size", "salt", "coverage",
                "blocks", "layers"):
        if key not in header:
            raise ValueError(f"KV payload header missing {key!r}")
    out = {k: header[k] for k in ("version", "kv_dtype", "page_size",
                                  "salt", "coverage", "blocks")}
    if not isinstance(header["layers"], list):
        raise ValueError("KV payload 'layers' must be a list")
    # an integrity-protected payload (digests in the header) that
    # arrives SHORT is wire damage, not a malformed request: type it
    # so the shipper re-ships instead of treating the replica as
    # broken (KVIntegrityError subclasses ValueError — callers that
    # only know 400 semantics keep working)
    torn_exc = (KVIntegrityError
                if isinstance(header.get("digests"), dict)
                else ValueError)
    layers, off = [], 4 + n
    for li, meta in enumerate(header["layers"]):
        if not isinstance(meta, dict) or "k" not in meta \
                or "v" not in meta:
            raise ValueError(
                f"KV payload layer {li} metadata must carry 'k' "
                "and 'v'")
        lay = {}
        for key in _ARRAY_KEYS:
            if key not in meta:
                continue
            m = meta[key]
            try:
                dt = _wire_dtype(m["dtype"])
                shape = tuple(int(s) for s in m["shape"])
            except (KeyError, TypeError, ValueError) as e:
                raise ValueError(
                    f"KV payload layer {li} {key!r} metadata "
                    f"malformed: {e}") from e
            if any(s < 0 for s in shape):
                raise ValueError(
                    f"KV payload layer {li} {key!r} has a negative "
                    "dim")
            count = int(np.prod(shape, dtype=np.int64))
            nbytes = dt.itemsize * count
            if off + nbytes > len(raw):
                raise torn_exc(
                    f"KV payload truncated at layer {li} {key!r}")
            lay[key] = _from_raw(raw, dt, count, off, shape)
            off += nbytes
        layers.append(lay)
    if off != len(raw):
        raise torn_exc(
            f"KV payload carries {len(raw) - off} trailing bytes")
    dig = header.get("digests")
    if isinstance(dig, dict) and dig.get("payload"):
        # verify BEFORE anything can install: framing above proved the
        # geometry; this proves the bytes. The whole-payload digest is
        # one pass over the array region; per-block digests only
        # recompute on mismatch, to name the culprit.
        hashes = _block_hash_bytes(header["blocks"])
        if _kv_digest(*hashes, raw[4 + n:]) != dig["payload"]:
            bad = None
            blk_digs = dig.get("blocks")
            if isinstance(blk_digs, list) \
                    and len(blk_digs) == len(hashes):
                for b in range(len(hashes)):
                    parts = [hashes[b]]
                    for lay in layers:
                        for key in _ARRAY_KEYS:
                            if key in lay and lay[key].shape \
                                    and lay[key].shape[0] == len(hashes):
                                parts.append(_raw(
                                    lay[key][b].contiguous()))
                    if _kv_digest(*parts) != blk_digs[b]:
                        bad = b
                        break
            raise KVIntegrityError(
                "KV payload integrity check failed"
                + (f" at block {bad}" if bad is not None else "")
                + ": checksum mismatch (bit-rot on the wire); "
                "nothing was installed — re-ship (chain-hash dedup "
                "makes the retry idempotent)")
    out["layers"] = layers
    return out


# ---------------------------------------------------------------------------
# HTTP plumbing (every call carries an explicit timeout)
# ---------------------------------------------------------------------------
def _http_json(method: str, url: str, path: str,
               body: Optional[dict] = None,
               timeout: float = 5.0):
    """One bounded JSON request; returns (status, parsed-body)."""
    import http.client
    from urllib.parse import urlsplit

    u = urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port,
                                      timeout=timeout)
    try:
        payload = (None if body is None
                   else json.dumps(body).encode())
        headers = ({"Content-Type": "application/json"}
                   if payload is not None else {})
        conn.request(method, path, body=payload, headers=headers)
        resp = conn.getresponse()
        raw = resp.read()
        try:
            parsed = json.loads(raw) if raw else {}
        except json.JSONDecodeError:
            parsed = {"error": raw.decode("utf-8", "replace")}
        return resp.status, parsed
    finally:
        conn.close()


def _http_raw(method: str, url: str, path: str, body: bytes,
              ctype: str, timeout: float = 30.0):
    """One bounded raw-bytes request; returns (status, raw body)."""
    import http.client
    from urllib.parse import urlsplit

    u = urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port,
                                      timeout=timeout)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": ctype})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


# ---------------------------------------------------------------------------
# Server-shaped shims over the polled /healthz snapshot
# ---------------------------------------------------------------------------
class _RemoteQueue:
    """``.depth`` off the cached snapshot — the router's pick loop
    reads it under the router lock, so it must never do I/O."""
    __slots__ = ("_rep",)

    def __init__(self, rep):
        self._rep = rep

    @property
    def depth(self) -> int:  # lint: hot-path
        # lint: allow-host-sync(host dict read off the cached snapshot)
        return int(self._rep._snap().get("queue_depth", 0))


class _RemoteAlloc:
    __slots__ = ("_rep",)

    def __init__(self, rep):
        self._rep = rep

    @property
    def free_pages(self) -> int:  # lint: hot-path
        # lint: allow-host-sync(host dict read off the cached snapshot)
        return int(self._rep._snap().get("free_pages", 0))


class _RemoteAdapters:
    """Adapter-affinity membership test (``adapter in engine.adapters``)
    over the snapshot's ``lora.resident`` list."""
    __slots__ = ("_rep",)

    def __init__(self, rep):
        self._rep = rep

    def _resident(self) -> list:
        lora = self._rep._snap().get("lora")
        if isinstance(lora, dict):
            return list(lora.get("resident", []))
        return []

    def __contains__(self, name) -> bool:  # lint: hot-path
        return name in self._resident()

    def resident(self) -> list:
        return self._resident()


class _RemoteEngine:
    """The engine-shaped corner of the duck type: capacity fields the
    router reads per pick. ``close()`` is a no-op — the REMOTE process
    owns its engine; the replica's ``shutdown()`` owns the process."""
    __slots__ = ("_rep", "alloc", "adapters")

    def __init__(self, rep):
        self._rep = rep
        self.alloc = _RemoteAlloc(rep)
        self.adapters = _RemoteAdapters(rep)

    @property
    def max_len(self) -> int:
        return int(self._rep._snap().get("max_len", 1 << 30))

    @property
    def prefix_cache(self) -> bool:
        p = self._rep._snap().get("pressure")
        return bool(isinstance(p, dict) and p.get("prefix_cache"))

    def close(self) -> None:
        pass


class _RemoteSLO:
    """SLO-tracker shim: the raw ``digests_dict()`` shard comes over
    ``GET /stats?shard=1`` and everything derives from it LOCALLY by
    the same merge math — fleet percentiles stay exact because the
    wire carries buckets, never pre-rolled percentiles."""
    __slots__ = ("_rep",)

    def __init__(self, rep):
        self._rep = rep

    def digests_dict(self) -> dict:
        status, body = _http_json(
            "GET", self._rep.base_url, "/stats?shard=1",
            timeout=self._rep.io_timeout_s)
        if status != 200:
            raise RuntimeError(
                f"replica {self._rep.base_url} /stats?shard=1 -> "
                f"{status}: {body.get('error')}")
        return body

    def rolling_tpot_p50(self, min_count: int = 1) -> Optional[float]:
        from ..monitor.slo import LatencyDigest

        d = LatencyDigest.from_dict(
            self.digests_dict()["rolling_tpot"])
        if d.count < max(1, min_count):
            return None
        return d.percentile(50)

    def percentiles(self) -> dict:
        from ..monitor.slo import fleet_rollup

        return fleet_rollup([self.digests_dict()])["metrics"]


class RemoteReplica:
    """A Server-shaped client for one out-of-process replica.

    The router-facing read surface (``status`` / ``load()`` /
    ``queue.depth`` / ``num_active()`` / ``engine.*``) comes from a
    background-polled ``/healthz`` snapshot — the pick loop runs under
    the router lock and must NEVER wait on a socket there. A replica
    whose poller cannot reach it reads ``failed``, which is exactly
    the signal the router's supervision turns into a respawn (via
    :class:`RemoteReplicaSpec`).

    ``submit()`` speaks streaming ``/generate``: the response's ndjson
    lines drive a local :class:`RequestHandle` from a reader thread,
    so the router's relay (condition-variable waits on ``_tokens`` /
    ``_status``) works on it unchanged. Backpressure maps back to the
    exceptions the router already classifies: 429 →
    ``RequestRejected("queue_full")``, 503 → ``RequestRejected`` with
    the server's reason, 400 → ValueError (the capacity verdict), and
    a mid-stream ``failed:`` trailer is re-typed by message so
    page-pool exhaustion stays a request-scoped terminal and a
    preemption-budget trip stays an overload migration.
    """

    def __init__(self, base_url: str, *,
                 proc: Optional[subprocess.Popen] = None,
                 poll_interval_s: float = 0.2,
                 io_timeout_s: float = 5.0,
                 stream_timeout_s: float = 600.0,
                 admission_probe_s: float = 0.25,
                 wire_retries: int = 2,
                 retry_backoff_s: float = 0.05,
                 retry_backoff_max_s: float = 1.0,
                 max_resumes: int = 2):
        self.base_url = base_url.rstrip("/")
        self.proc = proc                  # owned subprocess (or None:
        #                                   attached — never killed)
        self.io_timeout_s = io_timeout_s
        self.stream_timeout_s = stream_timeout_s
        self.admission_probe_s = admission_probe_s
        self.poll_interval_s = poll_interval_s
        # exactly-once wire knobs: submit retries are safe because
        # every attempt carries the SAME idempotency key (a retried
        # ambiguous POST attaches to the live request server-side
        # instead of double-executing); a torn stream resumes on the
        # SAME replica from the last received token (warm KV, no
        # re-prefill) before failover replay is ever considered
        self.wire_retries = wire_retries
        self.retry_backoff_s = retry_backoff_s
        self.retry_backoff_max_s = retry_backoff_max_s
        self.max_resumes = max_resumes
        self.resumes = 0                  # mid-stream resumes served
        self.submit_retries = 0           # wire-level resubmissions
        self.integrity_rejects = 0        # KV ships the peer refused
        # testing seam: a paddle_tpu_torch.testing.faults.NetworkFaultPlan
        # fired at the wire sites ("generate", "kv_import") — bounded
        # delay / connection drop / mid-stream half-close, so the chaos
        # suite can prove failover replay absorbs a torn wire, not just
        # a dead engine
        self.fault_plan = None
        self.queue = _RemoteQueue(self)
        self.engine = _RemoteEngine(self)
        self.slo = _RemoteSLO(self)
        self._lock = threading.Lock()
        self._next_id = 0                 # guarded-by: self._lock
        self._snapshot = {"status": "failed",
                          "error": "never polled"}
        self._snap_ts = 0.0
        self._stop = threading.Event()
        self._poller = threading.Thread(
            target=self._poll_loop, daemon=True,
            name=f"paddle_tpu-remote-poll-{self.base_url}")
        self._refresh()                   # one synchronous fetch so a
        #                                   freshly built replica is
        #                                   routable before the first
        #                                   poll tick
        self._poller.start()

    # -- /healthz snapshot ---------------------------------------------------
    def _refresh(self) -> None:
        try:
            status, body = _http_json("GET", self.base_url, "/healthz",
                                      timeout=self.io_timeout_s)
        except OSError as e:
            body = {"status": "failed", "healthy": False,
                    "error": f"unreachable: {e}"}
        else:
            if not isinstance(body, dict) or "status" not in body:
                body = {"status": "failed", "healthy": False,
                        "error": f"bad /healthz ({status})"}
        with self._lock:
            self._snapshot = body
            self._snap_ts = time.monotonic()

    def _poll_loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            self._refresh()

    def _snap(self) -> dict:
        with self._lock:
            return self._snapshot

    # -- Server-shaped read surface ------------------------------------------
    # The router reads these UNDER ITS LOCK on every pick/poll: they
    # must serve the poller's cached snapshot only, never the network.
    # The hot-path annotations mark them for the reference's lint rule
    # against a live round-trip sneaking back in.
    @property
    def status(self) -> str:  # lint: hot-path
        return str(self._snap().get("status", "failed"))

    def load(self) -> dict:  # lint: hot-path
        return dict(self._snap())

    def num_active(self) -> int:  # lint: hot-path
        # lint: allow-host-sync(host dict read off the cached snapshot)
        return int(self._snap().get("active_requests", 0))

    @property
    def flight_dumps(self) -> list:  # lint: hot-path
        d = self._snap().get("flight_dump")
        return [d] if d else []

    def profile(self) -> dict:
        """The replica process's program-ledger shard (its ``GET
        /profile``), which ``Router.profile`` merges."""
        status, body = _http_json("GET", self.base_url, "/profile",
                                  timeout=self.io_timeout_s)
        if status != 200:
            raise RuntimeError(
                f"replica {self.base_url} /profile -> {status}")
        return body

    def stats(self) -> dict:
        status, body = _http_json("GET", self.base_url, "/stats",
                                  timeout=self.io_timeout_s)
        if status != 200:
            raise RuntimeError(
                f"replica {self.base_url} /stats -> {status}")
        return body

    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        """Poll (directly — warmup is exactly when the cache is stale)
        until the replica reports ok/draining."""
        end = (None if timeout is None
               else time.monotonic() + timeout)
        while True:
            self._refresh()
            if self.status in ("ok", "draining"):
                return True
            if end is not None and time.monotonic() >= end:
                return False
            if self.proc is not None and self.proc.poll() is not None:
                return False              # process died during warmup
            time.sleep(0.05)

    # -- streaming submit ----------------------------------------------------
    def submit(self, prompt, cfg: Optional[GenerationConfig] = None,
               priority: int = 0,
               timeout_s: Optional[float] = None,
               trace_rid: Optional[str] = None,
               tenant: Optional[str] = None) -> RequestHandle:
        """Same contract as ``Server.submit`` across the wire. The
        admission probe waits ``admission_probe_s`` for an early
        response line — a rejection (429/503/400) answers immediately
        and raises HERE, synchronously, so router backpressure keeps
        its no-failover-budget semantics; the success status line is
        DEFERRED by the server until the first token, so its absence
        within the probe means "admitted or queued" and the reader
        thread takes over."""
        cfg = cfg or GenerationConfig()
        plen = _prompt_len(prompt)
        max_len = self.engine.max_len
        if plen + cfg.max_new_tokens > max_len:
            raise ValueError(
                f"prompt({plen}) + max_new_tokens({cfg.max_new_tokens})"
                f" exceeds engine max_len({max_len})")
        ids = (prompt.tolist() if isinstance(prompt, np.ndarray)
               else [int(t) for t in prompt])
        body = {"prompt": [int(t) for t in ids], "stream": True,
                "priority": priority}
        defaults = GenerationConfig()
        for k, v in vars(cfg).items():
            # only non-default fields travel: the remote server's OWN
            # defaults (e.g. speculative opt-in) must keep applying
            if v != getattr(defaults, k, None):
                body[k] = v
        if timeout_s is not None:
            body["timeout_s"] = timeout_s
        if tenant is not None:
            body["tenant"] = tenant
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        with self._lock:
            rid = self._next_id
            self._next_id += 1
        # the idempotency key every wire attempt of THIS submission
        # carries: the router's stable rid keeps it identical across
        # retries (so a retried ambiguous POST attaches to the live
        # request server-side instead of double-executing), and the
        # per-submit salt keeps a failover REPLAY — a new submission
        # with the same trace rid — from attaching to the zombie it
        # replaces
        idem = (f"{trace_rid if trace_rid is not None else self.base_url}"
                f"#{rid}")
        body["idem_key"] = idem

        state = {"conn": None, "closed": False}
        handle = RequestHandle(
            rid, prompt, plen, cfg, priority, deadline,
            on_cancel=lambda h: self._abort(state),
            tenant=(tenant if tenant is not None
                    else getattr(cfg, "adapter", None)))
        handle._trace_rid = (trace_rid if trace_rid is not None
                             else f"{self.base_url}:{rid}")
        handle._trace_ttft = trace_rid is None

        import http.client
        from urllib.parse import urlsplit

        u = urlsplit(self.base_url)
        attempt = 0
        while True:
            conn = http.client.HTTPConnection(u.hostname, u.port,
                                              timeout=self.io_timeout_s)
            state["conn"] = conn
            state["closed"] = False
            early = None
            try:
                if self.fault_plan is not None:
                    # network seam: a delay sleeps right here, a drop
                    # raises ConnectionResetError into the retry path
                    # below (exactly a refused/reset socket), and a
                    # half-close/corrupt spec rides in ``state`` for
                    # the reader thread to consume mid-stream
                    state["cut"] = self.fault_plan.fire("generate")
                payload = json.dumps(body).encode()
                conn.request("POST", "/generate", body=payload,
                             headers={"Content-Type":
                                      "application/json"})
                # the admission probe: readable within the window
                # means the server already answered — only rejections
                # and instant terminals do (the 200 status line waits
                # for the first token), so its absence means "admitted
                # or queued" and the reader thread takes over
                r, _, _ = select.select([conn.sock], [], [],
                                        self.admission_probe_s)
                if r:
                    early = conn.getresponse()
                    if early.status != 200:
                        raw = early.read()
                        self._close_conn(state)
                        self._raise_rejection(early.status, raw,
                                              handle)
                        return handle     # 504/500 finished the handle
            except RequestRejected:
                raise
            except ValueError:
                raise
            except OSError as e:
                # the AMBIGUOUS wire failure (the server may or may
                # not have admitted): safe to retry because the idem
                # key dedups server-side. Bounded exponential backoff,
                # and never a retry that cannot land before the
                # request's own deadline — shed those instead.
                self._close_conn(state)
                wait = min(self.retry_backoff_s * (2.0 ** attempt),
                           self.retry_backoff_max_s)
                attempt += 1
                if attempt > self.wire_retries:
                    raise RuntimeError(
                        f"replica {self.base_url} unreachable after "
                        f"{attempt} attempt(s): {e}") from e
                if (deadline is not None
                        and time.monotonic() + wait >= deadline):
                    raise RequestRejected(
                        "deadline_doomed",
                        f"replica {self.base_url}: wire retry would "
                        f"outlive the request deadline ({e})",
                        retry_after_s=None) from e
                self.submit_retries += 1
                if trace.enabled():
                    trace.event("wire.retry", rid=handle._trace_rid,
                                attempt=attempt, wait_s=wait,
                                cause=repr(e))
                time.sleep(wait)
                continue
            break
        reader = threading.Thread(
            target=self._read_stream,
            args=(state, handle, early, body, idem),
            daemon=True,
            name=f"paddle_tpu-remote-stream-{self.base_url}-{rid}")
        reader.start()
        return handle

    def _raise_rejection(self, status: int, raw: bytes,
                         handle: RequestHandle) -> None:
        """Map an early (pre-stream) HTTP error onto the submit
        contract: raise for backpressure/validation, finish the handle
        for per-request terminals."""
        try:
            body = json.loads(raw) if raw else {}
        except json.JSONDecodeError:
            body = {}
        msg = body.get("error", f"HTTP {status}")
        if status == 429:
            # carry the server's reason ("queue_full" vs the control
            # plane's "shed") and its Retry-After hint through — the
            # router's backpressure classification and a client's
            # backoff both depend on them surviving the hop
            raise RequestRejected(
                body.get("reason", "queue_full"), msg,
                retry_after_s=body.get("retry_after_s"))
        if status == 503:
            # draining/warming replicas now publish a drain-ETA /
            # warmup-estimate Retry-After too — same passthrough
            raise RequestRejected(
                body.get("reason", "degraded"), msg,
                retry_after_s=body.get("retry_after_s"))
        if status == 400:
            raise ValueError(msg)
        if status == 504:
            handle._finish(EXPIRED)
            return
        handle._finish(FAILED, RequestFailed(
            f"replica {self.base_url} -> {status}: {msg}"))

    def _abort(self, state: dict) -> None:
        """Cancel path: shear the socket. The remote handler's broken-
        pipe guard cancels the request server-side; the reader thread
        unblocks on the dead socket and finishes the handle."""
        self._close_conn(state)

    @staticmethod
    def _close_conn(state: dict) -> None:
        state["closed"] = True
        conn = state.get("conn")
        if conn is None:
            return
        try:
            if conn.sock is not None:
                conn.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            conn.close()
        except OSError:
            pass

    @staticmethod
    def _classify_failure(msg: str) -> BaseException:
        """Re-type a ``failed: <msg>`` stream trailer so the router's
        verdict logic keeps working across the wire: page-pool
        exhaustion is a request-scoped capacity terminal, a preemption-
        budget trip is an overload migration — everything else is a
        replica-attributed failover."""
        low = msg.lower()
        if "page pool exhausted" in low or "cannot ever hold" in low:
            return PagePoolExhausted(msg)
        if "preempt" in low and "budget" in low:
            return PreemptionBudgetExceeded(msg)
        return RequestFailed(msg)

    def _read_stream(self, state: dict, handle: RequestHandle,
                     early, body: Optional[dict] = None,
                     idem: Optional[str] = None) -> None:
        """Reader thread: relay one /generate ndjson stream into the
        local handle. Terminal mapping mirrors ``_stream_response``'s
        writer side; a torn stream (socket error, EOF without a done
        line) first tries a MID-STREAM RESUME — reconnect to the SAME
        replica with the idempotency key + ``from_token`` so the server
        reattaches the live handle and replays only the tokens we
        missed (warm KV intact, no re-prefill). Only when resumes are
        exhausted or the replica looks genuinely unhealthy does the
        tear surface as a replica-attributed failure for the router's
        failover replay — unless the tear was OUR cancel, which must
        read CANCELLED, not failover."""
        import http.client
        from urllib.parse import urlsplit

        err: Optional[BaseException] = None
        done_line = None
        resumed = 0
        while True:
            conn = state["conn"]
            err = None
            done_line = None
            try:
                if early is not None:
                    resp = early
                    early = None
                else:
                    resp = conn.getresponse()
                if resp.status != 200:
                    raw = resp.read()
                    try:
                        self._raise_rejection(resp.status, raw, handle)
                    except (RequestRejected, ValueError) as e:
                        # after the probe window these cannot raise
                        # into the caller anymore — carry them on the
                        # handle (the router relays RequestRejected ->
                        # failover, ValueError -> request-scoped
                        # terminal)
                        handle._finish(FAILED, e)
                    return
                # streaming begins: per-token gaps may be long (a cold
                # compile, a busy batch) — widen the per-recv timeout
                # from the connect/admission one to the stream one
                if conn.sock is not None:
                    conn.sock.settimeout(self.stream_timeout_s)
                first = len(handle.tokens_so_far()) == 0
                cut = state.get("cut")    # injected mid-stream tear
                relayed = 0
                while True:
                    line = resp.readline()
                    if not line:
                        break             # EOF without a done line
                    line = line.strip()
                    if not line:
                        continue
                    if (cut is not None
                            and cut.get("action") == "corrupt"
                            and cut.get("mode") == "flip"
                            and relayed >= cut["after"]):
                        # injected corruption: garble this line in
                        # flight — json.loads below tears exactly like
                        # real bit-rot would
                        line = bytes(b ^ 0xFF for b in line)
                    rec = json.loads(line)
                    if "token" in rec:
                        if first:
                            first = False
                            # admission is invisible over the wire
                            # until the first token: mark RUNNING here
                            # (engine rid is remote-private;
                            # -1 = "remote")
                            handle._mark_running(-1)
                        handle._push([int(rec["token"])])
                        relayed += 1
                        if (cut is not None
                                and cut.get("mode") != "flip"
                                and relayed >= cut["after"]):
                            # injected half-close (or truncation):
                            # walk away with the server mid-stream —
                            # no done line, so the tear enters the
                            # resume path below; server-side the
                            # broken-pipe guard parks the handle in
                            # the dedup window for the grace period
                            break
                    elif rec.get("done"):
                        done_line = rec
                        break
            except Exception as e:  # noqa: BLE001 - any tear (socket
                #   error, torn chunk framing, http.client's own
                #   internal races when the cancel path shears the
                #   socket under a blocked read) must RESOLVE the
                #   handle — an unresolved handle strands the router's
                #   relay forever
                err = e
            finally:
                self._close_conn(state)
            if handle.done:
                return
            if handle._cancel_requested:
                handle._finish(CANCELLED)
                return
            if done_line is not None:
                break
            # torn stream. Resume against the SAME replica first: the
            # server-side dedup window still holds the live handle (a
            # broken pipe with an idem key orphans, not cancels), so a
            # reconnect keyed on idem + from_token replays only the
            # missing tail against warm KV. Failover (full re-prefill
            # elsewhere) is the fallback, not the first move.
            if (idem is not None and body is not None
                    and resumed < self.max_resumes
                    and self.status in ("ok", "draining")):
                resumed += 1
                self.resumes += 1
                from_token = len(handle.tokens_so_far())
                if trace.enabled():
                    trace.event("wire.resume", rid=handle._trace_rid,
                                attempt=resumed,
                                from_token=from_token,
                                cause=repr(err) if err else "eof")
                try:
                    u = urlsplit(self.base_url)
                    conn = http.client.HTTPConnection(
                        u.hostname, u.port,
                        timeout=self.io_timeout_s)
                    state["conn"] = conn
                    state["closed"] = False
                    if self.fault_plan is not None:
                        state["cut"] = self.fault_plan.fire("generate")
                    else:
                        state["cut"] = None
                    rbody = dict(body)
                    rbody["from_token"] = from_token
                    conn.request(
                        "POST", "/generate",
                        body=json.dumps(rbody).encode(),
                        headers={"Content-Type": "application/json"})
                    continue              # next loop getresponse()s
                except OSError as e:
                    err = e
                    self._close_conn(state)
                    # fall through to the failover terminal
            handle._finish(FAILED, RequestFailed(
                f"replica {self.base_url} stream broke: "
                f"{err!r}" if err is not None else
                f"replica {self.base_url} stream ended without a "
                "done line"))
            return
        status = str(done_line.get("status", "finished"))
        if status == "finished":
            handle._finish(FINISHED)
        elif status == "cancelled":
            handle._finish(CANCELLED)
        elif status == "expired":
            handle._finish(EXPIRED)
        else:                             # "failed: <message>"
            msg = status.partition(":")[2].strip() or status
            handle._finish(FAILED, self._classify_failure(msg))

    # -- KV page handoff (disaggregated prefill/decode) ----------------------
    def export_kv_raw(self, tokens, salt: bytes = b"") -> bytes:
        """``POST /kv/export`` — the replica's resident full-block
        pages covering ``tokens``, as framed wire bytes. Kept RAW on
        purpose: the disaggregated front ships these bytes to the
        decode replica untouched (a page copy, never a conversion —
        and never a decode/re-encode hop in the middle)."""
        body = json.dumps(
            {"tokens": [int(t) for t in tokens],
             "salt": salt.hex()}).encode()
        status, raw = _http_raw("POST", self.base_url, "/kv/export",
                                body, "application/json",
                                timeout=self.stream_timeout_s)
        if status != 200:
            try:
                msg = json.loads(raw).get("error", "")
            except json.JSONDecodeError:
                msg = raw.decode("utf-8", "replace")
            raise RuntimeError(
                f"replica {self.base_url} /kv/export -> {status}: "
                f"{msg}")
        return raw

    def import_kv_raw(self, raw: bytes) -> dict:
        """``POST /kv/import`` — install framed pages into the
        replica's pool + prefix index. Idempotent: chain hashes dedup
        a replayed ship into ``{"deduped": n}``."""
        if self.fault_plan is not None:
            # network seam: delay sleeps, drop raises (surfaces as the
            # shipper's RuntimeError/OSError); a half-close truncates
            # the payload mid-ship — the server sees torn framing and
            # rejects, and the front's retry must re-ship (idempotent
            # by chain hash, so a retry after a PARTIAL install dedups)
            spec = self.fault_plan.fire("kv_import")
            if spec is not None and spec.get("action") == "half_close":
                raw = raw[:max(1, len(raw) // 2)]
            elif spec is not None and spec.get("action") == "corrupt":
                if spec.get("mode") == "truncate":
                    # torn mid-transfer but past the header: framing
                    # length no longer matches — the integrity layer
                    # must reject BEFORE any page installs
                    raw = raw[:max(5, (len(raw) * 3) // 4)]
                else:                     # "flip"
                    # single byte-flip in the array tail: framing
                    # survives, the payload digest does not — exactly
                    # the silent bit-rot the checksums exist for
                    raw = raw[:-1] + bytes([raw[-1] ^ 0xFF])
        status, out = _http_raw("POST", self.base_url, "/kv/import",
                                raw, "application/octet-stream",
                                timeout=self.stream_timeout_s)
        try:
            body = json.loads(out)
        except json.JSONDecodeError:
            body = {"error": out.decode("utf-8", "replace")}
        if status != 200:
            if body.get("reason") == "integrity":
                # typed-and-counted: the shipper distinguishes "the
                # bytes rotted (re-ship, dedup makes it idempotent)"
                # from "the replica is broken (failover)"
                self.integrity_rejects += 1
                if trace.enabled():
                    trace.event("kv.integrity_reject",
                                url=self.base_url,
                                error=str(body.get("error")))
                raise KVIntegrityError(
                    f"replica {self.base_url} /kv/import rejected: "
                    f"{body.get('error')}")
            raise RuntimeError(
                f"replica {self.base_url} /kv/import -> {status}: "
                f"{body.get('error')}")
        return body

    # -- lifecycle -----------------------------------------------------------
    def drain(self, timeout: Optional[float] = None) -> bool:
        """Wait for the replica's queued + active work to finish (the
        remote server keeps accepting — cross-process drain is an
        observation, not a command; the router drains ITSELF and this
        bounds the tail)."""
        end = (None if timeout is None
               else time.monotonic() + timeout)
        while True:
            self._refresh()
            snap = self._snap()
            if (snap.get("queue_depth", 0) == 0
                    and snap.get("active_requests", 0) == 0):
                return True
            if end is not None and time.monotonic() >= end:
                return False
            time.sleep(0.05)

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop the client (poller) and, for an OWNED process, the
        process: SIGTERM, bounded wait, SIGKILL. An attached replica
        (built from a URL) is left running — we didn't start it."""
        if drain:
            self.drain(timeout=timeout)
        self._stop.set()
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10.0)

    def close(self) -> None:
        self.shutdown(drain=False)


# ---------------------------------------------------------------------------
# spawning replica processes
# ---------------------------------------------------------------------------
_READY_MARKER = "PADDLE_TPU_REPLICA_PORT="


def spawn_replica(extra_args: Optional[List[str]] = None, *,
                  startup_timeout_s: float = 120.0,
                  env: Optional[dict] = None, stderr=subprocess.DEVNULL):
    """Start ``python -m paddle_tpu_torch.serving.remote`` and wait for
    its ready marker. Returns ``(proc, base_url)``. The child inherits our
    environment and binds an ephemeral port, so parallel runs never
    collide. It serves on the card unless ``extra_args`` holds
    ``--device cpu``; without CUDA it dies before its marker and this
    raises. ``stderr`` is where the child's errors go (a file object, or
    ``None`` for ours)."""
    cmd = [sys.executable, "-m", "paddle_tpu_torch.serving.remote",
           "--port", "0"] + list(extra_args or [])
    child_env = dict(os.environ)
    if env:
        child_env.update(env)
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=stderr,
        env=child_env, text=True)
    # a child that hangs before its marker is killed at the timeout, which
    # ends the blocking readline below with EOF
    watchdog = threading.Timer(startup_timeout_s, proc.kill)
    watchdog.daemon = True
    watchdog.start()
    port = None
    try:
        while True:
            line = proc.stdout.readline()
            if not line:
                break                     # child died before readiness
            if line.startswith(_READY_MARKER):
                port = int(line[len(_READY_MARKER):].strip())
                break
    finally:
        watchdog.cancel()
    if port is None:
        rc = proc.poll()
        proc.kill()
        proc.wait(timeout=10.0)
        raise RuntimeError(
            f"replica process did not become ready within "
            f"{startup_timeout_s}s (exit={rc}, cmd={cmd})")
    return proc, f"http://127.0.0.1:{port}"


class RemoteReplicaSpec(ReplicaSpec):
    """A :class:`ReplicaSpec` whose ``build()`` produces a
    :class:`RemoteReplica` — the router's supervised restart becomes a
    process respawn (spawn mode) or a reattach (url mode). Passes the
    router's ``isinstance(spec, ReplicaSpec)`` gate by construction,
    and the rest of the seam is duck-typed."""

    def __init__(self, *, args: Optional[List[str]] = None,
                 url: Optional[str] = None,
                 startup_timeout_s: float = 120.0,
                 env: Optional[dict] = None,
                 replica_kwargs: Optional[dict] = None):
        if (args is None) == (url is None):
            raise ValueError(
                "exactly one of 'args' (spawn a replica process) or "
                "'url' (attach to a running one) is required")
        # the factory is unused (build() is overridden) but the base
        # validates it — hand it something honest about that
        super().__init__(lambda: None)
        self.args = list(args) if args is not None else None
        self.url = url
        self.startup_timeout_s = startup_timeout_s
        self.env = dict(env) if env else None
        self.replica_kwargs = dict(replica_kwargs or {})

    def build(self) -> RemoteReplica:
        if self.url is not None:
            return RemoteReplica(self.url, **self.replica_kwargs)
        proc, base_url = spawn_replica(
            self.args, startup_timeout_s=self.startup_timeout_s,
            env=self.env)
        return RemoteReplica(base_url, proc=proc,
                             **self.replica_kwargs)


# ---------------------------------------------------------------------------
# disaggregated prefill/decode front
# ---------------------------------------------------------------------------
class DisaggregatedFront:
    """Splitwise/DistServe-shaped serving over two (or more) replicas:
    the PREFILL replica runs chunked prefill to completion — budget 1,
    so the scheduler's whole admission/chunking machinery applies —
    then its finished pages (chain hashes included) ship raw to the
    DECODE replica, which continues ``prompt + [t0]`` against the warm
    prefix. Stream identity with a monolithic engine is the bar: the
    handoff is a page copy keyed by the same chain hashes the prefix
    cache already trusts, so the decode side's lookup is exactly the
    prefix cache's warm admission.

    Failover: a decode replica dying mid-stream replays
    ``prompt + tokens emitted so far`` on the prefill replica — whose
    pages are STILL RESIDENT (it prefilled them), so the replay is a
    warm continuation, not a recompute. Same causal-replay argument as
    the in-process router."""

    def __init__(self, prefill: RemoteReplica, decode: RemoteReplica,
                 *, max_failovers: int = 1,
                 max_integrity_failures: int = 3):
        self.prefill = prefill
        self.decode = decode
        self.max_failovers = max_failovers
        # after this many integrity rejects the front stops trusting
        # the wire and decodes on the prefill replica (local prefill —
        # pages never travel), rather than serving off a suspect pool
        self.max_integrity_failures = max_integrity_failures
        self.handoffs = 0                 # pages shipped (blocks)
        self.dedups = 0                   # blocks dedup'd on import
        self.failovers = 0
        self.reships = 0                  # integrity-triggered retries
        self.integrity_rejects = 0        # corrupt payloads refused

    def ship(self, prompt, salt: bytes = b"") -> dict:
        """Ship the prefill replica's pages covering ``prompt`` to the
        decode replica. Returns the import verdict
        ``{"imported", "deduped", "coverage"}``. A corrupt arrival is
        rejected whole by the decode side (nothing installed), so one
        re-ship of freshly exported bytes is safe — the chain-hash
        dedup makes a retry after any partial progress idempotent."""
        attempts = 0
        while True:
            raw = self.prefill.export_kv_raw(
                [int(t) for t in prompt], salt=salt)
            try:
                out = self.decode.import_kv_raw(raw)
            except KVIntegrityError:
                self.integrity_rejects += 1
                attempts += 1
                if attempts > 1:
                    raise
                self.reships += 1
                continue
            self.handoffs += int(out.get("imported", 0))
            self.dedups += int(out.get("deduped", 0))
            return out

    def generate(self, prompt, cfg: Optional[GenerationConfig] = None,
                 timeout_s: Optional[float] = None) -> RequestHandle:
        """One disaggregated request; returns a local handle streaming
        the combined result (t0 from prefill, the rest from decode)."""
        cfg = cfg or GenerationConfig()
        plen = _prompt_len(prompt)
        ids = [int(t) for t in (prompt.tolist()
                                if isinstance(prompt, np.ndarray)
                                else prompt)]
        handle = RequestHandle(0, np.asarray(ids, np.int32), plen,
                               cfg, 0, None)
        t = threading.Thread(
            target=self._pump, args=(handle, ids, cfg, timeout_s),
            daemon=True, name="paddle_tpu-disagg-pump")
        t.start()
        return handle

    def _pump(self, handle: RequestHandle, ids: list,
              cfg: GenerationConfig,
              timeout_s: Optional[float]) -> None:
        try:
            # phase 1: prefill to completion (budget 1 -> the first
            # token proves the full prompt prefilled and its blocks
            # registered in the prefix index)
            kw = dict(vars(cfg))
            kw["max_new_tokens"] = 1
            h1 = self.prefill.submit(ids, GenerationConfig(**kw),
                                     timeout_s=timeout_s)
            t0 = int(h1.result(timeout=self.prefill.stream_timeout_s)
                     [0])
            handle._mark_running(-1)
            handle._push([t0])
            if cfg.max_new_tokens == 1:
                handle._finish(FINISHED)
                return
            # phase 2: ship the prompt's finished pages, decode the
            # remaining budget against the warm prefix. Past the
            # integrity-failure budget the wire is suspect: skip the
            # ship and decode on the prefill replica itself (its pages
            # never travelled, so correctness is untouched — only the
            # disaggregation win is given up)
            salt = (str(cfg.adapter).encode()
                    if getattr(cfg, "adapter", None) else b"")
            emitted = [t0]
            target = self.decode
            if self.integrity_rejects >= self.max_integrity_failures:
                target = self.prefill
            else:
                try:
                    self.ship(ids, salt=salt)
                except KVIntegrityError:
                    # both the ship and its one re-ship arrived
                    # corrupt — decode locally, nothing installed
                    target = self.prefill
            failovers = 0
            while True:
                kw = dict(vars(cfg))
                kw["max_new_tokens"] = cfg.max_new_tokens - \
                    len(emitted)
                try:
                    h2 = target.submit(ids + emitted,
                                       GenerationConfig(**kw),
                                       timeout_s=timeout_s)
                    for tok in h2.stream(
                            timeout=target.stream_timeout_s):
                        emitted.append(int(tok))
                        handle._push([int(tok)])
                except (RequestFailed, RequestRejected, RuntimeError,
                        TimeoutError) as e:
                    failovers += 1
                    self.failovers += 1
                    if failovers > self.max_failovers:
                        raise
                    # decode replica died mid-stream: replay the
                    # emitted prefix on the prefill replica, whose
                    # pages never left
                    target = self.prefill
                    continue
                handle._finish(FINISHED)
                return
        except BaseException as e:  # noqa: BLE001 - client must not hang
            if not handle.done:
                handle._finish(FAILED, e)


# ---------------------------------------------------------------------------
# the replica process entrypoint
# ---------------------------------------------------------------------------
def _build_server(ns):
    """One seeded Server from the CLI: deterministic init, so every
    replica spawned with the same knobs holds bitwise-identical weights
    (the property greedy failover parity and the disaggregated stream bar
    both ride on). Builds on ``--device`` (``cuda`` unless told ``cpu``;
    without CUDA the model's construction raises)."""
    from ..inference.generation import PagedContinuousBatchingEngine
    from ..models import LlamaForCausalLM, llama_config
    from .scheduler import Server

    dev = torch.device(ns.device)
    cfg = llama_config(ns.preset, num_hidden_layers=ns.layers,
                       dtype=ns.dtype)
    model = LlamaForCausalLM(
        cfg, device=ns.device,
        generator=torch.Generator(dev).manual_seed(ns.model_seed))
    eng = PagedContinuousBatchingEngine(
        model, max_batch=ns.max_batch, num_pages=ns.num_pages,
        page_size=ns.page_size, max_pages=ns.max_pages,
        prefill_chunk=ns.prefill_chunk,
        prefix_cache=(ns.prefix_cache == "on"),
        kv_dtype=ns.kv_dtype,
        lora_capacity=ns.adapters)
    slo_policy = None
    if ns.slo_ttft is not None or ns.slo_tpot is not None:
        from ..monitor.slo import SLOPolicy

        slo_policy = SLOPolicy(ttft_p99_s=ns.slo_ttft,
                               tpot_p99_s=ns.slo_tpot)
    srv = Server(eng, max_queue=ns.max_queue,
                 segment_steps=ns.segment_steps,
                 warmup=(ns.warmup == "on"),
                 slo_policy=slo_policy)
    return srv


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.serving.remote",
        description="one out-of-process replica: build a seeded Server, "
                    "serve HTTP, print the bound port")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="0 = ephemeral (the ready marker names it)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--preset", default="tiny")
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "bfloat16", "float16"))
    p.add_argument("--model-seed", type=int, default=0)
    p.add_argument("--max-batch", type=int, default=2)
    p.add_argument("--num-pages", type=int, default=64)
    p.add_argument("--page-size", type=int, default=8)
    p.add_argument("--max-pages", type=int, default=16)
    p.add_argument("--prefill-chunk", type=int, default=None)
    p.add_argument("--prefix-cache", choices=("on", "off"),
                   default="on")
    p.add_argument("--kv-dtype", default="bf16",
                   choices=("bf16", "int8"))
    p.add_argument("--adapters", type=int, default=0)
    p.add_argument("--max-queue", type=int, default=64)
    p.add_argument("--segment-steps", type=int, default=4)
    p.add_argument("--warmup", choices=("on", "off"), default="off")
    p.add_argument("--slo-ttft", type=float, default=None)
    p.add_argument("--slo-tpot", type=float, default=None)
    ns = p.parse_args(argv)

    from .http import serve_http

    srv = _build_server(ns)
    srv.wait_ready()
    httpd = serve_http(srv, addr=ns.host, port=ns.port)
    port = httpd.server_address[1]
    # the ready marker the parent's spawn_replica() waits for — keep
    # it the LAST startup line and flush: the parent reads stdout
    # line-buffered
    print(f"{_READY_MARKER}{port}", flush=True)

    stop = threading.Event()

    def _term(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    while not stop.wait(0.2):
        pass
    httpd.shutdown()
    srv.shutdown(drain=False, timeout=10.0)
    try:
        srv.engine.close()
    except Exception:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
