"""Stdlib HTTP front-end for :class:`~paddle_tpu_torch.serving.Server`.

Port of ``paddle_tpu/serving/http.py``, stdlib-only (``http.server``,
imported when :func:`serve_http` is called), with the reference's routes,
body fields and status codes:

- ``POST /generate`` — JSON body::

      {"prompt": [1, 2, 3],          # token ids (required)
       "max_new_tokens": 64, "temperature": 1.0, "top_k": 0,
       "top_p": 1.0, "do_sample": false, "eos_token_id": null,
       "seed": 0,                     # GenerationConfig fields
       "speculative": false, "draft_k": null,  # spec-decode opt-in
       "adapter": null,               # LoRA fine-tune (null = base)
       "tenant": null,                # quota bucket (default: adapter)
       "priority": 0, "timeout_s": null,   # admission deadline
       "stream": false,
       "idem_key": null, "from_token": 0}  # exactly-once retry / resume

  Bodies are STRICT: an unknown field is a 400 naming it — a typo'd
  ``adaptor`` must not silently serve base-model output. A request naming
  an adapter the engine does not hold fails at admission (a 500 with the
  cause).

  Non-streaming: one JSON response
  ``{"request_id", "tokens", "n_tokens", "ttft_s"}``.
  Streaming (``"stream": true``): chunked ``application/x-ndjson`` —
  one ``{"token": id}`` line per generated token AS IT ARRIVES (tokens
  reach the client segment by segment, long before completion), then a
  final ``{"done": true, "status": ..., "n_tokens": ...}`` line.

  Status codes are the backpressure contract: 400 malformed request
  (GenerationConfig validation / prompt that can never fit), 429 queue
  full OR tenant shed by the overload control plane — both with
  ``Retry-After`` (queue-depth-derived when full; the burn window's
  remaining life when shed — the body's ``retry_after_s`` float keeps
  the precision the integer header rounds up) — 503
  draining/degraded/shutdown, 504 admission deadline expired. A FAILED
  server (scheduler died) and a DEGRADED one (stalled step,
  mid-recovery) both reject immediately with 503 and a machine-readable
  ``reason`` (``shutdown``/``degraded``).

  ``idem_key`` makes a retried POST attach to the request this front
  already holds (live, or finished within ``idem_ttl_s``) instead of
  admitting it twice; a stream whose client tore away keeps decoding for
  ``resume_grace_s``, and a POST with the same key and ``from_token=n``
  resumes it from token n (409 when the key is unknown).

- ``GET /healthz`` — the server's ``load()`` snapshot, verbatim (ONE
  lock-light host-side read): ``{"status": "warming"|"ok"|"degraded"
  |"draining"|"failed"|"stopped", "healthy", "queue_depth",
  "free_slots", "active_requests", "active_slots", "max_batch",
  "restarts"[, "free_pages", "total_pages", "occupancy", "kv_dtype",
  "pressure"][, "lora"][, "slo"][, "control"][, "flight_dump"], "wire"}``.
  The
  HTTP code follows ``healthy``: 200 for "ok"/"draining", 503 otherwise
  ("warming" with a Retry-After).

- ``GET /metrics`` / ``GET /metrics.json`` — the monitor package's
  Prometheus / JSON exporters, the same payloads as
  ``monitor.start_http_server``.

- ``GET /stats`` — the SLO/goodput rollup
  (``paddle_tpu_torch.monitor.slo``): per-tenant goodput + fast/slow
  burn rates + token/KV-page-second cost, and per-(metric, tenant)
  latency percentiles with an exact all-tenant ``"*"`` aggregate;
  ``?shard=1`` returns the raw digest shard (``SLOTracker.digests_dict()``)
  that a fleet rollup merges. Render with ``tools/monitor_report.py --slo``.

- ``GET /trace?rid=N`` — one request's ordered lifecycle timeline
  (``paddle_tpu_torch.tracing``; ``rid`` is the public ``request_id`` the
  ``/generate`` response carried). Without ``rid`` returns the newest
  buffered events (bounded). 404 with a reason while
  ``FLAGS_enable_trace`` is off.

- ``POST /adapters/load`` / ``POST /adapters/unload`` — multi-tenant LoRA
  admin (an engine built with ``lora_capacity``): hot load (inline
  ``weights`` ``{target: {"a": [[...]], "b": [[...]]}}`` or an npz
  ``path`` with ``<target>.a`` / ``<target>.b`` arrays, optional
  ``alpha``) and unload (``{"name"}``), applied by the scheduler thread in
  the inter-segment gap; an unload while live requests decode under the
  adapter DEFERS (``"deferred": true``). 400 for validation errors and on
  an engine without ``lora_capacity``; 503 while the server cannot apply
  them. The registry snapshot rides ``/healthz`` under ``lora``.

- ``POST /kv/export`` / ``POST /kv/import`` — the KV-page handoff between
  replicas (disaggregated prefill/decode; a paged engine with
  ``prefix_cache=True``). Export takes ``{"tokens": [...][, "salt":
  "<hex>"]}`` and returns the resident full-block pages covering the
  prompt's longest cached prefix as a framed octet-stream (a length-prefixed
  JSON header with the chain hashes, parents, tokens, dtype and geometry,
  then the raw page bytes; int8 rows ship with their per-page scales).
  Import takes the same framing (at most ``MAX_KV_BODY_BYTES``, else 413)
  and installs the pages into the pool and prefix index, chain-hash
  verified and idempotent on replay. Both apply on the scheduler thread in
  the inter-segment gap. 400 for validation errors (and with ``"reason":
  "integrity"`` for a checksum mismatch), 503 while the scheduler cannot
  apply them.

- ``GET /profile``: the program ledger's roofline table
  (``monitor.ledger``): a ``Server`` serves its engine's shard, a
  ``Router`` the exact merge of its replicas' shards. Empty ``programs``
  (not a 404) while ``FLAGS_enable_ledger`` is off. Render it with
  ``tools/monitor_report.py --profile``.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Optional

from .. import monitor
from .. import tracing as trace
from ..inference.generation import GenerationConfig
from .queue import (DeadlineExpired, RequestCancelled, RequestFailed,
                    RequestRejected)

__all__ = ["serve_http"]

_CFG_FIELDS = ("max_new_tokens", "temperature", "top_k", "top_p",
               "do_sample", "eos_token_id", "seed", "speculative",
               "draft_k", "adapter")

# every field a /generate body may carry. Unknown fields are a 400
# NAMING the field, not silently ignored: a typo'd "adaptor" quietly
# serving BASE-model output to a fine-tune's customer is the silent
# failure multi-tenant serving cannot afford
_KNOWN_FIELDS = (frozenset(_CFG_FIELDS)
                 | {"prompt", "priority", "timeout_s", "stream", "tenant",
                    "idem_key", "from_token"})

# a /generate body is token ids + a dozen scalars; 8 MB is orders of
# magnitude above any real request, and an unbounded Content-Length
# would let one request buffer arbitrary bytes into the process that
# holds the model and KV pool
MAX_BODY_BYTES = 8 << 20

# a /kv/import body carries real page bytes (layers x pages x rows);
# still bounded — an unbounded Content-Length must not let a peer
# buffer arbitrary bytes into the serving process
MAX_KV_BODY_BYTES = 256 << 20
# a refused /kv/import body up to this many times the cap is read and
# dropped before the 413, so the shipper sees the status, not a reset
_KV_DRAIN_FACTOR = 4


def _parse_request(body: dict):
    unknown = sorted(k for k in body if k not in _KNOWN_FIELDS)
    if unknown:
        raise ValueError(
            f"unknown request field {unknown[0]!r} (allowed: "
            f"{', '.join(sorted(_KNOWN_FIELDS))})")
    prompt = body.get("prompt")
    if (not isinstance(prompt, list) or not prompt
            or not all(isinstance(t, int) and not isinstance(t, bool)
                       and 0 <= t < 2**31 for t in prompt)):
        raise ValueError(
            "'prompt' must be a non-empty list of int32 token ids")
    cfg_kw = {k: body[k] for k in _CFG_FIELDS if k in body}
    try:
        cfg = GenerationConfig(**cfg_kw)
    except ValueError:
        raise
    except Exception as e:   # e.g. TypeError from a null/list field
        raise ValueError(f"bad GenerationConfig field: {e}") from e
    priority = body.get("priority", 0)
    if not isinstance(priority, int) or isinstance(priority, bool):
        raise ValueError(f"'priority' must be an int, got {priority!r}")
    timeout_s = body.get("timeout_s")
    if timeout_s is not None and (
            isinstance(timeout_s, bool)
            or not isinstance(timeout_s, (int, float))
            or not timeout_s > 0):
        raise ValueError(
            f"'timeout_s' must be a positive number or null, got "
            f"{timeout_s!r}")
    tenant = body.get("tenant")
    if tenant is not None and (not isinstance(tenant, str)
                               or not tenant):
        raise ValueError(
            f"'tenant' must be a non-empty string or null, got "
            f"{tenant!r}")
    stream = body.get("stream", False)
    if not isinstance(stream, bool):
        # the same silent-failure class as the typo'd "adaptor":
        # bool("false") is True, so a client sending the STRING
        # "false" would silently get a streamed response it cannot
        # parse — name the type error instead of coercing
        raise ValueError(
            f"'stream' must be a boolean, got {stream!r}")
    idem_key = body.get("idem_key")
    if idem_key is not None and (not isinstance(idem_key, str)
                                 or not idem_key):
        raise ValueError(
            f"'idem_key' must be a non-empty string or null, got "
            f"{idem_key!r}")
    from_token = body.get("from_token", 0)
    if (not isinstance(from_token, int) or isinstance(from_token, bool)
            or from_token < 0):
        raise ValueError(
            f"'from_token' must be a non-negative int, got "
            f"{from_token!r}")
    return (prompt, cfg, priority, timeout_s, stream, tenant,
            idem_key, from_token)


def _adapter_weights(body: dict) -> dict:
    """A ``/adapters/load`` body as the registry's params ``{target: (A,
    B)}``: inline ``weights`` (nested lists) or an npz file ``path`` with
    ``<target>.a`` / ``<target>.b`` arrays."""
    import numpy as np

    weights = body.get("weights")
    path = body.get("path")
    if (weights is None) == (path is None):
        raise ValueError(
            "exactly one of 'weights' (inline) or 'path' (npz file) "
            "is required")
    if path is not None:
        if not isinstance(path, str):
            raise ValueError(f"'path' must be a string, got {path!r}")
        out = {}
        with np.load(path) as data:
            for key in data.files:
                t, _, kind = key.rpartition(".")
                if kind not in ("a", "A", "b", "B") or not t:
                    raise ValueError(
                        f"npz key {key!r} is not '<target>.a'/'<target>.b'")
                out.setdefault(t, [None, None])[
                    0 if kind in ("a", "A") else 1] = data[key]
        bad = [t for t, ab in out.items() if ab[0] is None or ab[1] is None]
        if bad:
            raise ValueError(
                f"npz missing the a or b half for target(s) {bad}")
        return {t: (a, b) for t, (a, b) in out.items()}
    if not isinstance(weights, dict) or not weights:
        raise ValueError(
            "'weights' must be a non-empty object "
            "{target: {'a': [[...]], 'b': [[...]]}}")
    out = {}
    for t, ab in weights.items():
        if not isinstance(ab, dict) or "a" not in ab or "b" not in ab:
            raise ValueError(
                f"weights[{t!r}] must be an object with 'a' and 'b' "
                "factor arrays")
        extra = sorted(k for k in ab if k not in ("a", "b"))
        if extra:
            raise ValueError(
                f"weights[{t!r}] has unknown key {extra[0]!r} "
                "(allowed: a, b)")
        out[t] = (np.asarray(ab["a"], np.float32),
                  np.asarray(ab["b"], np.float32))
    return out


def serve_http(server, port: int = 0, addr: str = "127.0.0.1",
               idem_ttl_s: float = 30.0, resume_grace_s: float = 2.0):
    """Serve ``server`` over HTTP on a daemon thread; returns the
    ``ThreadingHTTPServer`` (bound port: ``httpd.server_address[1]``;
    ``port=0`` picks a free one). Stop with ``httpd.shutdown()``.

    ``idem_ttl_s`` bounds the idempotency dedup window: a retried
    ambiguous ``/generate`` POST carrying the same ``idem_key``
    attaches to the live request (or its cached terminal result)
    instead of admitting twice; terminal entries are pruned this many
    seconds after finishing. ``resume_grace_s`` is how long a stream
    whose client tore away keeps DECODING before the slot is
    reclaimed — the window a mid-stream resume (same ``idem_key`` +
    ``from_token``) must land in to keep warm KV and skip
    re-prefill."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    import numpy as np

    # the exactly-once window: idem_key -> {"handle", "orphaned_at"}.
    # Closure-scoped (one window per front, like the Handler class
    # itself); all access under idem_lock. ``orphaned_at`` non-None
    # means the streaming client tore away and the request is decoding
    # unattended — resumable until the grace expires, cancelled after.
    idem_lock = threading.Lock()
    idem_window = {}
    wire_stats = {"idem_attaches": 0, "integrity_rejects": 0,
                  "resume_misses": 0}

    def _prune_idem(now: float) -> None:
        expired = []
        with idem_lock:
            for key in list(idem_window):
                ent = idem_window[key]
                h = ent["handle"]
                if h.done:
                    fin = getattr(h, "finish_ts", None)
                    if fin is None or now - fin > idem_ttl_s:
                        del idem_window[key]
                elif (ent["orphaned_at"] is not None
                        and now - ent["orphaned_at"] > resume_grace_s):
                    # no resume came: stop burning the slot
                    del idem_window[key]
                    expired.append(h)
        for h in expired:                 # cancel outside the lock
            h.cancel()

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        # -- helpers ---------------------------------------------------------
        def _json(self, code: int, obj: dict,
                  headers: Optional[dict] = None) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _chunk(self, data: bytes) -> None:
            self.wfile.write(f"{len(data):X}\r\n".encode())
            self.wfile.write(data)
            self.wfile.write(b"\r\n")
            self.wfile.flush()

        def _discard(self, n: int) -> None:
            while n > 0:
                piece = self.rfile.read(min(n, 1 << 20))
                if not piece:
                    return
                n -= len(piece)

        # -- routes ----------------------------------------------------------
        def do_GET(self):
            if self.path.startswith("/healthz"):
                # ONE host-side snapshot: ``load()`` carries status,
                # queue depth, slot/page capacity, the KV-pressure
                # block and the newest flight-recorder dump path. The
                # ``healthy`` verdict inside it decides 200 vs 503
                # (status ok/draining).
                body = server.load()
                healthy = body.get(
                    "healthy", body.get("status") in ("ok", "draining"))
                body["wire"] = dict(wire_stats)
                hdrs = None
                if not healthy and body.get("status") == "warming":
                    # Retry-After parity: warmup is bounded (segment
                    # sweep), so tell the client when to come back
                    # instead of letting it hammer the 503
                    body["retry_after_s"] = 1.0
                    hdrs = {"Retry-After": "1"}
                self._json(200 if healthy else 503, body,
                           headers=hdrs)
            elif self.path.startswith("/stats"):
                # SLO/goodput rollup (monitor.slo): a Server serves
                # its own tracker, in the reference fleet Router's
                # shape (tools/monitor_report.py --slo).
                # ``?shard=1`` instead returns the RAW digest shard
                # (``SLOTracker.digests_dict()``, to_dict-serialized
                # buckets and all): what a remote harvester feeds to
                # ``fleet_rollup`` — merging pre-rolled percentiles
                # would average, and fleet percentiles must merge.
                from urllib.parse import parse_qs, urlsplit

                q = parse_qs(urlsplit(self.path).query)
                if q.get("shard", ["0"])[0] not in ("0", ""):
                    slo = getattr(server, "slo", None)
                    if slo is None:
                        self._json(404, {
                            "error": "no digest shard: this front "
                                     "exposes no SLO tracker"})
                    else:
                        self._json(200, slo.digests_dict())
                    return
                fn = getattr(server, "stats", None)
                if fn is None:
                    self._json(404, {
                        "error": "no /stats: this front exposes no "
                                 "SLO tracker"})
                else:
                    self._json(200, fn())
            elif self.path.startswith("/profile"):
                # the program ledger's roofline table: a Server serves its
                # engine's shard, a Router merges every replica's shard
                # exactly; empty "programs" (not a 404) while
                # FLAGS_enable_ledger is off
                fn = getattr(server, "profile", None)
                if fn is None:
                    self._json(404, {
                        "error": "no /profile: this front exposes no "
                                 "program ledger"})
                else:
                    self._json(200, fn())
            elif self.path.startswith("/trace"):
                self._trace_response()
            elif (payload := monitor.http_payload(self.path)) is not None:
                body, ctype = payload
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def _trace_response(self) -> None:
            from urllib.parse import parse_qs, urlsplit

            if not trace.enabled():
                self._json(404, {
                    "error": "tracing disabled — enable with "
                             "FLAGS_enable_trace=1 / "
                             "paddle_tpu_torch.tracing.enable()"})
                return
            q = parse_qs(urlsplit(self.path).query)
            rid = q.get("rid", [None])[0]
            if rid is None:
                evs = trace.events(limit=256)
                self._json(200, {"events": evs, "n": len(evs)})
                return
            try:
                rid_i = int(rid)
            except ValueError:
                self._json(400, {"error": f"rid must be an int "
                                          f"request id, got {rid!r}"})
                return
            self._json(200, {
                "request_id": rid_i,
                "events": server.request_timeline(rid_i)})

        def _read_body(self):
            """Bounded JSON body read shared by the POST routes;
            returns the dict or None after replying with the error."""
            n = int(self.headers.get("Content-Length", 0))
            if n < 0:
                # rfile.read(-1) would block until the client closes
                # the socket, pinning a handler thread
                self.close_connection = True
                self._json(400, {"error": "negative Content-Length"},
                           headers={"Connection": "close"})
                return None
            if n > MAX_BODY_BYTES:
                self.close_connection = True
                self._json(413, {"error":
                                 f"body exceeds {MAX_BODY_BYTES} "
                                 "bytes"},
                           headers={"Connection": "close"})
                return None
            body = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
            return body

        def do_POST(self):
            if self.path.startswith("/adapters/"):
                self._adapters_response()
                return
            if self.path.startswith("/kv/"):
                self._kv_response()
                return
            if not self.path.startswith("/generate"):
                # body NOT consumed: drop the connection after replying
                # or keep-alive would parse the body as the next request
                self.close_connection = True
                self._json(404, {"error": f"no route {self.path}"},
                           headers={"Connection": "close"})
                return
            try:
                body = self._read_body()
                if body is None:
                    return
                (prompt, cfg, priority, timeout_s, stream, tenant,
                 idem_key, from_token) = _parse_request(body)
            except (ValueError, TypeError, json.JSONDecodeError) as e:
                self._json(400, {"error": str(e)})
                return
            _prune_idem(time.monotonic())
            if idem_key is not None:
                with idem_lock:
                    ent = idem_window.get(idem_key)
                    if ent is not None:
                        ent["orphaned_at"] = None   # reattached
                if ent is not None:
                    # the exactly-once attach: this POST is a retry of
                    # a request this server ALREADY holds (live or
                    # terminal within the TTL) — no second admission,
                    # no second slot/pages, no double SLO/quota count.
                    # The response carries the SAME request_id, which
                    # is how clients (and the dedup regression test)
                    # prove single admission.
                    wire_stats["idem_attaches"] += 1
                    handle = ent["handle"]
                    if trace.enabled():
                        trace.event("idem.attach", rid=handle.id,
                                    from_token=from_token,
                                    live=not handle.done)
                    if stream:
                        self._stream_response(handle, skip=from_token,
                                              idem=idem_key)
                    else:
                        self._block_response(handle)
                    return
                if from_token > 0:
                    # a resume aimed at a request we no longer (or
                    # never) held — refuse loudly so the client falls
                    # back to the failover replay, never a silent
                    # fresh decode that would double-emit tokens
                    wire_stats["resume_misses"] += 1
                    self._json(409, {"error": "unknown idem_key for "
                                              "mid-stream resume",
                                     "reason": "resume_miss"})
                    return
            try:
                handle = server.submit(
                    np.asarray(prompt, np.int32), cfg,
                    priority=priority, timeout_s=timeout_s,
                    **({"tenant": tenant} if tenant is not None
                       else {}))
            except RequestRejected as e:
                if e.reason in ("queue_full", "shed"):
                    # both are 429 backpressure, with honest hints:
                    # a SHED tenant's Retry-After is its burn window's
                    # remaining life (retrying sooner just re-rejects);
                    # a full queue's is depth-derived (deeper backlog
                    # -> back off longer). The body carries the float
                    # (retry_after_s) so programmatic clients — and
                    # RemoteReplica, which re-raises with it — keep
                    # the precision the integer header rounds away.
                    ra = e.retry_after_s
                    if ra is None:   # queue_full: scale with backlog
                        try:
                            depth = server.queue.depth
                        except Exception:
                            depth = 0
                        ra = 1.0 + depth / 8.0
                    ra = max(0.0, float(ra))
                    self._json(429, {"error": str(e),
                                     "reason": e.reason,
                                     "retry_after_s": round(ra, 3)},
                               headers={"Retry-After":
                                        str(max(1, int(-(-ra // 1))))})
                else:   # draining / degraded / shutdown (failed server)
                    # Retry-After parity with the 429 paths: a DRAINING
                    # server knows its drain ETA and says so — the same
                    # honest hint, float body field + integer header
                    out = {"error": str(e), "reason": e.reason}
                    hdrs = None
                    if e.retry_after_s is not None:
                        ra = max(0.0, float(e.retry_after_s))
                        out["retry_after_s"] = round(ra, 3)
                        hdrs = {"Retry-After":
                                str(max(1, int(-(-ra // 1))))}
                    self._json(503, out, headers=hdrs)
                return
            except ValueError as e:   # can never fit the engine
                self._json(400, {"error": str(e)})
                return
            if idem_key is not None:
                with idem_lock:
                    idem_window[idem_key] = {"handle": handle,
                                             "orphaned_at": None}
            if stream:
                self._stream_response(handle, idem=idem_key)
            else:
                self._block_response(handle)

        def _kv_response(self) -> None:
            """Disaggregated prefill/decode page handoff: ``POST
            /kv/export`` ``{"tokens": [...][, "salt": "<hex>"]}``
            returns the resident full-block pages covering the prompt
            as a framed octet-stream (JSON header + raw page bytes —
            ``serving.remote.encode_kv_payload``); ``POST /kv/import``
            takes the same framing back and installs the pages into
            this server's pool + prefix index (chain-hash verified,
            idempotent on replay). Both apply on the scheduler thread
            in the inter-segment gap — a replay may be writing the pools
            on that thread's stream, so no handler thread reads them. 400
            for validation errors (strict bodies, geometry/dtype
            mismatch, corrupt chain hash), 503 while the scheduler
            cannot apply them."""
            op = self.path[len("/kv/"):].split("?", 1)[0]
            if op not in ("export", "import"):
                self.close_connection = True
                self._json(404, {"error": f"no route {self.path}"},
                           headers={"Connection": "close"})
                return
            if (getattr(server, "export_kv", None) is None
                    or not getattr(getattr(server, "engine", None),
                                   "prefix_cache", False)):
                # permanently unsupported here (a Router front, or an
                # engine without the paged prefix cache) — a 400, not
                # a retryable 503
                self.close_connection = True
                self._json(400, {"error": "this endpoint fronts no "
                                          "KV-handoff-capable Server "
                                          "(needs a paged engine with "
                                          "prefix_cache=True)"},
                           headers={"Connection": "close"})
                return
            from .remote import (KVIntegrityError, decode_kv_payload,
                                 encode_kv_payload)
            try:
                if op == "export":
                    body = self._read_body()
                    if body is None:
                        return
                    # strict like /generate: a typo'd "token" must not
                    # silently export an empty prefix
                    allowed = {"tokens", "salt"}
                    unknown = sorted(k for k in body
                                     if k not in allowed)
                    if unknown:
                        raise ValueError(
                            f"unknown field {unknown[0]!r} (allowed: "
                            f"{', '.join(sorted(allowed))})")
                    tokens = body.get("tokens")
                    if (not isinstance(tokens, list) or not tokens
                            or not all(isinstance(t, int)
                                       and not isinstance(t, bool)
                                       and 0 <= t < 2**31
                                       for t in tokens)):
                        raise ValueError(
                            "'tokens' must be a non-empty list of "
                            "int32 token ids")
                    salt = body.get("salt", "")
                    if not isinstance(salt, str):
                        raise ValueError(
                            f"'salt' must be a hex string, got "
                            f"{salt!r}")
                    payload = server.export_kv(
                        np.asarray(tokens, np.int32),
                        salt=bytes.fromhex(salt))
                    raw = encode_kv_payload(payload)
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/octet-stream")
                    self.send_header("Content-Length", str(len(raw)))
                    self.end_headers()
                    self.wfile.write(raw)
                    return
                n = int(self.headers.get("Content-Length", 0))
                if n <= 0 or n > MAX_KV_BODY_BYTES:
                    self.close_connection = True
                    if n <= _KV_DRAIN_FACTOR * MAX_KV_BODY_BYTES:
                        # read the refused body off the socket (in small
                        # pieces, kept nowhere) before answering: a peer
                        # still sending when the socket closes unread gets
                        # a reset instead of the 413
                        self._discard(n)
                    self._json(
                        400 if n <= 0 else 413,
                        {"error": ("missing/empty body"
                                   if n <= 0 else
                                   f"body exceeds {MAX_KV_BODY_BYTES}"
                                   f" bytes")},
                        headers={"Connection": "close"})
                    return
                out = server.import_kv(
                    decode_kv_payload(self.rfile.read(n)))
            except KVIntegrityError as e:
                # checksum mismatch: the decode raised BEFORE
                # ``import_kv`` ran, so nothing installed — typed so
                # the shipper can count it and re-ship (idempotent)
                wire_stats["integrity_rejects"] += 1
                if trace.enabled():
                    trace.event("kv.integrity_reject", error=str(e))
                self._json(400, {"error": str(e),
                                 "reason": "integrity"})
                return
            except (ValueError, TypeError,
                    json.JSONDecodeError) as e:
                self._json(400, {"error": str(e)})
                return
            except (TimeoutError, RequestRejected,
                    RuntimeError) as e:
                # transient: the scheduler could not apply it right
                # now (wedged / shutting down)
                self._json(503, {"error": str(e)})
                return
            self._json(200, out)

        def _adapters_response(self) -> None:
            """The multi-tenant LoRA admin surface: ``POST /adapters/load``
            ``{"name", "weights" | "path"[, "alpha"]}`` and ``POST
            /adapters/unload`` ``{"name"}``, applied by the scheduler thread
            in the inter-segment gap; 400 for validation errors (an unknown
            target, a rank over the bank's, a duplicate name, a full
            registry) and on an engine without ``lora_capacity``, 503 while
            the server cannot apply them."""
            op = self.path[len("/adapters/"):].split("?", 1)[0]
            if op not in ("load", "unload"):
                self.close_connection = True
                self._json(404, {"error": f"no route {self.path}"},
                           headers={"Connection": "close"})
                return
            if (getattr(server, "load_adapter", None) is None
                    or getattr(getattr(server, "engine", None),
                               "adapters", None) is None):
                # permanently unsupported here: a 400, not a retryable 503
                self.close_connection = True
                self._json(400, {"error": "this endpoint fronts no "
                                          "adapter-capable Server "
                                          "(engine needs "
                                          "lora_capacity > 0)"},
                           headers={"Connection": "close"})
                return
            try:
                body = self._read_body()
                if body is None:
                    return
                # admin bodies are STRICT like /generate: a typo'd "aplha"
                # silently installing scale-1.0 deltas is the same silent
                # failure as the typo'd "adaptor"
                allowed = ({"name"} if op == "unload"
                           else {"name", "weights", "path", "alpha"})
                unknown = sorted(k for k in body if k not in allowed)
                if unknown:
                    raise ValueError(
                        f"unknown field {unknown[0]!r} (allowed: "
                        f"{', '.join(sorted(allowed))})")
                name = body.get("name")
                if not isinstance(name, str) or not name:
                    raise ValueError("'name' must be a non-empty string")
                if op == "unload":
                    freed = server.unload_adapter(name)
                    out = {"name": name, "unloaded": bool(freed),
                           "deferred": not freed}
                else:
                    params = _adapter_weights(body)
                    idx = server.load_adapter(name, params,
                                              alpha=body.get("alpha"))
                    out = {"name": name, "index": idx}
            except (TimeoutError, RequestRejected, RuntimeError) as e:
                # transient: the scheduler could not apply it now (wedged,
                # shutting down)
                self._json(503, {"error": str(e)})
                return
            except (ValueError, TypeError, OSError) as e:
                # OSError: an npz path that cannot be read
                self._json(400, {"error": str(e)})
                return
            out["adapters"] = server.engine.adapters.resident()
            self._json(200, out)

        def _block_response(self, handle) -> None:
            try:
                toks = handle.result()
            except DeadlineExpired as e:
                self._json(504, {"error": str(e), "request_id": handle.id})
                return
            except (RequestCancelled, RequestFailed) as e:
                self._json(500, {"error": str(e), "request_id": handle.id})
                return
            ttft = (None if handle.first_token_ts is None
                    else handle.first_token_ts - handle.submit_ts)
            self._json(200, {"request_id": handle.id,
                             "tokens": [int(t) for t in toks],
                             "n_tokens": len(toks), "ttft_s": ttft})

        def _stream_response(self, handle, skip: int = 0,
                             idem: Optional[str] = None) -> None:
            # the status line is deferred until the FIRST token (or a
            # terminal state) exists: a request that expires or fails
            # before emitting anything still gets its real 504/500,
            # not a 200 that then apologizes in the trailer
            it = handle.stream()
            first = None
            try:
                # a mid-stream resume already delivered the first
                # ``skip`` tokens on the torn connection: replay only
                # the tail (the handle's stream is re-iterable from 0
                # by design — each consumer keeps its own cursor)
                for _ in range(skip):
                    next(it)
                first = next(it)
            except StopIteration:
                pass              # zero-token terminal (e.g. cancelled)
            except DeadlineExpired as e:
                self._json(504, {"error": str(e),
                                 "request_id": handle.id})
                return
            except RequestFailed as e:
                self._json(500, {"error": str(e),
                                 "request_id": handle.id})
                return
            n = 0
            status = "finished"
            try:
                # header writes sit INSIDE the broken-pipe guard: a
                # client that disconnected while waiting for its first
                # token must trigger the cancel below, not strand a
                # decoding slot behind an unhandled socket error
                self.send_response(200)
                self.send_header("Content-Type",
                                 "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                if first is not None:
                    self._chunk(json.dumps({"token": int(first)})
                                .encode() + b"\n")
                    n += 1
                    for tok in it:
                        self._chunk(json.dumps({"token": int(tok)})
                                    .encode() + b"\n")
                        n += 1
                if handle.status == "cancelled":
                    status = "cancelled"
            except DeadlineExpired:
                status = "expired"
            except RequestFailed as e:
                status = f"failed: {e}"
            except (BrokenPipeError, ConnectionResetError):
                # client went away mid-stream. With an idem key the
                # request keeps DECODING for the resume grace period —
                # warm KV intact, so a reconnect replays only the tail;
                # the pruner cancels it if no resume comes. Without a
                # key: reclaim the slot immediately, as before.
                if idem is not None:
                    with idem_lock:
                        ent = idem_window.get(idem)
                        if ent is not None and not handle.done:
                            ent["orphaned_at"] = time.monotonic()
                            return
                handle.cancel()
                return
            try:
                self._chunk(json.dumps(
                    {"done": True, "status": status, "n_tokens": n,
                     "request_id": handle.id}).encode() + b"\n")
                self.wfile.write(b"0\r\n\r\n")
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                pass

        def log_message(self, *args):   # no access-log spam on stderr
            pass

    httpd = ThreadingHTTPServer((addr, port), Handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True,
                         name="paddle_tpu-serving-http")
    t.start()
    return httpd
