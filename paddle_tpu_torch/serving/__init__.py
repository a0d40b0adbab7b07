"""paddle_tpu_torch.serving: the online continuous-batching serving layer.

Port of ``paddle_tpu/serving`` over the port's engines. The engines
(:mod:`paddle_tpu_torch.inference.generation`) stop at a stepwise API —
``add_request`` / ``begin_admit`` / ``admit_chunk`` / ``decode_segment`` /
``collect_finished`` — plus a synchronous batch ``serve()``. THIS package
is the layer a client talks to:

- :class:`~paddle_tpu_torch.serving.queue.RequestQueue` — bounded,
  priority- and deadline-aware admission queue (backpressure: a full queue
  rejects with reason, the HTTP 429 path), with priority aging;
- :class:`~paddle_tpu_torch.serving.queue.RequestHandle` — per-request
  blocking ``result()``, incremental token ``stream()`` iterator,
  ``cancel()`` (the slot and its KV pages are reclaimed at the next
  inter-segment gap) and ``timeline()``;
- :class:`~paddle_tpu_torch.serving.scheduler.Server` — the scheduler
  thread that owns an engine: admission in the inter-segment gap through
  the engine's capacity probe, one decode segment (a captured CUDA graph on
  the card) per step, streaming, fault containment and supervised
  recovery, tenant quotas, SLO digests and the overload control plane;
- :func:`~paddle_tpu_torch.serving.http.serve_http` — stdlib HTTP front
  (``POST /generate`` with chunked ndjson streaming, ``GET /healthz``,
  ``/metrics``, ``/metrics.json``, ``/stats``, ``/trace``,
  ``POST /adapters/load`` and ``/adapters/unload``);
- :class:`~paddle_tpu_torch.serving.adapters.AdapterRegistry` — the
  multi-tenant LoRA registry and its device bank (engines built with
  ``lora_capacity > 0``; hot load / unload with deferral, per-load prefix
  namespaces);
- :mod:`~paddle_tpu_torch.serving.control` — the overload control plane
  (:class:`ControlPolicy`, :class:`ControlPlane`,
  :class:`ElasticController`);
- :class:`~paddle_tpu_torch.serving.router.Router` — the replica fleet:
  N Server-shaped replicas built from :class:`ReplicaSpec` s, least-loaded
  routing with adapter affinity, per-replica circuit breakers, failover
  replay (one stable request id and one stream across replicas), the
  supervisor that rebuilds dead replicas, drain, ``rolling_restart`` and
  elastic sizing;
- :mod:`~paddle_tpu_torch.serving.remote` — replicas in other processes
  (:class:`RemoteReplica`, :class:`RemoteReplicaSpec`, ``remote.spawn_replica``,
  ``python -m paddle_tpu_torch.serving.remote``) and disaggregated
  prefill/decode (:class:`DisaggregatedFront`): finished KV pages ship
  from a prefill replica to a decode replica over ``POST /kv/export`` ->
  ``/kv/import`` (``encode_kv_payload`` / ``decode_kv_payload``,
  chain-hash keyed and integrity checked, :class:`KVIntegrityError`).

Faults are classified by blast radius
(:class:`~paddle_tpu_torch.inference.generation.RequestFault` /
:class:`~paddle_tpu_torch.inference.generation.EngineFault` /
:func:`~paddle_tpu_torch.inference.generation.classify_fault`, re-exported
here); :mod:`paddle_tpu_torch.testing.faults` injects them
deterministically.

Quick start (on the card; ``device="cpu"`` on the model serves on the
CPU)::

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.serving import Server, serve_http

    model = pt.LlamaForCausalLM(pt.llama_config("7b", dtype="bfloat16"))
    eng = pt.PagedContinuousBatchingEngine(model, max_batch=8,
                                           num_pages=512, page_size=16,
                                           max_pages=64, prefill_chunk=256)
    srv = Server(eng, max_queue=64, segment_steps=8, warmup=True)
    httpd = serve_http(srv, port=8000)

    h = srv.submit(prompt_ids, pt.GenerationConfig(max_new_tokens=64))
    for tok in h.stream():
        ...
    httpd.shutdown(); srv.shutdown()
"""
from ..inference.generation import (EngineFault, PagePoolExhausted,
                                    RequestFault, classify_fault)
from ..monitor.slo import SLOPolicy
from .adapters import AdapterRegistry
from .control import (RUNG_ACTIONS, ControlPlane, ControlPolicy,
                      ElasticController)
from .http import serve_http
from .queue import (CANCELLED, EXPIRED, FAILED, FINISHED, QUEUED,
                    RUNNING, DeadlineExpired, QueueFull,
                    RequestCancelled, RequestFailed, RequestHandle,
                    RequestQueue, RequestRejected)
from .remote import (DisaggregatedFront, KVIntegrityError, RemoteReplica,
                     RemoteReplicaSpec, decode_kv_payload, encode_kv_payload)
from .router import (FailoverBudgetExceeded, FleetUnavailable, ReplicaSpec,
                     Router, RouterHandle)
from .scheduler import PreemptionBudgetExceeded, Server

__all__ = [
    "Server", "serve_http", "AdapterRegistry", "RequestHandle",
    "RequestQueue",
    "RequestRejected", "QueueFull", "RequestCancelled",
    "DeadlineExpired", "RequestFailed",
    "RequestFault", "EngineFault", "classify_fault",
    "PagePoolExhausted", "PreemptionBudgetExceeded",
    "Router", "ReplicaSpec", "RouterHandle",
    "RemoteReplica", "RemoteReplicaSpec", "DisaggregatedFront",
    "KVIntegrityError", "encode_kv_payload", "decode_kv_payload",
    "FailoverBudgetExceeded", "FleetUnavailable", "SLOPolicy",
    "ControlPolicy", "ControlPlane", "ElasticController",
    "RUNG_ACTIONS",
    "QUEUED", "RUNNING", "FINISHED", "CANCELLED", "EXPIRED", "FAILED",
]
