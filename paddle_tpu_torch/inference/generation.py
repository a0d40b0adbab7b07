"""Generation and continuous-batching serving over dense and paged KV
caches.

Port of ``paddle_tpu/inference/generation.py``: ``GenerationConfig`` (with
the sampling settings), length-bucketed and chunked prefill, the offline
batch generator ``CausalLMEngine``, and ``ContinuousBatchingEngine`` (dense
``[max_batch, max_len]`` caches, one slot per row) /
``PagedContinuousBatchingEngine`` (a shared page pool with reserved or
optimistic admission, preemption and an automatic prefix cache). The
engines admit requests into free slots between decode
SEGMENTS (one prefill each, its KV put into the slot's cache rows or
pages), decode ``n_steps`` steps over every slot with per-row lengths, and
retire finished rows between segments. With ``prefill_chunk=C`` a request
can also be admitted chunk by chunk across segment gaps
(:meth:`ContinuousBatchingEngine.begin_admit`, ``admit_chunk``,
``abort_admit``), each chunk one fixed-shape prefill at a device offset
(K3's prefix-chunk instance), and ``CausalLMEngine`` prefills prompts
longer than C in chunks.

Sampling (``inference/sampling.py``): each request's temperature, top-k,
top-p, sample flag and seed are per-slot device vectors, so one program
serves any mix of configs; a sampled row draws by a counter hash of its
seed and the token's position, so its tokens do not depend on its
batch-mates. The reference branches inside its compiled segment
(``lax.cond``) to skip the sampling filter for an all-greedy batch; a CUDA
graph cannot branch on a device value, so here the host picks the program:
a segment (and ``generate``'s step) has a greedy graph and a sampled one.

The reference compiles a segment (and ``generate``'s decode loop) into one
``lax.scan`` program and ``warmup()`` compiles it ahead of the requests;
here a segment is a Python loop over steps, captured on the card into one
CUDA graph per segment length (``generate``: one graph per step and batch
size, replayed once per token) by ``inference/_graphs.py``, and
``warmup()`` captures it ahead of the requests. Every tensor a graph reads
or writes is allocated once and updated in place (caches, per-slot
lengths, last tokens, flags, the paged engine's device page table), so
``reset_state()`` resets that storage in place and keeps the graphs.
Tokens, lengths and flags stay on the device and come back to the host once
per segment (once per ``generate``), as in the reference. Bucketed prefill
pads exactly as the reference does, so greedy streams of the two agree.

Serving seams (for ``serving/scheduler.py::Server``): the fault taxonomy
(:class:`RequestFault`, :class:`EngineFault`, :func:`classify_fault`,
:class:`PagePoolExhausted`), the host-side probes ``can_admit``,
``free_slots``, ``load()`` and ``partial_tokens``, and the reference's
monitor series (``paddle_tpu_requests_total``,
``paddle_tpu_generated_tokens_total``, ``paddle_tpu_prefill_requests_total``,
``paddle_tpu_prefill_chunks_total``, ``paddle_tpu_prefill_warmup_seconds``,
``paddle_tpu_kv_admission_seconds``, ``paddle_tpu_decode_tokens_per_sec``,
per engine label ``_monitor_engine``) and trace events (``engine.prefill``,
``engine.segment``), each behind the module's one enabled bool and none
reading the device.

Speculative decoding (lossless n-gram prompt lookup, ``inference/ngram.py``):
``CausalLMEngine.generate_speculative`` offline, and on the continuous
engines a per-slot capability (``draft_k > 0`` and a request's
``speculative`` opt-in): while a live request speculates, a segment runs
verify steps of ``draft_k + 1`` tokens per row (the model's
``forward_decode_spec`` / ``forward_decode_spec_paged``: K7 or K4 once per
window position), in ``spec_mode="host"`` one captured step a verify with
the host's proposers between them (key ``("spec_step", draft_k)``), in
``"device"`` one captured program a segment proposing from per-slot
history rings (key ``("spec_device", n_steps, draft_k, spec_draft)``);
each has a sampled twin, in which a sampled row draws its one token a step.
Every emitted token is the model's own pick; drafts decide only how many a
forward yields. ``spec_stats()`` and the ``paddle_tpu_spec_draft_tokens_total``
series count them.

Multi-tenant LoRA (``lora_capacity > 0`` on the continuous engines): an
:class:`~paddle_tpu_torch.serving.adapters.AdapterRegistry` owns the factor
bank (``[L, K+1, r, d]`` per target projection, index 0 the base model,
allocated once and written in place), and a per-slot adapter-index device
vector picks each row's factors inside every decode, verify and prefill
forward (the model's ``lora`` argument), so one captured program serves any
mix of adapters and a hot ``load_adapter`` / ``unload_adapter`` between
segments captures nothing. A request names its adapter in
``GenerationConfig.adapter``; the paged engine's prefix cache hashes its
blocks in the adapter's namespace (``name@generation``), so KV cached under
one adapter, or an earlier load of the name, never serves another.

The paged engine with ``prefix_cache=True`` also hands KV pages to another
engine (``export_kv_pages`` / ``import_kv_pages``): full prompt blocks travel
as raw pool rows (int8 with their scales) under their chain hashes, and the
importer parks them in its prefix index, so its next admission of the prompt
is a warm hit. Not ported yet: prefill capture, tensor parallelism (A11).
"""
from __future__ import annotations

import heapq
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import monitor
from .. import tracing as trace
from ..monitor import ledger
from ..quantization.kv import KV_DTYPES, KV_SCALE_FLOOR, quant_store_rows
from ._graphs import GraphCache
from .ngram import NgramProposer, propose_device
from .paged_cache import (PageAllocator, _block_hash, _chain_root,
                          copy_page, copy_page_q, gather_pages,
                          gather_pages_q, install_page, install_page_q,
                          scatter_rows, scatter_rows_q)
from .sampling import SlotSampling, sample_rows

__all__ = ["GenerationConfig", "CausalLMEngine", "ContinuousBatchingEngine",
           "PagedContinuousBatchingEngine", "prefill_buckets_for",
           "RequestFault", "EngineFault", "REQUEST_SITES", "classify_fault",
           "PagePoolExhausted", "ADMISSION_MODES", "SPEC_MODES",
           "SPEC_DRAFTS", "NgramProposer"]

_INT32_MAX = 2 ** 31 - 1


# -- fault taxonomy (the serving scheduler's containment contract) ----------
#
# For every exception an engine call raises, the scheduler needs to know
# how much state it poisons:
#
# - REQUEST-scoped: one request's admission went wrong (a prompt the model
#   chokes on, a prefill error). The engine's abort guards already
#   reclaimed the slot and pages, and everyone else's device state is
#   coherent: fail THAT request with its cause, keep serving.
# - ENGINE-scoped: device state is suspect (an error inside a decode
#   segment, which writes every slot's cache). The engine is reset
#   (`reset_state`) and the requests in flight replayed. This covers
#   faults that leave the CUDA context usable; a sticky CUDA error (an
#   illegal address) poisons the context, the reset raises, and the
#   scheduler fails what it holds.
# - FATAL: process-level signals (KeyboardInterrupt/SystemExit) that must
#   never be swallowed by a recovery loop.

class RequestFault(RuntimeError):
    """A fault scoped to ONE request: fail that request with its cause
    and keep serving everyone else (the engine's device state is
    coherent: admission abort guards reclaimed any claimed capacity).
    Raise it from code running single-request work (the admission,
    prefill and chunk seams). At a BATCH-wide seam (a decode segment over
    every slot) there is no single request to pin it on, so a supervisor
    treats it as engine-scoped there."""


class EngineFault(RuntimeError):
    """A fault that poisons the ENGINE's device state (e.g. a device
    error mid decode segment): the supervisor resets the state
    (:meth:`ContinuousBatchingEngine.reset_state`) and replays the
    requests in flight from their prompt + tokens emitted so far."""


# seams where an unclassified exception defaults to request scope: the
# engine was doing single-request work behind an abort guard, so shared
# device state was never touched
REQUEST_SITES = frozenset({"admit", "prefill", "chunk"})

# the paged engine's admission policies (the reference's)
ADMISSION_MODES = ("reserved", "optimistic")

# speculative decoding's execution modes: "host" proposes on the host and
# reads acceptance back after every verify step; "device" runs propose,
# verify and accept for a whole segment in one program (the per-slot
# history ring is the draft source), read back once a segment
SPEC_MODES = ("host", "device")

# device mode's draft sources: "ngram" = the suffix-match lookup over the
# slot's history ring (ngram.propose_device); "self" = the verify forward's
# trailing greedy tokens as the next step's drafts (the ring still drafts
# each segment's first step)
SPEC_DRAFTS = ("ngram", "self")


class PagePoolExhausted(RuntimeError):
    """Page growth could not be satisfied, or a request can never fit the
    pool. ``rids`` names the requests concerned. An optimistic paged
    engine raises it from ``decode_segment`` when the gap left a live
    request uncovered (never a silently dropped write); the serving
    scheduler fails with it a request that cannot grow even with the pool
    to itself, or whose replay can never be admitted again."""

    def __init__(self, rids, message: str):
        super().__init__(message)
        self.rids = list(rids)


def classify_fault(exc: BaseException, site: str = "decode") -> str:
    """Blast radius of ``exc`` raised at serving seam ``site``:
    ``"request"`` / ``"engine"`` / ``"fatal"``.

    Explicit :class:`RequestFault` / :class:`EngineFault` win over the
    site default; anything unclassified is request-scoped at the
    single-request seams (:data:`REQUEST_SITES`: admission work runs
    behind abort guards that reclaim capacity) and engine-scoped at the
    batch-wide ones (``decode``, ``collect``, ``cancel``)."""
    if isinstance(exc, (KeyboardInterrupt, SystemExit)):
        return "fatal"
    if isinstance(exc, EngineFault):
        return "engine"
    if isinstance(exc, RequestFault):
        return "request"
    return "request" if site in REQUEST_SITES else "engine"


def prefill_buckets_for(spec, max_len: int, floor: int = 16):
    """Normalize a ``prefill_buckets`` knob to a sorted tuple of pad
    targets, or None (exact-length prefill). ``"auto"`` gives powers of two
    from ``floor`` up to ``max_len``; an explicit sequence is deduped,
    sorted and extended to cover ``max_len``."""
    if spec is None:
        return None
    if isinstance(spec, str) and spec == "auto":
        if int(floor) < 1:
            raise ValueError(f"bucket floor must be >= 1, got {floor}")
        out = []
        b = int(floor)
        while b < max_len:
            out.append(b)
            b *= 2
        out.append(max_len)
        return tuple(out)
    out = sorted({int(b) for b in spec})
    if not out or out[0] < 1:
        raise ValueError(f"prefill_buckets must be positive ints, got "
                         f"{spec!r}")
    if out[-1] > max_len:
        raise ValueError(
            f"prefill bucket {out[-1]} exceeds max_len={max_len}")
    if out[-1] < max_len:
        out.append(max_len)
    return tuple(out)


def _normalize_prefill_chunk(prefill_chunk, max_len: int):
    """Validate the ``prefill_chunk`` engine knob (shared by all engines):
    None, or a positive int that divides ``max_len``. Chunks start at
    multiples of C, so divisibility is what keeps every (padded) chunk
    window [pos, pos + C) inside the cache."""
    if prefill_chunk is None:
        return None
    if isinstance(prefill_chunk, bool) or not isinstance(
            prefill_chunk, (int, np.integer)) or prefill_chunk < 1:
        raise ValueError(
            f"prefill_chunk must be a positive int or None, got "
            f"{prefill_chunk!r}")
    if max_len % int(prefill_chunk) != 0:
        raise ValueError(
            f"max_len({max_len}) must be a multiple of "
            f"prefill_chunk({int(prefill_chunk)}) — a final chunk "
            "overhanging the cache would clamp and corrupt earlier KV")
    return int(prefill_chunk)


def _chunks(ids: np.ndarray, C: int, start: int = 0):
    """The fixed-shape chunks of prompt ``ids`` [B, plen] from ``start``:
    (offset, [B, C] ids, real rows r); only the final chunk may be partial,
    and it is right-padded with id 0."""
    for pos in range(start, ids.shape[1], C):
        chunk = ids[:, pos:pos + C]
        yield pos, _pad_ids(chunk, C), chunk.shape[1]


def _bucket_for(buckets, plen: int) -> int:
    """Smallest bucket >= plen (buckets sorted, last == max_len); plen
    itself when ``buckets`` is None (exact-length prefill)."""
    if buckets is None:
        return plen
    for b in buckets:
        if b >= plen:
            return b
    return buckets[-1]


def _pad_ids(ids: np.ndarray, width: int) -> np.ndarray:
    """Right-pad [B, plen] token ids to [B, width] with id 0. Padded prefill
    gives the exact-length result: causal masking keeps every real query
    off the pad keys, logits are read at the true last position, and the
    pad tail's KV is masked by every decode read and overwritten as the
    sequence grows."""
    plen = ids.shape[1]
    if plen >= width:
        return ids
    return np.pad(ids, ((0, 0), (0, width - plen)))


def _prompt_ids(prompt) -> np.ndarray:
    """A prompt (tensor / ndarray / list) as int32 [1, plen]."""
    if isinstance(prompt, torch.Tensor):
        prompt = prompt.detach().cpu().numpy()
    return np.asarray(prompt).astype(np.int32).reshape(1, -1)


def _prompt_len(prompt) -> int:
    return _prompt_ids(prompt).shape[1]


def _model_signature(model, max_batch: int, max_len: int) -> str:
    """The static part of an engine's program ids (``monitor/ledger.py``):
    the model's class, configuration and dtype, the batch and the cache
    length."""
    dtype = next(model.parameters()).dtype
    return (f"{type(model).__name__}|{model.config!r}|{dtype}|"
            f"batch={max_batch}|max_len={max_len}")


def _lora_kw(lora) -> dict:
    """A serving forward's LoRA keyword: none at all without an adapter
    input, so an engine without adapters calls its model as before."""
    return {} if lora is None else {"lora": lora}


def _is_int(x) -> bool:
    return not isinstance(x, bool) and isinstance(x, (int, np.integer))


def _check_draft_k(draft_k) -> None:
    if not _is_int(draft_k) or not 0 <= draft_k <= 256:
        raise ValueError(f"draft_k must be an int in [0, 256] (0 disables "
                         f"speculative decoding), got {draft_k!r}")


def _check_choice(name: str, value, choices) -> None:
    if value not in choices:
        raise ValueError(f"{name} must be one of {choices}, got {value!r}")


class GenerationConfig:
    """Per-request decoding parameters, validated at construction (a
    malformed config from the network must fail admission, never a shared
    decode segment), with the reference's checks value for value.
    ``do_sample=False`` decodes greedily; ``do_sample=True`` draws from
    softmax(logits / temperature) filtered to the top-k logits (0: all) and
    then to the top-p mass, with the noise stream of ``seed``.
    ``speculative=True`` opts a greedy request into speculative decoding on
    an engine built with ``draft_k > 0`` (a sampled request decodes plain:
    lossless acceptance needs the argmax target); ``draft_k`` caps this
    request's draft window (None: the engine's). ``adapter`` names the
    LoRA adapter the request decodes under (None: the base model), on an
    engine built with ``lora_capacity > 0``."""

    def __init__(self, max_new_tokens: int = 64, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0, do_sample: bool = False,
                 eos_token_id: Optional[int] = None, seed: int = 0,
                 speculative: bool = False, draft_k: Optional[int] = None,
                 adapter: Optional[str] = None):
        if not _is_int(max_new_tokens) or not (1 <= max_new_tokens
                                               <= _INT32_MAX):
            raise ValueError(f"max_new_tokens must be an int in [1, 2**31), "
                             f"got {max_new_tokens!r}")
        if not (isinstance(temperature, (int, float, np.floating))
                and temperature > 0):
            # `not (x > 0)` also rejects NaN
            raise ValueError(f"temperature must be > 0, got {temperature!r}")
        if not _is_int(top_k) or not 0 <= top_k <= _INT32_MAX:
            raise ValueError(f"top_k must be an int in [0, 2**31) (0 "
                             f"disables), got {top_k!r}")
        if not (isinstance(top_p, (int, float, np.floating))
                and 0 < top_p <= 1):
            raise ValueError(f"top_p must satisfy 0 < top_p <= 1, got "
                             f"{top_p!r}")
        if eos_token_id is not None and (
                not _is_int(eos_token_id)
                or not 0 <= eos_token_id <= _INT32_MAX):
            raise ValueError(f"eos_token_id must be an int in [0, 2**31) or "
                             f"None, got {eos_token_id!r}")
        if not _is_int(seed):
            raise ValueError(f"seed must be an int, got {seed!r}")
        if draft_k is not None and (not _is_int(draft_k)
                                    or not 1 <= draft_k <= 256):
            # far above any useful window: an absurd value fails at
            # admission, never captures an absurd program
            raise ValueError(f"draft_k must be an int in [1, 256] or None "
                             f"(engine default), got {draft_k!r}")
        if adapter is not None and (not isinstance(adapter, str)
                                    or not adapter or len(adapter) > 256):
            # a malformed name fails here, never in a shared segment
            raise ValueError(
                f"adapter must be a non-empty str (<= 256 chars) or "
                f"None (base model), got {adapter!r}")
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.do_sample = bool(do_sample)
        self.eos_token_id = None if eos_token_id is None else int(eos_token_id)
        self.seed = int(seed)
        self.speculative = bool(speculative)
        self.draft_k = None if draft_k is None else int(draft_k)
        self.adapter = adapter


class CausalLMEngine:
    """Offline generation for a causal LM exposing ``init_cache`` /
    ``forward_with_cache``: one bucketed prefill of the whole batch into
    dense caches (or, for a prompt longer than ``prefill_chunk``, one
    fixed-shape prefill per chunk at a device offset), then one-token steps
    at ``pos = plen, plen + 1, ...`` (K7 over the cache), greedy or sampled
    per the config. Runs on its model's device.

    The engine owns its caches, ``[max_batch, max_len]`` per layer,
    allocated once; a call of batch ``b`` uses their first ``b`` rows,
    unpadded (cuBLAS may take another algorithm at another batch, and the
    tokens would no longer be the eager ones). A step reads its position
    from a device counter and writes its token into a device history, so on
    the card it is one CUDA graph per batch size, captured at its first
    call (or by :meth:`warmup`) and replayed ``max_new_tokens - 1`` times:
    the same graph serves every prompt length, eos and token budget. A
    sampled call replays a second graph per batch size (key ``("step", b,
    "sampled")``), whose sampling parameters are device vectors; row b
    draws with the stream of seed ``config.seed + b``.

    Usage::

        eng = CausalLMEngine(model, max_batch=8, max_len=2048)
        eng.warmup(batch=8)                  # optional: capture ahead
        out_ids = eng.generate(prompt_ids, GenerationConfig(max_new_tokens=64))

    :meth:`generate_speculative` decodes one greedy prompt with n-gram
    drafts verified in one forward each, eagerly.

    After each :meth:`generate`, ``generate_stats`` holds ``ttft_s`` (the
    call to the first tokens on the host), ``decode_s`` (the rest of the
    call) and ``decode_steps``; ``programs`` (a
    :class:`~paddle_tpu_torch.inference._graphs.GraphCache`) counts the
    captures per key.

    The program ledger sees the reference's four programs, ownerless as
    there: ``lm_prefill`` (one per batch and bucket), ``lm_prefill_chunk``,
    ``lm_decode`` and ``lm_spec_verify`` (one per window). The reference's
    ``lm_decode`` is one program a call (its scan over the tokens); here it
    is the step's graph, one dispatch a token."""

    def __init__(self, model, max_batch: int, max_len: int,
                 prefill_buckets="auto",
                 prefill_chunk: Optional[int] = None):
        self.model = model
        self.device = model.device
        self.max_batch = max_batch
        self.max_len = max_len
        self.prefill_buckets = prefill_buckets_for(prefill_buckets, max_len)
        self.prefill_chunk = _normalize_prefill_chunk(prefill_chunk, max_len)
        self.generate_stats: Optional[dict] = None
        self.programs = GraphCache(
            self.device, names={"step": "lm_decode"},
            signature=_model_signature(model, max_batch, max_len))
        dev, mb = self.device, max_batch
        self._caches = model.init_cache(mb, max_len)
        self._samp = SlotSampling(mb, dev)
        self._chunk_pos = torch.zeros((), dtype=torch.int32, device=dev)
        self._spec_pos = torch.zeros((), dtype=torch.int32, device=dev)
        self._tok = torch.zeros(mb, dtype=torch.int32, device=dev)
        self._done = torch.zeros(mb, dtype=torch.bool, device=dev)
        self._eos = torch.full((), -1, dtype=torch.int32, device=dev)
        self._pos = torch.zeros((), dtype=torch.int32, device=dev)
        self._hist = torch.zeros((mb, max_len), dtype=torch.int32,
                                 device=dev)

    def _rows(self, b: int):
        return [(k[:b], v[:b]) for k, v in self._caches]

    def _prefill(self, ids: np.ndarray, width: int) -> torch.Tensor:
        """Prefill ``ids`` [b, plen] padded to ``width`` into the first b
        rows of the caches; returns the logits [b, width, V]."""
        logits, _ = self.programs.eager(
            "lm_prefill", (ids.shape[0], width), self.model.forward_with_cache,
            torch.tensor(_pad_ids(ids, width), device=self.device),
            self._rows(ids.shape[0]), 0)
        return logits

    def _chunk(self, chunk: np.ndarray, pos: int) -> torch.Tensor:
        """One prefill chunk [b, C] at offset ``pos`` into the first b rows
        of the caches; the offset goes to the device (``_chunk_pos``), so
        the program is the same at every offset. Returns the logits [b, C,
        V]."""
        self._chunk_pos.fill_(pos)
        logits, _ = self.programs.eager(
            "lm_prefill_chunk", chunk.shape, self.model.forward_with_cache,
            torch.tensor(chunk, device=self.device),
            self._rows(chunk.shape[0]), self._chunk_pos)
        return logits

    def _run_prefill(self, ids: np.ndarray) -> torch.Tensor:
        """The prompt's prefill: in chunks of ``prefill_chunk`` when the
        prompt is longer, else padded to its bucket. Returns the
        last-position logits [b, V]."""
        plen, C = ids.shape[1], self.prefill_chunk
        if C is not None and plen > C:
            for pos, chunk, r in _chunks(ids, C):
                logits = self._chunk(chunk, pos)
            return logits[:, r - 1]
        return self._prefill(ids, _bucket_for(self.prefill_buckets,
                                              plen))[:, plen - 1]

    def _install(self, b: int, tok: torch.Tensor, plen: int,
                 eos: Optional[int]) -> None:
        """The step's device state for a call: first tokens, done flags,
        eos (-1: none), position."""
        self._tok[:b].copy_(tok)
        self._eos.fill_(-1 if eos is None else eos)
        self._done[:b].copy_(tok == self._eos)
        self._pos.fill_(plen)

    def _step(self, b: int, sampled: bool = False) -> None:
        """One token for rows [0, b): feed ``_tok`` at ``_pos``, write the
        next token (greedy, or drawn with the rows' sampling vectors when
        ``sampled``; eos once a row is done) into ``_tok`` and the history
        at ``_pos + 1``, advance ``_pos``."""
        logits, _ = self.model.forward_with_cache(
            self._tok[:b, None], self._rows(b), self._pos)
        nxt = sample_rows(logits[:, 0],
                          self._samp.view(slice(0, b)) if sampled else None,
                          self._pos + 1)
        done = self._done[:b]
        has_eos = self._eos >= 0
        nxt = torch.where(done & has_eos, self._eos, nxt)
        done |= has_eos & (nxt == self._eos)
        self._tok[:b].copy_(nxt)
        self._hist[:b].index_copy_(1, (self._pos + 1).long().reshape(1),
                                   nxt[:, None])
        self._pos += 1

    def warmup(self, batch: int) -> Dict[str, float]:
        """Run the step's state install, capture the step at this batch
        size (greedy and sampled), and run one prefill of ``batch`` rows
        per bucket and, with ``prefill_chunk``, one chunk (cuBLAS's and the
        kernels' first use at each width; prefill is not captured), so a
        :meth:`generate` of ``batch`` rows captures nothing. Returns
        ``{program: seconds}``."""
        if not 1 <= batch <= self.max_batch:
            raise ValueError(f"batch must be in [1, {self.max_batch}], got "
                             f"{batch}")
        t_all = time.perf_counter()
        out = {}
        with torch.no_grad():
            # the capture first: it empties PyTorch's allocator cache,
            # which the prefills then fill for the requests to reuse
            t0 = time.perf_counter()
            self._install(batch, self._tok[:batch].clone(), 0, None)
            out["admit_state"] = time.perf_counter() - t0
            for sampled in (False, True):
                t0 = time.perf_counter()
                self.programs.run(self._step_key(batch, sampled),
                                  lambda: self._step(batch, sampled))
                name = f"step_{batch}" + ("_sampled" if sampled else "")
                out[name] = time.perf_counter() - t0
            for w in self.prefill_buckets or ():
                t0 = time.perf_counter()
                self._prefill(np.zeros((batch, w), np.int32), w)
                out[f"prefill_{w}"] = time.perf_counter() - t0
            if self.prefill_chunk is not None:
                t0 = time.perf_counter()
                self._chunk(np.zeros((batch, self.prefill_chunk), np.int32),
                            0)
                out["prefill_chunk"] = time.perf_counter() - t0
        if self.device.type == "cuda":
            # this thread's stream only: another replica in the process may
            # be capturing a graph, which a device-wide sync would break
            torch.cuda.current_stream(self.device).synchronize()
        out["total"] = time.perf_counter() - t_all
        return out

    def reset_state(self) -> None:
        """Reset the caches and the step's state IN PLACE: a captured graph
        holds their addresses, so they are zeroed, not reallocated, and the
        graphs are kept."""
        with torch.no_grad():
            for k, v in self._caches:
                k.zero_()
                v.zero_()
            for t in (self._tok, self._done, self._pos, self._hist,
                      self._chunk_pos, self._spec_pos):
                t.zero_()
            self._eos.fill_(-1)
            self._samp.reset()

    @staticmethod
    def _step_key(b: int, sampled: bool):
        return ("step", b, "sampled") if sampled else ("step", b)

    def generate(self, input_ids,
                 config: Optional[GenerationConfig] = None) -> np.ndarray:
        """input_ids [B, prompt_len] (tensor, ndarray or nested lists).
        Returns int32 [B, prompt_len + max_new_tokens]: the prompt, then
        the generated tokens (greedy, or sampled under ``config.do_sample``);
        a row that emits eos stays on eos."""
        cfg = config or GenerationConfig()
        if isinstance(input_ids, torch.Tensor):
            input_ids = input_ids.detach().cpu().numpy()
        ids = np.asarray(input_ids).astype(np.int32)
        b, plen = ids.shape
        if b > self.max_batch:
            raise ValueError(f"batch {b} exceeds max_batch={self.max_batch} "
                             f"the engine was built for")
        if plen + cfg.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt({plen}) + max_new_tokens({cfg.max_new_tokens}) "
                f"exceeds engine max_len({self.max_len})")
        t0 = time.perf_counter()
        n, sampled = cfg.max_new_tokens, cfg.do_sample
        with torch.no_grad():
            last = self._run_prefill(ids)
            samp = at = None
            if sampled:
                self._samp.set(slice(0, b), cfg, torch.from_numpy(
                    (cfg.seed + np.arange(b, dtype=np.int64)) % 2 ** 32))
                samp = self._samp.view(slice(0, b))
                at = torch.full((b,), plen, dtype=torch.int64,
                                device=self.device)
            tok = sample_rows(last, samp, at)
            first = tok.cpu().numpy()[:, None]     # on the host: TTFT ends
            t1 = time.perf_counter()
            self._install(b, tok, plen, cfg.eos_token_id)
            key = self._step_key(b, sampled)
            for _ in range(n - 1):
                self.programs.run(key, lambda: self._step(b, sampled))
            rest = self._hist[:b, plen + 1:plen + n].cpu().numpy()
        gen = np.concatenate([first, rest], axis=1)
        self.generate_stats = {"ttft_s": t1 - t0,
                               "decode_s": time.perf_counter() - t1,
                               "decode_steps": n - 1}
        return np.concatenate([ids, gen], axis=1)

    # -- speculative decoding -------------------------------------------------
    def _verify(self, tokens, pos: int) -> torch.Tensor:
        """One verify forward of ``tokens`` (a list, the window) at offset
        ``pos`` into row 0 of the caches, the offset on the device; returns
        the greedy token of every window position (int64, on the host).
        A window of one token is the one-token step (K7), a wider one a
        prefill chunk at an offset (K3's prefix-chunk instance)."""
        self._spec_pos.fill_(pos)
        logits, _ = self.programs.eager(
            "lm_spec_verify", (len(tokens),), self.model.forward_with_cache,
            torch.tensor([tokens], dtype=torch.int32, device=self.device),
            self._rows(1), self._spec_pos)
        return logits[0].argmax(-1).cpu().numpy()

    def generate_speculative(self, input_ids,
                             config: Optional[GenerationConfig] = None,
                             draft_k: int = 8,
                             ngram_max: int = 3) -> np.ndarray:
        """LOSSLESS n-gram (prompt lookup) speculative decoding of one
        prompt: propose ``draft_k`` tokens by continuing the longest recent
        suffix match found earlier in the context (``ngram.NgramProposer``),
        verify all of them in ONE forward of ``draft_k + 1`` tokens at the
        cache's offset, and accept the matched prefix plus the model's own
        next token, so each forward yields 1 to ``draft_k + 1`` tokens.
        Every emitted token is the model's greedy pick: the output is
        :meth:`generate`'s greedy continuation wherever the wide verify
        forward and the one-token step agree on the argmax (their matmuls
        run at other M, so logits may differ in the last bits; a stream can
        part only at a near-tie). Where fewer than ``draft_k + 1`` rows of
        ``max_len`` remain, plain one-token steps finish the stream.

        Greedy only, batch 1. Runs eagerly, one host read a verify step.
        Rejected drafts leave stale cache rows past the accepted length;
        the next verify overwrites them and every read is position masked.
        ``last_spec_stats`` holds ``forwards`` (prefill included),
        ``tokens``, ``accepted_draft_tokens`` and ``tokens_per_forward``.
        Returns int32 [1, prompt_len + max_new_tokens]."""
        cfg = config or GenerationConfig()
        if cfg.do_sample:
            raise ValueError(
                "speculative decoding here is greedy-only (lossless "
                "acceptance needs the argmax target); use generate() "
                "for sampling")
        if isinstance(input_ids, torch.Tensor):
            input_ids = input_ids.detach().cpu().numpy()
        ids = np.asarray(input_ids).astype(np.int32)
        if ids.ndim == 1:
            ids = ids[None]
        b, plen = ids.shape
        if b != 1:
            raise ValueError("speculative decoding serves B=1 requests")
        if plen + cfg.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt({plen}) + max_new_tokens({cfg.max_new_tokens}) "
                f"exceeds engine max_len({self.max_len})")
        eos = cfg.eos_token_id
        with torch.no_grad():
            out = [int(self._run_prefill(ids)[0].argmax())]
            prop = NgramProposer([int(t) for t in ids[0]] + [out[0]],
                                 draft_k, ngram_max)
            pos = plen                  # tokens the cache holds
            forwards, extra = 1, 0      # the prefill; tokens beyond 1/forward
            while (len(out) < cfg.max_new_tokens
                   and (eos is None or out[-1] != eos)
                   and pos + 1 + draft_k <= self.max_len):
                draft = prop.propose()
                greedy = self._verify([out[-1]] + draft, pos)
                forwards += 1
                m = 0
                while m < draft_k and int(greedy[m]) == draft[m]:
                    m += 1
                before = len(out)
                for t in draft[:m] + [int(greedy[m])]:
                    out.append(t)
                    prop.extend([t])
                    if (len(out) >= cfg.max_new_tokens
                            or (eos is not None and t == eos)):
                        break
                extra += len(out) - before - 1
                # the cache gained the window's first 1 + m rows; the last
                # accepted token is the model's own pick, not yet cached
                pos += 1 + m
            # the tail: one-token steps where max_len has no room for a
            # whole window
            while (len(out) < cfg.max_new_tokens
                   and (eos is None or out[-1] != eos)
                   and pos + 1 <= self.max_len - 1):
                out.append(int(self._verify([out[-1]], pos)[0]))
                forwards += 1
                prop.extend([out[-1]])
                pos += 1
        budget = max(cfg.max_new_tokens, 1)
        if eos is not None and eos in out:
            # generate() keeps a finished row on eos
            i = out.index(eos)
            out = out[:i + 1] + [eos] * (budget - i - 1)
        out = out[:budget]
        self.last_spec_stats = {"forwards": forwards, "tokens": len(out),
                                "accepted_draft_tokens": extra,
                                "tokens_per_forward":
                                    len(out) / max(forwards, 1)}
        return np.concatenate([ids, np.asarray([out], np.int32)], axis=1)


class _ChunkedAdmission:
    """Host-side state of one chunked admission in flight. The slot (and,
    paged, the request's worst-case pages) is already claimed; ``mini``
    (a dense ``max_len`` cache) takes the prompt's KV chunk by chunk until
    the final chunk installs it and the request goes live under ``rid``.
    Drive with ``engine.admit_chunk``; reclaim with ``engine.abort_admit``."""

    __slots__ = ("rid", "slot", "ids", "plen", "cfg", "mini", "off",
                 "closed", "last_logits", "t0")

    def __init__(self, rid, slot, ids, plen, cfg, mini, off=0):
        self.t0 = time.perf_counter()    # the admission latency's start
        self.rid = rid
        self.slot = slot
        self.ids = ids
        self.plen = plen
        self.cfg = cfg
        self.mini = mini
        self.off = off            # the next chunk's offset
        self.closed = False
        self.last_logits = None


class ContinuousBatchingEngine:
    """Continuous batching over ``max_batch`` cache slots, each with its
    own length: admission and retirement happen between decode segments,
    so new work starts without waiting for the longest running request.

    This class holds the admission, decode-segment and serve logic, and
    the dense cache layout: per-layer caches ``[max_batch, max_len, Hkv,
    hd]``, slot s owning row s; a request prefills at its bucket width
    straight into its slot's rows, and each decode step is the model's
    ``forward_decode_ragged`` (K7 with per-row lengths). Rows past a
    request's length may hold an earlier request's K/V: every read is
    masked by the length and decode overwrites them, as the reference's
    zero rows past the bucket are. :class:`PagedContinuousBatchingEngine`
    replaces the layout hooks (``_make_caches``, ``_admit_cache``,
    ``_warm_prefill``, ``_fwd_decode``, ``_install_mini``,
    ``_reserve_admit``) with a page pool. The engine runs on its model's
    device.

    A decode segment of ``n`` steps is one program keyed on ``n`` and on
    whether any live request samples (``("segment", n)`` greedy,
    ``("segment", n, "sampled")`` with the sampling filter): on the card a
    CUDA graph, captured at the key's first segment or by :meth:`warmup`,
    and replayed after that (``programs``, a
    :class:`~paddle_tpu_torch.inference._graphs.GraphCache`, counts the
    captures). It reads and writes only storage allocated once: the
    caches, the per-slot state (``lens``, ``last``, ``done_dev``,
    ``active_dev``, ``eos``, the sampling vectors ``samp``) and a
    ``[max_batch, n + 1]`` output buffer of tokens and done flags, read
    back once a segment. :meth:`reset_state` drops every request and
    resets that storage in place, keeping the graphs.

    ``prefill_chunk=C`` (a divisor of ``max_len``) enables chunked
    admission: :meth:`begin_admit` claims a slot (and pages) for a
    request, each :meth:`admit_chunk` runs one fixed-shape prefill chunk of
    C tokens into the admission's dense ``max_len`` mini cache at a device
    offset, and the final chunk installs it and makes the request live, so
    a caller can interleave decode segments between the chunks of a long
    prompt; :meth:`abort_admit` gives the claim back.

    Usage::

        eng = ContinuousBatchingEngine(model, max_batch=8, max_len=1024)
        eng.warmup(segment_steps=8)          # optional: capture ahead
        outs = eng.serve(prompts, GenerationConfig(max_new_tokens=32))

    Speculative decoding (``draft_k > 0``, ``ngram_max``, ``spec_mode``,
    ``spec_draft``, ``spec_history``; the first three and ``spec_draft``
    settable on an idle engine, see :meth:`decode_segment`): a greedy
    request with ``speculative=True`` keeps up to ``min(its draft_k,
    draft_k) + 1`` tokens per verify forward, and its stream is the plain
    greedy one wherever the verify forward and the one-token step agree on
    the argmax. :meth:`spec_stats` holds the accounting.

    Multi-tenant LoRA (``lora_capacity=K > 0``, ``lora_rank``,
    ``lora_targets``): ``adapters`` is the engine's
    :class:`~paddle_tpu_torch.serving.adapters.AdapterRegistry` (K resident
    adapters, the bank on the model's device), :meth:`load_adapter` /
    :meth:`unload_adapter` hot-load and unload between segments, and a
    request's ``GenerationConfig.adapter`` picks its adapter: the slot's
    entry of the ``adapter_idx`` device vector, read by every decode and
    verify program, and its prefill runs under it. An unknown or draining
    name, or an adapter on an engine without ``lora_capacity``, fails that
    request's admission (ValueError). The program keys do not change.

    Host-side counters: ``prefills``, ``prefill_chunks``,
    ``decode_steps`` and ``verify_steps`` count the model forwards run
    (warmup's included;
    ``warm_prefills`` counts the paged engine's prefix-cache hits among
    the prefills, whose tail runs at an offset);
    ``serve_stats`` holds the timings of the last :meth:`serve`;
    :meth:`load` is the host-side snapshot a serving front reads.
    ``_monitor_engine`` labels this engine's monitor series; :meth:`close`
    retires them, and its programs' rows in the program ledger.

    The program ledger (``FLAGS_enable_ledger``) sees the reference's
    programs under its names, owned by ``_monitor_engine``: ``cb_prefill``
    (one per bucket), ``cb_prefill_chunk`` (one per chunk width: a chunk,
    or a warm prefix-cache tail at its bucket), ``cb_admit_state`` (the
    slot-state install), ``cb_admit`` (the dense engine's install of a
    chunked admission's mini cache), ``cb_segment``, ``cb_spec_step``,
    ``cb_spec_device_segment`` (one per graph key), the paged engine's
    ``cb_reset_scales`` and the registry's ``lora_install``. Where the
    boundaries differ: the dense one-shot admission here prefills straight
    into its slot's rows, so it has no ``cb_admit`` dispatch (the
    reference's prefills a mini cache and installs it); the paged install
    is not a program in either."""

    def __init__(self, model, max_batch: int, max_len: int,
                 prefill_buckets="auto",
                 prefill_chunk: Optional[int] = None,
                 draft_k: int = 0, ngram_max: int = 3,
                 spec_mode: str = "host", spec_draft: str = "ngram",
                 spec_history: int = 128, lora_capacity: int = 0,
                 lora_rank: int = 8, lora_targets=("q", "k", "v", "o")):
        _check_draft_k(draft_k)
        _check_choice("spec_mode", spec_mode, SPEC_MODES)
        _check_choice("spec_draft", spec_draft, SPEC_DRAFTS)
        if not _is_int(spec_history) or not 8 <= spec_history <= 65536:
            raise ValueError(
                f"spec_history must be an int in [8, 65536] (the device "
                f"history-ring width), got {spec_history!r}")
        if not _is_int(ngram_max) or ngram_max < 1:
            raise ValueError(
                f"ngram_max must be a positive int, got {ngram_max!r}")
        if not _is_int(lora_capacity) or lora_capacity < 0:
            raise ValueError(
                f"lora_capacity must be an int >= 0 (0 disables "
                f"multi-tenant LoRA), got {lora_capacity!r}")
        self.model = model
        self.device = model.device
        self.max_batch = max_batch
        self.max_len = max_len
        self.prefill_buckets = prefill_buckets_for(prefill_buckets, max_len)
        self.prefill_chunk = _normalize_prefill_chunk(prefill_chunk, max_len)
        # speculative decoding: the draft window (0: off), the n-gram
        # length, the execution mode and device mode's draft source are
        # idle-only knobs (the properties below); the history ring's width
        # is fixed at construction
        self._draft_k = int(draft_k)
        self.ngram_max = int(ngram_max)
        self._spec_mode = spec_mode
        self._spec_draft = spec_draft
        self.spec_history = int(spec_history)
        self._spec: Dict[int, NgramProposer] = {}   # rid -> proposer
        # engine-lifetime accounting (spec_stats): proposed and accepted
        # draft tokens, verify forwards that served a live row, slot
        # participations, tokens the spec segments emitted, and host mode's
        # per-verify-step reads
        self._spec_totals = {"proposed": 0, "accepted": 0, "forwards": 0,
                             "slot_steps": 0, "emitted": 0, "host_syncs": 0}
        self._spec_buf: Dict[tuple, torch.Tensor] = {}
        self.prefills = 0
        self.warm_prefills = 0
        self.prefill_chunks = 0
        self.decode_steps = 0
        self.verify_steps = 0
        self.serve_stats: Optional[dict] = None
        self._segment_log: List[tuple] = []   # (seconds, tokens emitted)
        # per-engine label: engines side by side publish their series
        # side by side
        self._monitor_engine = monitor.instance_label("engine")
        self.programs = GraphCache(
            self.device, names={"segment": "cb_segment",
                                "spec_step": "cb_spec_step",
                                "spec_device": "cb_spec_device_segment"},
            owner=self._monitor_engine)
        self._seg_out: Dict[int, torch.Tensor] = {}
        self._init_decode_state()
        self._slot_req: Dict[int, int] = {}   # slot -> request id
        self._tokens: Dict[int, list] = {}    # request id -> generated ids
        self._budget: Dict[int, int] = {}     # request id -> tokens left
        self._cfg: Dict[int, GenerationConfig] = {}
        self._finished: Dict[int, np.ndarray] = {}
        self._next_req = 0
        # multi-tenant LoRA: the registry owns the factor bank; 0 disables
        # it, and then every forward runs without a lora input, exactly as
        # an engine without LoRA
        self.lora_capacity = int(lora_capacity)
        self.adapters = None
        if self.lora_capacity:
            shapes_fn = getattr(model, "lora_shapes", None)
            if shapes_fn is None:
                raise ValueError(
                    f"lora_capacity needs a model exposing "
                    f"lora_shapes(targets) (llama does); "
                    f"{type(model).__name__} does not")
            num_layers, shapes = shapes_fn(tuple(lora_targets))
            # imported here: paddle_tpu_torch.serving imports this module
            from ..serving.adapters import AdapterRegistry

            self.adapters = AdapterRegistry(
                self.lora_capacity, lora_rank, tuple(lora_targets),
                num_layers, shapes, model.model.embed_tokens.weight.dtype,
                self._monitor_engine, device=self.device)
        # adapter indices around admissions: slot -> index while an
        # admission is in flight (moved to the request by _register,
        # released by _abort_admit), rid -> index while the request lives
        # (released by _retire)
        self._aidx_stash: Dict[int, int] = {}
        self._rid_aidx: Dict[int, int] = {}
        self._refresh_signature()

    def _program_signature(self) -> str:
        """The static part of this engine's program ids: the model, the
        batch, the cache length, the draft window and the LoRA geometry."""
        sig = (_model_signature(self.model, self.max_batch, self.max_len)
               + f"|draft_k={self.draft_k}")
        if self.adapters is not None:
            a = self.adapters
            sig += f"|lora={self.lora_capacity},{a.rank},{a.targets}"
        return sig

    def _refresh_signature(self) -> None:
        self.programs.signature = self._program_signature()

    def _init_decode_state(self) -> None:
        """Allocate the device-side decode state, once: caches, per-slot
        length, last token, done and active flags, eos id (-1 = none), the
        per-slot sampling vectors, draft window (0: plain decode), LoRA
        adapter index (0: the base model) and token-history ring, and the
        chunk offset; and the free slots. The ring holds each slot's LAST
        ``spec_history`` tokens of prompt and output, left-aligned,
        ``hist_len`` of them valid (device mode's draft source); it is
        allocated whatever the knobs, so switching them on an idle engine
        needs no new state."""
        mb, dev = self.max_batch, self.device
        self.caches = self._make_caches()
        self.lens = torch.zeros(mb, dtype=torch.int32, device=dev)
        self.last = torch.zeros(mb, dtype=torch.int32, device=dev)
        self.done_dev = torch.zeros(mb, dtype=torch.bool, device=dev)
        self.active_dev = torch.zeros(mb, dtype=torch.bool, device=dev)
        self.eos = torch.full((mb,), -1, dtype=torch.int32, device=dev)
        self.samp = SlotSampling(mb, dev)
        self.spec_k = torch.zeros(mb, dtype=torch.int32, device=dev)
        self.adapter_idx = torch.zeros(mb, dtype=torch.int32, device=dev)
        self.hist = torch.zeros((mb, self.spec_history), dtype=torch.int32,
                                device=dev)
        self.hist_len = torch.zeros(mb, dtype=torch.int32, device=dev)
        self._chunk_pos = torch.zeros((), dtype=torch.int32, device=dev)
        self._free = list(range(mb))

    # -- the speculative-decoding knobs (idle-only) ---------------------------
    @property
    def draft_k(self) -> int:
        """The engine's draft window (0: speculative decoding off): the
        verify step's width is ``draft_k + 1``. Set on an idle engine only;
        a change drops the captured programs that depend on it."""
        return self._draft_k

    @draft_k.setter
    def draft_k(self, value: int) -> None:
        _check_draft_k(value)
        self._set_spec_knob("_draft_k", int(value))

    @property
    def spec_mode(self) -> str:
        """``"host"`` or ``"device"`` (:data:`SPEC_MODES`); idle-only."""
        return self._spec_mode

    @spec_mode.setter
    def spec_mode(self, value: str) -> None:
        _check_choice("spec_mode", value, SPEC_MODES)
        self._set_spec_knob("_spec_mode", value)

    @property
    def spec_draft(self) -> str:
        """Device mode's draft source, ``"ngram"`` or ``"self"``
        (:data:`SPEC_DRAFTS`); idle-only."""
        return self._spec_draft

    @spec_draft.setter
    def spec_draft(self, value: str) -> None:
        _check_choice("spec_draft", value, SPEC_DRAFTS)
        self._set_spec_knob("_spec_draft", value)

    def _set_spec_knob(self, name: str, value) -> None:
        if getattr(self, name) == value:
            return
        if self._slot_req:
            raise RuntimeError(f"{name[1:]} can only be changed on an idle "
                               f"engine")
        setattr(self, name, value)
        self._refresh_signature()
        # the spec programs captured under the old value go with their
        # scratch (their keys name the value, so nothing would replay them)
        self.programs.drop(lambda key: key[0] in ("spec_step",
                                                  "spec_device"))
        self._spec_buf.clear()

    def reset_state(self) -> None:
        """Drop every request and reset the decode state to its initial
        values IN PLACE: caches zeroed (int8 scales back to the floor),
        lengths, last tokens and flags zeroed, eos ids -1, every slot
        greedy and free. Chunked admissions in flight are dropped: their
        objects no longer hold a claim (admit_chunk on one is undefined).
        Captured graphs hold these tensors' addresses, so nothing is
        reallocated and the graphs are kept: a restart costs no capture.
        Request ids are not reused: ``_next_req`` carries on, and
        ``spec_stats()`` keeps its engine-lifetime totals. Every adapter
        reference goes with its slot (deferred unloads complete); the bank
        and the adapter names stay, since adapters are weights and a
        supervised restart replays requests under them."""
        with torch.no_grad():
            for entry in self.caches:
                for t in entry[:2]:
                    t.zero_()
                for t in entry[2:]:
                    t.fill_(KV_SCALE_FLOOR)
            for t in (self.lens, self.last, self.done_dev, self.active_dev,
                      self._chunk_pos, self.spec_k, self.adapter_idx,
                      self.hist, self.hist_len):
                t.zero_()
            self.eos.fill_(-1)
            self.samp.reset()
        self._free = list(range(self.max_batch))
        self._slot_req.clear()
        self._tokens.clear()
        self._budget.clear()
        self._cfg.clear()
        self._spec.clear()         # the proposers die with their slots
        self._finished.clear()
        self._aidx_stash.clear()
        self._rid_aidx.clear()
        if self.adapters is not None:
            self.adapters.release_all()
        if monitor.enabled():
            self._requests_counter().labels(event="engine_reset").inc()

    # -- multi-tenant LoRA -----------------------------------------------------
    def _lora(self) -> dict:
        """The decode and verify programs' LoRA keyword: ``{"lora": (bank,
        adapter_idx)}`` with the per-slot index vector, or ``{}`` on an
        engine without adapters."""
        return _lora_kw(None if self.adapters is None
                        else (self.adapters.bank, self.adapter_idx))

    def _lora_one(self, slot: int):
        """The ``lora`` input of one admission's prefill (batch 1): its
        stashed adapter index as a one-row vector, or None without
        adapters."""
        if self.adapters is None:
            return None
        return (self.adapters.bank,
                torch.full((1,), self._aidx_stash.get(slot, 0),
                           dtype=torch.int32, device=self.device))

    def _acquire_adapter(self, cfg) -> int:
        """The bank index of the request's adapter, with one live reference
        taken (0 = the base model, no reference). Raises ValueError, a
        REQUEST-scoped verdict at the admission seam, for an unknown or
        draining name, or an adapter on an engine without
        ``lora_capacity``."""
        name = cfg.adapter
        if name is None:
            return 0
        if self.adapters is None:
            raise ValueError(
                f"request names adapter {name!r} but the engine was "
                f"built without lora_capacity")
        return self.adapters.acquire(name)

    def _release_adapter(self, aidx: int) -> None:
        if aidx and self.adapters is not None:
            # the last live reference completes a deferred unload
            self.adapters.release(aidx)

    def _adapter_salt(self, slot: int) -> bytes:
        """Prefix-cache chain salt of the admission in flight on ``slot``
        (b"": the base namespace). Cached KV is a function of the weights
        that made it, so every adapter hashes its blocks in its own
        namespace and a cross-adapter warm hit cannot happen."""
        if self.adapters is None:
            return b""
        return self.adapters.salt(self._aidx_stash.get(slot, 0))

    def load_adapter(self, name: str, params: dict, alpha=None) -> int:
        """Hot-load one LoRA adapter into the bank; returns its index.
        ``params`` maps target projections to ``(A, B)`` factor pairs (see
        :meth:`~paddle_tpu_torch.serving.adapters.AdapterRegistry.load`).
        Only bank ROWS are written, in place, so the captured programs stay
        valid: after ``warmup()`` a load captures nothing. Call from the
        thread driving the engine, between decode segments
        (``Server.load_adapter`` marshals into the gap)."""
        if self.adapters is None:
            raise RuntimeError(
                "engine built without lora_capacity; pass "
                "lora_capacity=K at construction")
        return self.adapters.load(name, params, alpha=alpha)

    def unload_adapter(self, name: str) -> bool:
        """Hot-unload an adapter. Returns True when its index freed at
        once; False when live requests still decode under it: the unload
        DEFERS (new requests naming it fail at admission) and the index
        frees when the last of them retires. Same thread contract as
        :meth:`load_adapter`."""
        if self.adapters is None:
            raise RuntimeError(
                "engine built without lora_capacity; pass "
                "lora_capacity=K at construction")
        return self.adapters.unload(name)

    # -- cache layout hooks (dense here; the paged subclass replaces them) ---
    def _make_caches(self):
        return self.model.init_cache(self.max_batch, self.max_len)

    def _admit_cache(self, slot: int, ids, plen: int, cfg):
        """Prefill the prompt at its bucket width straight into the slot's
        rows of every layer cache; returns the last-position logits."""
        rows = [(k[slot:slot + 1], v[slot:slot + 1]) for k, v in self.caches]
        last_logits, _ = self._run_prefill(ids, plen, rows,
                                           lora=self._lora_one(slot))
        return last_logits

    def _reserve_admit(self, slot: int, plen: int, cfg) -> None:
        """Claim what an admission needs beyond the slot, up front, so a
        chunked admission cannot fail for capacity halfway through (dense:
        nothing; the paged engine reserves the worst-case pages)."""

    def _install_mini(self, slot: int, mini, plen: int) -> None:
        """Copy a chunked admission's mini cache (its first ``plen`` rows)
        into the slot's rows of every layer cache (the program
        ``cb_admit``)."""
        self.programs.eager("cb_admit", (), self._copy_mini, slot, mini,
                            plen)

    def _copy_mini(self, slot: int, mini, plen: int) -> None:
        with torch.no_grad():
            for (k, v), (mk, mv) in zip(self.caches, mini):
                k[slot, :plen].copy_(mk[0, :plen])
                v[slot, :plen].copy_(mv[0, :plen])

    def _warm_prefill(self, width: int) -> None:
        """Warmup's prefill at one bucket: a zero prompt into the rows of
        slot 0, which is free, so its KV is dead weight that the next
        admission overwrites."""
        rows = [(k[:1], v[:1]) for k, v in self.caches]
        self._prefill_forward(np.zeros((1, width), np.int32), width, rows,
                              self._lora_one(0))

    def _fwd_decode(self, tok, lens, live):
        logits, _ = self.model.forward_decode_ragged(tok, self.caches, lens,
                                                     live, **self._lora())
        return logits

    # -- admission / retirement (host-side, between segments) ---------------
    def _can_admit(self, prompt_len: int, cfg) -> bool:
        return True

    def free_slots(self) -> int:
        """Number of free cache slots right now: the public capacity
        probe (with :meth:`can_admit`) for serving schedulers."""
        return len(self._free)

    def load(self) -> dict:
        """Host-side load snapshot: ``{"free_slots", "active_slots",
        "max_batch", "max_len", "tp_degree"}`` plus, paged, ``{"free_pages",
        "total_pages", "occupancy", "kv_dtype"}``, and with adapters the
        registry's snapshot under ``"lora"`` (``{"capacity", "resident",
        "free", "adapters", "draining"}``). All host bookkeeping kept
        between segments: no device sync, so a health endpoint can read it
        while the scheduler thread is inside a decode segment. The
        reference's ``tp`` block comes with tensor parallelism (ROADMAP
        A11)."""
        out = {"free_slots": len(self._free),
               "active_slots": len(self._slot_req),
               "max_batch": self.max_batch,
               "max_len": self.max_len,
               "tp_degree": 1}
        alloc = getattr(self, "alloc", None)
        if alloc is not None:
            out["free_pages"] = alloc.free_pages
            out["total_pages"] = alloc.num_pages
            out["occupancy"] = round(alloc.occupancy, 4)
        if self.adapters is not None:
            out["lora"] = self.adapters.resident()
        return out

    def can_admit(self, prompt_len: int, cfg: GenerationConfig) -> bool:
        """True iff ``add_request`` with this prompt length and config
        would succeed right now."""
        return (bool(self._free)
                and prompt_len + cfg.max_new_tokens <= self.max_len
                and self._can_admit(prompt_len, cfg))

    def add_request(self, prompt_ids, cfg: GenerationConfig) -> int:
        """Prefill one request into a free slot; returns the request id.
        Raises if no slot (or, paged, no page reservation) is available —
        probe :meth:`can_admit` to defer instead."""
        t0 = time.perf_counter()
        ids = self._check_admit(prompt_ids, cfg)
        plen = ids.shape[1]
        aidx = self._acquire_adapter(cfg)
        slot = heapq.heappop(self._free)
        self._aidx_stash[slot] = aidx
        try:
            rid = self._next_req
            self._next_req += 1
            last_logits = self._admit_cache(slot, ids, plen, cfg)
            first, tok_done = self._sample_first(slot, plen, last_logits, cfg)
            self._install_state(slot, plen, first, tok_done, cfg, ids)
        except BaseException:
            # a failed admission must not leak the slot (or its pages, or
            # its adapter reference)
            self._abort_admit(slot)
            raise
        self._init_spec(rid, ids, first, cfg)
        return self._register(slot, rid, first, tok_done, cfg, t0)

    def _check_admit(self, prompt_ids, cfg):
        """The prompt as int32 [1, plen], after the checks every admission
        makes: a free slot, the length within ``max_len``, and capacity."""
        if not self._free:
            raise RuntimeError("no free slot; drain with decode_segment()")
        ids = _prompt_ids(prompt_ids)
        plen = ids.shape[1]
        if plen + cfg.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt({plen}) + max_new_tokens({cfg.max_new_tokens}) "
                f"exceeds engine max_len({self.max_len})")
        if not self._can_admit(plen, cfg):
            raise RuntimeError(
                "page pool exhausted; drain with decode_segment()")
        return ids

    def begin_admit(self, prompt_ids, cfg: GenerationConfig
                    ) -> _ChunkedAdmission:
        """Start a CHUNKED admission: claim a slot and (paged) the
        request's worst-case pages up front, so a partial admission can
        neither leak capacity nor run out of it, and return the admission.
        The caller drives one fixed-shape prefill chunk per
        :meth:`admit_chunk`, with decode segments in between. Raises like
        :meth:`add_request` when the request cannot be admitted now, and
        RuntimeError on an engine built without ``prefill_chunk``."""
        if self.prefill_chunk is None:
            raise RuntimeError(
                "chunked admission needs an engine built with "
                "prefill_chunk=<tokens>")
        ids = self._check_admit(prompt_ids, cfg)
        plen = ids.shape[1]
        aidx = self._acquire_adapter(cfg)
        slot = heapq.heappop(self._free)
        # the adapter reference is held for the WHOLE chunked admission (an
        # unload defers while its chunks run); _register moves it to the
        # request, _abort_admit releases it
        self._aidx_stash[slot] = aidx
        try:
            mini, start = self._begin_admit_cache(slot, ids, plen, cfg)
        except BaseException:
            self._abort_admit(slot)
            raise
        rid = self._next_req
        self._next_req += 1
        self._count_prefill("chunked")
        return _ChunkedAdmission(rid, slot, ids, plen, cfg, mini, off=start)

    def _begin_admit_cache(self, slot: int, ids, plen: int, cfg):
        """Claim a chunked admission's capacity and build its mini cache:
        returns ``(mini, first chunk's offset)``. Every chunk program runs
        at the fixed (C, max_len) shapes, so all chunked admissions share
        one program (the paged engine pays a dense mini slab for the
        admission's lifetime)."""
        self._reserve_admit(slot, plen, cfg)
        return self.model.init_cache(1, self.max_len), 0

    def _offset_forward(self, ids: np.ndarray, mini, pos: int, r: int,
                        lora=None):
        """One fixed-shape prefill window ``ids`` [1, W] at offset ``pos``
        (on the device, in ``_chunk_pos``, so the program is the same at
        every offset) into ``mini``, under ``lora`` (an admission's
        adapter); returns the logits at its last real row ``r - 1`` [1,
        V]."""
        self._chunk_pos.fill_(pos)
        with torch.no_grad():
            logits, _ = self.programs.eager(
                "cb_prefill_chunk", (ids.shape[1], lora is not None),
                self.model.forward_with_cache,
                torch.tensor(ids, device=self.device), mini,
                self._chunk_pos, **_lora_kw(lora))
        return logits[:, r - 1]

    def _run_chunk(self, chunk: np.ndarray, mini, pos: int, r: int,
                   lora=None):
        """One prefill chunk [1, C] at offset ``pos`` into ``mini``;
        returns the logits at its last real row ``r - 1`` [1, V]."""
        logits = self._offset_forward(chunk, mini, pos, r, lora)
        self.prefill_chunks += 1
        return logits

    def admit_chunk(self, adm: _ChunkedAdmission) -> bool:
        """Run ONE prefill chunk of an admission started with
        :meth:`begin_admit`. Returns True when the admission completed: the
        request is live in its slot under ``adm.rid`` with its first token
        drawn. On any failure the claimed capacity is given back and the
        admission is closed."""
        if adm.closed:
            raise RuntimeError("admission already completed or aborted")
        C = self.prefill_chunk
        try:
            chunk = adm.ids[:, adm.off:adm.off + C]
            r = chunk.shape[1]
            adm.last_logits = self._run_chunk(_pad_ids(chunk, C), adm.mini,
                                              adm.off, r,
                                              self._lora_one(adm.slot))
            last = adm.off + r >= adm.plen
            adm.off += C
            if monitor.enabled():
                monitor.counter(
                    "paddle_tpu_prefill_chunks_total",
                    "fixed-shape prefill chunks run by chunked "
                    "admissions", ("engine",)).labels(
                    engine=self._monitor_engine).inc()
            if not last:
                return False
            self._install_mini(adm.slot, adm.mini, adm.plen)
            first, tok_done = self._sample_first(adm.slot, adm.plen,
                                                 adm.last_logits, adm.cfg)
            self._install_state(adm.slot, adm.plen, first, tok_done, adm.cfg,
                                adm.ids)
        except BaseException:
            adm.closed = True
            adm.mini = None
            self._abort_admit(adm.slot)
            raise
        adm.closed = True
        adm.mini = None     # the slab goes back to the allocator
        self._init_spec(adm.rid, adm.ids, first, adm.cfg)
        self._register(adm.slot, adm.rid, first, tok_done, adm.cfg, adm.t0)
        return True

    def abort_admit(self, adm: _ChunkedAdmission) -> None:
        """Abandon a chunked admission in flight: the slot and any page
        reservation return to the pool. Idempotent; the admission is
        closed either way."""
        if adm.closed:
            return
        adm.closed = True
        adm.mini = None
        self._abort_admit(adm.slot)

    def _sample_first(self, slot: int, plen: int, last_logits, cfg):
        """The admission's first token from the prompt's last-position
        logits [1, V]: the slot takes the request's sampling parameters,
        and a sampled request draws the token at position ``plen`` from
        its seed's stream. Returns (first token, done flag), on the
        device."""
        self.samp.set(slot, cfg, cfg.seed % 2 ** 32)
        samp = at = None
        if cfg.do_sample:
            samp = self.samp.view(slice(slot, slot + 1))
            at = torch.full((1,), plen, dtype=torch.int64,
                            device=self.device)
        first = sample_rows(last_logits, samp, at)[0]
        tok_done = (first == cfg.eos_token_id
                    if cfg.eos_token_id is not None else False)
        return first, tok_done

    def _install_state(self, slot: int, plen: int, first, tok_done,
                       cfg, ids=None) -> None:
        """The slot's device state for a new request: length, first token,
        flags, eos, draft window, adapter index (the admission's, from the
        stash) and history ring. ``ids`` (the prompt,
        when the caller has it) seeds the ring with the prompt's last
        ``spec_history - 1`` tokens and the first token; a replayed request
        admits ``prompt + generated``, so its ring is rebuilt as its host
        proposer's context is. The program ``cb_admit_state``."""
        self.programs.eager("cb_admit_state", (), self._set_slot_state,
                            slot, plen, first, tok_done, cfg, ids)

    def _set_slot_state(self, slot: int, plen: int, first, tok_done, cfg,
                        ids) -> None:
        self.lens[slot] = plen
        self.last[slot] = first
        self.done_dev[slot] = tok_done
        self.active_dev[slot] = True
        self.eos[slot] = -1 if cfg.eos_token_id is None else cfg.eos_token_id
        self.spec_k[slot] = self._spec_k_for(cfg)
        if self.adapters is not None:
            self.adapter_idx[slot] = self._aidx_stash.get(slot, 0)
        H = self.spec_history
        hrow = np.zeros(H, np.int32)
        hlen = 0
        if ids is not None:
            tail = np.asarray(ids, np.int32).reshape(-1)[-(H - 1):]
            hrow[:len(tail)] = tail
            hlen = len(tail) + 1
        self.hist[slot].copy_(torch.from_numpy(hrow))
        if hlen:
            self.hist[slot, hlen - 1] = first
        self.hist_len[slot] = hlen

    def _init_spec(self, rid: int, ids, first, cfg) -> None:
        """The request's host n-gram proposer (speculating requests only),
        seeded with the prompt and the first token. A replayed request
        admits ``prompt + generated`` as its prompt, so its proposer is
        rebuilt from the whole context (the index is a function of it).
        Runs before ``_register``, so a request retired at once has its
        proposer popped by ``_retire``."""
        k = self._spec_k_for(cfg)
        if k > 0:
            self._spec[rid] = NgramProposer(
                [int(t) for t in np.asarray(ids).reshape(-1)] + [int(first)],
                k, self.ngram_max)

    def _spec_k_for(self, cfg) -> int:
        """The draft window of a request under ``cfg`` (0: plain decode):
        it needs an engine with ``draft_k > 0``, a ``speculative`` opt-in
        and a greedy request. The request's own ``draft_k`` caps the
        engine's, never widens it (the verify width is the engine's)."""
        if not self.draft_k or not cfg.speculative or cfg.do_sample:
            return 0
        return (self.draft_k if cfg.draft_k is None
                else min(cfg.draft_k, self.draft_k))

    def _spec_k_of(self, rid: int) -> int:
        """The draft window of an ACTIVE request (0: plain)."""
        prop = self._spec.get(rid)
        return 0 if prop is None else prop.k

    def _register(self, slot: int, rid: int, first, tok_done, cfg,
                  t0: float) -> int:
        """Host-side tail of an admission: record the request, retire it
        at once when its first token already ends it, count the
        admission (``t0``: when it began). The admission's adapter
        reference moves from the slot to the request (``_retire`` releases
        it)."""
        self._rid_aidx[rid] = self._aidx_stash.pop(slot, 0)
        self._slot_req[slot] = rid
        self._tokens[rid] = [int(first)]     # the admission's one host sync
        self._budget[rid] = cfg.max_new_tokens - 1
        self._cfg[rid] = cfg
        if bool(tok_done) or self._budget[rid] <= 0:
            self._retire(slot)
        if monitor.enabled():
            monitor.histogram(
                "paddle_tpu_kv_admission_seconds",
                "add_request latency: prefill + cache install + slot "
                "state update").observe(time.perf_counter() - t0)
            self._requests_counter().labels(event="admitted").inc()
            # the prompt's first generated token is drawn HERE, not in a
            # decode segment: count it so tokens_total means tokens
            self._tokens_counter().inc()
        return rid

    def _prefill_width(self, plen: int) -> int:
        return _bucket_for(self.prefill_buckets, plen)

    def _count_prefill(self, bucket) -> None:
        if monitor.enabled():
            monitor.counter(
                "paddle_tpu_prefill_requests_total",
                "admission prefills by engine and padded bucket width "
                "('chunked' = chunked admission)",
                ("engine", "bucket")).labels(
                engine=self._monitor_engine, bucket=str(bucket)).inc()

    def _run_prefill(self, ids: np.ndarray, plen: int, mini, lora=None):
        """An admission's one-shot prefill: pad the prompt to its bucket
        and prefill it into the dense ``mini`` cache under ``lora`` (the
        request's adapter), counted per bucket; returns (last-position
        logits [1, V], mini)."""
        width = self._prefill_width(plen)
        self._count_prefill(width if self.prefill_buckets is not None
                            else "exact")
        if trace.enabled():
            # the bucket CHOICE explains a prefill's latency class
            trace.event("engine.prefill", engine=self._monitor_engine,
                        plen=plen, bucket=width)
        return self._prefill_forward(ids, plen, mini, lora)

    def _prefill_forward(self, ids: np.ndarray, plen: int, mini, lora=None):
        """The prefill forward itself (admissions and warmup)."""
        width = self._prefill_width(plen)
        ids_t = torch.tensor(_pad_ids(ids, width), device=self.device)
        with torch.no_grad():
            logits, mini = self.programs.eager(
                "cb_prefill", (width, lora is not None),
                self.model.forward_with_cache, ids_t, mini, 0,
                **_lora_kw(lora))
        self.prefills += 1
        return logits[:, plen - 1], mini

    def _abort_admit(self, slot: int) -> None:
        self._release_adapter(self._aidx_stash.pop(slot, 0))
        heapq.heappush(self._free, slot)

    def _retire(self, slot: int, event: str = "finished") -> None:
        rid = self._slot_req.pop(slot)
        self._finished[rid] = np.asarray(self._tokens.pop(rid), np.int32)
        del self._budget[rid]
        self._cfg.pop(rid, None)
        self._spec.pop(rid, None)
        self._release_adapter(self._rid_aidx.pop(rid, 0))
        self.active_dev[slot] = False
        if self.adapters is not None:
            self.adapter_idx[slot] = 0
        heapq.heappush(self._free, slot)   # lowest free slot admits first
        if monitor.enabled():
            self._requests_counter().labels(event=event).inc()

    def _evict_active(self, rid: int, event: str):
        """The reclaim that cancel and preemption share: retire ``rid``'s
        slot (its capacity back to the pool, the request never in
        ``collect_finished()``) and return its tokens so far (int32), or
        None when ``rid`` is not active."""
        slot = next((s for s, r in self._slot_req.items() if r == rid), None)
        if slot is None:
            return None
        out = np.asarray(self._tokens[rid], np.int32)
        self._retire(slot, event=event)
        self._finished.pop(rid, None)
        return out

    def cancel_request(self, rid: int):
        """Cancel an ACTIVE request between segments: its slot (and pages)
        return to the pool at once and it never appears in
        ``collect_finished()``. Returns its tokens so far, or None when
        ``rid`` is not active."""
        return self._evict_active(rid, "cancelled")

    def grow_for_segment(self, n_steps: int) -> List[int]:
        """Pre-segment capacity hook: grow every live request's cache
        coverage for the coming ``n_steps``-step segment and return the
        request ids that could NOT be covered (the caller preempts victims
        before decoding). Dense slabs and reserved paged pools cover the
        worst case at admission, so here it does nothing; the paged
        engine's optimistic mode overrides it."""
        return []

    def partial_tokens(self, rid: int, start: int = 0):
        """Copy of the tokens generated so far for an ACTIVE request, from
        position ``start`` (the streaming hook: a scheduler passes the
        count it already pushed, so each gap copies one segment's delta),
        or None when ``rid`` is not active. Host lists only."""
        toks = self._tokens.get(rid)
        return None if toks is None else list(toks[start:])

    # -- monitor instruments (the reference's names and help) ---------------
    @staticmethod
    def _requests_counter():
        return monitor.counter(
            "paddle_tpu_requests_total",
            "serving requests by lifecycle event", ("event",))

    @staticmethod
    def _tokens_counter():
        return monitor.counter(
            "paddle_tpu_generated_tokens_total",
            "tokens generated by the continuous-batching engines "
            "(admission first-token + decode segments)")

    @staticmethod
    def _spec_tokens_counter():
        return monitor.counter(
            "paddle_tpu_spec_draft_tokens_total",
            "speculative-decode draft tokens by engine and outcome "
            "(proposed = host n-gram drafts sent to verification; "
            "accepted = drafts the model's own greedy continuation "
            "confirmed — acceptance rate is accepted/proposed)",
            ("engine", "outcome"))

    @staticmethod
    def _tokens_per_sec_gauge():
        return monitor.gauge(
            "paddle_tpu_decode_tokens_per_sec",
            "emitted tokens / wall time of the latest decode "
            "segment (includes host collect), per engine", ("engine",))

    def close(self) -> None:
        """Retire this engine's per-instance monitor series and program
        ledger rows (idempotent; a dropped engine must not export its last
        tokens/sec forever)."""
        self._tokens_per_sec_gauge().remove(engine=self._monitor_engine)
        for name in ("paddle_tpu_prefill_requests_total",
                     "paddle_tpu_prefill_chunks_total",
                     "paddle_tpu_prefill_warmup_seconds",
                     "paddle_tpu_spec_draft_tokens_total"):
            monitor.remove_series(name, engine=self._monitor_engine)
        # the program ledger's rows this engine owned, and their
        # {program=...} series
        ledger.release(self._monitor_engine)
        alloc = getattr(self, "alloc", None)
        if alloc is not None:
            alloc.close()
        if self.adapters is not None:
            self.adapters.close()

    def collect_finished(self) -> Dict[int, np.ndarray]:
        out, self._finished = self._finished, {}
        return out

    # -- decode ---------------------------------------------------------------
    def _segment(self, n_steps: int, out: torch.Tensor,
                 sampled: bool = False) -> None:
        """``n_steps`` decode steps over every slot: the segment's program,
        greedy, or with each slot's sampling vectors when ``sampled`` (a
        greedy slot still takes the argmax). Reads and writes the static
        slot state; writes each step's tokens into ``out[:, :n_steps]`` and
        the done flags into ``out[:, n_steps]``."""
        last, lens, done = self.last, self.lens, self.done_dev
        samp = self.samp if sampled else None
        for i in range(n_steps):
            live = self.active_dev & ~done & (lens < self.max_len)
            logits = self._fwd_decode(last[:, None], lens, live)
            # the drawn token sits at position lens + 1 (last is at lens)
            nxt = torch.where(live, sample_rows(logits[:, 0], samp, lens + 1),
                              last)
            lens = lens + live.to(torch.int32)
            done = (done | (live & (self.eos >= 0) & (nxt == self.eos))
                    | (lens >= self.max_len))
            out[:, i] = nxt
            last = nxt
        out[:, n_steps] = done
        self.last.copy_(last)
        self.lens.copy_(lens)
        self.done_dev.copy_(done)

    @staticmethod
    def _segment_key(n_steps: int, sampled: bool):
        return ("segment", n_steps, "sampled") if sampled \
            else ("segment", n_steps)

    def _run_segment(self, n_steps: int,
                     sampled: bool = False) -> torch.Tensor:
        """Run the segment program of ``n_steps`` (replay, or run and
        capture), greedy or sampled; returns its output buffer (shared by
        the two programs of a length)."""
        out = self._seg_out.get(n_steps)
        if out is None:
            out = self._seg_out[n_steps] = torch.zeros(
                (self.max_batch, n_steps + 1), dtype=torch.int32,
                device=self.device)
        self._prepare_segment()
        with torch.no_grad():
            self.programs.run(self._segment_key(n_steps, sampled),
                              lambda: self._segment(n_steps, out, sampled))
        return out

    def _prepare_segment(self) -> None:
        """What the gap owes the device before a decode program runs
        (nothing here; the paged engine floors fresh pages' scales and
        refreshes the device page table)."""

    def _any_sampled(self) -> bool:
        return any(self._cfg[rid].do_sample
                   for rid in self._slot_req.values())

    def _publish_segment(self, t0: float, emitted: int) -> float:
        """The segment log and the tokens series, after a segment that
        emitted ``emitted`` tokens; returns its seconds."""
        dt = time.perf_counter() - t0
        self._segment_log.append((dt, emitted))
        if monitor.enabled():
            self._tokens_counter().inc(emitted)
            self._tokens_per_sec_gauge().labels(
                engine=self._monitor_engine).set(
                emitted / dt if dt > 0 else 0.0)
        return dt

    # -- speculative decoding (a per-slot capability) -------------------------
    def _fwd_spec(self, inp, lens, live):
        """The W-token verify forward at per-row offsets (cache layout
        hook; the paged engine reads and writes its pools): (logits [B, W,
        V], aux), aux None here, since a dense cache stores exact values and
        a rejected row is plain garbage a later write replaces."""
        logits, _ = self.model.forward_decode_spec(inp, self.caches, lens,
                                                   live, **self._lora())
        return logits, None

    def _commit_spec_rows(self, aux, n_acc) -> None:
        """After acceptance, on int8 pools: restore each layer's
        pre-window snapshot (the touched pages and both scale tables) and
        REPLAY only the accepted rows (``i < n_acc[b]``) one window
        position at a time through the running-absmax store, so the pools
        and scales are byte for byte what one-token steps storing the
        accepted tokens would leave (the same scale growths, the same
        re-quantizations): a rejected draft's absmax never stays in a
        page's monotonic scale. Every write is in place; a row past
        ``n_acc`` is aimed at the sink page. Nothing to do without aux."""
        if aux is None or not any(a is not None for a in aux):
            return
        for (kp, vp, ks, vs), (snap_k, snap_v, snap_ks, snap_vs, kh, vh,
                               page, offs) in zip(self.caches, aux):
            flat = page.reshape(-1)
            # duplicate pages in the snapshot hold the same pre-store
            # bytes, so their copies back agree
            kp.index_copy_(0, flat, snap_k)
            vp.index_copy_(0, flat, snap_v)
            ks.copy_(snap_ks)
            vs.copy_(snap_vs)
            sink = kp.shape[0] - 1
            for i in range(page.shape[1]):
                pg = torch.where(i < n_acc, page[:, i],
                                 torch.full_like(page[:, i], sink))
                quant_store_rows(kp, ks, pg, offs[:, i], kh[:, i])
                quant_store_rows(vp, vs, pg, offs[:, i], vh[:, i])

    def _accept(self, logits, drafts, lens, live, lim, sampled: bool):
        """Acceptance of one verify step: the window's tokens [B, W] (the
        model's own picks: position 0 greedy, or drawn for a sampled row at
        position ``lens + 1``, the rest greedy) and how many of them each
        row keeps, ``n_acc`` [B] int32: the leading draft/greedy matches
        capped at the row's ``spec_k`` (0 for plain and sampled rows: one
        token), plus one, capped by ``lim - lens`` (the row's absolute
        limit: budget, page coverage, max_len, so every kept token has its
        K/V written), and 0 for a dead row. Masks only, so one program
        serves every acceptance pattern."""
        k = drafts.shape[1]
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)     # [B, W]
        g0 = (sample_rows(logits[:, 0], self.samp, lens + 1) if sampled
              else greedy[:, 0])
        toks = torch.cat([g0[:, None], greedy[:, 1:]], dim=1)
        iw = torch.arange(k, device=lens.device)[None]
        match = (drafts == greedy[:, :k]) & (iw < self.spec_k[:, None])
        m = torch.cumprod(match.to(torch.int32), dim=1).sum(1)
        n_acc = torch.minimum(m + 1, (lim - lens).clamp(min=0))
        n_acc = torch.where(live, n_acc, torch.zeros_like(n_acc))
        return toks, n_acc.to(torch.int32)

    @staticmethod
    def _advance(toks, n_acc, last):
        """Each row's new last token: its last accepted one (``last`` where
        it accepted none)."""
        at = (n_acc.long() - 1).clamp(min=0)[:, None]
        return torch.where(n_acc > 0, toks.gather(1, at)[:, 0], last)

    def _spec_scratch(self, name: str, shape, dtype) -> torch.Tensor:
        """A buffer of the spec programs, allocated once per (name, shape)
        and written in place (a captured program holds its address)."""
        key = (name, tuple(shape))
        buf = self._spec_buf.get(key)
        if buf is None:
            buf = self._spec_buf[key] = torch.zeros(
                shape, dtype=dtype, device=self.device)
        return buf

    @staticmethod
    def _spec_key(k: int, sampled: bool):
        return ("spec_step", k, "sampled") if sampled else ("spec_step", k)

    def _spec_device_key(self, n_steps: int, sampled: bool):
        key = ("spec_device", n_steps, self.draft_k, self.spec_draft)
        return key + ("sampled",) if sampled else key

    def _spec_step(self, sampled: bool) -> None:
        """One host-mode verify step over every slot (the program of key
        ``("spec_step", draft_k)``, or its sampled twin): each row's window
        ``[last, drafts]`` at its own offset, acceptance, the int8 commit,
        then ``last`` and ``lens`` advanced in place. Reads the drafts,
        liveness and limits the host wrote into its input buffers; writes
        the window's tokens and ``n_acc`` into its output buffer [B, W +
        1], the step's one read."""
        mb, k = self.max_batch, self.draft_k
        drafts = self._spec_scratch("drafts", (mb, k), torch.int32)
        live_in = self._spec_scratch("live", (mb,), torch.bool)
        lim = self._spec_scratch("lim", (mb,), torch.int32)
        out = self._spec_scratch("step_out", (mb, k + 2), torch.int32)
        last, lens = self.last, self.lens
        live = live_in & self.active_dev & (lens < self.max_len)
        logits, aux = self._fwd_spec(torch.cat([last[:, None], drafts], 1),
                                     lens, live)
        toks, n_acc = self._accept(logits, drafts, lens, live, lim, sampled)
        self._commit_spec_rows(aux, n_acc)
        out[:, :k + 1] = toks
        out[:, k + 1] = n_acc
        last.copy_(self._advance(toks, n_acc, last))
        lens.add_(n_acc)

    def _run_spec_step(self, sampled: bool) -> torch.Tensor:
        with torch.no_grad():
            self.programs.run(self._spec_key(self.draft_k, sampled),
                              lambda: self._spec_step(sampled))
        self.verify_steps += 1
        return self._spec_scratch("step_out",
                                  (self.max_batch, self.draft_k + 2),
                                  torch.int32)

    def _spec_segment(self, n_steps: int, sampled: bool) -> None:
        """``n_steps`` device-mode verify steps in one program (key
        ``("spec_device", n_steps, draft_k, spec_draft)``, or its sampled
        twin): propose from the history ring (``spec_draft="ngram"``; with
        ``"self"`` the ring drafts the first step and each later step
        drafts the previous verify's greedy tokens past the accepted
        prefix), verify, accept, truncate at the first accepted eos,
        commit, append the accepted tokens to the ring, all as masks and
        gathers, with the budget and coverage caps read from the buffers
        the host filled (``bud``, ``cov``: page growth happens only in the
        gap, so coverage is fixed over a segment). Writes per step the
        window's tokens, ``n_acc`` and liveness, and at the end the done
        flags, into one output buffer [n_steps + 1, B, W + 2]: the
        segment's one read."""
        mb, k, H = self.max_batch, self.draft_k, self.spec_history
        W, n_max = k + 1, self.ngram_max
        dev = self.device
        bud = self._spec_scratch("bud", (mb,), torch.int32)
        cov = self._spec_scratch("cov", (mb,), torch.int32)
        out = self._spec_scratch(f"seg_out_{n_steps}", (n_steps + 1, mb,
                                                        W + 2), torch.int32)
        self_draft = self.spec_draft == "self"
        last, lens, done = self.last, self.lens, self.done_dev
        hist, hl = self.hist, self.hist_len
        iw = torch.arange(k, device=dev)[None]
        jw = torch.arange(W, device=dev)[None]
        jh = torch.arange(H, device=dev)[None]
        emitted = torch.zeros_like(lens)
        drafts = (propose_device(hist, hl, k, n_max) if self_draft
                  else torch.zeros((mb, k), dtype=torch.int32, device=dev))
        for s in range(n_steps):
            live = (self.active_dev & ~done & (lens < self.max_len)
                    & (emitted < bud))
            if not self_draft:
                drafts = propose_device(hist, hl, k, n_max)
            logits, aux = self._fwd_spec(
                torch.cat([last[:, None], drafts], 1), lens, live)
            lim = torch.minimum(lens + (bud - emitted).clamp(min=0), cov)
            toks, n_acc = self._accept(logits, drafts, lens, live, lim,
                                       sampled)
            # eos inside the accepted window: keep up to the FIRST one and
            # freeze the row
            hit = ((self.eos[:, None] >= 0) & (toks == self.eos[:, None])
                   & (jw < n_acc[:, None]))
            any_hit = hit.any(dim=1)
            first_hit = torch.argmax(hit.to(torch.int32), dim=1) + 1
            n_acc = torch.where(any_hit, first_hit.to(torch.int32), n_acc)
            done = done | any_hit
            self._commit_spec_rows(aux, n_acc)
            last = self._advance(toks, n_acc, last)
            lens = lens + n_acc
            done = done | (lens >= self.max_len)
            emitted = emitted + n_acc
            # the ring takes each row's n_acc tokens at hl: a scatter into
            # a widened row (a rejected column lands on the sink column H +
            # W), then a per-row shift keeps the last H
            cols = torch.where(jw < n_acc[:, None], hl[:, None].long() + jw,
                               torch.full_like(jw, H + W))
            ext = torch.cat([hist, torch.zeros((mb, W + 1), dtype=hist.dtype,
                                               device=dev)], dim=1)
            ext.scatter_(1, cols, toks)
            shift = (hl + n_acc - H).clamp(min=0)
            hist = ext.gather(1, jh + shift[:, None].long())
            hl = torch.minimum(hl + n_acc, torch.full_like(hl, H))
            if self_draft:
                nxt = toks.gather(1, (n_acc[:, None].long() + iw).clamp(0, k))
                drafts = torch.where(live[:, None], nxt, drafts)
            out[s, :, :W] = toks
            out[s, :, W] = n_acc
            out[s, :, W + 1] = live.to(torch.int32)
        out[n_steps] = 0
        out[n_steps, :, 0] = done.to(torch.int32)
        for dst, src in ((self.last, last), (self.lens, lens),
                         (self.done_dev, done), (self.hist, hist),
                         (self.hist_len, hl)):
            dst.copy_(src)

    def _decode_segment_spec(self, n_steps: int) -> int:
        """A host-mode speculative segment: up to ``n_steps`` replays of
        the verify step, the host between them proposing each speculating
        slot's drafts from its proposer, reading acceptance back (one read a
        step, ``spec_stats()["host_syncs"]``) and cutting at the budget and
        at eos as the plain collection does. Plain and sampled slots ride
        along at one token a step, so a mixed batch runs one program."""
        t0 = time.perf_counter()
        k, mb = self.draft_k, self.max_batch
        sampled = self._any_sampled()
        self._prepare_segment()
        # one read of (lens, done) a segment; lens is then tracked here
        both = torch.stack([self.lens, self.done_dev.to(torch.int32)])
        lens_h, done_h = both.cpu().numpy()
        lens_h = lens_h.astype(np.int64)
        emitted = {rid: [] for rid in self._slot_req.values()}
        finished = set()
        forwards = proposed = accepted = slot_steps = 0
        bufs = [self._spec_scratch(n, shape, dt) for n, shape, dt in (
            ("drafts", (mb, k), torch.int32), ("live", (mb,), torch.bool),
            ("lim", (mb,), torch.int32))]
        for _ in range(n_steps):
            drafts = np.zeros((mb, k), np.int32)
            live = np.zeros(mb, bool)
            lim = np.zeros(mb, np.int32)
            for slot, rid in self._slot_req.items():
                if rid in finished or done_h[slot]:
                    continue
                rem = self._budget[rid] - len(emitted[rid])
                if rem <= 0 or lens_h[slot] >= self.max_len:
                    continue
                live[slot] = True
                lim[slot] = min(lens_h[slot] + rem,
                                self._coverage_limit(slot), self.max_len)
                prop = self._spec.get(rid)
                if prop is not None:
                    d = prop.propose()
                    drafts[slot, :len(d)] = d
                    proposed += prop.k
            if not live.any():
                break
            slot_steps += int(live.sum())
            for buf, a in zip(bufs, (drafts, live, lim)):
                buf.copy_(torch.from_numpy(a))
            host = self._run_spec_step(sampled).cpu().numpy()
            forwards += 1
            for slot, rid in self._slot_req.items():
                if not live[slot]:
                    continue
                na = int(host[slot, k + 1])
                lens_h[slot] += na
                seq = host[slot, :na].tolist()
                eos = self._cfg[rid].eos_token_id
                if eos is not None and eos in seq:
                    # eos inside the accepted window: cut there and finish
                    # (the device rows past it die with the slot)
                    seq = seq[:seq.index(eos) + 1]
                    finished.add(rid)
                emitted[rid].extend(seq)
                prop = self._spec.get(rid)
                if prop is not None:
                    prop.extend(seq)
                    acc = max(len(seq) - 1, 0)
                    prop.accepted += acc
                    accepted += acc
        total = 0
        for slot, rid in list(self._slot_req.items()):
            seq = emitted.get(rid, [])
            self._tokens[rid].extend(seq)
            self._budget[rid] -= len(seq)
            total += len(seq)
            if self._budget[rid] <= 0 or rid in finished or done_h[slot]:
                self._retire(slot)
        self._close_spec_segment(t0, "host", n_steps, forwards, proposed,
                                 accepted, slot_steps, total, forwards)
        return len(self._slot_req)

    def _decode_segment_spec_device(self, n_steps: int) -> int:
        """A device-mode speculative segment: ONE replay of the segment's
        program, then ONE read of its packed output (no per-step host
        read: ``host_syncs`` stays 0). The budget and coverage caps go to
        the device as two vectors from host bookkeeping, and the
        segment's accounting is derived from the packed per-step tallies,
        so ``emitted == slot_steps + accepted`` holds in both modes."""
        t0 = time.perf_counter()
        mb, W = self.max_batch, self.draft_k + 1
        sampled = self._any_sampled()
        self._prepare_segment()
        bud = np.zeros(mb, np.int32)
        cov = np.zeros(mb, np.int32)
        for slot, rid in self._slot_req.items():
            bud[slot] = max(self._budget[rid], 0)
            cov[slot] = min(self._coverage_limit(slot), self.max_len)
        for name, a in (("bud", bud), ("cov", cov)):
            self._spec_scratch(name, (mb,), torch.int32).copy_(
                torch.from_numpy(a))
        with torch.no_grad():
            self.programs.run(self._spec_device_key(n_steps, sampled),
                              lambda: self._spec_segment(n_steps, sampled))
        self.verify_steps += n_steps
        seg = self._spec_scratch(f"seg_out_{n_steps}", (n_steps + 1, mb,
                                                        W + 2), torch.int32)
        seg = seg.cpu().numpy()             # the segment's one read
        done_h = seg[-1, :, 0].astype(bool)
        total = proposed = accepted = slot_steps = 0
        steps_live = np.zeros(n_steps, bool)
        for slot, rid in list(self._slot_req.items()):
            live_s = seg[:n_steps, slot, W + 1].astype(bool)
            sk = self._spec_k_of(rid)
            seq = []
            for s in np.flatnonzero(live_s):
                steps_live[s] = True
                slot_steps += 1
                proposed += sk
                na = int(seg[s, slot, W])
                seq.extend(int(t) for t in seg[s, slot, :na])
                accepted += max(na - 1, 0)
            self._tokens[rid].extend(seq)
            self._budget[rid] -= len(seq)
            total += len(seq)
            if self._budget[rid] <= 0 or done_h[slot]:
                self._retire(slot)
        # forwards: verify steps that served a live row (the trailing
        # all-dead steps of the program are masked no-ops)
        self._close_spec_segment(t0, "device", n_steps,
                                 int(steps_live.sum()), proposed, accepted,
                                 slot_steps, total, 0)
        return len(self._slot_req)

    def _close_spec_segment(self, t0, mode, n_steps, forwards, proposed,
                            accepted, slot_steps, total, host_syncs) -> None:
        """A spec segment's accounting, series and trace event."""
        for key, n in (("proposed", proposed), ("accepted", accepted),
                       ("forwards", forwards), ("slot_steps", slot_steps),
                       ("emitted", total), ("host_syncs", host_syncs)):
            self._spec_totals[key] += n
        dt = self._publish_segment(t0, total)
        if monitor.enabled() and proposed:
            c = self._spec_tokens_counter()
            c.labels(engine=self._monitor_engine,
                     outcome="proposed").inc(proposed)
            # inc(0) still creates the series: the rate stays derivable
            c.labels(engine=self._monitor_engine,
                     outcome="accepted").inc(accepted)
        if trace.enabled():
            trace.record("engine.spec_segment", dur_ns=int(dt * 1e9),
                         engine=self._monitor_engine, mode=mode,
                         steps=n_steps, forwards=forwards, proposed=proposed,
                         accepted=accepted, emitted=total,
                         host_syncs=host_syncs)

    def spec_stats(self) -> dict:
        """Engine-lifetime speculative-decoding accounting, host-side:
        ``proposed`` / ``accepted`` draft tokens, verify ``forwards``,
        ``slot_steps`` (slot participations), ``emitted`` (the spec
        segments' tokens; ``emitted == slot_steps + accepted``),
        ``host_syncs`` (host mode's one read a verify step; 0 in device
        mode), and the derived ``acceptance_rate``, ``tokens_per_forward``
        (per slot: ``emitted / slot_steps``, 1.0 is the plain cadence) and
        ``host_syncs_per_token``. ``reset_state()`` keeps them."""
        t = dict(self._spec_totals)
        t["acceptance_rate"] = (t["accepted"] / t["proposed"]
                                if t["proposed"] else 0.0)
        t["tokens_per_forward"] = (t["emitted"] / t["slot_steps"]
                                   if t["slot_steps"] else 0.0)
        t["host_syncs_per_token"] = (t["host_syncs"] / t["emitted"]
                                     if t["emitted"] else 0.0)
        return t

    def _coverage_limit(self, slot: int) -> int:
        """The absolute position up to which ``slot``'s cache writes land
        (a dense slab: all of it; the paged engine: the mapped pages): the
        spec step's acceptance cap, so a window past the coverage keeps
        fewer tokens, never tokens whose K/V was dropped."""
        return self.max_len

    def decode_segment(self, n_steps: int) -> int:
        """Run ``n_steps`` decode steps over every slot, collect each
        request's tokens and retire finished requests. Each request decodes
        under its own config; the sampled program runs only when a live
        request samples. While a live request speculates, the whole batch
        rides the spec programs instead (plain and sampled rows at one
        token a step): ``n_steps`` verify steps, fused into one program in
        ``spec_mode="device"``. Returns the number of requests still
        active."""
        if not self._slot_req:
            return 0
        if self._spec:
            if self.spec_mode == "device":
                return self._decode_segment_spec_device(n_steps)
            return self._decode_segment_spec(n_steps)
        n_live = len(self._slot_req)
        t0 = time.perf_counter()
        out = self._run_segment(n_steps, self._any_sampled())
        self.decode_steps += n_steps
        host = out.cpu().numpy()     # the segment's one device -> host read
        toks_h, done_h = host[:, :n_steps], host[:, n_steps].astype(bool)
        emitted = 0
        for slot, rid in list(self._slot_req.items()):
            rcfg = self._cfg[rid]
            take = min(self._budget[rid], n_steps)
            seq = toks_h[slot, :take].tolist()
            if rcfg.eos_token_id is not None and rcfg.eos_token_id in seq:
                seq = seq[:seq.index(rcfg.eos_token_id) + 1]
            self._tokens[rid].extend(int(t) for t in seq)
            self._budget[rid] -= len(seq)
            emitted += len(seq)
            if self._budget[rid] <= 0 or done_h[slot] or len(seq) < take:
                self._retire(slot)
        dt = self._publish_segment(t0, emitted)
        if trace.enabled():
            trace.record("engine.segment", dur_ns=int(dt * 1e9),
                         engine=self._monitor_engine, steps=n_steps,
                         active=n_live, emitted=emitted)
        return len(self._slot_req)

    def warmup(self, segment_steps: Optional[int] = None) -> Dict[str, float]:
        """Run every program a request can reach ahead of the requests, on
        an idle engine: the slot-state install; when ``segment_steps`` is
        given, the segment of that length, greedy and sampled, each
        captured (with every slot inactive it changes nothing); the
        speculative programs the knobs select (``draft_k > 0``: host mode's
        verify step, or device mode's segment of ``segment_steps``, greedy
        and sampled); one prefill per bucket and, with ``prefill_chunk``,
        one chunk (cuBLAS's and the kernels' first use at each width;
        prefill is not captured); with adapters, the bank's row install
        (``lora_install``: a zero write into base row 0). A serve with that
        segment length then captures nothing, whatever its configs and
        adapters. Returns ``{program: seconds}``. Raises RuntimeError on a
        busy engine."""
        if self._slot_req:
            raise RuntimeError("warmup() needs an idle engine")
        t_all = time.perf_counter()
        out = {}
        t0 = time.perf_counter()
        self._install_state(0, 0, torch.zeros((), dtype=torch.int32,
                                              device=self.device),
                            False, GenerationConfig(max_new_tokens=1))
        self.active_dev[0] = False
        out["admit_state"] = time.perf_counter() - t0
        # the captures first: they empty PyTorch's allocator cache, which
        # the prefills then fill for the requests to reuse
        for sampled in (False, True):
            tag = "_sampled" if sampled else ""
            if segment_steps is not None:
                t0 = time.perf_counter()
                self._run_segment(segment_steps, sampled)
                out[f"segment_{segment_steps}{tag}"] = \
                    time.perf_counter() - t0
            # the spec programs the knobs select: with every slot inactive
            # nothing is accepted and every write is dropped
            if self.draft_k and self.spec_mode == "host":
                t0 = time.perf_counter()
                self._prepare_segment()
                self._spec_scratch("live", (self.max_batch,),
                                   torch.bool).zero_()
                self._run_spec_step(sampled)
                out[f"spec_step_{self.draft_k}{tag}"] = \
                    time.perf_counter() - t0
            if (self.draft_k and self.spec_mode == "device"
                    and segment_steps is not None):
                t0 = time.perf_counter()
                self._prepare_segment()
                with torch.no_grad():
                    self.programs.run(
                        self._spec_device_key(segment_steps, sampled),
                        lambda: self._spec_segment(segment_steps, sampled))
                self.verify_steps += segment_steps
                out[f"spec_segment_{segment_steps}{tag}"] = \
                    time.perf_counter() - t0
        for w in self.prefill_buckets or ():
            t0 = time.perf_counter()
            self._warm_prefill(w)
            out[f"prefill_{w}"] = time.perf_counter() - t0
        if self.prefill_chunk is not None:
            # one chunk into a throwaway mini: the chunk program's first use
            t0 = time.perf_counter()
            self._run_chunk(np.zeros((1, self.prefill_chunk), np.int32),
                            self.model.init_cache(1, self.max_len), 0, 1,
                            self._lora_one(0))
            out["prefill_chunk"] = time.perf_counter() - t0
        if self.adapters is not None:
            t0 = time.perf_counter()
            self.adapters.warmup()
            out["lora_install"] = time.perf_counter() - t0
        out.update(self._warmup_prefix())
        if self.device.type == "cuda":
            # this thread's stream only: another replica in the process may
            # be capturing a graph, which a device-wide sync would break
            torch.cuda.current_stream(self.device).synchronize()
        out["total"] = time.perf_counter() - t_all
        if monitor.enabled():
            monitor.gauge(
                "paddle_tpu_prefill_warmup_seconds",
                "wall seconds engine.warmup() spent pre-compiling the "
                "serving-path programs", ("engine",)).labels(
                engine=self._monitor_engine).set(out["total"])
        return out

    def _warmup_prefix(self) -> Dict[str, float]:
        """Warmup's prefix-cache programs (the paged engine with
        ``prefix_cache=True``); nothing here."""
        return {}

    def serve(self, prompts, cfg=None,
              segment_steps: int = 8) -> List[np.ndarray]:
        """Continuous-batching loop: admits requests as slots (and pages)
        free up, decoding in fixed segments. ``cfg`` is one
        :class:`GenerationConfig` for every prompt, or a sequence of one
        per prompt (greedy and sampled requests may mix). Returns the
        generated ids (prompt not included) in submission order.

        Under an optimistic paged engine each gap grows the live mappings
        and, when the pool is dry, preempts the YOUNGEST of this call's
        requests (never the oldest: forward progress) and queues its
        ``prompt + generated`` again with the budget reduced, so a tight
        pool degrades to lower concurrency (a greedy resume is the
        unpreempted stream). Only a request the pool cannot hold even
        alone raises :class:`PagePoolExhausted`.

        Afterwards ``serve_stats`` holds ``ttft_s`` and ``finish_s`` (per
        prompt: seconds from the call to its first token, and to the
        segment gap that collected its last one), ``decode_s`` and
        ``decode_tokens`` (wall time of the decode segments and the tokens
        they emitted), ``segments``, ``preemptions`` and ``wall_s``."""
        cfgs = (list(cfg) if isinstance(cfg, (list, tuple))
                else [cfg or GenerationConfig()] * len(prompts))
        if len(cfgs) != len(prompts):
            raise ValueError(f"{len(cfgs)} configs for {len(prompts)} "
                             f"prompts")
        t0 = time.perf_counter()
        self._segment_log = []
        pending = list(enumerate(prompts))
        replay_cfg: Dict[int, GenerationConfig] = {}  # budget reduced
        prefix: Dict[int, list] = {}   # tokens emitted before a preemption
        order: Dict[int, int] = {}
        first_at: Dict[int, float] = {}
        done_at: Dict[int, float] = {}
        results: Dict[int, np.ndarray] = {}
        foreign: Dict[int, np.ndarray] = {}   # admitted outside this call
        preempted = 0
        while len(results) < len(prompts):
            while pending and self._free:
                idx0, p0 = pending[0]
                if (not self._can_admit(_prompt_len(p0),
                                        replay_cfg.get(idx0, cfgs[idx0]))
                        and self._slot_req):
                    break  # transient: defer to the next segment gap
                # (with nothing active to drain, a request that does not
                # fit can NEVER fit: add_request raises its loud error)
                idx, p = pending.pop(0)
                order[self.add_request(
                    p, replay_cfg.get(idx, cfgs[idx]))] = idx
                first_at.setdefault(idx, time.perf_counter())
            # the gap's memory-pressure relief (see the docstring)
            while True:
                short = self.grow_for_segment(segment_steps)
                if not short:
                    break
                ours = sorted(r for r in self._slot_req.values()
                              if r in order)
                if len(ours) < 2:
                    # the oldest survivor alone, or a foreign row this call
                    # must not touch: decode_segment raises if it stays
                    # short
                    break
                toks = self.preempt_request(ours[-1])     # the youngest
                preempted += 1
                idx = order.pop(ours[-1])
                pre = prefix.pop(idx, []) + [int(t) for t in toks]
                # the budget is measured against the ORIGINAL config:
                # ``pre`` is the whole history, so a replay config's
                # already reduced budget would count the first prefix twice
                c0 = cfgs[idx]
                remaining = c0.max_new_tokens - len(pre)
                if remaining < 1 or (c0.eos_token_id is not None and pre
                                     and pre[-1] == c0.eos_token_id):
                    results[idx] = np.asarray(pre, np.int32)
                    done_at[idx] = time.perf_counter()
                    continue
                prefix[idx] = pre
                kw = dict(vars(c0))
                kw["max_new_tokens"] = remaining
                replay_cfg[idx] = GenerationConfig(**kw)
                # replays admit before new work: they held pages when the
                # pressure hit
                pending.insert(0, (idx, np.concatenate(
                    [_prompt_ids(prompts[idx])[0],
                     np.asarray(pre, np.int32)])))
            self.decode_segment(segment_steps)
            now = time.perf_counter()
            for rid, seq in self.collect_finished().items():
                if rid in order:
                    idx = order.pop(rid)
                    pre = prefix.pop(idx, None)
                    results[idx] = seq if pre is None else np.concatenate(
                        [np.asarray(pre, np.int32), seq])
                    done_at[idx] = now
                else:
                    foreign[rid] = seq
        self._finished.update(foreign)
        self.serve_stats = {
            "ttft_s": [first_at[i] - t0 for i in range(len(prompts))],
            "finish_s": [done_at[i] - t0 for i in range(len(prompts))],
            "decode_s": sum(s for s, _ in self._segment_log),
            "decode_tokens": sum(n for _, n in self._segment_log),
            "segments": len(self._segment_log),
            "preemptions": preempted,
            "wall_s": time.perf_counter() - t0,
        }
        return [results[i] for i in range(len(prompts))]


class PagedContinuousBatchingEngine(ContinuousBatchingEngine):
    """ContinuousBatchingEngine over a PAGED KV pool: cache slots are
    page-table rows into shared per-layer pools, so the pools hold
    ``num_pages * page_size`` tokens in flight in all, not
    ``max_batch * max_len``, and any free page serves any slot.

    Two ``admission_mode`` policies (a plain attribute; the ``Server``
    sets it on an idle engine):

    - ``"reserved"`` (default): a request reserves its worst case (prompt
      + max_new_tokens, capped at max_len) up front, so a running request
      can never exhaust the pool mid-decode;
    - ``"optimistic"``: admission claims the prompt plus ONE page of
      headroom, and :meth:`grow_for_segment` grows each live slot per gap
      (capped by the request's remaining budget). When growth cannot be
      satisfied the caller relieves the pressure: :meth:`preempt_request`
      reclaims a victim's slot and pages like ``cancel_request`` and
      returns its tokens for a replay. ``decode_segment`` raises
      :class:`PagePoolExhausted` if the pressure was left unhandled, never
      a silently dropped write. ``kv_watermark`` (a fraction of the pool)
      pauses NEW admissions while the pool is crowded, so preemption is
      the fallback, not the steady state.

    ``prefix_cache=True`` turns on automatic prefix caching
    (``inference/paged_cache.py``): admission hashes the prompt in
    page_size-token blocks, maps resident blocks READ-ONLY into the new
    slot's row and prefills only the uncached tail, at a device offset
    through K3's prefix-chunk instance over the gathered cached KV; the
    first write into a shared page (a suffix that diverges mid-block, or
    decode appending into a partial shared tail page) goes through
    copy-on-write in the gap. Retirement releases references; released
    cached pages park in an LRU the pool reclaims on demand. A warm greedy
    admission gives the cold stream: the gathered prefix is the KV the
    first prefill wrote, and the tail rides the offset program that
    chunked admission already holds equal to one-shot prefill.
    ``prefix_pause`` (a host bool, the serving control plane's brownout
    rung 4) sends new admissions down the cold path.

    The page table lives on the host (numpy); a device copy, allocated
    once, is refreshed by a synchronous copy before every install and
    every segment, and the pools are only ever written in place (a
    captured segment holds their addresses). ``debug_pages=True`` runs the
    allocator's ``check()`` after every page operation and at every
    segment, plus a coverage check of every live slot.

    ``kv_dtype="int8"`` stores int8 pages with per-(page, kv head) fp32
    running-absmax scales (``quantization/kv.py``): installs and decode
    steps quantize on store, K4 dequantizes inside the kernel, freshly
    claimed pages' scales are reset to the floor in the gap before any
    write, and a copy-on-write copies the scales with the rows.
    :meth:`set_kv_dtype` swaps it on an idle engine; :meth:`kv_page_cost`
    prices a page.

    A chunked admission (``prefill_chunk``) claims its pages at
    :meth:`begin_admit` (with the prefix cache: maps the cached pages and
    copies the partial shared page then), fills a dense ``max_len`` mini
    cache chunk by chunk and installs it with the final chunk;
    :meth:`abort_admit` releases the claim."""

    def __init__(self, model, max_batch: int, num_pages: int,
                 page_size: int, max_pages: int, prefill_buckets="auto",
                 debug_pages: bool = False, kv_dtype: str = "bf16",
                 prefill_chunk: Optional[int] = None,
                 admission_mode: str = "reserved",
                 kv_watermark: float = 0.9, prefix_cache: bool = False,
                 draft_k: int = 0, ngram_max: int = 3,
                 spec_mode: str = "host", spec_draft: str = "ngram",
                 spec_history: int = 128, lora_capacity: int = 0,
                 lora_rank: int = 8, lora_targets=("q", "k", "v", "o")):
        if admission_mode not in ADMISSION_MODES:
            raise ValueError(
                f"admission_mode must be one of {ADMISSION_MODES}, got "
                f"{admission_mode!r}")
        if not (isinstance(kv_watermark, (int, float))
                and 0 < kv_watermark <= 1):
            raise ValueError(
                f"kv_watermark must satisfy 0 < w <= 1 (fraction of the "
                f"page pool), got {kv_watermark!r}")
        if kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}")
        self.admission_mode = admission_mode
        self.kv_watermark = float(kv_watermark)
        self.prefix_cache = bool(prefix_cache)
        self.prefix_pause = False
        self.num_pages = num_pages
        self.page_size = page_size
        self.kv_dtype = kv_dtype
        # slot -> warm-admission record ({"ids", "c_map", "hashes",
        # "saved", "salt"}), staged between an admission's prefill and its
        # install
        self._prefix_stash: Dict[int, dict] = {}
        # the segment length a clean grow_for_segment covered:
        # decode_segment consumes it and skips its re-check
        self._growth_stamp: Optional[int] = None
        # the gap's one host copy of (lens, done), shared by every
        # grow_for_segment call of the gap; a segment or an admission
        # clears it
        self._gap_sync = None
        self.alloc = PageAllocator(num_pages, page_size, max_batch,
                                   max_pages, debug=debug_pages,
                                   prefix_cache=prefix_cache,
                                   kv_dtype=kv_dtype)
        super().__init__(model, max_batch, max_len=max_pages * page_size,
                         prefill_buckets=prefill_buckets,
                         prefill_chunk=prefill_chunk, draft_k=draft_k,
                         ngram_max=ngram_max, spec_mode=spec_mode,
                         spec_draft=spec_draft, spec_history=spec_history,
                         lora_capacity=lora_capacity, lora_rank=lora_rank,
                         lora_targets=lora_targets)
        self._measure_quant_savings()

    def _init_decode_state(self) -> None:
        super()._init_decode_state()
        self.page_table_dev = torch.from_numpy(
            self.alloc.page_table.copy()).to(self.device)

    def _sync_table(self) -> None:
        """Refresh the device page table from the host's, in place. The
        copy is synchronous: the allocator rewrites the host table in the
        next gap, which an asynchronous copy could still be reading."""
        self.page_table_dev.copy_(torch.from_numpy(self.alloc.page_table))

    def _make_caches(self):
        return self.model.init_paged_cache(self.num_pages, self.page_size,
                                           kv_dtype=self.kv_dtype)

    def _fwd_decode(self, tok, lens, live):
        logits, _ = self.model.forward_decode_paged(
            tok, self.caches, self.page_table_dev, lens, live,
            **self._lora())
        return logits

    def _fwd_spec(self, inp, lens, live):
        snaps = None
        if self.kv_dtype == "int8":
            # the window's snapshot buffers, one set per layer, allocated
            # once per window width ([B * W] pages and both scale tables)
            n = inp.shape[0] * inp.shape[1]
            snaps = [tuple(self._spec_scratch(f"snap{i}_{j}", (n,) + tuple(
                t.shape[1:]) if j < 2 else tuple(t.shape), t.dtype)
                for j, t in enumerate(entry))
                for i, entry in enumerate(self.caches)]
        logits, _, aux = self.model.forward_decode_spec_paged(
            inp, self.caches, self.page_table_dev, lens, live, snaps,
            **self._lora())
        return logits, aux

    def _coverage_limit(self, slot: int) -> int:
        # only tokens whose K/V landed in mapped pages may be accepted
        # (writes past the coverage go to the sink)
        return min(self.alloc.covered_tokens(slot), self.max_len)

    def _measure_quant_savings(self) -> None:
        """Price the int8 layout from the real pools: the bytes a page
        would take at 2 bytes an element minus what its int8 rows and
        scales take; the allocator adds it per claimed page
        (``paddle_tpu_kv_quant_bytes_saved_total``)."""
        if self.kv_dtype != "int8":
            self.alloc.bytes_saved_per_page = 0
            return
        cost = self.kv_page_cost()
        self.alloc.bytes_saved_per_page = max(
            cost["bf16_equiv_bytes_per_page"] - cost["bytes_per_page"], 0)

    def _flush_fresh_scales(self) -> None:
        """Reset freshly claimed pages' scale rows to the floor (int8): a
        previous owner's absmax must not coarsen a new page. One masked
        fill per scale tensor, of a fixed shape, in the gap before an
        install or a segment. A copy-on-write's page is not on the queue:
        its scales are the copied ones."""
        if self.kv_dtype != "int8":
            return
        fresh = self.alloc.take_fresh_scales()
        if not fresh:
            return
        mask = torch.zeros((self.num_pages + 1, 1), dtype=torch.bool)
        mask[fresh] = True
        self.programs.eager("cb_reset_scales", (), self._reset_scales,
                            mask.to(self.device))

    def _reset_scales(self, mask) -> None:
        """The program ``cb_reset_scales``: the masked fill itself."""
        with torch.no_grad():
            for entry in self.caches:
                for sc in entry[2:]:
                    sc.masked_fill_(mask, KV_SCALE_FLOOR)

    def set_kv_dtype(self, kv_dtype: str) -> None:
        """Swap the pool storage dtype on an idle engine: rebuilds the
        pools (the cached prefix KV dies with them, so the content index
        is cleared), and drops the graphs that held the old ones (the next
        segment, or :meth:`warmup`, captures anew)."""
        if kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}")
        if kv_dtype == self.kv_dtype:
            return
        if self._slot_req:
            raise RuntimeError(
                "kv_dtype can only be changed on an idle engine")
        # the old pools go before the new ones are allocated: both alive
        # at once would double the KV memory at its peak
        self.caches = None
        self.programs.clear()
        self.alloc.clear_prefix_index()
        self.alloc.set_kv_dtype(kv_dtype)
        self.kv_dtype = kv_dtype
        self._prefix_stash.clear()
        self._growth_stamp = None
        self._gap_sync = None
        self.caches = self._make_caches()
        self._measure_quant_savings()
        self._refresh_signature()

    def _program_signature(self) -> str:
        return (super()._program_signature()
                + f"|pages={self.num_pages}x{self.page_size}"
                + f"|kv={self.kv_dtype}")

    def kv_page_cost(self) -> dict:
        """Device bytes of one page under the current storage dtype, scales
        included (``bytes_per_page``), and of the same page at 2 bytes an
        element (``bf16_equiv_bytes_per_page``)."""
        total = sum(t[0].numel() * t.element_size()
                    for entry in self.caches for t in entry)
        elems = sum(t[0].numel() for entry in self.caches for t in entry[:2])
        return {"bytes_per_page": total, "bf16_equiv_bytes_per_page":
                2 * elems}

    def load(self) -> dict:
        out = super().load()
        out["kv_dtype"] = self.kv_dtype
        return out

    # -- the KV-page handoff ---------------------------------------------------
    _KV_KEYS = {"bf16": ("k", "v"), "int8": ("k", "v", "k_scale", "v_scale")}

    def export_kv_pages(self, tokens, salt: bytes = b"") -> dict:
        """The resident cached pages covering the longest FULL-BLOCK prefix
        of a prompt: the read half of a page handoff between engines
        (disaggregated prefill and decode). Returns ``{"version",
        "kv_dtype", "page_size", "salt" (hex), "coverage", "blocks":
        [{"hash", "parent", "tokens"}], "layers": [{"k", "v"[, "k_scale",
        "v_scale"]}]}``, the arrays host tensors of the pools' dtypes with
        one row per block: a page copy, never a format conversion. Each
        pool is gathered once (``index_select``) and copied to the host in
        one copy.

        Runs on the thread that drives the engine (``Server.export_kv``
        marshals it into the scheduler's gap): a replay may be writing the
        pools on that thread's stream. A partial tail block never ships:
        the importer parks blocks with no copy-on-write attached, so only
        token-complete, hash-verified pages are safe to share."""
        ids = np.ascontiguousarray(np.asarray(tokens).reshape(-1), np.int32)
        pids, cov, hashes = self.alloc.lookup_prefix(ids, salt=salt)
        ps = self.page_size
        nfull = min(len(pids), cov // ps, len(hashes))
        pids = pids[:nfull]
        root = _chain_root(salt)
        blocks = [{"hash": hashes[b].hex(),
                   "parent": (hashes[b - 1] if b else root).hex(),
                   "tokens": ids[b * ps:(b + 1) * ps].tolist()}
                  for b in range(nfull)]
        idx = torch.as_tensor(pids, dtype=torch.long).to(self.device)
        keys = self._KV_KEYS[self.kv_dtype]
        host = []
        with torch.no_grad():
            for j in range(len(keys)):
                pool = self.caches[0][j]
                buf = torch.empty((len(self.caches), nfull)
                                  + tuple(pool.shape[1:]), dtype=pool.dtype,
                                  device=pool.device)
                for i, entry in enumerate(self.caches):
                    torch.index_select(entry[j], 0, idx, out=buf[i])
                host.append(buf.cpu())
        layers = [{key: host[j][i] for j, key in enumerate(keys)}
                  for i in range(len(self.caches))]
        return {"version": 1, "kv_dtype": self.kv_dtype, "page_size": ps,
                "salt": salt.hex(), "coverage": nfull * ps,
                "blocks": blocks, "layers": layers}

    def import_kv_pages(self, payload: dict) -> dict:
        """Install exported pages into this engine's pools and prefix index:
        the write half of the handoff. The whole geometry (dtype, page
        size, layer count, every array's rows and shape) and every block's
        chain hash, re-derived from (parent, tokens), are checked before a
        single page is claimed, so a corrupt or mis-framed payload installs
        nothing; an already-resident hash is a dedup no-op
        (``PageAllocator.adopt_block``), so a replayed handoff is
        idempotent. Imported pages PARK (refcount 0, LRU-reclaimable): the
        next admission of the prompt maps them through the ordinary prefix
        path. Each adopted page's rows land in place as it is adopted, so
        a page the pool reclaims within the import holds its last block.
        Same threading contract as :meth:`export_kv_pages`. Returns
        ``{"imported", "deduped", "coverage"}``."""
        if payload.get("kv_dtype") != self.kv_dtype:
            raise ValueError(
                f"kv_dtype mismatch: payload {payload.get('kv_dtype')!r} vs "
                f"engine {self.kv_dtype!r}: a KV handoff is a page copy, "
                "never a format conversion")
        if int(payload.get("page_size", -1)) != self.page_size:
            raise ValueError(
                f"page_size mismatch: payload {payload.get('page_size')} vs "
                f"engine {self.page_size}")
        layers = payload.get("layers") or []
        if len(layers) != len(self.caches):
            raise ValueError(
                f"layer count mismatch: payload {len(layers)} vs engine "
                f"{len(self.caches)}")
        blocks = payload.get("blocks") or []
        keys = self._KV_KEYS[self.kv_dtype]
        arrays = []
        for lay, entry in zip(layers, self.caches):
            row = []
            for key, pool in zip(keys, entry):
                arr = lay.get(key)
                if arr is None or len(arr) != len(blocks):
                    raise ValueError(
                        f"payload layer missing/short {key!r} rows")
                arr = torch.as_tensor(arr)
                if (tuple(arr.shape[1:]) != tuple(pool.shape[1:])
                        or arr.dtype != pool.dtype):
                    raise ValueError(
                        f"page geometry mismatch: payload {key!r} "
                        f"{arr.dtype}{tuple(arr.shape[1:])} vs pool "
                        f"{pool.dtype}{tuple(pool.shape[1:])}")
                row.append(arr)
            arrays.append(row)
        chain = []
        for b, blk in enumerate(blocks):
            h = bytes.fromhex(blk["hash"])
            parent = bytes.fromhex(blk["parent"])
            toks = np.ascontiguousarray(
                np.asarray(blk["tokens"]).reshape(-1), np.int32)
            if _block_hash(parent, toks) != h:
                raise ValueError(
                    f"block {b}: chain hash does not match (parent, tokens): "
                    "corrupted handoff rejected")
            chain.append((h, parent, toks))
        imported = deduped = 0
        staged = None
        with torch.no_grad():
            for b, (h, parent, toks) in enumerate(chain):
                pid = self.alloc.adopt_block(h, parent, toks)
                if pid is None:
                    deduped += 1
                    continue
                if staged is None:
                    # one host-to-device copy an array, then a page at a
                    # time in adoption order: a later block may reclaim a
                    # page this import adopted, and its rows must win
                    staged = [[a.to(self.device) for a in row]
                              for row in arrays]
                for entry, row in zip(self.caches, staged):
                    if self.kv_dtype == "int8":
                        install_page_q(*entry, pid, *(a[b] for a in row))
                    else:
                        install_page(*entry, pid, *(a[b] for a in row))
                if self.kv_dtype == "int8":
                    self.alloc.note_scale_copied(pid)
                imported += 1
        return {"imported": imported, "deduped": deduped,
                "coverage": len(blocks) * self.page_size}

    # -- admission ------------------------------------------------------------
    def _reserved(self, plen: int, cfg) -> int:
        return min(plen + cfg.max_new_tokens, self.max_len)

    def _optimistic_claim(self, plen: int, cfg) -> int:
        """Tokens an OPTIMISTIC admission claims up front: the prompt plus
        one page of headroom (the first decode step writes at ``plen``),
        never more than the reserved worst case."""
        return min(plen + self.page_size, self._reserved(plen, cfg))

    def _claim(self, plen: int, cfg) -> int:
        return (self._reserved(plen, cfg)
                if self.admission_mode == "reserved"
                else self._optimistic_claim(plen, cfg))

    def _can_admit(self, prompt_len: int, cfg) -> bool:
        # any free slot owns zero pages, so capacity is slot-agnostic. The
        # prefix cache never tightens the probe: a warm admission claims
        # at most what a cold one would, and when the pool cannot also
        # spare a partial hit's copy-on-write page the hit degrades to
        # full blocks, so a yes here means add_request cannot fail for
        # capacity
        probe = self._free[0] if self._free else 0
        claim = self._claim(prompt_len, cfg)
        if not self.alloc.can_fit(probe, claim):
            return False
        if self.admission_mode == "optimistic" and self._slot_req:
            # the high watermark: while running requests crowd the pool,
            # NEW admissions wait rather than force preemptions. An idle
            # pool skips it, so a lone request can always admit
            used_after = self.alloc.used_pages + self.alloc.pages_for(claim)
            if used_after > self.kv_watermark * self.num_pages:
                return False
        return True

    def _reserve_admit(self, slot: int, plen: int, cfg) -> None:
        self.alloc.ensure(slot, self._claim(plen, cfg))

    def _lookup_degraded(self, slot: int, ids, plen: int, cfg):
        """The warm-admission preamble of both admission paths: the longest
        resident cached prefix IN THE ADMISSION'S ADAPTER NAMESPACE (the
        chain hash is salted with the adapter's ``name@generation``, so a
        base block never warm-hits an adapter's admission, nor one adapter's
        another's), degraded to full blocks when the pool cannot spare the
        partial page's copy-on-write. Returns ``(pids, c_map, hashes,
        salt)``."""
        salt = self._adapter_salt(slot)
        pids, c_map, hashes = self.alloc.lookup_prefix(ids[0], salt=salt)
        pids, c_map = self._degrade_partial_hit(slot, plen, cfg, pids, c_map)
        return pids, c_map, hashes, salt

    def _degrade_partial_hit(self, slot: int, plen: int, cfg, pids,
                             c_map: int):
        """A hit ending mid-page maps a page the request must copy before
        its first write: one page beyond its claim. When the pool cannot
        spare it, keep only the full blocks (a request whose worst case
        exactly fills the pool must still admit, cache or no cache)."""
        ps = self.page_size
        if not pids or c_map % ps == 0:
            return pids, c_map
        if self.alloc.can_fit(slot, self._claim(plen, cfg) + ps):
            return pids, c_map
        return pids[:-1], (c_map // ps) * ps

    def _admit_cache(self, slot: int, ids, plen: int, cfg):
        """A one-shot admission's prefill and install; returns the prompt's
        last-position logits. With the prefix cache, a hit takes the warm
        path (:meth:`_admit_cache_warm`); else the prompt prefills at its
        bucket width into a dense mini cache, the request's pages are
        claimed and the KV rows scattered into them."""
        if self.prefix_cache and not self.prefix_pause:
            pids, c_map, hashes, salt = self._lookup_degraded(slot, ids, plen,
                                                              cfg)
            self._prefix_stash[slot] = {"ids": ids, "c_map": c_map,
                                        "hashes": hashes,
                                        "saved": min(c_map, plen - 1),
                                        "salt": salt}
            if c_map > 0:
                return self._admit_cache_warm(slot, ids, plen, cfg, pids,
                                              c_map)
        mini = self.model.init_cache(1, self._prefill_width(plen))
        last_logits, mini = self._run_prefill(ids, plen, mini,
                                              lora=self._lora_one(slot))
        self._reserve_admit(slot, plen, cfg)
        self._install_mini(slot, mini, plen)
        return last_logits

    def _admit_cache_warm(self, slot: int, ids, plen: int, cfg, pids,
                          c_map: int):
        """A prefix-cache hit: gather the cached prefix KV from its pages
        into a ``max_len`` mini cache (a pure copy), prefill only the tail
        at the device offset ``c_cmp`` (K3's prefix-chunk instance at the
        tail's bucket width), then map the cached pages read-only, claim
        the rest and install the tail. The last prompt token always
        recomputes (its logits give the first token), even when the whole
        prompt is resident (its KV write is then masked out)."""
        c_cmp = min(c_map, plen - 1)
        wt = (plen - c_cmp if self.prefill_buckets is None
              else _bucket_for(self.prefill_buckets, plen - c_cmp))
        # the tail writes mini rows [c_cmp, c_cmp + wt): pull the start
        # DOWN where the bucket would overhang max_len; the extra cached
        # positions recompute to the same values and are never installed
        c_cmp = min(c_cmp, self.max_len - wt)
        self._prefix_stash[slot]["saved"] = c_cmp
        tail = plen - c_cmp
        mini = self.model.init_cache(1, self.max_len)
        self._gather_mini(mini, pids)
        self._count_prefill("warm")
        if trace.enabled():
            trace.event("engine.prefill", engine=self._monitor_engine,
                        plen=plen, bucket="warm", cached=c_cmp)
        last_logits = self._offset_forward(_pad_ids(ids[:, c_cmp:], wt),
                                           mini, c_cmp, tail,
                                           self._lora_one(slot))
        self.prefills += 1
        self.warm_prefills += 1
        self.alloc.map_shared(slot, pids)
        self._reserve_admit(slot, plen, cfg)
        self._install_mini(slot, mini, plen)
        return last_logits

    def _gather_mini(self, mini, pids) -> None:
        """Copy the resident pages ``pids`` into the head of a ``max_len``
        mini cache, every layer, in place. The page vector is padded with
        -1 to the full table width (one shape for every admission); the
        sink rows it reads sit past the cached coverage."""
        row = np.full((self.alloc.page_table.shape[1],), -1, np.int64)
        row[:len(pids)] = pids
        pages = torch.from_numpy(row).to(self.device)
        with torch.no_grad():
            for entry, (mk, mv) in zip(self.caches, mini):
                if self.kv_dtype == "int8":
                    gather_pages_q(*entry, pages, mk, mv)
                else:
                    gather_pages(*entry, pages, mk, mv)

    def _cow_page(self, slot: int, page_idx: int) -> None:
        """Copy-on-write of ``slot``'s shared page at ``page_idx``: claim a
        fresh page (allocator), copy the rows (and int8 scales) on the
        device, swap the table entry (the device table takes it at the
        next sync)."""
        old, new = self.alloc.cow(slot, page_idx)
        with torch.no_grad():
            for entry in self.caches:
                if self.kv_dtype == "int8":
                    copy_page_q(*entry, old, new)
                else:
                    copy_page(*entry, old, new)
        self.alloc.note_scale_copied(new)

    def _install_mini(self, slot: int, mini, plen: int) -> None:
        """Install an admission's mini cache into the slot's pages. Cold:
        scatter the bucket-width rows (rows past plen land on claimed
        positions that the decode mask hides and decode overwrites, or on
        unmapped pages, where they go to the sink; int8 pools take only
        the rows below plen). Warm: :meth:`_install_mini_warm`. With the
        prefix cache, the prompt's full private blocks are then indexed
        for later admissions."""
        self._flush_fresh_scales()
        info = (self._prefix_stash.pop(slot, None)
                if self.prefix_cache else None)
        if info is not None and info["c_map"] > 0:
            self._install_mini_warm(slot, mini, plen, info)
        else:
            self._sync_table()
            width = min(self._prefill_width(plen), mini[0][0].shape[1])
            pt = self.page_table_dev
            with torch.no_grad():
                for entry, (mk, mv) in zip(self.caches, mini):
                    if self.kv_dtype == "int8":
                        scatter_rows_q(*entry, pt, slot, 0, plen, mk, mv,
                                       width=width)
                    else:
                        scatter_rows(*entry, pt, slot, 0, width, mk, mv,
                                     width=width)
        if info is not None:
            ps = self.page_size
            # the prompt's full private blocks become hits in the
            # admission's adapter namespace
            self.alloc.register_blocks(slot, info["hashes"], info["ids"][0],
                                       info["c_map"] // ps, plen // ps,
                                       salt=info["salt"])
            if info["c_map"] > 0:
                self.alloc.count_prefix_hit(info["saved"])

    def _install_mini_warm(self, slot: int, mini, plen: int,
                           info: dict) -> None:
        """Install a warm admission's UNCACHED suffix: copy-on-write the
        shared page the first write lands in (a suffix diverging
        mid-block, or, for a fully cached prompt, the partial tail page
        decode appends into), then scatter exactly the rows ``[c_map,
        plen)``. Shared pages are never written."""
        ps = self.page_size
        c_map = info["c_map"]
        # the first position this slot will EVER write
        p0 = c_map if c_map < plen else plen
        if p0 % ps and self.alloc.needs_cow(slot, p0):
            self._cow_page(slot, p0 // ps)
        self._sync_table()
        if c_map >= plen:
            return
        width = (plen - c_map if self.prefill_buckets is None
                 else _bucket_for(self.prefill_buckets, plen - c_map))
        width = min(width, mini[0][0].shape[1])
        pt = self.page_table_dev
        with torch.no_grad():
            for entry, (mk, mv) in zip(self.caches, mini):
                if self.kv_dtype == "int8":
                    scatter_rows_q(*entry, pt, slot, c_map, plen, mk, mv,
                                   width=width)
                else:
                    scatter_rows(*entry, pt, slot, c_map, plen, mk, mv,
                                 width=width)

    def _begin_admit_cache(self, slot: int, ids, plen: int, cfg):
        """A chunked admission's claim. With the prefix cache it maps the
        cached pages, claims the rest, copies the partial shared page
        EAGERLY (the claim is atomic with the reservation; the install
        runs gaps later and its spare page must not be taken meanwhile)
        and starts the chunk cursor at the cached coverage aligned down to
        C; the ``[start, c_map)`` sliver recomputes and is not
        installed."""
        if not self.prefix_cache or self.prefix_pause:
            return super()._begin_admit_cache(slot, ids, plen, cfg)
        pids, c_map, hashes, salt = self._lookup_degraded(slot, ids, plen,
                                                          cfg)
        C = self.prefill_chunk
        start = (min(c_map, plen - 1) // C) * C
        self._prefix_stash[slot] = {"ids": ids, "c_map": c_map,
                                    "hashes": hashes, "saved": start,
                                    "salt": salt}
        self.alloc.map_shared(slot, pids)
        self._reserve_admit(slot, plen, cfg)
        p0 = c_map if c_map < plen else plen
        if p0 % self.page_size and self.alloc.needs_cow(slot, p0):
            self._cow_page(slot, p0 // self.page_size)
        mini = self.model.init_cache(1, self.max_len)
        if pids:
            self._gather_mini(mini, pids)
        return mini, start

    def _warm_prefill(self, width: int) -> None:
        """Warmup's prefill and install at one bucket: slot 0 is free and
        owns no pages, so every row of the install goes to the sink."""
        mini = self.model.init_cache(1, width)
        _, mini = self._prefill_forward(np.zeros((1, width), np.int32),
                                        width, mini, self._lora_one(0))
        self._install_mini(0, mini, width)

    def _warmup_prefix(self) -> Dict[str, float]:
        """The first use of every program a WARM admission runs (with
        ``prefix_cache``): the page gather, the copy-on-write page copy,
        and per prefill bucket one tail prefill at an offset (K3's
        prefix-chunk instance at that width) and its masked scatter. All
        value-neutral: nothing is mapped, every scatter row is masked out
        (limit 0), and page 0 is copied onto itself. Nothing is
        captured."""
        if not self.prefix_cache:
            return {}
        out = {}
        t0 = time.perf_counter()
        mini = self.model.init_cache(1, self.max_len)
        self._gather_mini(mini, [])
        with torch.no_grad():
            for entry in self.caches:
                if self.kv_dtype == "int8":
                    copy_page_q(*entry, 0, 0)
                else:
                    copy_page(*entry, 0, 0)
        out["prefix_gather_copy"] = time.perf_counter() - t0
        self._sync_table()
        pt = self.page_table_dev
        for w in self.prefill_buckets or ():
            t0 = time.perf_counter()
            self._offset_forward(np.zeros((1, w), np.int32), mini, 0, 1,
                                 self._lora_one(0))
            with torch.no_grad():
                for entry, (mk, mv) in zip(self.caches, mini):
                    if self.kv_dtype == "int8":
                        scatter_rows_q(*entry, pt, 0, 0, 0, mk, mv, width=w)
                    else:
                        scatter_rows(*entry, pt, 0, 0, 0, mk, mv, width=w)
            out[f"prefix_warm_{w}"] = time.perf_counter() - t0
        return out

    def _abort_admit(self, slot: int) -> None:
        super()._abort_admit(slot)
        self._prefix_stash.pop(slot, None)
        self.alloc.free_slot(slot)   # release any claimed pages

    def _register(self, slot: int, rid: int, first, tok_done, cfg,
                  t0: float) -> int:
        # a new live slot may be uncovered for the next segment (an
        # optimistic claim stops at prompt + one page): a growth stamp
        # from before it is stale, and so is the gap's (lens, done) copy
        self._growth_stamp = None
        self._gap_sync = None
        return super()._register(slot, rid, first, tok_done, cfg, t0)

    def _retire(self, slot: int, event: str = "finished") -> None:
        super()._retire(slot, event)
        self.alloc.free_slot(slot)

    def reset_state(self) -> None:
        """As the dense engine's, and every slot's pages go back to the
        pool, the prefix index is cleared (the zeroed pools hold no cached
        KV), the fresh-scale queue is drained, the scales are back at the
        floor and the device page table is unmapped, all in place: the
        graphs are kept."""
        for slot in range(self.max_batch):
            self.alloc.free_slot(slot)
        self.alloc.clear_prefix_index()
        self.alloc.take_fresh_scales()
        self._prefix_stash.clear()
        self._growth_stamp = None
        self._gap_sync = None
        super().reset_state()
        self._sync_table()

    # -- optimistic-mode memory pressure (host-side, between segments) -------
    def grow_for_segment(self, n_steps: int) -> List[int]:
        """Grow every live slot's mapping to cover the coming
        ``n_steps``-step segment (optimistic mode; nothing in reserved
        mode). Returns the request ids whose growth could NOT be covered:
        the pool is dry and the caller must preempt (or meet
        :class:`PagePoolExhausted` from ``decode_segment``).

        OLDEST request first (ascending rid), so pressure lands on the
        youngest work. A row's target is capped by its remaining budget:
        a segment keeps at most ``min(n_steps, budget)`` of its tokens,
        and the steps past that write to uncovered positions (the sink)
        and read clamped pages, making tokens the host discards. No
        partial growth: a slot covers its whole target or joins the short
        list. The gap's one host read of ``lens`` and ``done`` is cached
        in ``_gap_sync`` for the gap's later calls."""
        if self.admission_mode != "optimistic" or not self._slot_req:
            return []
        if self._gap_sync is None:
            both = torch.stack([self.lens, self.done_dev.to(torch.int32)])
            self._gap_sync = both.cpu().numpy()
        lens, done = self._gap_sync
        short = []
        for slot, rid in sorted(self._slot_req.items(), key=lambda kv: kv[1]):
            if done[slot]:
                continue       # a frozen row never writes
            # a speculating row may keep up to spec_k + 1 tokens a step, so
            # its target scales by its window (still capped by the budget;
            # the acceptance cap keeps it inside the coverage anyway)
            w = self._spec_k_of(rid) + 1
            target = min(int(lens[slot])
                         + min(n_steps * w, self._budget[rid]),
                         self.max_len)
            if self.alloc.can_fit(slot, target):
                self.alloc.ensure(slot, target)
            else:
                short.append(rid)
        # a clean pass covers the coming segment: decode_segment(n_steps)
        # may skip its re-check until the slot set changes or it runs
        self._growth_stamp = n_steps if not short else None
        if short and trace.enabled():
            trace.event("engine.grow_short", engine=self._monitor_engine,
                        engine_rids=tuple(short),
                        free_pages=self.alloc.free_pages)
        return short

    def preempt_request(self, rid: int, reason: str = "pressure"):
        """Preempt an ACTIVE request under memory pressure: reclaim its slot
        AND pages at once (``cancel_request``'s reclaim) and return its
        tokens so far (int32); the caller replays ``prompt + tokens``
        through a normal admission later. None when ``rid`` is not active.
        The request never appears in ``collect_finished()``; the pool's
        ``paddle_tpu_kv_preemptions_total{reason}`` counts it. Call from
        the thread driving the engine, between segments."""
        out = self._evict_active(rid, "preempted")
        if out is not None:
            self.alloc.count_preemption(reason)
        return out

    def _prepare_segment(self) -> None:
        # pages claimed in the gap get their scales floored, and the
        # device table takes the gap's allocations, before the segment
        self._flush_fresh_scales()
        self._sync_table()

    def decode_segment(self, n_steps: int) -> int:
        if not self._slot_req:
            return 0
        if self.admission_mode == "optimistic":
            # the last guard: a caller that skipped pressure relief fails
            # LOUDLY here, never by a write dropped past the mapped pages.
            # After a clean grow_for_segment(n_steps) in this gap the
            # re-check is skipped (the stamp is single-shot)
            short = ([] if self._growth_stamp == n_steps
                     else self.grow_for_segment(n_steps))
            self._growth_stamp = None
            self._gap_sync = None      # the segment advances lens/done
            if short:
                raise PagePoolExhausted(
                    short,
                    f"page pool exhausted in the inter-segment gap: "
                    f"requests {short} cannot grow for the next "
                    f"{n_steps}-step segment ({self.alloc.available_pages} "
                    f"pages reclaimable) — preempt victims "
                    f"(preempt_request) or grow num_pages")
        if self.alloc.debug:
            self._flush_fresh_scales()
            self.alloc.check()
            if self.kv_dtype == "int8":
                # layer 0 stands for all: one program writes them all
                self.alloc.check_scales(self.caches[0][2],
                                        self.caches[0][3])
            lens = self.lens.cpu().numpy()
            done = self.done_dev.cpu().numpy()
            for slot, rid in self._slot_req.items():
                if not done[slot]:
                    # a speculating row's next writes span its window
                    self.alloc.check_coverage(
                        slot, int(lens[slot]),
                        write_ahead=1 + self._spec_k_of(rid))
        return super().decode_segment(n_steps)
