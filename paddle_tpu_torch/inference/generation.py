"""Generation and continuous-batching serving over dense and paged KV
caches.

Port of ``paddle_tpu/inference/generation.py``: ``GenerationConfig`` (with
the sampling settings), length-bucketed and chunked prefill, the offline
batch generator ``CausalLMEngine``, and ``ContinuousBatchingEngine`` (dense
``[max_batch, max_len]`` caches, one slot per row) /
``PagedContinuousBatchingEngine`` (a shared page pool, reserved
admission). The engines admit requests into free slots between decode
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

Not ported yet: prefill capture, speculative decoding (ROADMAP A7, and
with it the spec-draft counter), optimistic admission and preemption
(A4c), the prefix cache (A4c), LoRA (A8), tensor parallelism (A11).
"""
from __future__ import annotations

import heapq
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import monitor
from .. import tracing as trace
from ..quantization.kv import KV_DTYPES, KV_SCALE_FLOOR
from ._graphs import GraphCache
from .paged_cache import PageAllocator, write_tokens, write_tokens_q
from .sampling import SlotSampling, sample_rows

__all__ = ["GenerationConfig", "CausalLMEngine", "ContinuousBatchingEngine",
           "PagedContinuousBatchingEngine", "prefill_buckets_for",
           "RequestFault", "EngineFault", "REQUEST_SITES", "classify_fault",
           "PagePoolExhausted", "ADMISSION_MODES"]

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

# the reference's paged-engine admission policies; the port has
# "reserved" only ("optimistic" waits for ROADMAP A4c)
ADMISSION_MODES = ("reserved", "optimistic")


class PagePoolExhausted(RuntimeError):
    """Page growth could not be satisfied, or a request can never fit the
    pool. ``rids`` names the requests concerned. With reserved admission
    (the port's only mode) the serving scheduler raises it as the cause of
    a replay that can never be admitted again."""

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


def _is_int(x) -> bool:
    return not isinstance(x, bool) and isinstance(x, (int, np.integer))


class GenerationConfig:
    """Per-request decoding parameters, validated at construction (a
    malformed config from the network must fail admission, never a shared
    decode segment), with the reference's checks value for value.
    ``do_sample=False`` decodes greedily; ``do_sample=True`` draws from
    softmax(logits / temperature) filtered to the top-k logits (0: all) and
    then to the top-p mass, with the noise stream of ``seed``. The
    reference's ``speculative``, ``draft_k`` and ``adapter`` are not
    ported and are not accepted."""

    def __init__(self, max_new_tokens: int = 64, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0, do_sample: bool = False,
                 eos_token_id: Optional[int] = None, seed: int = 0):
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
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.do_sample = bool(do_sample)
        self.eos_token_id = None if eos_token_id is None else int(eos_token_id)
        self.seed = int(seed)


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

    After each :meth:`generate`, ``generate_stats`` holds ``ttft_s`` (the
    call to the first tokens on the host), ``decode_s`` (the rest of the
    call) and ``decode_steps``; ``programs`` (a
    :class:`~paddle_tpu_torch.inference._graphs.GraphCache`) counts the
    captures per key."""

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
        self.programs = GraphCache(self.device)
        dev, mb = self.device, max_batch
        self._caches = model.init_cache(mb, max_len)
        self._samp = SlotSampling(mb, dev)
        self._chunk_pos = torch.zeros((), dtype=torch.int32, device=dev)
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
        logits, _ = self.model.forward_with_cache(
            torch.tensor(_pad_ids(ids, width), device=self.device),
            self._rows(ids.shape[0]), 0)
        return logits

    def _chunk(self, chunk: np.ndarray, pos: int) -> torch.Tensor:
        """One prefill chunk [b, C] at offset ``pos`` into the first b rows
        of the caches; the offset goes to the device (``_chunk_pos``), so
        the program is the same at every offset. Returns the logits [b, C,
        V]."""
        self._chunk_pos.fill_(pos)
        logits, _ = self.model.forward_with_cache(
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
            torch.cuda.synchronize(self.device)
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
                      self._chunk_pos):
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

    Host-side counters: ``prefills``, ``prefill_chunks`` and
    ``decode_steps`` count the model forwards run (warmup's included);
    ``serve_stats`` holds the timings of the last :meth:`serve`;
    :meth:`load` is the host-side snapshot a serving front reads.
    ``_monitor_engine`` labels this engine's monitor series; :meth:`close`
    retires them."""

    def __init__(self, model, max_batch: int, max_len: int,
                 prefill_buckets="auto",
                 prefill_chunk: Optional[int] = None):
        self.model = model
        self.device = model.device
        self.max_batch = max_batch
        self.max_len = max_len
        self.prefill_buckets = prefill_buckets_for(prefill_buckets, max_len)
        self.prefill_chunk = _normalize_prefill_chunk(prefill_chunk, max_len)
        self.prefills = 0
        self.prefill_chunks = 0
        self.decode_steps = 0
        self.serve_stats: Optional[dict] = None
        self._segment_log: List[tuple] = []   # (seconds, tokens emitted)
        self.programs = GraphCache(self.device)
        self._seg_out: Dict[int, torch.Tensor] = {}
        self._init_decode_state()
        self._slot_req: Dict[int, int] = {}   # slot -> request id
        self._tokens: Dict[int, list] = {}    # request id -> generated ids
        self._budget: Dict[int, int] = {}     # request id -> tokens left
        self._cfg: Dict[int, GenerationConfig] = {}
        self._finished: Dict[int, np.ndarray] = {}
        self._next_req = 0
        # per-engine label: engines side by side publish their series
        # side by side
        self._monitor_engine = monitor.instance_label("engine")

    def _init_decode_state(self) -> None:
        """Allocate the device-side decode state, once: caches, per-slot
        length, last token, done and active flags, eos id (-1 = none), the
        per-slot sampling vectors and the chunk offset; and the free
        slots."""
        mb, dev = self.max_batch, self.device
        self.caches = self._make_caches()
        self.lens = torch.zeros(mb, dtype=torch.int32, device=dev)
        self.last = torch.zeros(mb, dtype=torch.int32, device=dev)
        self.done_dev = torch.zeros(mb, dtype=torch.bool, device=dev)
        self.active_dev = torch.zeros(mb, dtype=torch.bool, device=dev)
        self.eos = torch.full((mb,), -1, dtype=torch.int32, device=dev)
        self.samp = SlotSampling(mb, dev)
        self._chunk_pos = torch.zeros((), dtype=torch.int32, device=dev)
        self._free = list(range(mb))

    def reset_state(self) -> None:
        """Drop every request and reset the decode state to its initial
        values IN PLACE: caches zeroed (int8 scales back to the floor),
        lengths, last tokens and flags zeroed, eos ids -1, every slot
        greedy and free. Chunked admissions in flight are dropped: their
        objects no longer hold a claim (admit_chunk on one is undefined).
        Captured graphs hold these tensors' addresses, so nothing is
        reallocated and the graphs are kept: a restart costs no capture.
        Request ids are not reused: ``_next_req`` carries on."""
        with torch.no_grad():
            for entry in self.caches:
                for t in entry[:2]:
                    t.zero_()
                for t in entry[2:]:
                    t.fill_(KV_SCALE_FLOOR)
            for t in (self.lens, self.last, self.done_dev, self.active_dev,
                      self._chunk_pos):
                t.zero_()
            self.eos.fill_(-1)
            self.samp.reset()
        self._free = list(range(self.max_batch))
        self._slot_req.clear()
        self._tokens.clear()
        self._budget.clear()
        self._cfg.clear()
        self._finished.clear()
        if monitor.enabled():
            self._requests_counter().labels(event="engine_reset").inc()

    # -- cache layout hooks (dense here; the paged subclass replaces them) ---
    def _make_caches(self):
        return self.model.init_cache(self.max_batch, self.max_len)

    def _admit_cache(self, slot: int, ids, plen: int, cfg):
        """Prefill the prompt at its bucket width straight into the slot's
        rows of every layer cache; returns the last-position logits."""
        rows = [(k[slot:slot + 1], v[slot:slot + 1]) for k, v in self.caches]
        last_logits, _ = self._run_prefill(ids, plen, rows)
        return last_logits

    def _reserve_admit(self, slot: int, plen: int, cfg) -> None:
        """Claim what an admission needs beyond the slot, up front, so a
        chunked admission cannot fail for capacity halfway through (dense:
        nothing; the paged engine reserves the worst-case pages)."""

    def _install_mini(self, slot: int, mini, plen: int) -> None:
        """Copy a chunked admission's mini cache (its first ``plen`` rows)
        into the slot's rows of every layer cache."""
        with torch.no_grad():
            for (k, v), (mk, mv) in zip(self.caches, mini):
                k[slot, :plen].copy_(mk[0, :plen])
                v[slot, :plen].copy_(mv[0, :plen])

    def _warm_prefill(self, width: int) -> None:
        """Warmup's prefill at one bucket: a zero prompt into the rows of
        slot 0, which is free, so its KV is dead weight that the next
        admission overwrites."""
        rows = [(k[:1], v[:1]) for k, v in self.caches]
        self._prefill_forward(np.zeros((1, width), np.int32), width, rows)

    def _fwd_decode(self, tok, lens, live):
        logits, _ = self.model.forward_decode_ragged(tok, self.caches, lens,
                                                     live)
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
        "total_pages", "occupancy", "kv_dtype"}``. All host bookkeeping
        kept between segments: no device sync, so a health endpoint can
        read it while the scheduler thread is inside a decode segment.
        The reference's ``tp`` and ``lora`` blocks come with tensor
        parallelism and LoRA (ROADMAP A11, A8)."""
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
        slot = heapq.heappop(self._free)
        try:
            rid = self._next_req
            self._next_req += 1
            last_logits = self._admit_cache(slot, ids, plen, cfg)
            first, tok_done = self._sample_first(slot, plen, last_logits, cfg)
            self._install_state(slot, plen, first, tok_done, cfg)
        except BaseException:
            # a failed admission must not leak the slot (or its pages)
            self._abort_admit(slot)
            raise
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
        slot = heapq.heappop(self._free)
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

    def _run_chunk(self, chunk: np.ndarray, mini, pos: int, r: int):
        """One prefill chunk [1, C] at offset ``pos`` (on the device, in
        ``_chunk_pos``) into ``mini``; returns the logits at its last real
        row ``r - 1`` [1, V]."""
        self._chunk_pos.fill_(pos)
        with torch.no_grad():
            logits, _ = self.model.forward_with_cache(
                torch.tensor(chunk, device=self.device), mini,
                self._chunk_pos)
        self.prefill_chunks += 1
        return logits[:, r - 1]

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
                                              adm.off, r)
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
            self._install_state(adm.slot, adm.plen, first, tok_done, adm.cfg)
        except BaseException:
            adm.closed = True
            adm.mini = None
            self._abort_admit(adm.slot)
            raise
        adm.closed = True
        adm.mini = None     # the slab goes back to the allocator
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
                       cfg) -> None:
        self.lens[slot] = plen
        self.last[slot] = first
        self.done_dev[slot] = tok_done
        self.active_dev[slot] = True
        self.eos[slot] = -1 if cfg.eos_token_id is None else cfg.eos_token_id

    def _register(self, slot: int, rid: int, first, tok_done, cfg,
                  t0: float) -> int:
        """Host-side tail of an admission: record the request, retire it
        at once when its first token already ends it, count the
        admission (``t0``: when it began)."""
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

    def _run_prefill(self, ids: np.ndarray, plen: int, mini):
        """An admission's one-shot prefill: pad the prompt to its bucket
        and prefill it into the dense ``mini`` cache, counted per bucket;
        returns (last-position logits [1, V], mini)."""
        width = self._prefill_width(plen)
        self._count_prefill(width if self.prefill_buckets is not None
                            else "exact")
        if trace.enabled():
            # the bucket CHOICE explains a prefill's latency class
            trace.event("engine.prefill", engine=self._monitor_engine,
                        plen=plen, bucket=width)
        return self._prefill_forward(ids, plen, mini)

    def _prefill_forward(self, ids: np.ndarray, plen: int, mini):
        """The prefill forward itself (admissions and warmup)."""
        width = self._prefill_width(plen)
        ids_t = torch.tensor(_pad_ids(ids, width), device=self.device)
        with torch.no_grad():
            logits, mini = self.model.forward_with_cache(ids_t, mini, 0)
        self.prefills += 1
        return logits[:, plen - 1], mini

    def _abort_admit(self, slot: int) -> None:
        heapq.heappush(self._free, slot)

    def _retire(self, slot: int, event: str = "finished") -> None:
        rid = self._slot_req.pop(slot)
        self._finished[rid] = np.asarray(self._tokens.pop(rid), np.int32)
        del self._budget[rid]
        self._cfg.pop(rid, None)
        self.active_dev[slot] = False
        heapq.heappush(self._free, slot)   # lowest free slot admits first
        if monitor.enabled():
            self._requests_counter().labels(event=event).inc()

    def cancel_request(self, rid: int):
        """Cancel an ACTIVE request between segments: its slot (and pages)
        return to the pool at once and it never appears in
        ``collect_finished()``. Returns its tokens so far, or None when
        ``rid`` is not active."""
        slot = next((s for s, r in self._slot_req.items() if r == rid), None)
        if slot is None:
            return None
        out = np.asarray(self._tokens[rid], np.int32)
        self._retire(slot, event="cancelled")
        self._finished.pop(rid, None)
        return out

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
    def _tokens_per_sec_gauge():
        return monitor.gauge(
            "paddle_tpu_decode_tokens_per_sec",
            "emitted tokens / wall time of the latest decode "
            "segment (includes host collect), per engine", ("engine",))

    def close(self) -> None:
        """Retire this engine's per-instance monitor series (idempotent;
        a dropped engine must not export its last tokens/sec forever)."""
        self._tokens_per_sec_gauge().remove(engine=self._monitor_engine)
        for name in ("paddle_tpu_prefill_requests_total",
                     "paddle_tpu_prefill_chunks_total",
                     "paddle_tpu_prefill_warmup_seconds"):
            monitor.remove_series(name, engine=self._monitor_engine)

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
        with torch.no_grad():
            self.programs.run(self._segment_key(n_steps, sampled),
                              lambda: self._segment(n_steps, out, sampled))
        return out

    def decode_segment(self, n_steps: int) -> int:
        """Run ``n_steps`` decode steps over every slot, collect each
        request's tokens and retire finished requests. Each request decodes
        under its own config; the sampled program runs only when a live
        request samples. Returns the number of requests still active."""
        if not self._slot_req:
            return 0
        n_live = len(self._slot_req)
        t0 = time.perf_counter()
        sampled = any(self._cfg[rid].do_sample
                      for rid in self._slot_req.values())
        out = self._run_segment(n_steps, sampled)
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
        dt = time.perf_counter() - t0
        self._segment_log.append((dt, emitted))
        if monitor.enabled():
            self._tokens_counter().inc(emitted)
            self._tokens_per_sec_gauge().labels(
                engine=self._monitor_engine).set(
                emitted / dt if dt > 0 else 0.0)
        if trace.enabled():
            trace.record("engine.segment", dur_ns=int(dt * 1e9),
                         engine=self._monitor_engine, steps=n_steps,
                         active=n_live, emitted=emitted)
        return len(self._slot_req)

    def warmup(self, segment_steps: Optional[int] = None) -> Dict[str, float]:
        """Run every program a request can reach ahead of the requests, on
        an idle engine: the slot-state install; when ``segment_steps`` is
        given, the segment of that length, greedy and sampled, each
        captured (with every slot inactive it changes nothing); one prefill
        per bucket and, with ``prefill_chunk``, one chunk (cuBLAS's and the
        kernels' first use at each width; prefill is not captured). A serve
        with that segment length then captures nothing, whatever its
        configs. Returns ``{program: seconds}``. Raises RuntimeError on a
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
        if segment_steps is not None:
            # the captures first: they empty PyTorch's allocator cache,
            # which the prefills then fill for the requests to reuse
            for sampled in (False, True):
                t0 = time.perf_counter()
                self._run_segment(segment_steps, sampled)
                name = f"segment_{segment_steps}" + ("_sampled" if sampled
                                                     else "")
                out[name] = time.perf_counter() - t0
        for w in self.prefill_buckets or ():
            t0 = time.perf_counter()
            self._warm_prefill(w)
            out[f"prefill_{w}"] = time.perf_counter() - t0
        if self.prefill_chunk is not None:
            # one chunk into a throwaway mini: the chunk program's first use
            t0 = time.perf_counter()
            self._run_chunk(np.zeros((1, self.prefill_chunk), np.int32),
                            self.model.init_cache(1, self.max_len), 0, 1)
            out["prefill_chunk"] = time.perf_counter() - t0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        out["total"] = time.perf_counter() - t_all
        if monitor.enabled():
            monitor.gauge(
                "paddle_tpu_prefill_warmup_seconds",
                "wall seconds engine.warmup() spent pre-compiling the "
                "serving-path programs", ("engine",)).labels(
                engine=self._monitor_engine).set(out["total"])
        return out

    def serve(self, prompts, cfg=None,
              segment_steps: int = 8) -> List[np.ndarray]:
        """Continuous-batching loop: admits requests as slots (and pages)
        free up, decoding in fixed segments. ``cfg`` is one
        :class:`GenerationConfig` for every prompt, or a sequence of one
        per prompt (greedy and sampled requests may mix). Returns the
        generated ids (prompt not included) in submission order.

        Afterwards ``serve_stats`` holds ``ttft_s`` and ``finish_s`` (per
        prompt: seconds from the call to its first token, and to the
        segment gap that collected its last one), ``decode_s`` and
        ``decode_tokens`` (wall time of the decode segments and the tokens
        they emitted), ``segments`` and ``wall_s``."""
        cfgs = (list(cfg) if isinstance(cfg, (list, tuple))
                else [cfg or GenerationConfig()] * len(prompts))
        if len(cfgs) != len(prompts):
            raise ValueError(f"{len(cfgs)} configs for {len(prompts)} "
                             f"prompts")
        t0 = time.perf_counter()
        self._segment_log = []
        pending = list(enumerate(prompts))
        order: Dict[int, int] = {}
        first_at: Dict[int, float] = {}
        done_at: Dict[int, float] = {}
        results: Dict[int, np.ndarray] = {}
        foreign: Dict[int, np.ndarray] = {}   # admitted outside this call
        while len(results) < len(prompts):
            while pending and self._free:
                idx0, p0 = pending[0]
                if (not self._can_admit(_prompt_len(p0), cfgs[idx0])
                        and self._slot_req):
                    break  # transient: defer to the next segment gap
                # (with nothing active to drain, a request that does not
                # fit can NEVER fit: add_request raises its loud error)
                idx, p = pending.pop(0)
                order[self.add_request(p, cfgs[idx])] = idx
                first_at[idx] = time.perf_counter()   # after its host sync
            self.decode_segment(segment_steps)
            now = time.perf_counter()
            for rid, seq in self.collect_finished().items():
                if rid in order:
                    idx = order.pop(rid)
                    results[idx] = seq
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
            "wall_s": time.perf_counter() - t0,
        }
        return [results[i] for i in range(len(prompts))]


class PagedContinuousBatchingEngine(ContinuousBatchingEngine):
    """ContinuousBatchingEngine over a PAGED KV pool: cache slots are
    page-table rows into shared per-layer pools, so the pools hold
    ``num_pages * page_size`` tokens in flight in all, not
    ``max_batch * max_len``, and any free page serves any slot.

    Reserved admission: a request reserves its worst case (prompt +
    max_new_tokens, capped at max_len) up front, so a running request can
    never exhaust the pool mid-decode; ``serve`` defers admission while the
    pool is transiently full. The page table lives on the host (numpy); a
    device copy, allocated once, is refreshed by a synchronous copy (the
    host rewrites its table between segments) before every install and
    every segment. ``debug_pages=True`` runs the allocator's ``check()``
    after every page operation and at every segment.

    ``kv_dtype="bf16"`` keeps the pools in the model's dtype;
    ``kv_dtype="int8"`` stores int8 pages with per-(page, kv head) fp32
    running-absmax scales (``quantization/kv.py``): the install and every
    decode step quantize on store, K4 dequantizes inside the kernel, and
    freshly claimed pages' scales are reset to the floor in the gap before
    any write lands in them. :meth:`set_kv_dtype` swaps it on an idle
    engine; :meth:`kv_page_cost` prices a page.

    A chunked admission (``prefill_chunk``) reserves the request's pages at
    :meth:`begin_admit`, fills a dense ``max_len`` mini cache chunk by
    chunk and installs it into the pages (bf16 or int8) with the final
    chunk; :meth:`abort_admit` frees the reserved pages.

    This is the reference's ``admission_mode="reserved"`` with
    ``prefix_cache=False``: :attr:`admission_mode` reads ``"reserved"``,
    and setting ``"optimistic"`` raises NotImplementedError (ROADMAP A4c,
    with preemption and the prefix cache)."""

    def __init__(self, model, max_batch: int, num_pages: int,
                 page_size: int, max_pages: int, prefill_buckets="auto",
                 debug_pages: bool = False, kv_dtype: str = "bf16",
                 prefill_chunk: Optional[int] = None):
        if kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}")
        self.num_pages = num_pages
        self.page_size = page_size
        self.kv_dtype = kv_dtype
        self.alloc = PageAllocator(num_pages, page_size, max_batch,
                                   max_pages, debug=debug_pages,
                                   kv_dtype=kv_dtype)
        super().__init__(model, max_batch, max_len=max_pages * page_size,
                         prefill_buckets=prefill_buckets,
                         prefill_chunk=prefill_chunk)

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
            tok, self.caches, self.page_table_dev, lens, live)
        return logits

    def _flush_fresh_scales(self) -> None:
        """Reset freshly claimed pages' scale rows to the floor (int8): a
        previous owner's absmax must not coarsen a new page. One masked
        fill per scale tensor, of a fixed shape, in the gap before an
        install or a segment."""
        if self.kv_dtype != "int8":
            return
        fresh = self.alloc.take_fresh_scales()
        if not fresh:
            return
        mask = torch.zeros((self.num_pages + 1, 1), dtype=torch.bool)
        mask[fresh] = True
        mask = mask.to(self.device)
        with torch.no_grad():
            for entry in self.caches:
                for sc in entry[2:]:
                    sc.masked_fill_(mask, KV_SCALE_FLOOR)

    def set_kv_dtype(self, kv_dtype: str) -> None:
        """Swap the pool storage dtype on an idle engine: rebuilds the
        pools, and drops the graphs that held the old ones (the next
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
        self.alloc.set_kv_dtype(kv_dtype)
        self.kv_dtype = kv_dtype
        self.caches = self._make_caches()

    def kv_page_cost(self) -> dict:
        """Device bytes of one page under the current storage dtype, scales
        included (``bytes_per_page``), and of the same page at 2 bytes an
        element (``bf16_equiv_bytes_per_page``)."""
        total = sum(t[0].numel() * t.element_size()
                    for entry in self.caches for t in entry)
        elems = sum(t[0].numel() for entry in self.caches for t in entry[:2])
        return {"bytes_per_page": total, "bf16_equiv_bytes_per_page":
                2 * elems}

    def _reserved(self, plen: int, cfg) -> int:
        return min(plen + cfg.max_new_tokens, self.max_len)

    def _can_admit(self, prompt_len: int, cfg) -> bool:
        # any free slot owns zero pages, so capacity is slot-agnostic
        probe = self._free[0] if self._free else 0
        return self.alloc.can_fit(probe, self._reserved(prompt_len, cfg))

    def _admit_cache(self, slot: int, ids, plen: int, cfg):
        """Prefill into a dense mini cache sized to the prompt's bucket,
        reserve the request's pages, scatter the KV rows into them; returns
        the prompt's last-position logits."""
        mini = self.model.init_cache(1, self._prefill_width(plen))
        last_logits, mini = self._run_prefill(ids, plen, mini)
        self._reserve_admit(slot, plen, cfg)
        self._install_mini(slot, mini, plen)
        return last_logits

    def _reserve_admit(self, slot: int, plen: int, cfg) -> None:
        self.alloc.ensure(slot, self._reserved(plen, cfg))

    @property
    def admission_mode(self) -> str:
        """The admission policy: ``"reserved"``, the port's only one."""
        return "reserved"

    @admission_mode.setter
    def admission_mode(self, mode: str) -> None:
        if mode not in ADMISSION_MODES:
            raise ValueError(f"admission_mode must be one of "
                             f"{ADMISSION_MODES}, got {mode!r}")
        if mode != "reserved":
            raise NotImplementedError(
                f"admission_mode={mode!r} is not ported yet (ROADMAP A4c: "
                f"optimistic admission, page growth and preemption); the "
                f"port's paged engine admits 'reserved'")

    def load(self) -> dict:
        out = super().load()
        out["kv_dtype"] = self.kv_dtype
        return out

    def _warm_prefill(self, width: int) -> None:
        """Warmup's prefill and install at one bucket: slot 0 is free and
        owns no pages, so every row of the install goes to the sink."""
        mini = self.model.init_cache(1, width)
        _, mini = self._prefill_forward(np.zeros((1, width), np.int32),
                                        width, mini)
        self._install_mini(0, mini, width)

    def _install_mini(self, slot: int, mini, plen: int) -> None:
        """Scatter the mini cache's bucket-width rows into the slot's pages:
        rows past plen land on reserved positions that the decode mask
        hides and decode writes overwrite, or on unmapped pages, where
        write_tokens drops them into the sink. int8 pools take only the
        rows below plen (``limit``), after the fresh pages' scales are
        reset."""
        self._flush_fresh_scales()
        self._sync_table()
        width = min(self._prefill_width(plen), mini[0][0].shape[1])
        pt = self.page_table_dev
        slots = torch.full((width,), slot, dtype=torch.int32,
                           device=self.device)
        pos = torch.arange(width, dtype=torch.int32, device=self.device)
        with torch.no_grad():
            for entry, (mk, mv) in zip(self.caches, mini):
                if self.kv_dtype == "int8":
                    write_tokens_q(*entry, pt, slots, pos, mk[0, :width],
                                   mv[0, :width], limit=plen)
                else:
                    write_tokens(*entry, pt, slots, pos, mk[0, :width],
                                 mv[0, :width])

    def _abort_admit(self, slot: int) -> None:
        super()._abort_admit(slot)
        self.alloc.free_slot(slot)   # release any reserved pages

    def _retire(self, slot: int, event: str = "finished") -> None:
        super()._retire(slot, event)
        self.alloc.free_slot(slot)

    def reset_state(self) -> None:
        """As the dense engine's, and every slot's pages go back to the
        pool, the fresh-scale queue is drained, the scales are back at the
        floor and the device page table is unmapped, all in place."""
        for slot in range(self.max_batch):
            self.alloc.free_slot(slot)
        self.alloc.take_fresh_scales()
        super().reset_state()
        self._sync_table()

    def _run_segment(self, n_steps: int,
                     sampled: bool = False) -> torch.Tensor:
        # pages claimed in the gap get their scales floored, and the
        # device table takes the gap's allocations, before the segment
        self._flush_fresh_scales()
        self._sync_table()
        return super()._run_segment(n_steps, sampled)

    def decode_segment(self, n_steps: int) -> int:
        if self._slot_req and self.alloc.debug:
            self.alloc.check()
        # reserved admission pre-covered every running request's worst
        # case, so no growth can fail
        return super().decode_segment(n_steps)
