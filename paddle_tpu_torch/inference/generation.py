"""Greedy generation and continuous-batching serving over dense and paged
KV caches.

Port of ``paddle_tpu/inference/generation.py``: ``GenerationConfig``,
length-bucketed prefill, the offline batch generator ``CausalLMEngine``,
and ``ContinuousBatchingEngine`` (dense ``[max_batch, max_len]`` caches,
one slot per row) / ``PagedContinuousBatchingEngine`` (a shared page pool,
reserved admission). The engines admit requests into free slots between
decode SEGMENTS (one prefill each, its KV put into the slot's cache rows or
pages), decode ``n_steps`` steps over every slot with per-row lengths, and
retire finished rows between segments.

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

Not ported yet: sampled decoding (the port is greedy), chunked prefill,
prefill capture, speculative decoding, optimistic admission and
preemption, the prefix cache, LoRA, tensor parallelism, monitor and
tracing.
"""
from __future__ import annotations

import heapq
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..quantization.kv import KV_DTYPES, KV_SCALE_FLOOR
from ._graphs import GraphCache
from .paged_cache import PageAllocator, write_tokens, write_tokens_q

__all__ = ["GenerationConfig", "CausalLMEngine", "ContinuousBatchingEngine",
           "PagedContinuousBatchingEngine", "prefill_buckets_for"]

_INT32_MAX = 2 ** 31 - 1


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


def _sample_rows(logits: torch.Tensor) -> torch.Tensor:
    """Next token per row of [B, V] logits: the greedy branch of the
    reference's ``_sample_rows``, argmax with the first maximum on ties
    (as ``jnp.argmax``)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _is_int(x) -> bool:
    return not isinstance(x, bool) and isinstance(x, (int, np.integer))


class GenerationConfig:
    """Per-request decoding parameters, validated at construction (a
    malformed config from the network must fail admission, never a shared
    decode segment). Decoding is greedy: the reference's sampling settings
    arrive with the sampled branch of ``_sample_rows``."""

    def __init__(self, max_new_tokens: int = 64,
                 eos_token_id: Optional[int] = None):
        if not _is_int(max_new_tokens) or not 1 <= max_new_tokens <= _INT32_MAX:
            raise ValueError(f"max_new_tokens must be an int in [1, 2**31), "
                             f"got {max_new_tokens!r}")
        if eos_token_id is not None and (
                not _is_int(eos_token_id)
                or not 0 <= eos_token_id <= _INT32_MAX):
            raise ValueError(f"eos_token_id must be an int in [0, 2**31) or "
                             f"None, got {eos_token_id!r}")
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = None if eos_token_id is None else int(eos_token_id)


class CausalLMEngine:
    """Offline greedy generation for a causal LM exposing ``init_cache`` /
    ``forward_with_cache``: one bucketed prefill of the whole batch into
    dense caches, then one-token steps at ``pos = plen, plen + 1, ...``
    (K7 over the cache). Runs on its model's device.

    The engine owns its caches, ``[max_batch, max_len]`` per layer,
    allocated once; a call of batch ``b`` uses their first ``b`` rows,
    unpadded (cuBLAS may take another algorithm at another batch, and the
    tokens would no longer be the eager ones). A step reads its position
    from a device counter and writes its token into a device history, so on
    the card it is one CUDA graph per batch size, captured at its first
    call (or by :meth:`warmup`) and replayed ``max_new_tokens - 1`` times:
    the same graph serves every prompt length, eos and token budget.

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
                 prefill_buckets="auto"):
        self.model = model
        self.device = model.device
        self.max_batch = max_batch
        self.max_len = max_len
        self.prefill_buckets = prefill_buckets_for(prefill_buckets, max_len)
        self.generate_stats: Optional[dict] = None
        self.programs = GraphCache(self.device)
        dev, mb = self.device, max_batch
        self._caches = model.init_cache(mb, max_len)
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

    def _install(self, b: int, tok: torch.Tensor, plen: int,
                 eos: Optional[int]) -> None:
        """The step's device state for a call: first tokens, done flags,
        eos (-1: none), position."""
        self._tok[:b].copy_(tok)
        self._eos.fill_(-1 if eos is None else eos)
        self._done[:b].copy_(tok == self._eos)
        self._pos.fill_(plen)

    def _step(self, b: int) -> None:
        """One token for rows [0, b): feed ``_tok`` at ``_pos``, write the
        greedy choice (eos once a row is done) into ``_tok`` and the
        history at ``_pos + 1``, advance ``_pos``."""
        logits, _ = self.model.forward_with_cache(
            self._tok[:b, None], self._rows(b), self._pos)
        nxt = _sample_rows(logits[:, 0])
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
        size, and run one prefill of ``batch`` rows per bucket (cuBLAS's
        and the kernels' first use at each width; prefill is not
        captured), so a :meth:`generate` of ``batch`` rows captures
        nothing. Returns ``{program: seconds}``."""
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
            t0 = time.perf_counter()
            self.programs.run(("step", batch), lambda: self._step(batch))
            out[f"step_{batch}"] = time.perf_counter() - t0
            for w in self.prefill_buckets or ():
                t0 = time.perf_counter()
                self._prefill(np.zeros((batch, w), np.int32), w)
                out[f"prefill_{w}"] = time.perf_counter() - t0
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
            for t in (self._tok, self._done, self._pos, self._hist):
                t.zero_()
            self._eos.fill_(-1)

    def generate(self, input_ids,
                 config: Optional[GenerationConfig] = None) -> np.ndarray:
        """input_ids [B, prompt_len] (tensor, ndarray or nested lists).
        Returns int32 [B, prompt_len + max_new_tokens]: the prompt, then
        the greedy tokens; a row that emits eos stays on eos."""
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
        n = cfg.max_new_tokens
        with torch.no_grad():
            logits = self._prefill(ids, _bucket_for(self.prefill_buckets,
                                                    plen))
            tok = _sample_rows(logits[:, plen - 1])
            first = tok.cpu().numpy()[:, None]     # on the host: TTFT ends
            t1 = time.perf_counter()
            self._install(b, tok, plen, cfg.eos_token_id)
            for _ in range(n - 1):
                self.programs.run(("step", b), lambda: self._step(b))
            rest = self._hist[:b, plen + 1:plen + n].cpu().numpy()
        gen = np.concatenate([first, rest], axis=1)
        self.generate_stats = {"ttft_s": t1 - t0,
                               "decode_s": time.perf_counter() - t1,
                               "decode_steps": n - 1}
        return np.concatenate([ids, gen], axis=1)


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
    ``_warm_prefill``, ``_fwd_decode``) with a page pool. The engine runs
    on its model's device.

    A decode segment of ``n`` steps is one program keyed on ``n`` alone:
    on the card a CUDA graph, captured at the key's first segment or by
    :meth:`warmup`, and replayed after that (``programs``, a
    :class:`~paddle_tpu_torch.inference._graphs.GraphCache`, counts the
    captures). It reads and writes only storage allocated once: the
    caches, the per-slot state (``lens``, ``last``, ``done_dev``,
    ``active_dev``, ``eos``) and a ``[max_batch, n + 1]`` output buffer of
    tokens and done flags, read back once a segment. :meth:`reset_state`
    drops every request and resets that storage in place, keeping the
    graphs.

    Usage::

        eng = ContinuousBatchingEngine(model, max_batch=8, max_len=1024)
        eng.warmup(segment_steps=8)          # optional: capture ahead
        outs = eng.serve(prompts, GenerationConfig(max_new_tokens=32))

    Host-side counters: ``prefills`` and ``decode_steps`` count the model
    forwards run (warmup's included); ``serve_stats`` holds the timings
    of the last :meth:`serve`."""

    def __init__(self, model, max_batch: int, max_len: int,
                 prefill_buckets="auto"):
        self.model = model
        self.device = model.device
        self.max_batch = max_batch
        self.max_len = max_len
        self.prefill_buckets = prefill_buckets_for(prefill_buckets, max_len)
        self.prefills = 0
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

    def _init_decode_state(self) -> None:
        """Allocate the device-side decode state, once: caches, per-slot
        length, last token, done and active flags, eos id (-1 = none);
        and the free slots."""
        mb, dev = self.max_batch, self.device
        self.caches = self._make_caches()
        self.lens = torch.zeros(mb, dtype=torch.int32, device=dev)
        self.last = torch.zeros(mb, dtype=torch.int32, device=dev)
        self.done_dev = torch.zeros(mb, dtype=torch.bool, device=dev)
        self.active_dev = torch.zeros(mb, dtype=torch.bool, device=dev)
        self.eos = torch.full((mb,), -1, dtype=torch.int32, device=dev)
        self._free = list(range(mb))

    def reset_state(self) -> None:
        """Drop every request and reset the decode state to its initial
        values IN PLACE: caches zeroed (int8 scales back to the floor),
        lengths, last tokens and flags zeroed, eos ids -1, every slot free.
        Captured graphs hold these tensors' addresses, so nothing is
        reallocated and the graphs are kept: a restart costs no capture.
        Request ids are not reused: ``_next_req`` carries on."""
        with torch.no_grad():
            for entry in self.caches:
                for t in entry[:2]:
                    t.zero_()
                for t in entry[2:]:
                    t.fill_(KV_SCALE_FLOOR)
            for t in (self.lens, self.last, self.done_dev, self.active_dev):
                t.zero_()
            self.eos.fill_(-1)
        self._free = list(range(self.max_batch))
        self._slot_req.clear()
        self._tokens.clear()
        self._budget.clear()
        self._cfg.clear()
        self._finished.clear()

    # -- cache layout hooks (dense here; the paged subclass replaces them) ---
    def _make_caches(self):
        return self.model.init_cache(self.max_batch, self.max_len)

    def _admit_cache(self, slot: int, ids, plen: int, cfg):
        """Prefill the prompt at its bucket width straight into the slot's
        rows of every layer cache; returns the last-position logits."""
        rows = [(k[slot:slot + 1], v[slot:slot + 1]) for k, v in self.caches]
        last_logits, _ = self._run_prefill(ids, plen, rows)
        return last_logits

    def _warm_prefill(self, width: int) -> None:
        """Warmup's prefill at one bucket: a zero prompt into the rows of
        slot 0, which is free, so its KV is dead weight that the next
        admission overwrites."""
        rows = [(k[:1], v[:1]) for k, v in self.caches]
        self._run_prefill(np.zeros((1, width), np.int32), width, rows)

    def _fwd_decode(self, tok, lens, live):
        logits, _ = self.model.forward_decode_ragged(tok, self.caches, lens,
                                                     live)
        return logits

    # -- admission / retirement (host-side, between segments) ---------------
    def _can_admit(self, prompt_len: int, cfg) -> bool:
        return True

    def free_slots(self) -> int:
        return len(self._free)

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
        slot = heapq.heappop(self._free)
        try:
            rid = self._next_req
            self._next_req += 1
            last_logits = self._admit_cache(slot, ids, plen, cfg)
            first = _sample_rows(last_logits)[0]
            tok_done = (first == cfg.eos_token_id
                        if cfg.eos_token_id is not None else False)
            self._install_state(slot, plen, first, tok_done, cfg)
        except BaseException:
            # a failed admission must not leak the slot (or its pages)
            self._abort_admit(slot)
            raise
        return self._register(slot, rid, first, tok_done, cfg)

    def _install_state(self, slot: int, plen: int, first, tok_done,
                       cfg) -> None:
        self.lens[slot] = plen
        self.last[slot] = first
        self.done_dev[slot] = tok_done
        self.active_dev[slot] = True
        self.eos[slot] = -1 if cfg.eos_token_id is None else cfg.eos_token_id

    def _register(self, slot: int, rid: int, first, tok_done, cfg) -> int:
        """Host-side tail of an admission: record the request and retire
        it at once when its first token already ends it."""
        self._slot_req[slot] = rid
        self._tokens[rid] = [int(first)]     # the admission's one host sync
        self._budget[rid] = cfg.max_new_tokens - 1
        self._cfg[rid] = cfg
        if bool(tok_done) or self._budget[rid] <= 0:
            self._retire(slot)
        return rid

    def _prefill_width(self, plen: int) -> int:
        return _bucket_for(self.prefill_buckets, plen)

    def _run_prefill(self, ids: np.ndarray, plen: int, mini):
        """Pad the prompt to its bucket and prefill it into the dense
        ``mini`` cache; returns (last-position logits [1, V], mini)."""
        width = self._prefill_width(plen)
        ids_t = torch.tensor(_pad_ids(ids, width), device=self.device)
        with torch.no_grad():
            logits, mini = self.model.forward_with_cache(ids_t, mini, 0)
        self.prefills += 1
        return logits[:, plen - 1], mini

    def _abort_admit(self, slot: int) -> None:
        heapq.heappush(self._free, slot)

    def _retire(self, slot: int) -> None:
        rid = self._slot_req.pop(slot)
        self._finished[rid] = np.asarray(self._tokens.pop(rid), np.int32)
        del self._budget[rid]
        self._cfg.pop(rid, None)
        self.active_dev[slot] = False
        heapq.heappush(self._free, slot)   # lowest free slot admits first

    def cancel_request(self, rid: int):
        """Cancel an ACTIVE request between segments: its slot (and pages)
        return to the pool at once and it never appears in
        ``collect_finished()``. Returns its tokens so far, or None when
        ``rid`` is not active."""
        slot = next((s for s, r in self._slot_req.items() if r == rid), None)
        if slot is None:
            return None
        out = np.asarray(self._tokens[rid], np.int32)
        self._retire(slot)
        self._finished.pop(rid, None)
        return out

    def collect_finished(self) -> Dict[int, np.ndarray]:
        out, self._finished = self._finished, {}
        return out

    # -- decode ---------------------------------------------------------------
    def _segment(self, n_steps: int, out: torch.Tensor) -> None:
        """``n_steps`` greedy steps over every slot: the segment's program.
        Reads and writes the static slot state; writes each step's tokens
        into ``out[:, :n_steps]`` and the done flags into
        ``out[:, n_steps]``."""
        last, lens, done = self.last, self.lens, self.done_dev
        for i in range(n_steps):
            live = self.active_dev & ~done & (lens < self.max_len)
            logits = self._fwd_decode(last[:, None], lens, live)
            nxt = torch.where(live, _sample_rows(logits[:, 0]), last)
            lens = lens + live.to(torch.int32)
            done = (done | (live & (self.eos >= 0) & (nxt == self.eos))
                    | (lens >= self.max_len))
            out[:, i] = nxt
            last = nxt
        out[:, n_steps] = done
        self.last.copy_(last)
        self.lens.copy_(lens)
        self.done_dev.copy_(done)

    def _run_segment(self, n_steps: int) -> torch.Tensor:
        """Run the segment program of ``n_steps`` (replay, or run and
        capture); returns its output buffer."""
        out = self._seg_out.get(n_steps)
        if out is None:
            out = self._seg_out[n_steps] = torch.zeros(
                (self.max_batch, n_steps + 1), dtype=torch.int32,
                device=self.device)
        with torch.no_grad():
            self.programs.run(("segment", n_steps),
                              lambda: self._segment(n_steps, out))
        return out

    def decode_segment(self, n_steps: int) -> int:
        """Run ``n_steps`` greedy decode steps over every slot, collect each
        request's tokens and retire finished requests. Returns the number
        of requests still active."""
        if not self._slot_req:
            return 0
        t0 = time.perf_counter()
        out = self._run_segment(n_steps)
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
        self._segment_log.append((time.perf_counter() - t0, emitted))
        return len(self._slot_req)

    def warmup(self, segment_steps: Optional[int] = None) -> Dict[str, float]:
        """Run every program a request can reach ahead of the requests, on
        an idle engine: the slot-state install; when ``segment_steps`` is
        given, the segment of that length, which is captured (with every
        slot inactive it changes nothing); and one prefill per bucket
        (cuBLAS's and the kernels' first use at each width; prefill is not
        captured). A serve with that segment length then captures nothing.
        Returns ``{program: seconds}``. Raises RuntimeError on a busy
        engine."""
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
            # the capture first: it empties PyTorch's allocator cache,
            # which the prefills then fill for the requests to reuse
            t0 = time.perf_counter()
            self._run_segment(segment_steps)
            out[f"segment_{segment_steps}"] = time.perf_counter() - t0
        for w in self.prefill_buckets or ():
            t0 = time.perf_counter()
            self._warm_prefill(w)
            out[f"prefill_{w}"] = time.perf_counter() - t0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        out["total"] = time.perf_counter() - t_all
        return out

    def serve(self, prompts, cfg: Optional[GenerationConfig] = None,
              segment_steps: int = 8) -> List[np.ndarray]:
        """Continuous-batching loop: admits requests as slots (and pages)
        free up, decoding in fixed segments. Returns the generated ids
        (prompt not included) in submission order.

        Afterwards ``serve_stats`` holds ``ttft_s`` and ``finish_s`` (per
        prompt: seconds from the call to its first token, and to the
        segment gap that collected its last one), ``decode_s`` and
        ``decode_tokens`` (wall time of the decode segments and the tokens
        they emitted), ``segments`` and ``wall_s``."""
        cfg = cfg or GenerationConfig()
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
                if (not self._can_admit(_prompt_len(pending[0][1]), cfg)
                        and self._slot_req):
                    break  # transient: defer to the next segment gap
                # (with nothing active to drain, a request that does not
                # fit can NEVER fit: add_request raises its loud error)
                idx, p = pending.pop(0)
                order[self.add_request(p, cfg)] = idx
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

    This is the reference's ``admission_mode="reserved"`` with
    ``prefix_cache=False``; its other admission modes and the prefix cache
    are not ported yet."""

    def __init__(self, model, max_batch: int, num_pages: int,
                 page_size: int, max_pages: int, prefill_buckets="auto",
                 debug_pages: bool = False, kv_dtype: str = "bf16"):
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
                         prefill_buckets=prefill_buckets)

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
        self.alloc.ensure(slot, self._reserved(plen, cfg))
        self._install_mini(slot, mini, plen)
        return last_logits

    def _warm_prefill(self, width: int) -> None:
        """Warmup's prefill and install at one bucket: slot 0 is free and
        owns no pages, so every row of the install goes to the sink."""
        mini = self.model.init_cache(1, width)
        _, mini = self._run_prefill(np.zeros((1, width), np.int32), width,
                                    mini)
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

    def _retire(self, slot: int) -> None:
        super()._retire(slot)
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

    def _run_segment(self, n_steps: int) -> torch.Tensor:
        # pages claimed in the gap get their scales floored, and the
        # device table takes the gap's allocations, before the segment
        self._flush_fresh_scales()
        self._sync_table()
        return super()._run_segment(n_steps)

    def decode_segment(self, n_steps: int) -> int:
        if self._slot_req and self.alloc.debug:
            self.alloc.check()
        # reserved admission pre-covered every running request's worst
        # case, so no growth can fail
        return super().decode_segment(n_steps)
