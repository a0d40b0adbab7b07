"""Flash attention on Hopper: K3 forward (``csrc/flash_fwd.cu``) and the two
backward kernels (``csrc/flash_bwd.cu``), with their fp32 instances
(``csrc/flash_f32.cu``), each beside its plain PyTorch version, and the
``torch.autograd.Function`` that joins them.

Port of ``paddle_tpu/ops/flash_attention_kernel.py::flash_attention_bhsd``:
``_fwd_kernel``/``_fwd_impl`` (pallas_call at :331), ``_bwd_dq_kernel``
(:497), ``_bwd_dkv_kernel`` (:519) and the ``custom_vjp`` ``_flash``
(:559-582). The port keeps the repo's ``[B, S, H, D]`` activation layout
and hands the kernels its strides, so no transpose happens around them.
Bottom-right causal alignment (query i attends keys <= i + Sk - Sq), GQA
through kv head = h // (Hq / Hkv), fp32 softmax and accumulation, any
lengths (the kernels mask the ragged edge).

Dropout is the TPU kernel's counter hash (``_mix``/``_keep_mask``, a
murmur3 finalizer over seed, batch, query head and the global (q, k)
coordinates), reproduced bit for bit here and in the CUDA kernels, so the
masks of the kernels, of the plain versions and of the JAX package agree
exactly at the same seed, whatever the tile sizes.

Kernels exist for bf16 and fp16 (tensor cores) and fp32 (CUDA cores) at
head dims 64 and 128; :func:`kernel_for` is the dispatch. Any other head
dim up to 128 is zero-padded to the next of those widths around the
kernels, with the softmax scale of the real one, and the outputs sliced
back: zero columns add nothing to a score, their output columns and
gradients are zero, so the padding is exact (``_sublane_plan``'s ``pad``
mode of the JAX kernel). Other dtypes and head dims above 128 raise
``ValueError``.

K3's prefix-chunk instance (:func:`prefix_chunk_attention`, entry points
``flash_fwd_prefix_*``) runs chunked prefill: the port of
``paddle_tpu/ops/pallas.py::prefix_chunk_attention`` (:167-213), queries at
absolute positions ``[pos, pos + C)`` over a cache whose first ``pos + C``
rows are written, with ``pos`` read from a device tensor by the kernel, so
the wrapper never syncs with the host. It is K3 causal with Sk = pos + C,
so its rows are bitwise the rows of a one-shot causal prefill of the same
prompt, on the card and in the plain versions.

The wrappers take the plain version only for CPU tensors; a CUDA tensor
launches the kernel or raises.

K3, K5 and K6 are also the library ops ``paddle_tpu::flash_fwd``,
``paddle_tpu::flash_bwd_dq`` and ``paddle_tpu::flash_bwd_dkv``
(``torch.library.custom_op``: the CUDA implementation is the launch, the
CPU one the plain version, a fake that gives shapes and dtypes only; the
forward's gradient is the two backward ops). :func:`flash_attention_apply`
goes through them only while ``torch.compiler.is_compiling()``, so a
compiled or exported program holds each kernel as one node, and an eager
call is :class:`FlashAttention` as before.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ..core.random import _mix
from . import _build
from ._launches import costed, count

__all__ = ["flash_attention_bshd", "flash_attention_bshd_ref",
           "prefix_chunk_attention", "prefix_chunk_attention_ref",
           "flash_attention_bwd", "flash_attention_bwd_ref",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
           "FlashAttention", "flash_attention_apply", "kernel_for"]

_NEG = -1e30            # the kernels' mask value: no inf - inf NaNs
_U32 = 0xFFFFFFFF
_CHUNK = 512            # query rows per step of the plain backward
_KEY_TILE = 64          # keys per tile of K3 (kBK in csrc/flash_fwd.cu)
_WIDTHS = (64, 128)     # head dims the kernels are instantiated at
# (kernel, dtype) -> (library built from csrc/<library>.cu, entry point)
_ENTRIES = {
    ("flash_fwd", torch.bfloat16): ("flash_fwd", "flash_fwd_bf16"),
    ("flash_fwd", torch.float16): ("flash_fwd", "flash_fwd_f16"),
    ("flash_fwd", torch.float32): ("flash_f32", "flash_fwd_f32"),
    ("flash_fwd_prefix", torch.bfloat16): ("flash_fwd",
                                           "flash_fwd_prefix_bf16"),
    ("flash_fwd_prefix", torch.float16): ("flash_fwd",
                                          "flash_fwd_prefix_f16"),
    ("flash_fwd_prefix", torch.float32): ("flash_f32",
                                          "flash_fwd_prefix_f32"),
    ("flash_bwd_dq", torch.bfloat16): ("flash_bwd", "flash_bwd_dq_bf16"),
    ("flash_bwd_dq", torch.float16): ("flash_bwd", "flash_bwd_dq_f16"),
    ("flash_bwd_dq", torch.float32): ("flash_f32", "flash_bwd_dq_f32"),
    ("flash_bwd_dkv", torch.bfloat16): ("flash_bwd", "flash_bwd_dkv_bf16"),
    ("flash_bwd_dkv", torch.float16): ("flash_bwd", "flash_bwd_dkv_f16"),
    ("flash_bwd_dkv", torch.float32): ("flash_f32", "flash_bwd_dkv_f32"),
}


# ---------------------------------------------------------------------------
# Dropout: the counter hash (uint32 arithmetic in int64, masked after every
# multiply: the low 32 bits of a product survive int64 wrap-around)
# ---------------------------------------------------------------------------


def _threshold(dropout_p: float) -> int:
    return min(int(dropout_p * 4294967296.0), 4294967295)


def _keep_mask(seed, b, h, q0, k0, bq: int, bk: int, dropout_p: float,
               device=None) -> torch.Tensor:
    """Keep-mask of the (bq, bk) score block whose top-left element is the
    global (q0, k0), for batch ``b`` and query head ``h``: deterministic in
    (seed, b, h, global q, global k). ``b`` and ``h`` may be int64 tensors
    that broadcast in front of the block ([..., 1, 1])."""
    def u32(v):
        return torch.as_tensor(v, dtype=torch.int64, device=device) & _U32

    s0 = _mix(u32(seed) ^ ((u32(b) * 0x9E3779B9) & _U32)
              ^ ((u32(h) * 0x85EBCA77) & _U32))
    qi = (u32(q0) + torch.arange(bq, device=device)[:, None]) & _U32
    ki = (u32(k0) + torch.arange(bk, device=device)[None, :]) & _U32
    bits = _mix(_mix((qi + s0) & _U32) ^ ki)
    return bits >= _threshold(dropout_p)     # P(keep) = 1 - dropout_p


def _check_dropout(dropout_p: float) -> None:
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"flash attention takes q [B, Sq, Hq, D] and k = v [B, Sk, Hkv, "
            f"D], got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if (q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]
            or q.shape[2] % k.shape[2]):
        raise ValueError(
            f"Hq={q.shape[2]} not a multiple of Hkv={k.shape[2]} or "
            f"batch/head dim mismatch: {tuple(q.shape)} vs {tuple(k.shape)}")


def _bhsd(x: torch.Tensor, hq: int) -> torch.Tensor:
    """[B, S, H, D] -> fp32 [B, Hq, S, D], kv heads repeated for GQA."""
    t = x.transpose(1, 2).float()
    return t.repeat_interleave(hq // t.shape[1], dim=1) if t.shape[1] != hq \
        else t


def _valid(q0, q1, k0, k1, offset, causal, device):
    """Score-block validity: causal with query i seeing keys <= i +
    ``offset`` (bottom-right alignment: offset = Sk - Sq), all true when
    not causal."""
    if not causal:
        return torch.ones((q1 - q0, k1 - k0), dtype=torch.bool,
                          device=device)
    qpos = torch.arange(q0, q1, device=device)[:, None]
    kpos = torch.arange(k0, k1, device=device)[None, :]
    return kpos <= qpos + offset


def _heads(b: int, h: int, device):
    return (torch.arange(b, device=device)[:, None, None, None],
            torch.arange(h, device=device)[None, :, None, None])


def flash_attention_bshd_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = False,
                             sm_scale: Optional[float] = None,
                             dropout_p: float = 0.0, seed: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3: the online-softmax recurrence of
    ``_fwd_kernel`` over K3's tiles of ``_KEY_TILE`` keys, in fp32 (the
    kernel's arithmetic), GQA by repeating kv heads. The running max is
    updated per tile, and P = exp(s - m) (after dropout and the 1 / (1 -
    p) scale) is rounded to v's dtype before P.V, as the JAX kernel rounds
    it (``pv.astype(v.dtype)``, :292; a no-op in fp32), while the
    normalizer sums the unrounded fp32 p. With dropout only P.V sees the
    mask. Returns ``(out [B, Sq, Hq, D] in q's dtype, lse [B, Hq, Sq]
    fp32)``."""
    _check_shapes(q, k, v)
    _check_dropout(dropout_p)
    return _fwd_ref(q, k, v, causal, sm_scale, dropout_p, seed,
                    k.shape[1] - q.shape[1])


def _fwd_ref(q, k, v, causal, sm_scale, dropout_p, seed, offset):
    """The plain forward's tile walk, causal with query i seeing keys <= i
    + ``offset``. Every tile is ``_KEY_TILE`` keys wide, the last one
    zero-padded past Sk and masked there, as the kernel stages it: a row's
    sums then run over the same tiles whatever Sk is, so a chunk's rows
    equal the one-shot rows bitwise."""
    b, sq, hq, d = q.shape
    sk = k.shape[1]
    dev = q.device
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    qt, kt, vt = _bhsd(q, hq), _bhsd(k, hq), _bhsd(v, hq)
    pad = -sk % _KEY_TILE
    if pad:
        kt, vt = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                  for t in (kt, vt))
    acc = torch.zeros((b, hq, sq, d), dtype=torch.float32, device=dev)
    m = torch.full((b, hq, sq), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hq, sq), dtype=torch.float32, device=dev)
    bi, hi = _heads(b, hq, dev)
    for c0 in range(0, sk, _KEY_TILE):
        c1 = c0 + _KEY_TILE
        s = torch.einsum("bhqd,bhkd->bhqk", qt, kt[:, :, c0:c1]) * scale
        valid = _valid(0, sq, c0, c1, offset, causal, dev)
        if c1 > sk:
            valid = valid & (torch.arange(c0, c1, device=dev) < sk)
        s = s.masked_fill(~valid, _NEG)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None]).masked_fill(~valid, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        if dropout_p > 0.0:
            keep = _keep_mask(seed, bi, hi, 0, c0, sq, c1 - c0, dropout_p,
                              dev)
            p = torch.where(keep, p, 0.0) * (1.0 / (1.0 - dropout_p))
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", _rounded(p, v.dtype), vt[:, :, c0:c1])
        m = m_new
    l_safe = l.clamp_min(1e-30)
    out = (acc / l_safe[..., None]).to(q.dtype).transpose(1, 2).contiguous()
    return out, m + torch.log(l_safe)


def prefix_chunk_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, pos,
                               sm_scale: Optional[float] = None
                               ) -> torch.Tensor:
    """Plain version of K3's prefix-chunk instance: query row i of the
    chunk q [B, C, Hq, D] sits at absolute position ``pos + i`` and
    attends the cache's keys ``<= pos + i``, of which the first
    ``min(W, pos + C)`` rows of k/v_cache [B, W, Hkv, D] are read. It is
    :func:`flash_attention_bshd_ref`'s tile walk (64-key tiles from key 0,
    P rounded to v's dtype at each tile's running max), so its rows equal
    the rows of a one-shot causal prefill of the same prompt. ``pos`` is an
    int or a 0-d tensor. Returns [B, C, Hq, D] in q's dtype."""
    _check_shapes(q, k_cache, v_cache)
    p = int(pos)
    sk = min(k_cache.shape[1], p + q.shape[1])
    out, _ = _fwd_ref(q, k_cache[:, :sk], v_cache[:, :sk], True, sm_scale,
                      0.0, 0, p)
    return out


def _delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(dO * O) in fp32, [B, Hq, Sq] (``_bwd_impl`` :481)."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """fp32 ``x`` rounded to ``dtype`` and back."""
    return x.to(dtype).float()


def flash_attention_bwd_ref(q, k, v, out, lse, do, causal: bool = False,
                            sm_scale: Optional[float] = None,
                            dropout_p: float = 0.0, seed: int = 0):
    """Plain version of the two backward kernels (``_bwd_impl``,
    :475-551), in fp32 over chunks of query rows: P is recomputed from
    the saved lse, rows with no key re-masked to 0, dS = P (dP - delta)
    (with dropout, dS = P_drop dP - P delta), dQ = dS K scale, dK = dS^T Q
    scale, dV = P_drop^T dO, dK and dV summed over each GQA group. dS and
    P_drop are rounded to the inputs' dtypes before the second products,
    as the JAX kernels do (``ds.astype(k.dtype)`` :405, ``pd.astype(
    do.dtype)`` :455, ``ds.astype(q.dtype)`` :458; a no-op in fp32).
    Returns (dq, dk, dv) in the dtypes of q, k, v."""
    _check_shapes(q, k, v)
    _check_dropout(dropout_p)
    return _bwd_ref(q, k, v, do, lse, _delta(out, do), causal, sm_scale,
                    dropout_p, seed)


def _bwd_ref(q, k, v, do, lse, delta, causal, sm_scale, dropout_p, seed,
             want_dq: bool = True, want_dkv: bool = True):
    """:func:`flash_attention_bwd_ref` from ``delta`` = rowsum(dO * O)
    [B, Hq, Sq]: (dq, dk, dv), each None where it is not wanted (the plain
    versions of K5 alone and of K6 alone)."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dev = q.device
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    qt, kt, vt, dot = _bhsd(q, hq), _bhsd(k, hq), _bhsd(v, hq), _bhsd(do, hq)
    dq = torch.empty((b, hq, sq, d), dtype=torch.float32, device=dev)
    dk = torch.zeros((b, hq, sk, d), dtype=torch.float32, device=dev)
    dv = torch.zeros((b, hq, sk, d), dtype=torch.float32, device=dev)
    bi, hi = _heads(b, hq, dev)
    for r0 in range(0, sq, _CHUNK):
        r1 = min(r0 + _CHUNK, sq)
        qc, doc = qt[:, :, r0:r1], dot[:, :, r0:r1]
        s = torch.einsum("bhqd,bhkd->bhqk", qc, kt) * scale
        valid = _valid(r0, r1, 0, sk, sk - sq, causal, dev)
        p = torch.exp(s.masked_fill(~valid, _NEG)
                      - lse[:, :, r0:r1, None].float())
        p = p.masked_fill(~valid, 0.0)
        dp = torch.einsum("bhqd,bhkd->bhqk", doc, vt)
        dl = delta[:, :, r0:r1, None]
        if dropout_p > 0.0:
            keep = _keep_mask(seed, bi, hi, r0, 0, r1 - r0, sk, dropout_p,
                              dev)
            pd = torch.where(keep, p, 0.0) * (1.0 / (1.0 - dropout_p))
            ds = pd * dp - p * dl
        else:
            pd = p
            ds = p * (dp - dl)
        if want_dq:
            dq[:, :, r0:r1] = torch.einsum(
                "bhqk,bhkd->bhqd", _rounded(ds, k.dtype), kt) * scale
        if want_dkv:
            dk += torch.einsum("bhqk,bhqd->bhkd", _rounded(ds, q.dtype),
                               qc) * scale
            dv += torch.einsum("bhqk,bhqd->bhkd", _rounded(pd, do.dtype),
                               doc)
    g = hq // hkv
    dk = dk.view(b, hkv, g, sk, d).sum(2)
    dv = dv.view(b, hkv, g, sk, d).sum(2)
    return (dq.transpose(1, 2).to(q.dtype) if want_dq else None,
            dk.transpose(1, 2).to(k.dtype) if want_dkv else None,
            dv.transpose(1, 2).to(v.dtype) if want_dkv else None)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _vec_ready(x: torch.Tensor) -> torch.Tensor:
    """The kernels read rows as 16-byte vectors: unit stride on D, every
    other stride a multiple of 8 elements, a 16-byte aligned base."""
    ok = (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
          and all(st % 8 == 0 for st in x.stride()[:-1]))
    return x if ok else x.clone(memory_format=torch.contiguous_format)


def kernel_for(kernel: str, dtype: torch.dtype,
               d: int) -> Tuple[str, str, int]:
    """The dispatch of ``kernel`` ("flash_fwd", "flash_fwd_prefix",
    "flash_bwd_dq" or "flash_bwd_dkv") for inputs of ``dtype`` and head
    dim ``d``: ``(library, entry point, width)``, where ``width`` is the instantiated head dim the
    inputs are zero-padded to. Raises ``ValueError`` for a dtype without a
    kernel (other than bf16, fp16 and fp32) and for head dims outside
    1..128."""
    entry = _ENTRIES.get((kernel, dtype))
    if entry is None:
        raise ValueError(
            f"{kernel}: no kernel for {dtype}; the kernels take bfloat16, "
            f"float16 and float32")
    width = next((w for w in _WIDTHS if 0 < d <= w), None)
    if width is None:
        raise ValueError(f"{kernel}: the kernels take head_dim 1 to "
                         f"{_WIDTHS[-1]}, got {d}")
    return entry[0], entry[1], width


def _check_cuda(kernel: str, *ts: torch.Tensor) -> Tuple[str, str, int]:
    """Device and dtype checks of a launch; returns :func:`kernel_for`."""
    dev = ts[0].device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"{kernel}: no kernel for devices "
                         f"{', '.join(str(t.device) for t in ts)}")
    if any(t.dtype != ts[0].dtype for t in ts):
        raise ValueError(f"{kernel}: the kernel takes one dtype, got "
                         f"{'/'.join(str(t.dtype) for t in ts)}")
    return kernel_for(kernel, ts[0].dtype, ts[0].shape[-1])


def _padded(x: torch.Tensor, width: int) -> torch.Tensor:
    """x zero-padded on D to ``width``, with the rows the kernels read."""
    if x.shape[-1] != width:
        x = torch.nn.functional.pad(x, (0, width - x.shape[-1]))
    return _vec_ready(x)


def _sliced(x: torch.Tensor, d: int) -> torch.Tensor:
    return x if x.shape[-1] == d else x[..., :d]


def _dropout_args(dropout_p: float, seed: int):
    """(seed as uint32, keep threshold, 1 / (1 - p), dropout on)."""
    return (ctypes.c_uint32(int(seed) & _U32),
            ctypes.c_uint32(_threshold(dropout_p)),
            ctypes.c_float(1.0 / (1.0 - dropout_p)), int(dropout_p > 0.0))


def _strides(*ts: torch.Tensor):
    return [s for t in ts for s in t.stride()[:3]]


def _bind(lib: ctypes.CDLL, name: str, n_ptr: int, n_ll: int):
    """Entry point ``name``: n_ptr pointers, 6 ints (batch, sq, sk, hq, hkv,
    d), n_ll strides, then scale, causal, the dropout arguments and the
    stream."""
    fn = getattr(lib, name)
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        u, f = ctypes.c_uint32, ctypes.c_float
        fn.argtypes = ([p] * n_ptr + [i] * 6 + [ll] * n_ll
                       + [f, i, u, u, f, i, p])
        fn.restype = ctypes.c_int
    return fn


def _launch(source: str, entry: str, ptrs, shape, strides, scale, causal,
            dropout_p, seed, device) -> None:
    """Call ``entry`` of the library built from ``csrc/<source>.cu`` on
    the current stream and raise if the launch was refused."""
    lib = _build.load(source)
    fn = _bind(lib, entry, len(ptrs), len(strides))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*ptrs, *shape, *strides, ctypes.c_float(scale),
                 int(bool(causal)), *_dropout_args(dropout_p, seed), stream)
    _build.check(lib, err, entry)


def causal_pairs(sq: int, sk: int) -> int:
    """(query, key) pairs a bottom-right causal mask lets through: row i
    sees min(sk, i + 1 + sk - sq) keys, none where that is negative."""
    off = sk - sq
    lo = min(max(-off, 0), sq)          # the rows that see no key
    n = sq - lo
    return n * (lo + 1 + off + sk) // 2 if n > 0 else 0


def _pairs(sq: int, sk: int, causal: bool) -> int:
    return causal_pairs(sq, sk) if causal else sq * sk


def _fwd_cost(q, k, v, causal=False, sm_scale=None, dropout_p=0.0, seed=0):
    """K3's (FLOPs, bytes): 4 D operations a (query, key) pair a head (the
    two products); q, k and v read, out and the fp32 lse written once."""
    b, sq, hq, d = q.shape
    pairs = _pairs(sq, k.shape[1], causal)
    return 4 * d * pairs * hq * b, (
        (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        + b * hq * sq * 4)


def _prefix_cost(q, k_cache, v_cache, pos, sm_scale=None):
    """K3's prefix-chunk instance: the chunk's causal pairs at the offset
    ``pos`` (read from the device: this run's data), q read and out written
    once, the first ``pos + C`` rows of K and V read once."""
    b, c, hq, d = q.shape
    sk, hkv = k_cache.shape[1], k_cache.shape[2]
    keys = min(int(pos) + c, sk)
    return 4 * d * causal_pairs(c, keys) * hq * b, (
        (2 * q.numel() + 2 * b * keys * hkv * d) * q.element_size())


def _bwd_io(q, k, v, do, lse, causal):
    b, sq, hq, d = q.shape
    pairs = _pairs(sq, k.shape[1], causal) * hq * b
    io = ((q.numel() + k.numel() + v.numel() + do.numel())
          * q.element_size() + 2 * lse.numel() * 4)
    return d * pairs, io


def _dq_cost(q, k, v, do, lse, delta, causal=False, *args, **kwargs):
    """K5's (FLOPs, bytes): 6 D operations a pair a head; q, k, v, dO,
    lse and delta read, dq written once."""
    dpairs, io = _bwd_io(q, k, v, do, lse, causal)
    return 6 * dpairs, io + q.numel() * q.element_size()


def _dkv_cost(q, k, v, do, lse, delta, causal=False, *args, **kwargs):
    """K6's (FLOPs, bytes): 8 D operations a pair a head; the inputs of K5
    read, dk and dv written once."""
    dpairs, io = _bwd_io(q, k, v, do, lse, causal)
    return 8 * dpairs, io + (k.numel() + v.numel()) * k.element_size()


def _bwd_cost(q, k, v, out, lse, do, causal=False, *args, **kwargs):
    """The whole backward: K5's and K6's costs."""
    f5, b5 = _dq_cost(q, k, v, do, lse, None, causal)
    f6, b6 = _dkv_cost(q, k, v, do, lse, None, causal)
    return f5 + f6, b5 + b6


@costed(_fwd_cost)
def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = False,
                         sm_scale: Optional[float] = None,
                         dropout_p: float = 0.0, seed: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention forward over q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D]
    (K3), with in-kernel dropout at ``dropout_p`` from ``seed``. Returns
    ``(out [B, Sq, Hq, D], lse [B, Hq, Sq] fp32)``; not differentiable
    (:class:`FlashAttention` is)."""
    _check_shapes(q, k, v)
    _check_dropout(dropout_p)
    if q.device.type == "cpu":
        return flash_attention_bshd_ref(q, k, v, causal, sm_scale,
                                        dropout_p, seed)
    lib, entry, w = _check_cuda("flash_fwd", q, k, v)
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty((b, sq, hq, w), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:      # an empty grid is not a launch
        return _sliced(out, d), lse
    q, k, v = (_padded(t, w) for t in (q, k, v))
    _launch(lib, entry,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr()], (b, sq, sk, hq, hkv, w),
            _strides(q, k, v, out), scale, causal, dropout_p, seed, q.device)
    count(flash_attention_bshd)
    return _sliced(out, d), lse


flash_attention_bshd.launches = 0


@costed(_prefix_cost)
def prefix_chunk_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, pos,
                           sm_scale: Optional[float] = None) -> torch.Tensor:
    """K3's prefix-chunk instance: the chunk q [B, C, Hq, D] at absolute
    positions ``[pos, pos + C)`` attends causally over k/v_cache [B, W,
    Hkv, D] (GQA allowed), whose first ``pos + C`` rows hold the prompt's
    K/V; rows past ``min(W, pos + C)`` are never read. ``pos`` is a 0-d
    int32 tensor on q's device (an int is copied there); the kernel reads
    it from device memory and the wrapper never reads it back, so a CUDA
    graph may capture the call. Returns [B, C, Hq, D] in q's dtype; not
    differentiable (the serving path runs under ``no_grad``)."""
    _check_shapes(q, k_cache, v_cache)
    if q.device.type == "cpu":
        return prefix_chunk_attention_ref(q, k_cache, v_cache, pos, sm_scale)
    lib, entry, w = _check_cuda("flash_fwd_prefix", q, k_cache, v_cache)
    b, sq, hq, d = q.shape
    sk, hkv = k_cache.shape[1], k_cache.shape[2]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    pos = torch.as_tensor(pos, dtype=torch.int32,
                          device=q.device).reshape(()).contiguous()
    out = torch.empty((b, sq, hq, w), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return _sliced(out, d)
    q, k, v = (_padded(t, w) for t in (q, k_cache, v_cache))
    _launch(lib, entry,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), pos.data_ptr()], (b, sq, sk, hq, hkv, w),
            _strides(q, k, v, out), scale, True, 0.0, 0, q.device)
    count(prefix_chunk_attention)
    return _sliced(out, d)


prefix_chunk_attention.launches = 0


@costed(_dq_cost)
def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal: bool = False,
                           sm_scale: Optional[float] = None,
                           dropout_p: float = 0.0, seed: int = 0
                           ) -> torch.Tensor:
    """dq [B, Sq, Hq, D] in q's dtype from the ``flash_bwd_dq`` kernel: one
    block per (query head, batch, 64-query tile), looping over key tiles
    (bf16 and fp16 on the tensor cores, fp32 on the CUDA cores). CUDA
    tensors only: the plain version is :func:`flash_attention_bwd_ref`."""
    _check_shapes(q, k, v)
    lib, entry, w = _check_cuda("flash_bwd_dq", q, k, v, do)
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    dq = torch.empty((b, sq, hq, w), dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return _sliced(dq, d)
    q, k, v, do = (_padded(t, w) for t in (q, k, v, do))
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    _launch(lib, entry,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr()],
            (b, sq, sk, hq, hkv, w), _strides(q, k, v, do, dq), scale,
            causal, dropout_p, seed, q.device)
    count(flash_attention_bwd_dq)
    return _sliced(dq, d)


flash_attention_bwd_dq.launches = 0


@costed(_dkv_cost)
def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal: bool = False,
                            sm_scale: Optional[float] = None,
                            dropout_p: float = 0.0, seed: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B, Sk, Hkv, D] in k's dtype from the ``flash_bwd_dkv``
    kernel: one block per (kv head, batch, 64-key tile), looping over the
    query heads of its group and the query tiles with fp32 accumulators (no
    atomics). CUDA tensors only."""
    _check_shapes(q, k, v)
    lib, entry, w = _check_cuda("flash_bwd_dkv", q, k, v, do)
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    dk = torch.empty((b, sk, hkv, w), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, sk, hkv, w), dtype=v.dtype, device=v.device)
    if dk.numel() == 0:
        return _sliced(dk, d), _sliced(dv, d)
    q, k, v, do = (_padded(t, w) for t in (q, k, v, do))
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    _launch(lib, entry,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr()],
            (b, sq, sk, hq, hkv, w), _strides(q, k, v, do, dk, dv), scale,
            causal, dropout_p, seed, q.device)
    count(flash_attention_bwd_dkv)
    return _sliced(dk, d), _sliced(dv, d)


flash_attention_bwd_dkv.launches = 0


@costed(_bwd_cost)
def flash_attention_bwd(q, k, v, out, lse, do, causal: bool = False,
                        sm_scale: Optional[float] = None,
                        dropout_p: float = 0.0, seed: int = 0):
    """(dq, dk, dv) of flash attention from the saved ``out`` and ``lse``:
    the plain version for CPU tensors, the two backward kernels for CUDA
    tensors (delta = rowsum(dO * O) is computed here, outside the kernels,
    as ``_bwd_impl`` does; a head dim between the kernels' widths is
    padded here once for both kernels)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, do, causal,
                                       sm_scale, dropout_p, seed)
    _, _, w = _check_cuda("flash_bwd_dq", q, k, v, do)
    d = q.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    delta = _delta(out, do)
    q, k, v, do = (_padded(t, w) for t in (q, k, v, do))
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, scale,
                                dropout_p, seed)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal,
                                     scale, dropout_p, seed)
    return _sliced(dq, d), _sliced(dk, d), _sliced(dv, d)


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (the counterpart of ``_flash`` with
    ``_flash_fwd``/``_flash_bwd``): K3 forward, and a backward that runs
    the two backward kernels on CUDA tensors and their plain version on
    CPU tensors, never autograd through the plain forward. Saves
    ``(q, k, v, out, lse)`` and the seed, so the backward regenerates the
    forward's dropout mask."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: Optional[float],
                dropout_p: float, seed: int):
        out, lse = flash_attention_bshd(q, k, v, causal, sm_scale,
                                        dropout_p, seed)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, sm_scale, dropout_p, seed)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None, None


# ---------------------------------------------------------------------------
# K3, K5 and K6 as library ops (the path of compiled and exported programs)
# ---------------------------------------------------------------------------


@torch.library.custom_op("paddle_tpu::flash_fwd", mutates_args=(),
                         device_types="cpu")
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, sm_scale: Optional[float], dropout_p: float,
                  seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 as a library op: ``(out, lse)``, the plain version on the CPU."""
    out, lse = flash_attention_bshd_ref(q, k, v, causal, sm_scale,
                                        dropout_p, seed)
    return out.contiguous(), lse.contiguous()


@_flash_fwd_op.register_kernel("cuda")
def _(q, k, v, causal, sm_scale, dropout_p, seed):
    out, lse = flash_attention_bshd(q, k, v, causal, sm_scale, dropout_p,
                                    seed)
    return out.contiguous(), lse


@_flash_fwd_op.register_fake
def _(q, k, v, causal, sm_scale, dropout_p, seed):
    b, sq, hq, _ = q.shape
    return (torch.empty(q.shape, dtype=q.dtype, device=q.device),
            torch.empty((b, hq, sq), dtype=torch.float32, device=q.device))


@torch.library.custom_op("paddle_tpu::flash_bwd_dq", mutates_args=(),
                         device_types="cpu")
def _flash_bwd_dq_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     do: torch.Tensor, lse: torch.Tensor,
                     delta: torch.Tensor, causal: bool,
                     sm_scale: Optional[float], dropout_p: float,
                     seed: int) -> torch.Tensor:
    """K5 as a library op: dq, the plain backward's dq on the CPU."""
    dq, _, _ = _bwd_ref(q, k, v, do, lse, delta, causal, sm_scale,
                        dropout_p, seed, want_dkv=False)
    return dq.contiguous()


@_flash_bwd_dq_op.register_kernel("cuda")
def _(q, k, v, do, lse, delta, causal, sm_scale, dropout_p, seed):
    return flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, sm_scale,
                                  dropout_p, seed).contiguous()


@_flash_bwd_dq_op.register_fake
def _(q, k, v, do, lse, delta, causal, sm_scale, dropout_p, seed):
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


@torch.library.custom_op("paddle_tpu::flash_bwd_dkv", mutates_args=(),
                         device_types="cpu")
def _flash_bwd_dkv_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, lse: torch.Tensor,
                      delta: torch.Tensor, causal: bool,
                      sm_scale: Optional[float], dropout_p: float,
                      seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6 as a library op: (dk, dv), the plain backward's on the CPU."""
    _, dk, dv = _bwd_ref(q, k, v, do, lse, delta, causal, sm_scale,
                         dropout_p, seed, want_dq=False)
    return dk.contiguous(), dv.contiguous()


@_flash_bwd_dkv_op.register_kernel("cuda")
def _(q, k, v, do, lse, delta, causal, sm_scale, dropout_p, seed):
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal,
                                     sm_scale, dropout_p, seed)
    return dk.contiguous(), dv.contiguous()


@_flash_bwd_dkv_op.register_fake
def _(q, k, v, do, lse, delta, causal, sm_scale, dropout_p, seed):
    return (torch.empty(k.shape, dtype=k.dtype, device=k.device),
            torch.empty(v.shape, dtype=v.dtype, device=v.device))


def _flash_fwd_op_setup(ctx, inputs, output):
    q, k, v, causal, sm_scale, dropout_p, seed = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.args = (causal, sm_scale, dropout_p, seed)
    ctx.mark_non_differentiable(lse)


def _flash_fwd_op_bwd(ctx, do, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    delta = _delta(out, do)
    dq = torch.ops.paddle_tpu.flash_bwd_dq(q, k, v, do, lse, delta,
                                           *ctx.args)
    dk, dv = torch.ops.paddle_tpu.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                *ctx.args)
    return dq, dk, dv, None, None, None, None


_flash_fwd_op.register_autograd(_flash_fwd_op_bwd,
                                setup_context=_flash_fwd_op_setup)


def flash_attention_apply(q, k, v, causal: bool,
                          sm_scale: Optional[float], dropout_p: float,
                          seed: int) -> torch.Tensor:
    """Differentiable flash attention, the output alone: eagerly
    :class:`FlashAttention`; while compiling (``torch.compile``,
    ``torch.export``) the op ``paddle_tpu::flash_fwd``, whose gradient is
    the ops ``paddle_tpu::flash_bwd_dq`` and ``paddle_tpu::flash_bwd_dkv``
    with delta = rowsum(dO * O) between them, as the eager backward
    computes it."""
    if torch.compiler.is_compiling():
        return torch.ops.paddle_tpu.flash_fwd(
            q, k, v, bool(causal),
            None if sm_scale is None else float(sm_scale), float(dropout_p),
            int(seed))[0]
    return FlashAttention.apply(q, k, v, causal, sm_scale, dropout_p, seed)
