"""K3: flash attention forward (CUDA C++, ``csrc/flash_fwd.cu``) beside its
plain PyTorch version.

Port of the forward half of
``paddle_tpu/ops/flash_attention_kernel.py::flash_attention_bhsd``
(``_fwd_kernel``/``_fwd_impl``, pallas_call at :331). The port keeps the
repo's ``[B, S, H, D]`` activation layout and hands the kernel its strides,
so no transpose happens around it. Bottom-right causal alignment (query i
attends keys <= i + Sk - Sq), GQA through kv head = h // (Hq / Hkv), fp32
softmax and accumulation, any lengths (the kernel masks the ragged edge).
The TPU kernel's in-kernel dropout is not ported yet: it belongs with the
backward kernels of the training slice.

The wrapper takes the plain version only for CPU tensors; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build

__all__ = ["flash_attention_bshd", "flash_attention_bshd_ref"]

_NEG = -1e30            # the kernel's mask value: no inf - inf NaNs
_HEAD_DIMS = (64, 128)  # instantiated in csrc/flash_fwd.cu


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


def flash_attention_bshd_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = False,
                             sm_scale: Optional[float] = None,
                             chunk: int = 512
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3: the online-softmax recurrence over key chunks
    of ``paddle_tpu/ops/pallas.py::_chunked_attention``, in fp32 (the
    kernel's arithmetic), GQA by repeating kv heads. Returns ``(out
    [B, Sq, Hq, D] in q's dtype, lse [B, Hq, Sq] fp32)``."""
    _check_shapes(q, k, v)
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    qt = q.transpose(1, 2).float()                     # [B, Hq, Sq, D]
    kt = k.transpose(1, 2).float()
    vt = v.transpose(1, 2).float()
    if hkv != hq:
        kt = kt.repeat_interleave(hq // hkv, dim=1)
        vt = vt.repeat_interleave(hq // hkv, dim=1)
    acc = torch.zeros((b, hq, sq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, hq, sq), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hq, sq), dtype=torch.float32, device=q.device)
    qpos = torch.arange(sq, device=q.device)[:, None]
    nchunk = max(1, -(-sk // chunk))
    csize = -(-sk // nchunk)
    for c0 in range(0, sk, csize):
        c1 = min(c0 + csize, sk)
        s = torch.einsum("bhqd,bhkd->bhqk", qt, kt[:, :, c0:c1]) * scale
        kpos = torch.arange(c0, c1, device=q.device)[None, :]
        valid = (kpos <= qpos + (sk - sq)) if causal else \
            torch.ones((sq, c1 - c0), dtype=torch.bool, device=q.device)
        s = s.masked_fill(~valid, _NEG)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None]).masked_fill(~valid, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p, vt[:, :, c0:c1])
        m = m_new
    l_safe = l.clamp_min(1e-30)
    out = (acc / l_safe[..., None]).to(q.dtype).transpose(1, 2).contiguous()
    return out, m + torch.log(l_safe)


def _vec_ready(x: torch.Tensor) -> torch.Tensor:
    """The kernel reads rows as 16-byte vectors: unit stride on D, every
    other stride a multiple of 8 elements, a 16-byte aligned base."""
    ok = (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
          and all(st % 8 == 0 for st in x.stride()[:-1]))
    return x if ok else x.clone(memory_format=torch.contiguous_format)


def _bind(lib: ctypes.CDLL):
    fn = lib.flash_fwd_bf16
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([p] * 5 + [i] * 6 + [ll] * 12
                       + [ctypes.c_float, i, p])
        fn.restype = ctypes.c_int
    return fn


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = False,
                         sm_scale: Optional[float] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention forward over q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D]
    (K3). Returns ``(out [B, Sq, Hq, D], lse [B, Hq, Sq] fp32)``."""
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_bshd_ref(q, k, v, causal, sm_scale)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash attention: no kernel for devices "
                         f"{q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(f"flash attention kernel takes bf16, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes head_dim in "
                         f"{_HEAD_DIMS}, got {d}")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:      # an empty grid is not a launch
        return out, lse
    q, k, v = _vec_ready(q), _vec_ready(k), _vec_ready(v)
    lib = _build.load("flash_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bind(lib)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, sq, sk, hq, hkv, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            float(scale), int(bool(causal)), stream)
    _build.check(lib, err, "flash_fwd_bf16")
    flash_attention_bshd.launches += 1
    return out, lse


flash_attention_bshd.launches = 0
