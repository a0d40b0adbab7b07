"""K1 ``rms_norm`` and K2 ``fused_rope`` (CUDA C++, ``csrc/norm_rope.cu``)
and K8 ``fused_layer_norm`` (Triton), beside their plain PyTorch versions.

Port of ``paddle_tpu/ops/pallas_kernels.py::rms_norm`` (``_rms_kernel``,
pallas_call at :67), ``::fused_layer_norm`` (``_ln_kernel``, pallas_call in
``_ln_fwd_impl`` at :144) and ``::fused_rope`` (``_rope_kernel``,
pallas_call at :245). All three are single passes that read each input once
and write each output once, with no tensor-core work: memory bandwidth
bounds them. K1 and K2 are warp-level CUDA C++ (rows held in registers,
shuffle reductions, streaming cache hints; the source's note says why) and
launch through ``ctypes`` with their argument types bound once, as the
port's other CUDA kernels do: on the decode paths they launch 64-65 times
a step, so the host's cost of a launch counts. K8 stays in Triton's
one-program-per-row form.

:func:`rms_norm_kernel_for` and :func:`rope_kernel_for` choose each call's
path from its dtype, widths, strides and alignment: the vector kernels
(16-byte chunks) or the element-wise ones of the same source;
:func:`rms_norm_plan` and :func:`rope_plan` give the grid, a pure function
of the shapes and the SM count.

All are differentiable, as the JAX package's ``custom_vjp``s are: the
RMSNorm and LayerNorm backwards are plain PyTorch copies of
``_rms_vjp_bwd`` (:88-100) and ``_ln_vjp_bwd`` (:173-197), XLA in the JAX
package, so no kernel is owed; the RoPE backward runs K2 again on (dO, cos,
-sin), a rotation by -theta (``_rope_vjp_bwd``, :269-273).

Each wrapper takes its plain version only for a CPU tensor; a CUDA tensor
launches the kernel or raises. ``triton`` is imported inside K8's launch,
so this module imports where Triton is absent.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..framework.amp_state import cast_inputs, check_outputs
from . import _build

__all__ = ["rms_norm", "rms_norm_ref", "fused_layer_norm",
           "fused_layer_norm_ref", "fused_rope", "fused_rope_ref",
           "rms_norm_kernel_for", "rms_norm_plan", "rope_kernel_for",
           "rope_plan"]

tl = None      # triton.language, bound by _jit at the first launch
_kernels = {}


def _jit(fn):
    """``triton.jit(fn)``, compiled once. Triton is imported here, at the
    first launch, and its language module becomes this module's ``tl``,
    which the kernel bodies below name (their annotations stay strings)."""
    global tl
    if fn.__name__ not in _kernels:
        import triton
        import triton.language

        tl = triton.language
        _kernels[fn.__name__] = triton.jit(fn)
    return _kernels[fn.__name__]


def _require_cuda(what: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {t.device} and {dev}")
    if dev.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {dev}")


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


# ---------------------------------------------------------------------------
# K1 and K2 in csrc/norm_rope.cu: dispatch, plans and the launch
# ---------------------------------------------------------------------------

# x's dtype -> the entry points' dtype code
_DTYPE_CODE = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
_CHUNK = 16                  # bytes a vector load or store moves
_RMS_WARP_CHUNKS = 4         # 16-byte chunks a lane of a one-warp row holds
_RMS_WIDE_WARPS = 8          # warps a wider row takes, up to 8 chunks a lane
# blocks an SM holds of each K1 vector instance (W, N) (its registers allow
# no more; csrc/norm_rope.cu's RmsShape), and of the element-wise one
_RMS_BLOCKS_PER_SM = {(1, 1): 8, (1, 2): 8, (1, 4): 6, (8, 1): 4, (8, 2): 4,
                      (8, 4): 3, (8, 8): 2}
_RMS_ELEM_BLOCKS_PER_SM = 16
_ROPE_THREADS = 256          # threads in a K2 block at most
_THREADS_PER_SM = 2048
_BLOCKS_PER_SM = 32
_MAX_GRID_Y = 65535
_MAX_INDEX = 2 ** 31 - 1     # the vector paths count elements in 32 bits


def _code(what: str, dtype: torch.dtype) -> int:
    code = _DTYPE_CODE.get(dtype)
    if code is None:
        raise ValueError(f"{what}: no kernel for {dtype}; the kernel takes "
                         f"bfloat16, float16 and float32")
    return code


def rms_norm_kernel_for(dtype: torch.dtype, rows: int, h: int,
                        row_stride: int, ptrs) -> str:
    """K1's path for ``rows`` rows of ``h`` elements of ``dtype``,
    ``row_stride`` elements apart, with ``ptrs`` the data pointers of x, w
    and y: "vec" where every row is a whole number of aligned 16-byte
    chunks (h and the row stride multiples of 16 bytes, the pointers
    16-byte aligned) that 8 warps can hold (at most 32 KB) and every
    offset fits 32 bits, else "elem". Raises ``ValueError`` for dtypes
    other than bf16, fp16 and fp32."""
    _code("rms_norm", dtype)
    el = _CHUNK // dtype.itemsize
    max_chunks = 32 * _RMS_WIDE_WARPS * 8
    vec = (0 < h and h % el == 0 and 0 <= row_stride
           and row_stride % el == 0 and h // el <= max_chunks
           and max(rows - 1, 0) * row_stride + h <= _MAX_INDEX
           and rows * h <= _MAX_INDEX
           and all(p % _CHUNK == 0 for p in ptrs))
    return "vec" if vec else "elem"


@functools.lru_cache(maxsize=256)
def rms_norm_plan(rows: int, h: int, dtype: torch.dtype, path: str,
                  sms: int):
    """K1's grid for ``rows`` rows of ``h`` elements: ``(warps a row W,
    chunks a lane N, blocks)``. The vector path gives a row of up to 2 KB
    (the training step's H = 1024 in bf16) one warp at up to 4 chunks a
    lane, and a wider row 8 warps at up to 8 (H = 4096 in bf16: 2), N the
    power of two that covers the row's chunks; the element-wise path (N =
    0) a warp a row. A block holds 4 teams of a warp or one of 8 warps;
    blocks are as many as the rows need, at most what the SMs hold at
    once; teams then stride over the rows."""
    if path == "vec":
        chunks = h * dtype.itemsize // _CHUNK
        w = 1 if chunks <= 32 * _RMS_WARP_CHUNKS else _RMS_WIDE_WARPS
        n = _next_pow2(-(-chunks // (32 * w)))
        per_sm = _RMS_BLOCKS_PER_SM[(w, n)]
    else:
        w, n, per_sm = 1, 0, _RMS_ELEM_BLOCKS_PER_SM
    teams = max(1, 4 // w)
    return w, n, min(-(-rows // teams), sms * per_sm)


def rope_kernel_for(dtype: torch.dtype, table_dtype: torch.dtype, shape,
                    x_strides, table_strides, ptrs) -> str:
    """K2's path for x of ``dtype`` and ``shape`` (b, s, h, d) with element
    strides ``x_strides`` (b, s, h), tables of ``table_dtype`` (x's or
    fp32) with row strides ``table_strides``, and ``ptrs`` the data
    pointers of x, cos, sin and out: "vec" where each half of D is a whole
    number of aligned 16-byte chunks (D/2 and the strides multiples of 16
    bytes, the pointers 16-byte aligned), a half's chunks fit a block,
    every offset fits 32 bits and the batch fits the grid, else "elem".
    Raises ``ValueError`` for dtypes other than bf16, fp16 and fp32, and
    for odd D."""
    _code("fused_rope", dtype)
    b, s, h, d = shape
    if d % 2:
        raise ValueError(f"fused_rope: no kernel for odd head dim {d}")
    el = _CHUNK // dtype.itemsize
    tab_el = _CHUNK // table_dtype.itemsize
    half = d // 2
    x_end = sum(max(n - 1, 0) * st for n, st in zip((b, s, h), x_strides))
    vec = (0 < half and half % el == 0 and half // el <= _ROPE_THREADS
           and all(0 <= st and st % el == 0 for st in x_strides)
           and all(0 <= st and st % tab_el == 0 for st in table_strides)
           and x_end + d <= _MAX_INDEX and b * s * h * d <= _MAX_INDEX
           and max(s - 1, 0) * max(table_strides) + half <= _MAX_INDEX
           and b <= _MAX_GRID_Y and all(p % _CHUNK == 0 for p in ptrs))
    return "vec" if vec else "elem"


@functools.lru_cache(maxsize=256)
def rope_plan(b: int, s: int, h: int, d: int, dtype: torch.dtype,
              path: str, sms: int):
    """K2's grid for x [b, s, h, d]: ``(heads a block P, positions a block
    T, grid over s, grid over b, grid over head groups)``. On the vector
    path a thread takes one 16-byte chunk of each half of one head at one
    position: a block is (C, P, T), C the chunks of a half, P = min(h, 256
    / C) heads, halved once where the positions alone would leave SMs idle
    (a decode step), T = min(s, 256 / (C P)) positions; the grid covers
    every position and head once. The element-wise path (P = 0) takes a
    block of 256 threads a position, as many blocks as the positions need
    and at most what the SMs hold at once, striding over the rest."""
    if path == "vec":
        c = (d // 2) * dtype.itemsize // _CHUNK
        per_block = min(h, max(1, _ROPE_THREADS // c))
        if -(-s // max(1, min(s, _ROPE_THREADS // (c * per_block)))) * b \
                < sms:
            per_block = -(-per_block // 2)
        teams = max(1, min(s, _ROPE_THREADS // (c * per_block)))
        return (per_block, teams, -(-s // teams), b,
                -(-h // per_block))
    cap = sms * min(_BLOCKS_PER_SM, _THREADS_PER_SM // _ROPE_THREADS)
    grid_b = min(b, cap, _MAX_GRID_Y)
    return 0, 1, min(s, max(1, cap // max(grid_b, 1))), grid_b, 1


_sm_counts = {}


def _sms(device: torch.device) -> int:
    n = _sm_counts.get(device.index)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _sm_counts[device.index] = n
    return n


_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "rms_norm": [_p, _p, _p, _ll, _i, _ll, ctypes.c_float, _i, _i, _i, _i,
                 _i, _p],
    "fused_rope": [_p, _p, _p, _p, _i, _i, _i, _i, _ll, _ll, _ll, _ll, _ll,
                   _i, _i, _i, _i, _i, _i, _i, _p],
}
_entries = {}


def _launch(name: str, device: torch.device, *args) -> None:
    """Call the entry point ``name`` of ``csrc/norm_rope.cu`` with ``args``
    and the current stream of ``device``; raise if it returns an error."""
    bound = _entries.get(name)
    if bound is None:
        lib = _build.load("norm_rope")
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        bound = _entries[name] = (lib, fn)
    lib, fn = bound
    if device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, name)


# ---------------------------------------------------------------------------
# K1: RMSNorm
# ---------------------------------------------------------------------------


def rms_norm_ref(x: torch.Tensor, weight: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """Plain version of K1: ``x * rsqrt(mean(x^2) + eps) * w`` over the last
    dim, in fp32 throughout, cast to x's dtype at the end (``_rms_kernel``'s
    math)."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (y * weight.float()).to(x.dtype)


def _rms_norm_fwd(x: torch.Tensor, weight: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """K1 on a CUDA tensor, its plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return rms_norm_ref(x, weight, eps)
    _require_cuda("rms_norm", x, weight)
    h = x.shape[-1]
    if weight.shape != (h,):
        raise ValueError(f"rms_norm: weight {tuple(weight.shape)} for "
                         f"hidden size {h}")
    code = _code("rms_norm", x.dtype)
    if x.is_contiguous():
        x2, stride = x, h
    else:
        x2 = x.reshape(-1, h)
        if x2.stride(-1) != 1:
            x2 = x2.contiguous()
        stride = x2.stride(0)
    # weights of another dtype go in as fp32, exactly as the plain
    # version's w.float() takes them
    w = (weight if weight.dtype == x.dtype else weight.float()).contiguous()
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    rows = y.numel() // h if h else 0
    path = rms_norm_kernel_for(x.dtype, rows, h, stride,
                               (x2.data_ptr(), w.data_ptr(), y.data_ptr()))
    if rows:
        wr, n, blocks = rms_norm_plan(rows, h, x.dtype, path,
                                      _sms(x.device))
        _launch("rms_norm", x.device, x2.data_ptr(), w.data_ptr(),
                y.data_ptr(), rows, h, stride, float(eps), code,
                int(w.dtype != x.dtype), wr, n, blocks)
        rms_norm.launches += 1
    return y


def _rms_norm_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                  eps: float):
    """(dx, dw) of y = x r w, r = rsqrt(mean(x^2) + eps), in fp32, each cast
    once: dx = w g r - x r^3 / H sum(g w x), dw = sum over rows of g x r."""
    xf, gf, wf = x.float(), g.float(), w.float()
    h = xf.shape[-1]
    r = torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    gw = gf * wf
    dx = gw * r - xf * (r.pow(3) / h) * (gw * xf).sum(-1, keepdim=True)
    dw = (gf * xf * r).reshape(-1, h).sum(0)
    return dx.to(x.dtype), dw.to(w.dtype)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _rms_norm_fwd(x, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = _rms_norm_bwd(x, w, g, ctx.eps)
        return dx, dw, None


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """y = x / sqrt(mean(x^2, -1) + eps) * w over x [..., H] (K1: rows
    held in registers, a warp or a few a row). Differentiable in x and
    w; where no gradient is wanted (the decode paths run under no_grad)
    the autograd Function and its host cost are skipped. Under AMP its
    inputs go to fp32 (black list); under ``FLAGS_check_nan_inf`` its
    output is checked."""
    x, weight = cast_inputs("rms_norm", x, weight)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        y = _RMSNorm.apply(x, weight, eps)
    else:
        y = _rms_norm_fwd(x, weight, eps)
    check_outputs("rms_norm", y)
    return y


rms_norm.launches = 0


# ---------------------------------------------------------------------------
# K8: LayerNorm with optional bias and residual
# ---------------------------------------------------------------------------


def _ln_input(x, residual, bias):
    """z = x [+ bias] [+ residual] in fp32, the order of ``_ln_kernel``."""
    z = x.float()
    if bias is not None:
        z = z + bias.float()
    if residual is not None:
        z = z + residual.float()
    return z


def fused_layer_norm_ref(x: torch.Tensor, residual=None, bias=None,
                         gamma=None, beta=None,
                         eps: float = 1e-5) -> torch.Tensor:
    """Plain version of K8: LN(x [+ bias] [+ residual]) * gamma + beta over
    the last dim, two-pass fp32 mean and variance, cast to x's dtype at the
    end (``_ln_kernel``'s math). gamma and beta default to ones and
    zeros."""
    z = _ln_input(x, residual, bias)
    zc = z - z.mean(-1, keepdim=True)
    y = zc * torch.rsqrt(zc.pow(2).mean(-1, keepdim=True) + eps)
    if gamma is not None:
        y = y * gamma.float()
    if beta is not None:
        y = y + beta.float()
    return y.to(x.dtype)


def _layer_norm_kernel(x_ptr, r_ptr, b_ptr, g_ptr, beta_ptr, y_ptr,
                       x_row_stride, r_row_stride, y_row_stride, n_cols, eps,
                       HAS_RES: tl.constexpr, HAS_BIAS: tl.constexpr,
                       BLOCK: tl.constexpr):
    row = tl.program_id(0)
    cols = tl.arange(0, BLOCK)
    mask = cols < n_cols
    z = tl.load(x_ptr + row * x_row_stride + cols, mask=mask,
                other=0.0).to(tl.float32)
    if HAS_BIAS:
        z += tl.load(b_ptr + cols, mask=mask, other=0.0).to(tl.float32)
    if HAS_RES:
        z += tl.load(r_ptr + row * r_row_stride + cols, mask=mask,
                     other=0.0).to(tl.float32)
    mean = tl.sum(z, axis=0) / n_cols
    zc = tl.where(mask, z - mean, 0.0)      # padded lanes stay out of var
    rstd = tl.rsqrt(tl.sum(zc * zc, axis=0) / n_cols + eps)
    g = tl.load(g_ptr + cols, mask=mask, other=0.0).to(tl.float32)
    beta = tl.load(beta_ptr + cols, mask=mask, other=0.0).to(tl.float32)
    tl.store(y_ptr + row * y_row_stride + cols,
             (zc * rstd * g + beta).to(y_ptr.dtype.element_ty), mask=mask)


def _rows(t: torch.Tensor, h: int) -> torch.Tensor:
    t2 = t.reshape(-1, h)
    return t2 if t2.stride(-1) == 1 else t2.contiguous()


def _layer_norm_fwd(x: torch.Tensor, residual, bias, gamma: torch.Tensor,
                    beta: torch.Tensor, eps: float) -> torch.Tensor:
    """K8 on a CUDA tensor, its plain version on a CPU tensor."""
    h = x.shape[-1]
    if (gamma.shape != (h,) or beta.shape != (h,)
            or (bias is not None and bias.shape != (h,))
            or (residual is not None and residual.shape != x.shape)):
        raise ValueError(f"fused_layer_norm: residual, bias, gamma and beta "
                         f"must match x {tuple(x.shape)}")
    if x.device.type == "cpu":
        return fused_layer_norm_ref(x, residual, bias, gamma, beta, eps)
    _require_cuda("fused_layer_norm", x, gamma, beta,
                  *[t for t in (residual, bias) if t is not None])
    x2 = _rows(x, h)
    r2 = _rows(residual, h) if residual is not None else x2
    y = torch.empty((x2.shape[0], h), dtype=x.dtype, device=x.device)
    if x2.shape[0]:
        block = _next_pow2(h)
        with torch.cuda.device(x.device):
            _jit(_layer_norm_kernel)[(x2.shape[0],)](
                x2, r2, (bias if bias is not None else gamma).contiguous(),
                gamma.contiguous(), beta.contiguous(), y, x2.stride(0),
                r2.stride(0), y.stride(0), h, float(eps),
                HAS_RES=residual is not None, HAS_BIAS=bias is not None,
                BLOCK=block, num_warps=min(max(block // 512, 1), 16))
        fused_layer_norm.launches += 1
    return y.reshape(x.shape)


def _layer_norm_bwd(x, residual, bias, gamma, g, eps: float):
    """(dx, dresidual, dbias, dgamma, dbeta): a plain copy of
    ``_ln_vjp_bwd`` (:173-197), fp32 throughout, each cast once."""
    h = x.shape[-1]
    z = _ln_input(x, residual, bias)
    zc = z - z.mean(-1, keepdim=True)
    rstd = torch.rsqrt(zc.pow(2).mean(-1, keepdim=True) + eps)
    xhat = zc * rstd
    gf = g.float()
    dgamma = (gf * xhat).reshape(-1, h).sum(0)
    dbeta = gf.reshape(-1, h).sum(0)
    dxhat = gf * gamma.float()
    dz = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    dres = dz.to(residual.dtype) if residual is not None else None
    dbias = (dz.reshape(-1, h).sum(0).to(bias.dtype) if bias is not None
             else None)
    return (dz.to(x.dtype), dres, dbias, dgamma.to(gamma.dtype),
            dbeta.to(gamma.dtype))


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, residual, bias, gamma, beta, eps):
        ctx.save_for_backward(x, residual, bias, gamma)
        ctx.eps = eps
        return _layer_norm_fwd(x, residual, bias, gamma, beta, eps)

    @staticmethod
    def backward(ctx, g):
        x, residual, bias, gamma = ctx.saved_tensors
        return (*_layer_norm_bwd(x, residual, bias, gamma, g, ctx.eps), None)


def fused_layer_norm(x: torch.Tensor, residual=None, bias=None, gamma=None,
                     beta=None, eps: float = 1e-5) -> torch.Tensor:
    """LN(x [+ bias] [+ residual]) * gamma + beta over x [..., H] (K8): one
    Triton program per row (a row reduction and an elementwise pass,
    memory-bound, no tensor-core work), at 69% of its bound and faster than
    ``F.layer_norm`` (PERF.md). gamma and beta default to ones and zeros of
    x's dtype, as in ``pallas_kernels.fused_layer_norm`` (:209-213).
    Differentiable in every tensor; the backward is plain PyTorch, as it is
    XLA in the JAX package."""
    h = x.shape[-1]
    if gamma is None:
        gamma = torch.ones(h, dtype=x.dtype, device=x.device)
    if beta is None:
        beta = torch.zeros(h, dtype=x.dtype, device=x.device)
    return _LayerNorm.apply(x, residual, bias, gamma, beta, eps)


fused_layer_norm.launches = 0


# ---------------------------------------------------------------------------
# K2: rotary position embedding (NeoX rotate-half)
# ---------------------------------------------------------------------------


def fused_rope_ref(x: torch.Tensor, cos: torch.Tensor,
                   sin: torch.Tensor) -> torch.Tensor:
    """Plain version of K2 on x [B, S, H, D] with shared tables cos/sin
    [S, D/2]: ``(x1 c - x2 s | x2 c + x1 s)`` in fp32, cast at the end
    (``_rope_kernel``'s math; its roll is the half split)."""
    d2 = x.shape[-1] // 2
    xf = x.float()
    x1, x2 = xf[..., :d2], xf[..., d2:]
    c = cos.float()[None, :, None, :]
    s = sin.float()[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def _rope_fwd(x: torch.Tensor, cos: torch.Tensor,
              sin: torch.Tensor) -> torch.Tensor:
    """K2 on a CUDA tensor, its plain version on a CPU tensor."""
    b, s, h, d = x.shape
    if d % 2 or cos.shape != (s, d // 2) or sin.shape != (s, d // 2):
        raise ValueError(
            f"fused_rope: x {tuple(x.shape)} needs even D and tables of "
            f"shape {(s, d // 2)}, got {tuple(cos.shape)}/{tuple(sin.shape)}")
    if x.device.type == "cpu":
        return fused_rope_ref(x, cos, sin)
    _require_cuda("fused_rope", x, cos, sin)
    code = _code("fused_rope", x.dtype)
    if x.stride(-1) != 1:
        x = x.contiguous()
    # tables of another dtype go in as fp32, exactly as the plain
    # version's cos.float() takes them
    tab = x.dtype
    if cos.dtype != tab or sin.dtype != tab:
        tab = torch.float32
        cos, sin = cos.float(), sin.float()
    if cos.stride(-1) != 1 or sin.stride(-1) != 1:
        cos, sin = cos.contiguous(), sin.contiguous()
    out = torch.empty((b, s, h, d), dtype=x.dtype, device=x.device)
    # a dim of size 1 is never stepped over: its stride is 0
    xs = [st if n > 1 else 0 for n, st in zip(x.shape[:3], x.stride()[:3])]
    ts = [t.stride(0) if s > 1 else 0 for t in (cos, sin)]
    path = rope_kernel_for(x.dtype, tab, (b, s, h, d), xs, ts,
                           (x.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                            out.data_ptr()))
    if out.numel():
        plan = rope_plan(b, s, h, d, x.dtype, path, _sms(x.device))
        _launch("fused_rope", x.device, x.data_ptr(), cos.data_ptr(),
                sin.data_ptr(), out.data_ptr(), b, s, h, d // 2, *xs, *ts,
                code, int(tab != x.dtype), *plan)
        fused_rope.launches += 1
    return out


class _Rope(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cos, sin):
        ctx.save_for_backward(cos, sin)
        return _rope_fwd(x, cos, sin)

    @staticmethod
    def backward(ctx, g):
        cos, sin = ctx.saved_tensors
        return _rope_fwd(g, cos, -sin), None, None   # no table gradient


def fused_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotary embedding of x [B, S, H, D] by shared position tables cos/sin
    [S, D/2] (K2: a team of threads a position, its table row loaded once
    for all its heads), reading x through its strides. Differentiable in
    x; the backward launches K2 with -sin. Where no gradient is wanted the
    autograd Function and its host cost are skipped. Gray under AMP (O2
    casts x and the tables to the AMP dtype); under
    ``FLAGS_check_nan_inf`` its output is checked."""
    x, cos, sin = cast_inputs("fused_rope", x, cos, sin)
    if torch.is_grad_enabled() and x.requires_grad:
        y = _Rope.apply(x, cos, sin)
    else:
        y = _rope_fwd(x, cos, sin)
    check_outputs("fused_rope", y)
    return y


fused_rope.launches = 0
