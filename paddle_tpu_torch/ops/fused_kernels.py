"""K1 ``rms_norm``, K8 ``fused_layer_norm`` and K2 ``fused_rope``: Triton
kernels beside their plain PyTorch versions.

Port of ``paddle_tpu/ops/pallas_kernels.py::rms_norm`` (``_rms_kernel``,
pallas_call at :67), ``::fused_layer_norm`` (``_ln_kernel``, pallas_call in
``_ln_fwd_impl`` at :144) and ``::fused_rope`` (``_rope_kernel``,
pallas_call at :245). All three are single passes that read each input once
and write each output once, with no tensor-core work and no reuse to stage
in shared memory: memory bandwidth bounds them, and Triton's
one-program-per-row form says that directly, which is why they are Triton
and not CUDA C++.

All are differentiable, as the JAX package's ``custom_vjp``s are: the
RMSNorm and LayerNorm backwards are plain PyTorch copies of
``_rms_vjp_bwd`` (:88-100) and ``_ln_vjp_bwd`` (:173-197), XLA in the JAX
package, so no kernel is owed; the RoPE backward runs K2 again on (dO, cos,
-sin), a rotation by -theta (``_rope_vjp_bwd``, :269-273).

Each wrapper takes its plain version only for a CPU tensor; a CUDA tensor
launches the kernel or raises. ``triton`` is imported inside the launch, so
this module imports where Triton is absent.
"""
from __future__ import annotations

import torch

__all__ = ["rms_norm", "rms_norm_ref", "fused_layer_norm",
           "fused_layer_norm_ref", "fused_rope", "fused_rope_ref"]

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


def _rms_norm_kernel(x_ptr, w_ptr, y_ptr, x_row_stride, y_row_stride,
                     n_cols, eps, BLOCK: tl.constexpr):
    row = tl.program_id(0)
    cols = tl.arange(0, BLOCK)
    mask = cols < n_cols
    x = tl.load(x_ptr + row * x_row_stride + cols, mask=mask,
                other=0.0).to(tl.float32)
    r = tl.rsqrt(tl.sum(x * x, axis=0) / n_cols + eps)
    w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
    tl.store(y_ptr + row * y_row_stride + cols,
             (x * r * w).to(y_ptr.dtype.element_ty), mask=mask)


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
    x2 = x.reshape(-1, h)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    w = weight.contiguous()
    y = torch.empty((x2.shape[0], h), dtype=x.dtype, device=x.device)
    if x2.shape[0]:
        block = _next_pow2(h)
        with torch.cuda.device(x.device):
            _jit(_rms_norm_kernel)[(x2.shape[0],)](
                x2, w, y, x2.stride(0), y.stride(0), h, float(eps),
                BLOCK=block, num_warps=min(max(block // 512, 1), 16))
        rms_norm.launches += 1
    return y.reshape(x.shape)


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
    """y = x / sqrt(mean(x^2, -1) + eps) * w over x [..., H]; one Triton
    program per row (K1). Differentiable in x and w."""
    return _RMSNorm.apply(x, weight, eps)


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
    Triton program per row, the same form as K1 (a row reduction and an
    elementwise pass, memory-bound, no tensor-core work: why Triton and not
    CUDA C++). gamma and beta default to ones and zeros of x's dtype, as in
    ``pallas_kernels.fused_layer_norm`` (:209-213). Differentiable in every
    tensor; the backward is plain PyTorch, as it is XLA in the JAX
    package."""
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


def _rope_kernel(x_ptr, cos_ptr, sin_ptr, o_ptr, seq, n_heads, half,
                 sxb, sxs, sxh, scs, sss, sob, sos, soh,
                 BLOCK_H: tl.constexpr, BLOCK_D: tl.constexpr):
    row = tl.program_id(0)          # one (batch, position)
    b = row // seq
    s = row % seq
    hs = tl.program_id(1) * BLOCK_H + tl.arange(0, BLOCK_H)[:, None]
    ds = tl.arange(0, BLOCK_D)[None, :]
    dmask = ds < half
    mask = (hs < n_heads) & dmask
    c = tl.load(cos_ptr + s * scs + ds, mask=dmask, other=0.0).to(tl.float32)
    sn = tl.load(sin_ptr + s * sss + ds, mask=dmask, other=0.0).to(tl.float32)
    xb = x_ptr + b * sxb + s * sxs + hs * sxh
    x1 = tl.load(xb + ds, mask=mask, other=0.0).to(tl.float32)
    x2 = tl.load(xb + half + ds, mask=mask, other=0.0).to(tl.float32)
    ob = o_ptr + b * sob + s * sos + hs * soh
    ty = o_ptr.dtype.element_ty
    tl.store(ob + ds, (x1 * c - x2 * sn).to(ty), mask=mask)
    tl.store(ob + half + ds, (x2 * c + x1 * sn).to(ty), mask=mask)


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
    if x.stride(-1) != 1:
        x = x.contiguous()
    if cos.stride(-1) != 1 or sin.stride(-1) != 1:
        cos, sin = cos.contiguous(), sin.contiguous()
    out = torch.empty((b, s, h, d), dtype=x.dtype, device=x.device)
    if out.numel():
        block_h = min(_next_pow2(h), 16)
        grid = (b * s, -(-h // block_h))
        with torch.cuda.device(x.device):
            _jit(_rope_kernel)[grid](
                x, cos, sin, out, s, h, d // 2,
                x.stride(0), x.stride(1), x.stride(2),
                cos.stride(0), sin.stride(0),
                out.stride(0), out.stride(1), out.stride(2),
                BLOCK_H=block_h, BLOCK_D=_next_pow2(d // 2), num_warps=4)
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
    [S, D/2] (K2): one Triton program per (batch, position, head block),
    indexing the two halves of D directly. Differentiable in x; the
    backward launches K2 with -sin."""
    return _Rope.apply(x, cos, sin)


fused_rope.launches = 0
