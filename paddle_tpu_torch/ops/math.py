"""Elementwise math and reductions (port of ``paddle_tpu/ops/math.py``).

Each op is a plain function on ``torch.Tensor`` with paddle's signature and
the reference's semantics, differentiable through torch's autograd. Where
the torch function of the same name means something else, the reference
wins: ``median`` averages the two middle values of an even count,
``max``/``min`` with an axis return the values only, ``std``/``var`` take
``unbiased``, ``mod``/``remainder``/``floor_divide`` follow the divisor's
sign, and ``cummax``/``cummin`` index the last extremum.
"""
from __future__ import annotations

import builtins
import functools

import torch

from ..core import dtype as dtypes
from ._helpers import (axis_arg, both, dims, inplace_guard, moved_last,
                       tensor)

__all__ = []


def _export(name, fn):
    fn.__name__ = name
    globals()[name] = fn
    __all__.append(name)


def _unary(fn):
    return lambda x, name=None: fn(tensor(x))


def _imag(v):
    return torch.imag(v) if v.is_complex() else torch.zeros_like(v)


def _float(v):
    """Integer and bool inputs of a transcendental op in the default float
    dtype, as jnp promotes them."""
    return v if v.is_floating_point() or v.is_complex() else \
        v.to(dtypes.get_default_dtype())


# ---- unary elementwise -----------------------------------------------------
_UNARY = dict(
    exp=lambda v: torch.exp(_float(v)),
    expm1=lambda v: torch.expm1(_float(v)),
    log=lambda v: torch.log(_float(v)),
    log2=lambda v: torch.log2(_float(v)),
    log10=lambda v: torch.log10(_float(v)),
    log1p=lambda v: torch.log1p(_float(v)),
    sqrt=lambda v: torch.sqrt(_float(v)),
    rsqrt=lambda v: torch.rsqrt(_float(v)),
    square=torch.square,
    abs=torch.abs,
    neg=torch.neg,
    sin=lambda v: torch.sin(_float(v)),
    cos=lambda v: torch.cos(_float(v)),
    tan=lambda v: torch.tan(_float(v)),
    asin=lambda v: torch.asin(_float(v)),
    acos=lambda v: torch.acos(_float(v)),
    atan=lambda v: torch.atan(_float(v)),
    sinh=lambda v: torch.sinh(_float(v)),
    cosh=lambda v: torch.cosh(_float(v)),
    tanh=lambda v: torch.tanh(_float(v)),
    asinh=lambda v: torch.asinh(_float(v)),
    acosh=lambda v: torch.acosh(_float(v)),
    atanh=lambda v: torch.atanh(_float(v)),
    ceil=torch.ceil,
    floor=torch.floor,
    round=torch.round,
    trunc=torch.trunc,
    reciprocal=lambda v: torch.reciprocal(_float(v)),
    sign=torch.sign,
    erf=lambda v: torch.erf(_float(v)),
    erfinv=lambda v: torch.erfinv(_float(v)),
    sigmoid=lambda v: torch.sigmoid(_float(v)),
    digamma=lambda v: torch.digamma(_float(v)),
    lgamma=lambda v: torch.lgamma(_float(v)),
    i0=lambda v: torch.i0(_float(v)),
    i1=lambda v: torch.special.i1(_float(v)),
    frac=lambda v: v - torch.trunc(v),
    angle=torch.angle,
    conj=torch.conj,
    real=torch.real,
    imag=_imag,
    deg2rad=lambda v: torch.deg2rad(_float(v)),
    rad2deg=lambda v: torch.rad2deg(_float(v)),
)
for _n, _f in _UNARY.items():
    _export(_n, _unary(_f))

_export("absolute", _unary(torch.abs))
_export("negative", _unary(torch.neg))


# ---- binary elementwise ----------------------------------------------------
def _binary(fn):
    def op(x, y, name=None):
        return fn(*both(x, y))
    return op


def _heaviside(x, y):
    """0 where x < 0, 1 where x > 0, y where x == 0 (jnp.heaviside)."""
    d = torch.result_type(x, y)
    one, zero = torch.ones((), dtype=d, device=x.device), \
        torch.zeros((), dtype=d, device=x.device)
    return torch.where(x < 0, zero, torch.where(x > 0, one, y.to(d)))


_BINARY = dict(
    add=torch.add,
    subtract=torch.subtract,
    multiply=torch.multiply,
    divide=torch.divide,
    floor_divide=lambda a, b: torch.div(a, b, rounding_mode="floor"),
    mod=torch.remainder,
    remainder=torch.remainder,
    pow=torch.pow,
    maximum=torch.maximum,
    minimum=torch.minimum,
    fmax=torch.fmax,
    fmin=torch.fmin,
    atan2=lambda a, b: torch.atan2(_float(a), _float(b)),
    hypot=torch.hypot,
    logaddexp=torch.logaddexp,
    copysign=torch.copysign,
    nextafter=torch.nextafter,
    ldexp=lambda a, b: a * torch.pow(2.0, b).to(a.dtype),
    heaviside=_heaviside,
    gcd=torch.gcd,
    lcm=torch.lcm,
)
for _n, _f in _BINARY.items():
    _export(_n, _binary(_f))


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    x = tensor(x)
    if bias_after_scale:
        return x * scale + bias
    return (x + bias) * scale


def clip(x, min=None, max=None, name=None):
    v = tensor(x)
    if min is None and max is None:
        return v.clone()
    return torch.clamp(v, min, max)


def lerp(x, y, weight, name=None):
    x, y = both(x, y)
    return x + weight * (y - x)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return scale_b * torch.tanh(scale_a * tensor(x))


def multiplex(inputs, index, name=None):
    stacked = torch.stack([tensor(i) for i in inputs], 0)
    idx = tensor(index).long()
    if idx.dim() > 1:
        idx = idx.squeeze(-1)
    return stacked[idx, torch.arange(stacked.shape[1], device=idx.device)]


for _n in ("scale", "clip", "lerp", "stanh", "multiplex"):
    _export(_n, globals()[_n])


# ---- reductions ------------------------------------------------------------
def _reduce(fn):
    """fn(v, dims, keepdim) over ``axis`` (all dims for None), the result
    cast to ``dtype`` where one is given."""
    def op(x, axis=None, keepdim=False, dtype=None, name=None):
        v = tensor(x)
        out = fn(v, dims(v, axis), keepdim)
        d = dtypes.convert_dtype(dtype)
        return out if d is None else out.to(d)
    return op


def _prod(v, ds, keepdim):
    out = v
    for d in sorted((d % builtins.max(v.dim(), 1) for d in ds),
                    reverse=True):
        out = torch.prod(out, d, keepdim=keepdim)
    return out


_REDUCTIONS = dict(
    sum=lambda v, ds, k: torch.sum(v, ds, keepdim=k),
    mean=lambda v, ds, k: torch.mean(_float(v), ds, keepdim=k),
    prod=_prod,
    max=lambda v, ds, k: torch.amax(v, ds, keepdim=k),
    min=lambda v, ds, k: torch.amin(v, ds, keepdim=k),
    amax=lambda v, ds, k: torch.amax(v, ds, keepdim=k),
    amin=lambda v, ds, k: torch.amin(v, ds, keepdim=k),
    nansum=lambda v, ds, k: torch.nansum(v, ds, keepdim=k),
    nanmean=lambda v, ds, k: torch.nanmean(_float(v), ds, keepdim=k),
    logsumexp=lambda v, ds, k: torch.logsumexp(_float(v), ds, keepdim=k),
    all=lambda v, ds, k: torch.all(v, ds, keepdim=k),
    any=lambda v, ds, k: torch.any(v, ds, keepdim=k),
)
for _n, _f in _REDUCTIONS.items():
    _export(_n, _reduce(_f))


def count_nonzero(x, axis=None, keepdim=False, name=None):
    v = tensor(x)
    return torch.sum(v != 0, dims(v, axis), keepdim=keepdim)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    v = tensor(x)
    return torch.std(v, dims(v, axis), correction=int(builtins.bool(
        unbiased)), keepdim=keepdim)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    v = tensor(x)
    return torch.var(v, dims(v, axis), correction=int(builtins.bool(
        unbiased)), keepdim=keepdim)


def _keep(out, v, kept, ds, keepdim):
    """Put back the reduced dims ``ds`` of ``v`` as ones when ``keepdim``
    (``out`` is q's dims, then the ``kept`` ones)."""
    if not keepdim:
        return out
    lead = out.shape[:out.dim() - len(kept)]
    return out.reshape(*lead, *[1 if d in ds else s
                                for d, s in enumerate(v.shape)])


def _quantile(fn, v, q, axis, keepdim):
    """fn (torch.quantile or torch.nanquantile, linear interpolation) over
    ``axis`` (an int, a tuple or None), q's dims leading."""
    flat, kept, ds = moved_last(v, axis)
    out = fn(_float(flat), q, dim=-1)
    return _keep(out, v, kept, ds, keepdim)


def median(x, axis=None, keepdim=False, name=None):
    """The middle value; for an even count the mean of the two middle
    values (``jnp.median``), not torch's lower one."""
    v = tensor(x)
    return _quantile(torch.quantile, v, 0.5, axis, keepdim)


def quantile(x, q, axis=None, keepdim=False, name=None):
    v = tensor(x)
    qt = q if isinstance(q, float) else torch.as_tensor(
        q, dtype=_float(v).dtype, device=v.device)
    return _quantile(torch.quantile, v, qt, axis, keepdim)


for _n in ("count_nonzero", "std", "var", "median", "quantile"):
    _export(_n, globals()[_n])


# ---- cumulative ------------------------------------------------------------
def _along(v, axis):
    """``v`` and the dim to scan: the flattened tensor for axis None."""
    return (v.reshape(-1), 0) if axis is None else (v, int(axis))


def cumsum(x, axis=None, dtype=None, name=None):
    v, ax = _along(tensor(x), axis)
    out = torch.cumsum(v, ax)
    d = dtypes.convert_dtype(dtype)
    return out if d is None else out.to(d)


def cumprod(x, dim=None, dtype=None, name=None):
    v, ax = _along(tensor(x), dim)
    out = torch.cumprod(v, ax)
    d = dtypes.convert_dtype(dtype)
    return out if d is None else out.to(d)


def cummax(x, axis=None, dtype="int64", name=None):
    """Running maximum and the index of its last occurrence."""
    v, ax = _along(tensor(x), axis)
    out = torch.cummax(v, ax)
    return out.values, out.indices


def cummin(x, axis=None, dtype="int64", name=None):
    v, ax = _along(tensor(x), axis)
    out = torch.cummin(v, ax)
    return out.values, out.indices


def logcumsumexp(x, axis=None, name=None):
    v, ax = _along(tensor(x), axis)
    return torch.logcumsumexp(v, ax)


for _n in ("cumsum", "cumprod", "cummax", "cummin", "logcumsumexp"):
    _export(_n, globals()[_n])


# ---- misc ------------------------------------------------------------------
def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return beta * tensor(input) + alpha * torch.matmul(tensor(x), tensor(y))


def inner(x, y, name=None):
    return torch.inner(*both(x, y))


def outer(x, y, name=None):
    x, y = both(x, y)
    return torch.outer(x.reshape(-1), y.reshape(-1))


def kron(x, y, name=None):
    return torch.kron(*both(x, y))


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(tensor(x), offset, axis1, axis2).sum(-1)


def _edge(e, v, axis):
    """``prepend``/``append`` of diff as a tensor of v's rank (a scalar
    becomes one slice along ``axis``)."""
    if e is None:
        return None
    e = tensor(e, like=v).to(v.dtype)
    if e.dim() == 0:
        shape = list(v.shape)
        shape[axis] = 1
        e = e.expand(shape)
    return e


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    v = tensor(x)
    return torch.diff(v, n, axis, _edge(prepend, v, axis),
                      _edge(append, v, axis))


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return torch.nan_to_num(tensor(x), nan, posinf, neginf)


def increment(x, value=1.0, name=None):
    """x += value in place; returns x."""
    with inplace_guard(x):
        x.add_(value)
    return x


def floor_mod(x, y, name=None):
    return torch.remainder(*both(x, y))


def divide_no_nan(x, y, name=None):
    x, y = both(x, y)
    zero = y == 0
    return torch.where(zero, torch.zeros_like(x),
                       x / torch.where(zero, torch.ones_like(y), y))


for _n in ("addmm", "inner", "outer", "kron", "trace", "diff", "nan_to_num",
           "increment", "floor_mod", "divide_no_nan"):
    _export(_n, globals()[_n])


def logit(x, eps=None, name=None):
    """log(p / (1 - p)); ``eps`` clamps p into [eps, 1 - eps]."""
    p = tensor(x)
    if eps is not None:
        p = torch.clamp(p, eps, 1.0 - eps)
    return torch.log(p) - torch.log1p(-p)


def frexp(x, name=None):
    """Mantissa and exponent, x = m * 2**e with 0.5 <= |m| < 1; the
    exponent in x's dtype."""
    v = tensor(x)
    m, e = torch.frexp(v)
    return m, e.to(v.dtype)


def i0e(x, name=None):
    return torch.special.i0e(_float(tensor(x)))


def i1e(x, name=None):
    return torch.special.i1e(_float(tensor(x)))


def polygamma(x, n, name=None):
    return torch.polygamma(n, _float(tensor(x)))


def sgn(x, name=None):
    """sign for real inputs, x / |x| for complex ones."""
    return torch.sgn(tensor(x))


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    y = tensor(y)
    if x is not None:
        return torch.trapezoid(y, tensor(x, like=y), dim=axis)
    return torch.trapezoid(y, dx=1.0 if dx is None else dx, dim=axis)


def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    y = tensor(y)
    if x is not None:
        return torch.cumulative_trapezoid(y, tensor(x, like=y), dim=axis)
    return torch.cumulative_trapezoid(y, dx=1.0 if dx is None else dx,
                                      dim=axis)


def renorm(x, p, axis, max_norm, name=None):
    """Scale each slice along ``axis`` whose p-norm exceeds ``max_norm``
    down to it."""
    v = tensor(x)
    moved = torch.movedim(v, axis, 0)
    flat = moved.reshape(moved.shape[0], -1)
    norms = torch.sum(torch.abs(flat) ** p, 1) ** (1.0 / p)
    factor = torch.where(norms > max_norm,
                         max_norm / torch.clamp(norms, min=1e-12),
                         torch.ones_like(norms))
    out = flat * factor[:, None]
    return torch.movedim(out.reshape(moved.shape), 0, axis)


def nanmedian(x, axis=None, keepdim=False, name=None):
    """median ignoring NaNs, averaging an even count's middle values."""
    return _quantile(torch.nanquantile, tensor(x), 0.5, axis, keepdim)


def nanquantile(x, q, axis=None, keepdim=False, name=None):
    v = tensor(x)
    qt = q if isinstance(q, float) else torch.as_tensor(
        q, dtype=_float(v).dtype, device=v.device)
    return _quantile(torch.nanquantile, v, qt, axis_arg(axis), keepdim)


def vander(x, n=None, increasing=False, name=None):
    """Columns of powers of ``x``: x^(n-1) ... x^0 (or increasing)."""
    v = tensor(x)
    n = v.shape[0] if n is None else n
    powers = torch.arange(n, device=v.device)
    if not increasing:
        powers = powers.flip(0)
    return v.unsqueeze(-1) ** powers


def add_n(inputs, name=None):
    """The sum of a list of tensors."""
    if isinstance(inputs, (list, tuple)):
        return functools.reduce(torch.add, [tensor(i) for i in inputs])
    return tensor(inputs)


for _n in ("logit", "frexp", "i0e", "i1e", "polygamma", "sgn", "trapezoid",
           "cumulative_trapezoid", "renorm", "nanmedian", "nanquantile",
           "vander", "add_n"):
    _export(_n, globals()[_n])
