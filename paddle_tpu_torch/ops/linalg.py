"""Linear algebra (port of ``paddle_tpu/ops/linalg.py``; reachable as
``paddle_tpu_torch.linalg``).

``lstsq`` is the reference's SVD-based least squares on every device: the
least-norm solution, the residuals, the rank and the singular values
(``torch.linalg.lstsq`` on CUDA has only the ``gels`` driver, which assumes
full rank and returns neither rank nor singular values). ``eig`` and
``eigvals`` of a CUDA tensor are computed on the host and moved back, as
torch's own CUDA ``eig`` does; nothing else here leaves the device.
"""
from __future__ import annotations

import builtins

import torch

from ..core.random import Generator
from ._helpers import both, dims, tensor

__all__ = ["matmul", "mm", "bmm", "dot", "mv", "t", "einsum", "norm", "dist",
           "cond", "cross", "cholesky", "cholesky_solve", "triangular_solve",
           "lu", "qr", "svd", "pinv", "inverse", "det", "slogdet",
           "matrix_power", "matrix_rank", "eig", "eigh", "eigvals",
           "eigvalsh", "solve", "lstsq", "multi_dot", "histogram",
           "bincount", "corrcoef", "cov", "cdist", "tensordot", "inv",
           "lu_unpack", "pca_lowrank", "householder_product"]


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    a, b = both(x, y)
    if transpose_x and a.dim() > 1:
        a = a.transpose(-1, -2)
    if transpose_y and b.dim() > 1:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


def mm(input, mat2, name=None):
    return torch.matmul(*both(input, mat2))


def bmm(x, y, name=None):
    return torch.matmul(*both(x, y))


def dot(x, y, name=None):
    a, b = both(x, y)
    return torch.sum(a * b, -1)


def mv(x, vec, name=None):
    return torch.matmul(*both(x, vec))


def t(input, name=None):
    v = tensor(input)
    return v.t() if v.dim() <= 2 else v.transpose(-1, -2)


def einsum(equation, *operands):
    return torch.einsum(equation, *[tensor(o) for o in operands])


def norm(x, p=None, axis=None, keepdim=False, name=None):
    """Vector p-norms over ``axis``; over a pair of axes with p other than
    None or 0, the matrix norm (1, -1, 2, -2, inf, -inf, 'fro', 'nuc'),
    as the reference."""
    v = tensor(x)
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis
    if isinstance(ax, tuple) and len(ax) == 2 and p not in (None, 0):
        return torch.linalg.matrix_norm(v, ord=p, dim=ax, keepdim=keepdim)
    if p is None or p == "fro":
        if ax is None:
            return torch.sqrt(torch.sum(v.float() ** 2)).to(v.dtype)
        return torch.linalg.vector_norm(v, 2, dim=ax, keepdim=keepdim)
    ds = dims(v, ax)
    if p == float("inf"):
        return torch.amax(torch.abs(v), ds, keepdim=keepdim)
    if p == float("-inf"):
        return torch.amin(torch.abs(v), ds, keepdim=keepdim)
    if p == 0:
        return torch.sum((v != 0).to(v.dtype), ds, keepdim=keepdim)
    return torch.sum(torch.abs(v) ** p, ds, keepdim=keepdim) ** (1.0 / p)


def dist(x, y, p=2, name=None):
    a, b = both(x, y)
    return norm(a - b, p=p)


def cond(x, p=None, name=None):
    return torch.linalg.cond(tensor(x), p)


def cross(x, y, axis=9, name=None):
    """The cross product along ``axis`` (default: the first dim of size
    3)."""
    a, b = both(x, y)
    if axis == 9:
        sizes = [i for i, d in enumerate(a.shape) if d == 3]
        if not sizes:
            raise ValueError("no axis of size 3")
        axis = sizes[0]
    return torch.linalg.cross(a, b, dim=axis)


def cholesky(x, upper=False, name=None):
    return torch.linalg.cholesky(tensor(x), upper=upper)


def cholesky_solve(x, y, upper=False, name=None):
    """Solve A X = x with ``y`` the Cholesky factor of A: two triangular
    solves that read only the factor's triangle, as the reference's."""
    b, chol = both(x, y)
    low = chol.transpose(-1, -2) if upper else chol
    z = torch.linalg.solve_triangular(low, b, upper=False)
    return torch.linalg.solve_triangular(low.transpose(-1, -2), z, upper=True)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    """Solve op(x) X = y for triangular ``x``."""
    a, b = both(x, y)
    if transpose:
        a, upper = a.transpose(-1, -2), not upper
    return torch.linalg.solve_triangular(a, b, upper=upper,
                                         unitriangular=unitriangular)


def lu(x, pivot=True, get_infos=False, name=None):
    """The packed LU factors and the 1-based pivots (LAPACK's getrf)."""
    v = tensor(x)
    lu_, piv = torch.linalg.lu_factor(v)
    if get_infos:
        return lu_, piv, torch.zeros((), dtype=torch.int32, device=v.device)
    return lu_, piv


def qr(x, mode="reduced", name=None):
    q, r = torch.linalg.qr(tensor(x), mode=mode)
    return r if mode == "r" else (q, r)


def svd(x, full_matrices=False, name=None):
    """(U, S, VH) with U @ diag(S) @ VH == x."""
    u, s, vh = torch.linalg.svd(tensor(x), full_matrices=full_matrices)
    return u, s, vh


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return torch.linalg.pinv(tensor(x), rtol=rcond, hermitian=hermitian)


def inverse(x, name=None):
    return torch.linalg.inv(tensor(x))


def det(x, name=None):
    return torch.linalg.det(tensor(x))


def slogdet(x, name=None):
    """[sign, log|det|] stacked."""
    sign, logdet = torch.linalg.slogdet(tensor(x))
    return torch.stack([sign, logdet])


def matrix_power(x, n, name=None):
    return torch.linalg.matrix_power(tensor(x), n)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return torch.linalg.matrix_rank(tensor(x), rtol=tol, hermitian=hermitian)


def _on_host(fn, v):
    """fn on the host copy of ``v``, each result moved back."""
    outs = fn(v.cpu())
    if isinstance(outs, torch.Tensor):
        return outs.to(v.device)
    return tuple(o.to(v.device) for o in outs)


def eig(x, name=None):
    """Eigenvalues and eigenvectors of a general matrix (complex); a CUDA
    tensor's are computed on the host."""
    return _on_host(torch.linalg.eig, tensor(x))


def eigh(x, UPLO="L", name=None):
    w, v = torch.linalg.eigh(tensor(x), UPLO=UPLO)
    return w, v


def eigvals(x, name=None):
    return _on_host(torch.linalg.eigvals, tensor(x))


def eigvalsh(x, UPLO="L", name=None):
    return torch.linalg.eigvalsh(tensor(x), UPLO=UPLO)


def solve(x, y, name=None):
    return torch.linalg.solve(*both(x, y))


def lstsq(x, y, rcond=None, driver=None, name=None):
    """Least squares by the SVD, as ``jnp.linalg.lstsq``: the least-norm
    solution, the residuals' squared norms (always), the rank and the
    singular values. Singular values below ``rcond`` times the largest
    (default: eps * max(M, N)) count as zero. ``driver`` is taken for the
    signature's sake."""
    a, b = both(x, y)
    vec = b.dim() == a.dim() - 1
    if vec:
        b = b.unsqueeze(-1)
    m, n = a.shape[-2], a.shape[-1]
    if rcond is None:
        rcond = torch.finfo(a.dtype).eps * builtins.max(m, n)
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    mask = s >= rcond * s[..., :1]
    rank = mask.sum(-1)
    s_inv = torch.where(mask, 1 / torch.where(mask, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    sol = vh.mH @ (s_inv.unsqueeze(-1) * (u.mH @ b))
    resid = torch.sum(torch.abs(b - a @ sol) ** 2, -2)
    if vec:
        sol, resid = sol.squeeze(-1), resid.squeeze(-1)
    return sol, resid, rank, s


def multi_dot(tensors, name=None):
    return torch.linalg.multi_dot([tensor(t) for t in tensors])


def histogram(input, bins=100, min=0, max=0, name=None):
    """Counts of ``bins`` equal bins over [min, max] (the data's range when
    both are 0); the last bin closed."""
    v = tensor(input)
    return torch.histc(v if v.is_floating_point() else v.float(), bins, min,
                       max)


def bincount(x, weights=None, minlength=0, name=None):
    return torch.bincount(tensor(x), None if weights is None
                          else tensor(weights), minlength)


def corrcoef(x, rowvar=True, name=None):
    v = tensor(x)
    return torch.corrcoef(v if rowvar else v.T)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    v = tensor(x)
    return torch.cov(v if rowvar else v.T, correction=int(builtins.bool(ddof)),
                     fweights=fweights, aweights=aweights)


def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary",
          name=None):
    """Pairwise p-distances between the rows of x and y, computed from the
    differences (exactly 0 for equal rows, and differentiable there)."""
    a, b = both(x, y)
    d = a[..., :, None, :] - b[..., None, :, :]
    if p == 2.0:
        d2 = torch.sum(d * d, -1)
        zero = d2 == 0
        return torch.where(zero, torch.zeros_like(d2),
                           torch.sqrt(torch.where(zero, torch.ones_like(d2),
                                                  d2)))
    if p == float("inf"):
        return torch.amax(torch.abs(d), -1)
    if p == 0:
        return torch.sum((d != 0).to(a.dtype), -1)
    return torch.sum(torch.abs(d) ** p, -1) ** (1.0 / p)


def tensordot(x, y, axes=2, name=None):
    if isinstance(axes, torch.Tensor):
        axes = axes.tolist()
    return torch.tensordot(*both(x, y), dims=axes)


def inv(x, name=None):
    """paddle.linalg.inv, the alias of inverse."""
    return inverse(x, name=name)


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """P, L, U from ``lu``'s factors and pivots, with A = P L U."""
    p, l_, u = torch.lu_unpack(tensor(x), tensor(y).to(torch.int32))
    return (p if unpack_pivots else None,
            l_ if unpack_ludata else None,
            u if unpack_ludata else None)


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    """Randomized PCA: (U, S, V). As the reference, the sketch is drawn
    from a generator of seed 0, not the default one, so a call is
    repeatable."""
    a = tensor(x)
    m, n = a.shape[-2], a.shape[-1]
    q = q if q is not None else builtins.min(6, m, n)
    if center:
        a = a - torch.mean(a, -2, keepdim=True)
    omega = torch.randn(a.shape[:-2] + (n, q), generator=Generator(
        0).generator(a.device), dtype=a.dtype, device=a.device)
    y = a @ omega
    for _ in range(niter):
        y = a @ (a.transpose(-1, -2) @ y)
    qmat, _ = torch.linalg.qr(y)
    u_b, s, vt = torch.linalg.svd(qmat.transpose(-1, -2) @ a,
                                  full_matrices=False)
    return qmat @ u_b, s, vt.transpose(-1, -2)


def householder_product(x, tau, name=None):
    """Q = H_1 ... H_k from the reflectors in the columns of ``x`` and
    their coefficients ``tau`` (LAPACK's orgqr), its first n columns."""
    return torch.linalg.householder_product(*both(x, tau))
