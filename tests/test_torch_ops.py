"""The JAX package's remaining public kernel ops against their ports:
K9 ``fused_linear_param_grad_add`` (the Pallas kernel in interpret mode),
K10 ``grouped_matmul`` (the JAX package's CPU fallback of megablox
``gmm``), the stock-layout ``paged_attention`` (over K4; held against the
JAX ``paged_decode_mha`` in interpret mode on the same pools transposed to
its layout, with q multiplied by sqrt(D), since JAX's stock TPU kernel
runs only on a TPU: "Only interpret mode is supported on CPU backend"),
the head-batched flash route (against ``flash_attention_bshd_hb`` in
interpret mode, forward and ``jax.vjp``) and the flag registry.

Tolerances: float32 on both sides (the JAX side at
``jax_default_matmul_precision="highest"``, set by conftest) runs the
same arithmetic summed in another order, a few fp32 ulps at these
magnitudes: atol = rtol = 1e-5, as in test_torch_kernels.py. Products of
bf16 inputs are exact in fp32 and summed in fp32 on both sides, so the
same bar holds where the result stays fp32; where one side rounds to bf16
(the grouped fallback's einsum returns bf16 for bf16 inputs before its
``astype``) the bar is one bf16 step, rtol 2^-7, plus atol 1e-5.
"""
import importlib
import importlib.util
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.framework import flags as jax_flags
from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu.ops.flash_attention_hb import \
    flash_attention_bshd_hb as jax_hb
from paddle_tpu.ops.flash_attention_hb import supports_hb as jax_supports_hb
from paddle_tpu.ops.paged_attention import paged_decode_mha as jax_paged
from paddle_tpu.ops.pallas import grouped_matmul as jax_gmm
import paddle_tpu_torch
from paddle_tpu_torch import ops
from paddle_tpu_torch.framework import flags as port_flags
from paddle_tpu_torch.ops import _build, attention

# the modules: ``ops.paged_attention`` and ``ops.grouped_matmul`` are the
# functions
port_paged = importlib.import_module("paddle_tpu_torch.ops.paged_attention")
port_gmm = importlib.import_module("paddle_tpu_torch.ops.grouped_matmul")
port_grad_add = importlib.import_module("paddle_tpu_torch.ops.grad_add")

TOL = dict(atol=1e-5, rtol=1e-5)
BF16_STEP_TOL = dict(atol=1e-5, rtol=2.0 ** -7)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs: its models and ops are
    tiny, and a thread pool on a machine whose cores other test workers
    hold waits for its threads at every op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _jdt(name):
    return {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[name]


def _tdt(name):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


# -- K9 fused_linear_param_grad_add -----------------------------------------


@pytest.mark.parametrize("x_shape,n,in_dtype,dw_dtype", [
    ((12, 16), 8, "float32", "float32"),          # 2-D x
    ((2, 6, 16), 8, "float32", "float32"),        # 3-D x, flattened to T=12
    ((3, 5, 24), 40, "bfloat16", "float32"),      # bf16 activations
    ((20, 12), 10, "float32", "bfloat16"),        # ragged sizes, bf16 dW
    ((4, 9, 17), 33, "bfloat16", "bfloat16"),     # odd K and N, T=36
])
def test_grad_add_matches_pallas(x_shape, n, in_dtype, dw_dtype):
    """dweight + x^T dy as a new fp32 [K, N] against the Pallas kernel in
    interpret mode; the caller's dweight is left unchanged."""
    rng = np.random.RandomState(sum(x_shape) + n)
    k = x_shape[-1]
    x = rng.randn(*x_shape).astype(np.float32)
    dy = rng.randn(*x_shape[:-1], n).astype(np.float32)
    dw = rng.randn(k, n).astype(np.float32)
    jin, jdw = _jdt(in_dtype), _jdt(dw_dtype)
    ref = pk.fused_linear_param_grad_add(jnp.asarray(x).astype(jin),
                                         jnp.asarray(dy).astype(jin),
                                         jnp.asarray(dw).astype(jdw))
    tin = _tdt(in_dtype)
    tdw = _t(dw).to(_tdt(dw_dtype))
    before = tdw.clone()
    out = ops.fused_linear_param_grad_add(_t(x).to(tin), _t(dy).to(tin), tdw)
    assert out.dtype == torch.float32 and out.shape == (k, n)
    np.testing.assert_allclose(out.numpy(), _np(ref), **TOL)
    assert torch.equal(tdw, before)          # not accumulated in place
    assert out.data_ptr() != tdw.data_ptr()


def test_grad_add_checks_shapes_and_counts_no_cpu_launch():
    ops.reset_launch_counts()
    x, dy = torch.randn(6, 4), torch.randn(6, 3)
    ops.fused_linear_param_grad_add(x, dy, torch.zeros(4, 3))
    assert ops.launch_counts()["grad_add"] == 0
    with pytest.raises(ValueError):
        ops.fused_linear_param_grad_add(x, dy, torch.zeros(3, 4))
    with pytest.raises(ValueError):
        ops.fused_linear_param_grad_add(x, torch.randn(5, 3),
                                        torch.zeros(4, 3))
    m = torch.empty(6, 4, device="meta")
    with pytest.raises(ValueError):
        ops.fused_linear_param_grad_add(m, torch.empty(6, 3, device="meta"),
                                        torch.empty(4, 3, device="meta"))


# -- K10 grouped_matmul ------------------------------------------------------


@pytest.mark.parametrize("sizes,m", [
    ([0, 3, 5, 4], 12),          # first group empty, sum == M
    ([3, 0, 0, 9], 12),          # middle groups empty
    ([5, 7, 0], 12),             # last group empty
    ([2, 3, 1], 12),             # sum < M: rows 6..11 take the last group
    ([0, 4, 0, 0], 9),           # sum < M with empty groups after the sum
])
@pytest.mark.parametrize("in_dtype,out_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"),
    ("bfloat16", "bfloat16")])
def test_grouped_matmul_matches_fallback(sizes, m, in_dtype, out_dtype):
    rng = np.random.RandomState(len(sizes) + m)
    kdim, n = 8, 6
    lhs = rng.randn(m, kdim).astype(np.float32)
    rhs = rng.randn(len(sizes), kdim, n).astype(np.float32)
    gs = np.asarray(sizes, np.int32)
    jin = _jdt(in_dtype)
    ref = jax_gmm(jnp.asarray(lhs).astype(jin), jnp.asarray(rhs).astype(jin),
                  jnp.asarray(gs), preferred_element_type=_jdt(out_dtype))
    tin = _tdt(in_dtype)
    out = ops.grouped_matmul(_t(lhs).to(tin), _t(rhs).to(tin), _t(gs),
                             preferred_element_type=_tdt(out_dtype))
    assert out.dtype == _tdt(out_dtype) and out.shape == (m, n)
    tol = TOL if (in_dtype, out_dtype) == ("float32", "float32") \
        else BF16_STEP_TOL
    np.testing.assert_allclose(out.float().numpy(), _np(ref), **tol)


def test_grouped_matmul_rows_use_their_group_weights():
    """Each group's rows are multiplied by that group's weights (identity
    rows of lhs pick rows of the group's rhs out exactly)."""
    rhs = torch.arange(3 * 2 * 2, dtype=torch.float32).reshape(3, 2, 2)
    lhs = torch.tensor([[1., 0.], [0., 1.], [1., 0.], [0., 1.], [1., 1.]])
    out = ops.grouped_matmul(lhs, rhs, torch.tensor([2, 0, 3]))
    want = torch.stack([rhs[0, 0], rhs[0, 1], rhs[2, 0], rhs[2, 1],
                        rhs[2, 0] + rhs[2, 1]])
    assert torch.equal(out, want)


def test_grouped_matmul_checks_and_counts_no_cpu_launch():
    ops.reset_launch_counts()
    ops.grouped_matmul(torch.randn(4, 3), torch.randn(2, 3, 5),
                       torch.tensor([1, 3]))
    assert ops.launch_counts()["grouped_matmul"] == 0
    with pytest.raises(ValueError):
        ops.grouped_matmul(torch.randn(4, 3), torch.randn(2, 4, 5),
                           torch.tensor([1, 3]))
    with pytest.raises(ValueError):
        ops.grouped_matmul(torch.randn(4, 3), torch.randn(2, 3, 5),
                           torch.tensor([1, 2, 1]))
    m = torch.empty(4, 3, device="meta")
    with pytest.raises(ValueError):
        ops.grouped_matmul(m, torch.empty(2, 3, 5, device="meta"),
                           torch.empty(2, dtype=torch.int32, device="meta"))


# -- K10's tile schedule and the GEMM kernels' dispatch ----------------------


def _segments(sizes, m):
    """numpy: each row's group as the JAX fallback assigns it
    (``clip(#{g: r >= start_g} - 1)``, so rows past the sum take the last
    group, C-ref-5)."""
    sizes = np.asarray(sizes, np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    seg = (np.arange(m)[:, None] >= starts[None, :]).sum(1) - 1
    return np.clip(seg, 0, len(sizes) - 1)


def _schedule_oracle(sizes, m, bm):
    """numpy: runs of bm rows from each group's first row."""
    seg, tiles = _segments(sizes, m), []
    for grp in range(len(sizes)):
        rows = np.flatnonzero(seg == grp)
        for i in range(0, len(rows), bm):
            tiles.append((grp, int(rows[i]), int(rows[i:i + bm][-1]) + 1))
    return tiles


_MOE_SIZES = np.random.RandomState(7).multinomial(
    8192, np.random.RandomState(8).dirichlet(np.full(64, 0.3))).tolist()


@pytest.mark.parametrize("sizes,m,bm", [
    ([0, 3, 5, 4], 12, 4),           # first group empty
    ([3, 0, 0, 9], 12, 4),           # middle groups empty
    ([5, 7, 0], 12, 4),              # last group empty, sum == M
    ([12], 12, 5),                   # one group, M not a multiple of bm
    ([2, 3, 1], 12, 4),              # sum < M: rows 6..11 take the last group
    ([0, 4, 0, 0], 9, 2),            # sum < M with empty groups after it
    ([5, 10], 8, 4),                 # sum > M: the last group is cut
    ([300, 1, 0, 299, 100], 700, 128),
    (_MOE_SIZES, 8192, 128),         # 64 skewed groups, the MoE shape
])
def test_group_tile_schedule_matches_numpy(sizes, m, bm):
    """The schedule the Hopper and fp32 instances of K10 walk: every row is
    stored by exactly one tile, of its own group (the fallback's
    assignment); tiles start at their group's first row, bm rows apart;
    the count never exceeds the grid's ceil(M / bm) + G - 1 row tiles."""
    ends = np.cumsum(sizes).tolist()
    sched = port_gmm.group_tile_schedule(ends, m, bm)
    assert sched == _schedule_oracle(sizes, m, bm)
    seg, stored = _segments(sizes, m), np.zeros(m, np.int64)
    for grp, r0, r1 in sched:
        assert 0 < r1 - r0 <= bm
        assert (seg[r0:r1] == grp).all()
        stored[r0:r1] += 1
    assert (stored == 1).all()
    assert len(sched) <= port_gmm.max_row_tiles(m, len(sizes), bm)
    passes = port_gmm.tile_passes(sizes, m, bm)
    walk = sum(len(set(seg[t:t + bm].tolist())) for t in range(0, m, bm))
    assert passes == {"made": len(sched), "walk": walk,
                      "needed": -(-m // bm)}


def test_max_row_tiles_bounds_every_draw_and_is_reached():
    """The grid is a function of (M, G) alone: it covers every draw of
    group sizes, and sizes that leave one row past each tile boundary
    reach it, so no smaller grid would do."""
    m, g, bm = 1000, 9, 128
    rng = np.random.RandomState(0)
    grid = port_gmm.max_row_tiles(m, g, bm)
    for _ in range(200):
        sizes = rng.multinomial(m, rng.dirichlet(np.full(g, 0.5)))
        assert len(port_gmm.group_tile_schedule(
            np.cumsum(sizes).tolist(), m, bm)) <= grid
    worst = [1] * (g - 1) + [m - (g - 1)]
    assert len(port_gmm.group_tile_schedule(
        np.cumsum(worst).tolist(), m, bm)) == grid


_GOOD = 1 << 20           # a 16-byte aligned pointer


@pytest.mark.parametrize("dtype,k,n,strides,ptrs,want", [
    (torch.bfloat16, 1024, 4096, (1024, 1024 * 4096, 4096), (_GOOD,) * 2,
     "wgmma"),                                   # the MoE up GEMM
    (torch.bfloat16, 72, 136, (72, 72 * 136, 136), (_GOOD,) * 2, "wgmma"),
    (torch.bfloat16, 1024, 4096, (1032, 1024 * 4096, 4096), (_GOOD,) * 2,
     "wgmma"),                                   # padded rows, 16-byte pitch
    (torch.bfloat16, 100, 36, (100, 3600, 36), (_GOOD,) * 2, "mma_sync"),
    (torch.bfloat16, 1024, 36, (1024, 1024 * 36, 36), (_GOOD,) * 2,
     "mma_sync"),                                # N % 8
    (torch.bfloat16, 1024, 4096, (1028, 1024 * 4096, 4096), (_GOOD,) * 2,
     "mma_sync"),                                # lhs pitch not 16 bytes
    (torch.bfloat16, 1024, 4096, (1024, 1024 * 4096 + 4, 4096),
     (_GOOD,) * 2, "mma_sync"),                  # group stride
    (torch.bfloat16, 1024, 4096, (1024, 1024 * 4096, 4096),
     (_GOOD, _GOOD + 8), "mma_sync"),            # rhs base not aligned
    (torch.bfloat16, 0, 4096, (0, 0, 4096), (_GOOD,) * 2, "mma_sync"),
    (torch.float32, 1024, 4096, (1024, 1024 * 4096, 4096), (_GOOD,) * 2,
     "f32"),
    (torch.float32, 70, 36, (70, 70 * 36, 36), (_GOOD + 4,) * 2, "f32"),
])
def test_grouped_matmul_kernel_for(dtype, k, n, strides, ptrs, want):
    assert port_gmm.kernel_for(dtype, k, n, strides, ptrs) == want


@pytest.mark.parametrize("dtype,t,k,n,strides,ptrs,want", [
    (torch.bfloat16, 4096, 4096, 11008, (4096, 11008), (_GOOD,) * 2,
     "wgmma"),                                   # the 7B gate/up linear
    (torch.bfloat16, 1000, 200, 136, (200, 136), (_GOOD,) * 2, "wgmma"),
    (torch.bfloat16, 1000, 200, 136, (208, 136), (_GOOD,) * 2, "wgmma"),
    (torch.bfloat16, 777, 100, 36, (100, 36), (_GOOD,) * 2, "mma_sync"),
    (torch.bfloat16, 777, 96, 36, (96, 36), (_GOOD,) * 2, "mma_sync"),
    (torch.bfloat16, 777, 96, 32, (100, 32), (_GOOD,) * 2, "mma_sync"),
    (torch.bfloat16, 777, 96, 32, (96, 32), (_GOOD + 2, _GOOD),
     "mma_sync"),                                # x base not aligned
    (torch.bfloat16, 0, 96, 32, (96, 32), (_GOOD,) * 2, "mma_sync"),
    (torch.float32, 1000, 96, 200, (96, 200), (_GOOD,) * 2, "f32"),
    (torch.float32, 777, 100, 36, (101, 36), (_GOOD + 4,) * 2, "f32"),
])
def test_grad_add_kernel_for(dtype, t, k, n, strides, ptrs, want):
    assert port_grad_add.kernel_for(dtype, t, k, n, strides, ptrs) == want


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int8])
def test_gemm_kernel_for_refuses_other_dtypes(dtype):
    with pytest.raises(ValueError, match="no kernel"):
        port_gmm.kernel_for(dtype, 64, 64, (64, 64 * 64, 64), (_GOOD,) * 2)
    with pytest.raises(ValueError, match="no kernel"):
        port_grad_add.kernel_for(dtype, 64, 64, 64, (64, 64), (_GOOD,) * 2)


def test_gemm_wrappers_dispatch_through_kernel_for(monkeypatch):
    """On CUDA tensors the wrappers launch the instance ``kernel_for``
    names (with the schedule's workspace for "wgmma" and "f32", sized from
    the shapes); a CUDA tensor is stood in for by patching the device
    checks' view of the device and the launch."""
    seen = []
    monkeypatch.setattr(port_gmm, "_launch", lambda inst, lhs, rhs, ends,
                        out, sched: seen.append(
                            (inst, None if sched is None else sched.numel())))
    monkeypatch.setattr(port_grad_add, "_launch", lambda inst, *a: seen.append(
        (inst, None)))

    class Cuda(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 0)

    def cuda(t):
        return t.as_subclass(Cuda)

    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **kw:
                        cuda(torch.zeros(*a, **kw)))
    monkeypatch.setattr(torch, "cumsum", lambda t, dim, dtype=None: t.to(
        dtype))
    lhs = cuda(torch.zeros(300, 72, dtype=torch.bfloat16))
    sizes = cuda(torch.tensor([0, 5, 100, 0, 3]))
    port_gmm.grouped_matmul(lhs, cuda(torch.zeros(5, 72, 136,
                                                  dtype=torch.bfloat16)),
                            sizes)
    port_gmm.grouped_matmul(cuda(torch.zeros(300, 100, dtype=torch.bfloat16)),
                            cuda(torch.zeros(5, 100, 36,
                                             dtype=torch.bfloat16)), sizes)
    port_gmm.grouped_matmul(cuda(torch.zeros(300, 70)),
                            cuda(torch.zeros(5, 70, 36)), sizes)
    grid = 3 * port_gmm.max_row_tiles(300, 5)
    assert seen == [("wgmma", grid), ("mma_sync", None), ("f32", grid)]
    seen.clear()
    for t, k, n, dt in [(64, 200, 136, torch.bfloat16),
                        (64, 100, 36, torch.bfloat16),
                        (64, 100, 36, torch.float32)]:
        ops.fused_linear_param_grad_add(
            cuda(torch.zeros(t, k, dtype=dt)), cuda(torch.zeros(t, n,
                                                                dtype=dt)),
            cuda(torch.zeros(k, n)))
    assert [i for i, _ in seen] == ["wgmma", "mma_sync", "f32"]


# -- s1 paged_attention (stock layout over K4) -------------------------------


def _stock_case(lens, hq, hkv, d=16, ps=4, maxp=6, seed=0):
    """K4-layout pools [P, ps, Hkv, D] with a fragmented page assignment,
    -1 past each row's pages, and the same pools in the stock layout
    [Hkv, P, ps, D]."""
    rng = np.random.RandomState(seed)
    b = len(lens)
    num_pages = b * maxp + 3
    perm = rng.permutation(num_pages)
    table = np.full((b, maxp), -1, np.int32)
    nxt = 0
    for p in range(maxp):
        for r in range(b):
            if p * ps < lens[r]:
                table[r, p] = perm[nxt]
                nxt += 1
    kp = rng.randn(num_pages, ps, hkv, d).astype(np.float32)
    vp = rng.randn(num_pages, ps, hkv, d).astype(np.float32)
    q = rng.randn(b, hq, d).astype(np.float32)
    stock = (np.ascontiguousarray(kp.transpose(2, 0, 1, 3)),
             np.ascontiguousarray(vp.transpose(2, 0, 1, 3)))
    return q, kp, vp, stock, table, np.asarray(lens, np.int32)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_paged_attention_is_unscaled_paged_decode(hq, hkv):
    """The stock route on [Hkv, P, ps, D] pools equals the JAX
    ``paged_decode_mha`` on the same pools in its layout with q times
    sqrt(D): the stock kernel does not scale q. Row 0 has length 0
    (zeros); the -1 table entries past each length are never read."""
    lens = [0, 1, 5, 13, 24, 7]
    q, kp, vp, (ks, vs), table, ln = _stock_case(lens, hq, hkv, seed=hq)
    d = q.shape[-1]
    ref = jax_paged(jnp.asarray(q * math.sqrt(d)), jnp.asarray(kp),
                    jnp.asarray(vp), jnp.asarray(table), jnp.asarray(ln))
    out = ops.paged_attention(_t(q), _t(ks), _t(vs), _t(ln), _t(table),
                              pages_per_compute_block=2)
    np.testing.assert_allclose(out.numpy(), _np(ref), **TOL)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    plain = ops.paged_attention_ref(_t(q), _t(ks), _t(vs), _t(ln), _t(table),
                                    pages_per_compute_block=3)
    assert torch.equal(out, plain)


def _soft_capped_reference(q, ks, vs, table, lens, cap):
    """paged_attention_kernel.py:263-269 in numpy: qk = q.k (no scale),
    capped = tanh(qk / cap) * cap, masked past the length, softmax, P.V;
    pools [Hkv, P, ps, D]."""
    hkv, _, ps, d = ks.shape
    b, hq, _ = q.shape
    out = np.zeros((b, hq, d), np.float64)
    for r in range(b):
        n = int(lens[r])
        if n == 0:
            continue
        pages = table[r, :(n + ps - 1) // ps]
        for h in range(hq):
            kh = h // (hq // hkv)
            k = ks[kh, pages].reshape(-1, d)[:n].astype(np.float64)
            v = vs[kh, pages].reshape(-1, d)[:n].astype(np.float64)
            qk = k @ q[r, h].astype(np.float64)
            qk = np.tanh(qk / cap) * cap
            p = np.exp(qk - qk.max())
            out[r, h] = (p / p.sum()) @ v
    return out


@pytest.mark.parametrize("cap", [2.0, -2.0, 30.0])
def test_paged_attention_soft_cap(cap):
    lens = [3, 0, 17, 24]
    q, _, _, (ks, vs), table, ln = _stock_case(lens, 4, 2, seed=5)
    q = q * 3.0                            # logits large enough to cap
    out = ops.paged_attention(_t(q), _t(ks), _t(vs), _t(ln), _t(table),
                              pages_per_compute_block=1,
                              attn_logits_soft_cap=cap)
    ref = _soft_capped_reference(q, ks, vs, table, ln, cap)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    uncapped = ops.paged_attention(_t(q), _t(ks), _t(vs), _t(ln), _t(table),
                                   pages_per_compute_block=1)
    assert not torch.allclose(out, uncapped, atol=1e-3)


def test_paged_attention_reads_the_stock_layout_in_place(monkeypatch):
    """The pools reach K4's plain version as permuted views of the caller's
    tensors, and nothing copies a whole pool (the engine's pools were made
    contiguous before; now no pool is)."""
    q, _, _, (ks, vs), table, ln = _stock_case([5, 9], 4, 2, seed=3)
    tk, tv = _t(ks), _t(vs)
    seen, copied = [], []
    real_ref = port_paged.paged_decode_mha_ref

    def spy(q_, kp, vp, *a, **kw):
        seen.append((kp, vp))
        return real_ref(q_, kp, vp, *a, **kw)

    def guard(name):
        real = getattr(torch.Tensor, name)

        def fn(self, *a, **kw):
            if self.numel() >= tk.numel():
                copied.append(name)
            return real(self, *a, **kw)
        return fn

    monkeypatch.setattr(port_paged, "paged_decode_mha_ref", spy)
    for name in ("contiguous", "clone"):
        monkeypatch.setattr(torch.Tensor, name, guard(name))
    ops.paged_attention(_t(q), tk, tv, _t(ln), _t(table),
                        pages_per_compute_block=3)
    (kp, vp), = seen
    assert kp.shape == (tk.shape[1], tk.shape[2], tk.shape[0], tk.shape[3])
    assert kp.data_ptr() == tk.data_ptr() and vp.data_ptr() == tv.data_ptr()
    assert not kp.is_contiguous()
    assert copied == []


def test_paged_attention_argument_checks():
    """The stock kernel's checks (paged_attention_kernel.py:441-483) and
    the TypeError on quantized pools."""
    q, _, _, (ks, vs), table, ln = _stock_case([5, 9], 4, 2, seed=1)
    q, ks, vs, ln, table = _t(q), _t(ks), _t(vs), _t(ln), _t(table)

    def call(q=q, k=ks, v=vs, lens=ln, tab=table, **kw):
        kw.setdefault("pages_per_compute_block", 2)
        return ops.paged_attention(q, k, v, lens, tab, **kw)

    call()
    with pytest.raises(ValueError, match="same shape"):
        call(v=vs[:, :-1])
    with pytest.raises(ValueError, match="divisible by number of KV"):
        call(q=q[:, :3])
    with pytest.raises(ValueError, match="head_dim"):
        call(q=q[..., :8])
    with pytest.raises(ValueError, match="pages_per_compute_block"):
        call(pages_per_compute_block=4)
    with pytest.raises(ValueError, match="lengths"):
        call(lens=ln[:1])
    with pytest.raises(ValueError, match="page_indices"):
        call(tab=table[:1])
    with pytest.raises(ValueError, match="int32"):
        call(lens=ln.long())
    with pytest.raises(ValueError, match="even"):
        call(megacore_mode="kv_head", k=ks[:1], v=vs[:1])
    with pytest.raises(ValueError, match="even"):
        call(megacore_mode="batch", q=q[:1], lens=ln[:1], tab=table[:1])
    with pytest.raises(ValueError, match="megacore_mode"):
        call(megacore_mode="core")
    with pytest.raises(ValueError, match="soft_cap"):
        call(attn_logits_soft_cap=0.0)
    with pytest.raises(TypeError, match="paged_decode_mha"):
        call(k=ks.to(torch.int8), v=vs.to(torch.int8))
    with pytest.raises(ValueError, match="mask_value"):
        call(mask_value=-1e9)
    out = call(megacore_mode="kv_head", inline_seq_dim=False,
               mask_value=float("-inf"))
    assert torch.equal(out, call(mask_value=-float(np.finfo(np.float32).max)))
    assert torch.equal(out, call())
    call(megacore_mode="batch")
    m = torch.empty(2, 4, 16, device="meta")
    with pytest.raises(ValueError):
        ops.paged_attention(m, ks.to("meta"), vs.to("meta"), ln.to("meta"),
                            table.to("meta"), pages_per_compute_block=2)


def test_paged_decode_mha_scale_and_cap_defaults():
    """K4's new arguments default to what the engines ran before: scale
    1/sqrt(D) and no cap."""
    q, kp, vp, _, table, ln = _stock_case([5, 9, 0], 4, 2, seed=2)
    args = (_t(q), _t(kp), _t(vp), _t(table), _t(ln))
    base = ops.paged_decode_mha(*args)
    assert torch.equal(base, ops.paged_decode_mha(
        *args, sm_scale=1.0 / math.sqrt(q.shape[-1])))
    scaled = ops.paged_decode_mha(_t(q * 0.25), *args[1:], sm_scale=1.0)
    np.testing.assert_allclose(scaled.numpy(), base.numpy(), **TOL)


# -- head-batched flash route ------------------------------------------------


def _qkv(b, sq, sk, h, d=8, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, sq, h, d).astype(np.float32),
            rng.randn(b, sk, h, d).astype(np.float32),
            rng.randn(b, sk, h, d).astype(np.float32),
            rng.randn(b, sq, h, d).astype(np.float32))


@pytest.mark.parametrize("causal,sq,sk", [(False, 32, 32), (True, 32, 32),
                                          (True, 16, 32), (False, 16, 40),
                                          (True, 32, 16)])
def test_hb_route_matches_pallas_hb(causal, sq, sk):
    """Forward and gradients of the route against the Pallas head-batched
    kernel in interpret mode (8-row blocks, so several per axis). With
    Sq > Sk (causal) the first Sq - Sk rows see no key: zero output, zero
    dq, finite gradients."""
    q, k, v, do = _qkv(2, sq, sk, 3, seed=sq + sk + causal)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    out_j, vjp = jax.vjp(lambda a, b, c: jax_hb(
        a, b, c, causal=causal, block_q=8, block_k=8, interpret=True),
        jq, jk, jv)
    grads_j = vjp(jnp.asarray(do))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = ops.flash_attention_bshd_hb(tq, tk, tv, causal=causal, block_q=8,
                                      block_k=8)
    out.backward(_t(do))
    np.testing.assert_allclose(out.detach().numpy(), _np(out_j), **TOL)
    for name, got, want in zip("qkv", (tq.grad, tk.grad, tv.grad), grads_j):
        np.testing.assert_allclose(got.numpy(), _np(want), err_msg=name,
                                   **TOL)
        assert torch.isfinite(got).all()
    if causal and sq > sk:
        assert torch.equal(out[:, :sq - sk].detach(),
                           torch.zeros_like(out[:, :sq - sk]))
        assert torch.equal(tq.grad[:, :sq - sk],
                           torch.zeros_like(tq.grad[:, :sq - sk]))


def test_supports_hb_keeps_the_functions_own_conditions():
    for qs, ks, p in [((2, 32, 4, 8), (2, 32, 4, 8), 0.0),
                      ((2, 32, 8, 8), (2, 32, 4, 8), 0.0),      # GQA
                      ((2, 32, 4, 8), (2, 32, 4, 8), 0.1),      # dropout
                      ((1, 48, 2, 16), (1, 80, 2, 16), 0.0)]:
        assert ops.supports_hb(qs, ks, p) == jax_supports_hb(
            qs, ks, p, interpret=True)
    # the TPU-only conditions are not carried over: the VMEM score budget
    # (32 heads at 512 blocks) and the tiling of S by the block
    big = (1, 1024, 32, 128)
    assert not jax_supports_hb(big, big, 0.0, interpret=True)
    assert ops.supports_hb(big, big, 0.0)
    assert ops.supports_hb((1, 1000, 8, 128), (1, 1000, 8, 128), 0.0,
                           block=512)


def test_hb_route_raises_where_the_function_requires():
    x = torch.randn(1, 8, 4, 8)
    with pytest.raises(ValueError, match="Hq == Hkv"):
        ops.flash_attention_bshd_hb(x, x[:, :, :2], x[:, :, :2])
    for bad in (0, -8, 8.0, True):
        with pytest.raises(ValueError, match="positive int"):
            ops.flash_attention_bshd_hb(x, x, x, block_q=bad)
        with pytest.raises(ValueError, match="positive int"):
            ops.flash_attention_bshd_hb(x, x, x, block_k=bad)


def test_router_takes_the_route_only_on_the_card(monkeypatch):
    """With the flag set, CPU tensors stay on the per-head path (the JAX
    router takes the branch only on the TPU); with ``_use_hb`` forced the
    CPU route gives the per-head result bitwise, and counts one call."""
    q, k, v, _ = _qkv(2, 24, 24, 4, seed=9)
    tq, tk, tv = _t(q), _t(k), _t(v)
    base = ops.flash_attention(tq, tk, tv, causal=True)
    ops.reset_launch_counts()
    monkeypatch.setitem(port_flags._REGISTRY, "FLAGS_flash_head_batched",
                        True)
    assert not attention._use_hb(tq, tk, 0.0)
    assert torch.equal(ops.flash_attention(tq, tk, tv, causal=True), base)
    assert ops.route_calls()["flash_hb"] == 0
    monkeypatch.setattr(attention, "_use_hb", lambda *a: True)
    assert torch.equal(ops.flash_attention(tq, tk, tv, causal=True), base)
    assert ops.route_calls()["flash_hb"] == 1
    assert ops.launch_counts()["flash_fwd"] == 0        # CPU: no launches


def test_use_hb_decision(monkeypatch):
    """The branch needs the flag, CUDA tensors and supported shapes; a
    CUDA tensor is stood in for by an object with that device type."""
    class Fake:
        def __init__(self, shape, dev="cuda"):
            self.shape, self.device = shape, torch.device(dev)

    q, k = Fake((1, 8, 4, 8)), Fake((1, 8, 4, 8))
    assert not attention._use_hb(q, k, 0.0)            # flag off
    monkeypatch.setitem(port_flags._REGISTRY, "FLAGS_flash_head_batched",
                        True)
    assert attention._use_hb(q, k, 0.0)
    assert not attention._use_hb(q, Fake((1, 8, 2, 8)), 0.0)     # GQA
    assert not attention._use_hb(q, k, 0.1)                      # dropout
    assert not attention._use_hb(Fake((1, 8, 4, 8), "cpu"), k, 0.0)


# -- flags -------------------------------------------------------------------


def _fresh(module):
    """A new copy of a flags module, so that flags other tests set in this
    process do not enter the comparison of defaults."""
    spec = importlib.util.spec_from_file_location(
        module.__name__ + "_fresh", module.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_flags_match_the_reference_registry(monkeypatch):
    """The port defines the flags it reads, each with the reference's
    default and environment parsing, and no flag that nothing reads."""
    jax_reg, port_reg = (_fresh(m)._REGISTRY for m in (jax_flags,
                                                        port_flags))
    assert set(port_reg) == {"FLAGS_flash_head_batched",
                             "FLAGS_enable_monitor", "FLAGS_enable_trace",
                             "FLAGS_check_nan_inf", "FLAGS_enable_ledger"}
    for name in port_reg:
        assert port_reg[name] == jax_reg[name]
    assert port_reg["FLAGS_flash_head_batched"] is False
    monkeypatch.setenv("FLAGS_flash_head_batched", "1")
    assert (_fresh(port_flags)._REGISTRY["FLAGS_flash_head_batched"]
            is _fresh(jax_flags)._REGISTRY["FLAGS_flash_head_batched"]
            is True)
    assert paddle_tpu_torch.get_flags("FLAGS_unknown") == {
        "FLAGS_unknown": None}


def test_set_flags_and_environment_parsing(monkeypatch):
    monkeypatch.setattr(port_flags, "_REGISTRY", dict(port_flags._REGISTRY))
    paddle_tpu_torch.set_flags({"FLAGS_flash_head_batched": True,
                                "FLAGS_made_up": 3})
    assert paddle_tpu_torch.get_flags(
        ["FLAGS_flash_head_batched", "FLAGS_made_up"]) == {
        "FLAGS_flash_head_batched": True, "FLAGS_made_up": 3}
    for env, default, want in [("TRUE", False, True), ("0", True, False),
                               ("7", 1, 7), ("0.5", 0.25, 0.5),
                               ("x", "y", "x")]:
        monkeypatch.setenv("FLAGS_probe", env)
        assert port_flags.define_flag("FLAGS_probe", default) == want
        assert jax_flags.define_flag("FLAGS_probe", default) == want
    jax_flags._REGISTRY.pop("FLAGS_probe")


# -- builds ------------------------------------------------------------------


@pytest.mark.parametrize("name", ["grad_add", "grouped_matmul"])
def test_new_kernel_build_failure_raises(monkeypatch, tmp_path, name):
    monkeypatch.setattr(_build, "find_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load(name)


# -- launch counting across threads --------------------------------------------

def test_launch_counts_survive_threads_and_captures():
    """``ops._launches``: launches from many threads all land on the counts
    (no lost update under a short switch interval), and a thread inside a
    capture tally keeps its launches off the counts while another thread's
    launches meanwhile still land on them (a graph's replay credit is its
    own launches only)."""
    import sys
    import threading

    from paddle_tpu_torch.ops import _launches

    fn = ops.KERNELS["rms_norm"]
    ops.reset_launch_counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [
            _launches.count(fn) for _ in range(2000)]) for _ in range(16)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    assert fn.launches == 16 * 2000
    ops.reset_launch_counts()
    inside, other = threading.Event(), threading.Event()

    def capturing(box):
        with _launches.capture_tally() as tally:
            _launches.count(fn)
            inside.set()
            other.wait(60)
            _launches.count(fn)
        box.update(tally)

    box = {}
    t = threading.Thread(target=capturing, args=(box,))
    t.start()
    assert inside.wait(60)
    _launches.count(fn)                 # another thread, mid-capture
    other.set()
    t.join(60)
    assert not t.is_alive()
    assert box == {fn: 2} and fn.launches == 1
    _launches.credit(fn, 5)             # a replay of that graph
    assert fn.launches == 6
    ops.reset_launch_counts()
