"""The plain versions of paddle_tpu_torch's four kernels against the JAX
Pallas kernels they replace, run in interpret mode on the CPU.

On a CPU tensor each kernel wrapper of the port runs its plain PyTorch
version, which repeats the Hopper kernel's arithmetic; the Hopper kernels
themselves are held against these plain versions on the card by
``chip_smoke.py``.

Tolerance: everything here is float32 on both sides, and both sides do the
same fp32 arithmetic; only the order of the sums differs (XLA's reductions
and interpret-mode block loops against ATen's, an online softmax against a
one-shot one). That moves results by a few fp32 ulps at these magnitudes
(|x| <~ 10), so atol = rtol = 1e-5 holds with margin and a wrong mask,
scale, page or head mapping misses it by orders of magnitude.
"""
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu.ops.flash_attention_kernel import _fwd_impl
from paddle_tpu.ops.paged_attention import paged_decode_mha as jax_paged
from paddle_tpu.ops.pallas import _chunked_attention
from paddle_tpu.quantization import kv as jax_kv
from paddle_tpu_torch import ops
from paddle_tpu_torch.ops.attention import flash_attention

# the module: ``ops.paged_attention`` is the stock function
port_paged = importlib.import_module("paddle_tpu_torch.ops.paged_attention")

TOL = dict(atol=1e-5, rtol=1e-5)


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


# -- K1 rms_norm -------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 5, 64), (7, 128), (1, 3, 96)])
def test_rms_norm_matches_pallas(shape):
    rng = np.random.RandomState(0)
    x = (rng.randn(*shape) * 3).astype(np.float32)
    w = rng.randn(shape[-1]).astype(np.float32)
    ref = pk.rms_norm(jnp.asarray(x), jnp.asarray(w), eps=1e-5)
    out = ops.rms_norm(_t(x), _t(w), 1e-5)
    np.testing.assert_allclose(out.numpy(), _np(ref), **TOL)


def test_rms_norm_bf16_casts_once_at_the_end():
    # the Pallas kernel's math: fp32 throughout, one cast of the product
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(4, 64).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.randn(64).astype(np.float32)).bfloat16()
    out = ops.rms_norm(x, w, 1e-6)
    xf, wf = x.float(), w.float()
    want = (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + 1e-6)
            * wf).bfloat16()
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, want)


# -- K2 fused_rope -----------------------------------------------------------


@pytest.mark.parametrize("b,s,h,d", [(2, 8, 4, 16), (1, 13, 3, 32)])
def test_fused_rope_matches_pallas(b, s, h, d):
    rng = np.random.RandomState(2)
    x = rng.randn(b, s, h, d).astype(np.float32)
    ang = rng.rand(s, d // 2).astype(np.float32) * 6.0
    cos, sin = np.cos(ang), np.sin(ang)
    ref = pk.fused_rope(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin))
    out = ops.fused_rope(_t(x), _t(cos), _t(sin))
    np.testing.assert_allclose(out.numpy(), _np(ref), **TOL)


def test_fused_rope_rejects_mismatched_tables():
    x = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError):
        ops.fused_rope(x, torch.zeros(5, 4), torch.zeros(5, 4))


# -- K1/K2 on the card: paths and grids (csrc/norm_rope.cu) -------------------


fused = importlib.import_module("paddle_tpu_torch.ops.fused_kernels")
SMS = 132                                  # an H100's SMs
DTYPES = [torch.bfloat16, torch.float16, torch.float32]
ALIGNED = (0x7f0000000000,) * 4            # 16-byte-aligned pointers


def _covered_once(n, teams):
    """Team t of ``teams`` walks items t, t + teams, .. below n, as the
    kernels' loops do; True if every item is taken exactly once."""
    if n == 0:
        return True
    taken = np.concatenate([np.arange(t, n, teams) for t in range(teams)])
    return bool((np.bincount(taken, minlength=n) == 1).all())


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("h", [20, 64, 1024, 4096, 5120, 8192])
@pytest.mark.parametrize("rows", [0, 1, 8, 512, 16384])
def test_rms_norm_plan_covers_every_row_once(rows, h, dtype):
    """K1's grid: each row taken by one team exactly once, every 16-byte
    chunk of a row by one lane of its team (a warp for rows up to 2 KB, 8
    warps for wider ones; the smallest power of two of chunks a lane), and
    no more blocks than the SMs hold at once."""
    path = fused.rms_norm_kernel_for(dtype, rows, h, h, ALIGNED[:3])
    w, n, blocks = fused.rms_norm_plan(rows, h, dtype, path, SMS)
    es = torch.empty((), dtype=dtype).element_size()
    assert path == ("vec" if h * es % 16 == 0 else "elem")
    if path == "vec":
        chunks = h * es // 16
        assert w == (1 if chunks <= 32 * 4 else 8)
        assert n in (1, 2, 4, 8) and (w == 8 or n <= 4)
        assert 32 * w * n >= chunks             # the team's lanes cover it
        assert n == 1 or 32 * w * (n // 2) < chunks
        cap = SMS * fused._RMS_BLOCKS_PER_SM[(w, n)]
        lanes = np.zeros(chunks, int)
        for tl in range(32 * w):                # lane in the team
            for j in range(n):
                c = j * 32 * w + tl
                if c < chunks:
                    lanes[c] += 1
        assert (lanes == 1).all()
    else:
        assert (w, n) == (1, 0)
        cap = SMS * fused._RMS_ELEM_BLOCKS_PER_SM
    assert blocks <= cap and (blocks > 0) == (rows > 0)
    assert _covered_once(rows, blocks * max(1, 4 // w))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("heads,d", [(32, 128), (8, 128), (40, 128),
                                     (4, 16), (3, 20), (2, 64)])
@pytest.mark.parametrize("positions", [0, 1, 8, 512, 16384])
@pytest.mark.parametrize("rows_of", ["two rows", "one position a row"])
def test_rope_plan_covers_every_position_once(rows_of, positions, heads, d,
                                              dtype):
    """K2's grid: on the vector path every (b, s, head, 16-byte chunk of a
    half) taken by exactly one thread (grid (ceil(s / T), b, ceil(h / P)),
    block (C, P, T)), on the element-wise path every (b, s) by one block,
    striding, and each (head, pair) by one of its threads; blocks of at
    most 256 threads."""
    if rows_of == "two rows":
        b, s = (2, positions // 2) if positions > 1 else (1, positions)
    else:
        b, s = positions, 1
    path = fused.rope_kernel_for(dtype, dtype, (b, s, heads, d),
                                 [s * heads * d, heads * d, d],
                                 [d // 2] * 2, ALIGNED)
    per_block, teams, grid_s, grid_b, grid_h = fused.rope_plan(
        b, s, heads, d, dtype, path, SMS)
    es = torch.empty((), dtype=dtype).element_size()
    half = d // 2
    assert path == ("vec" if half * es % 16 == 0 else "elem")
    if path == "vec":
        c = half * es // 16
        assert 0 < per_block <= heads and 0 < teams <= max(s, 1)
        assert c * per_block * teams <= 256 and grid_b == b
        assert teams <= 64          # CUDA's bound on a block's z dimension
        taken = np.zeros((b, s, heads, c), int)
        for gs in range(grid_s):
            for t in range(teams):
                ss = gs * teams + t
                for gh in range(grid_h):
                    for p in range(per_block):
                        hh = gh * per_block + p
                        if ss < s and hh < heads:
                            taken[:, ss, hh, :] += 1
        assert (taken == 1).all()
    else:
        assert (per_block, teams, grid_h) == (0, 1, 1)
        slots = np.zeros(heads * half, int)
        for t in range(256):
            slots[t::256] += 1
        assert (slots == 1).all()
        cap = SMS * min(32, 2048 // 256)
        assert grid_s * grid_b <= cap and grid_b <= 65535
        assert (grid_s * grid_b > 0) == (positions > 0)
        assert _covered_once(b, grid_b) and _covered_once(s, grid_s)


@pytest.mark.parametrize("dtype,h,stride,ptrs,path", [
    (torch.bfloat16, 4096, 4096, ALIGNED[:3], "vec"),
    (torch.float16, 1024, 2048, ALIGNED[:3], "vec"),     # rows of a wider x
    (torch.float32, 64, 64, ALIGNED[:3], "vec"),
    (torch.float32, 8192, 8192, ALIGNED[:3], "vec"),     # 32 KB, 8 warps
    (torch.bfloat16, 16384, 16384, ALIGNED[:3], "vec"),
    (torch.float32, 16384, 16384, ALIGNED[:3], "elem"),  # wider than that
    (torch.bfloat16, 20, 20, ALIGNED[:3], "elem"),       # 40-byte rows
    (torch.bfloat16, 4096, 4097, ALIGNED[:3], "elem"),   # row stride
    (torch.bfloat16, 4096, 4096, (ALIGNED[0] + 2,) + ALIGNED[:2], "elem"),
    (torch.float32, 4096, 4096, ALIGNED[:2] + (ALIGNED[0] + 8,), "elem")])
def test_rms_norm_kernel_for_table(dtype, h, stride, ptrs, path):
    """K1's path: vector where every row is whole aligned 16-byte chunks
    8 warps can hold (32 KB), element-wise otherwise."""
    assert fused.rms_norm_kernel_for(dtype, 512, h, stride, ptrs) == path


def test_vector_paths_count_in_32_bits():
    """Tensors whose offsets pass 2^31 - 1 elements take the element-wise
    paths, which count in 64 bits."""
    big = 2 ** 31 // 4096
    assert fused.rms_norm_kernel_for(torch.bfloat16, big - 1, 4096, 4096,
                                     ALIGNED[:3]) == "vec"
    assert fused.rms_norm_kernel_for(torch.bfloat16, big, 4096, 4096,
                                     ALIGNED[:3]) == "elem"
    assert fused.rms_norm_kernel_for(torch.bfloat16, big // 2 + 1, 4096, 8192,
                                     ALIGNED[:3]) == "elem"
    strides = (0, 32 * 128, 128)                # positions of 4096
    assert fused.rope_kernel_for(torch.bfloat16, torch.bfloat16,
                                 (1, big + 1, 32, 128), strides, (64, 64),
                                 ALIGNED) == "elem"
    assert fused.rope_kernel_for(torch.bfloat16, torch.bfloat16,
                                 (1, big - 1, 32, 128), strides, (64, 64),
                                 ALIGNED) == "vec"
    assert fused.rope_kernel_for(torch.bfloat16, torch.bfloat16,
                                 (70000, 1, 1, 128), (128, 128, 128), (0, 0),
                                 ALIGNED) == "elem"   # the batch fits no grid


@pytest.mark.parametrize("dtype,tab,d,xs,ts,ptrs,path", [
    (torch.bfloat16, torch.bfloat16, 128, (0, 4096, 128), (64, 64), ALIGNED,
     "vec"),
    (torch.bfloat16, torch.bfloat16, 128, (0, 6144, 128), (0, 0), ALIGNED,
     "vec"),                                 # a q view, one table row
    (torch.float32, torch.float32, 16, (0, 64, 16), (8, 8), ALIGNED, "vec"),
    (torch.bfloat16, torch.float32, 128, (0, 4096, 128), (64, 64), ALIGNED,
     "vec"),                                 # fp32 tables
    (torch.float16, torch.float16, 16, (0, 64, 16), (8, 8), ALIGNED, "vec"),
    (torch.bfloat16, torch.bfloat16, 20, (0, 80, 20), (10, 10), ALIGNED,
     "elem"),                                # 20-byte halves
    (torch.bfloat16, torch.bfloat16, 128, (0, 4096, 130), (64, 64), ALIGNED,
     "elem"),                                # head stride
    (torch.bfloat16, torch.float32, 128, (0, 4096, 128), (66, 66), ALIGNED,
     "elem"),                                # table row stride
    (torch.bfloat16, torch.bfloat16, 128, (0, 4096, 128), (64, 64),
     ALIGNED[:1] + (ALIGNED[0] + 2,) + ALIGNED[2:], "elem")])
def test_rope_kernel_for_table(dtype, tab, d, xs, ts, ptrs, path):
    """K2's path: vector where each half of D is whole aligned 16-byte
    chunks of x, tables and output, element-wise otherwise."""
    assert fused.rope_kernel_for(dtype, tab, (2, 64, 32, d), xs, ts,
                                 ptrs) == path


def test_norm_rope_kernel_for_refusals():
    """fp64 and integer inputs have no kernel, nor an odd head dim."""
    for dt in (torch.float64, torch.int32, torch.int8):
        with pytest.raises(ValueError, match=f"no kernel for {dt}"):
            fused.rms_norm_kernel_for(dt, 8, 64, 64, ALIGNED[:3])
        with pytest.raises(ValueError, match=f"no kernel for {dt}"):
            fused.rope_kernel_for(dt, dt, (1, 2, 1, 64), (0, 64, 64),
                                  (32, 32), ALIGNED)
    with pytest.raises(ValueError, match="odd head dim"):
        fused.rope_kernel_for(torch.bfloat16, torch.bfloat16, (1, 2, 1, 15),
                              (0, 15, 15), (7, 7), ALIGNED)


# -- K3 flash attention forward ----------------------------------------------


def _qkv(b, sq, sk, hq, hkv, d, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, sq, hq, d).astype(np.float32),
            rng.randn(b, sk, hkv, d).astype(np.float32),
            rng.randn(b, sk, hkv, d).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 2)])
@pytest.mark.parametrize("sq,sk", [(16, 16), (8, 32)])
def test_flash_matches_pallas_kernel(causal, hq, hkv, sq, sk):
    """Block-divisible lengths: the Pallas kernel itself (interpret mode),
    output and lse, bottom-right causal alignment when sq < sk."""
    q, k, v = _qkv(2, sq, sk, hq, hkv, 16, seed=hq + sq)
    tr = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3))  # noqa: E731
    scale = 1.0 / math.sqrt(16)
    out_j, lse_j = _fwd_impl(tr(q), tr(k), tr(v), jnp.zeros((1,), jnp.int32),
                             causal, scale, 0.0, 8, 8, True)
    out, lse = ops.flash_attention_bshd(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(out.numpy(), _np(out_j).transpose(0, 2, 1, 3),
                               **TOL)
    np.testing.assert_allclose(lse.numpy(), _np(lse_j)[..., 0], **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(13, 13), (5, 21), (600, 600)])
def test_flash_matches_chunked_attention_ragged(causal, sq, sk):
    """Ragged lengths (no block divides them): ``_chunked_attention``, the
    reference's path for those, with kv heads repeated as it repeats
    them. 600 keys split into two chunks of 300 on both sides."""
    q, k, v = _qkv(1, sq, sk, 4, 2, 8, seed=sq)
    tr = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3))  # noqa: E731
    kr = np.repeat(k, 2, axis=2)
    vr = np.repeat(v, 2, axis=2)
    ref = _chunked_attention(tr(q), tr(kr), tr(vr), causal,
                             1.0 / math.sqrt(8))
    out = flash_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(out.numpy(), _np(ref).transpose(0, 2, 1, 3),
                               **TOL)


def test_flash_causal_rows_without_keys_give_zeros():
    # sq > sk, bottom-right: the first sq - sk queries see no key at all
    q, k, v = _qkv(1, 6, 2, 2, 2, 8, seed=5)
    out, lse = ops.flash_attention_bshd(_t(q), _t(k), _t(v), causal=True)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert torch.equal(out[:, :4], torch.zeros_like(out[:, :4]))


def test_flash_dropout_raises():
    """Dropout is ported (its parity tests are in test_torch_training.py);
    what still raises is a rate outside [0, 1)."""
    q, k, v = (torch.zeros(1, 4, 2, 8) for _ in range(3))
    for p in (1.0, -0.1):
        with pytest.raises(ValueError, match="dropout_p"):
            flash_attention(q, k, v, causal=True, dropout_p=p)
    out = flash_attention(q, k, v, causal=True, dropout_p=0.1, seed=3)
    assert out.shape == q.shape


# -- K4 paged decode attention -----------------------------------------------


def _paged_case(lens, hq, hkv, d=16, ps=4, maxp=6, seed=0, int8=False):
    """Pools with a fragmented page assignment (rows interleave their
    pages), -1 past each row's pages, random K/V everywhere else."""
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
    shape = (num_pages, ps, hkv, d)
    if int8:
        kp = rng.randint(-127, 128, shape).astype(np.int8)
        vp = rng.randint(-127, 128, shape).astype(np.int8)
        ks = (rng.rand(num_pages, hkv) * 3 + jax_kv.KV_SCALE_FLOOR
              ).astype(np.float32)
        vs = (rng.rand(num_pages, hkv) * 3 + jax_kv.KV_SCALE_FLOOR
              ).astype(np.float32)
    else:
        kp = rng.randn(*shape).astype(np.float32)
        vp = rng.randn(*shape).astype(np.float32)
        ks = vs = None
    q = rng.randn(b, hq, d).astype(np.float32)
    return q, kp, vp, table, np.asarray(lens, np.int32), ks, vs


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 2)])
def test_paged_decode_matches_pallas(hq, hkv, int8):
    lens = [0, 1, 5, 13, 24, 7]       # 0 = dead slot; 24 = every page
    q, kp, vp, table, ln, ks, vs = _paged_case(lens, hq, hkv, seed=hq,
                                               int8=int8)
    scales = () if ks is None else (jnp.asarray(ks), jnp.asarray(vs))
    ref = jax_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                    jnp.asarray(table), jnp.asarray(ln), *scales)
    tscales = () if ks is None else (_t(ks), _t(vs))
    out = ops.paged_decode_mha(_t(q), _t(kp), _t(vp), _t(table), _t(ln),
                               *tscales)
    np.testing.assert_allclose(out.numpy(), _np(ref), **TOL)
    assert torch.equal(out[0], torch.zeros_like(out[0]))   # len 0 -> zeros


@pytest.mark.parametrize("qdt,atol,rtol", [
    (np.float16, 1e-5, 2.0 ** -10),   # both round fp32 to fp16 once
    (np.float32, 1e-5, 1e-5)])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_paged_decode_int8_pools_under_fp16_and_fp32_queries(hq, hkv, qdt,
                                                             atol, rtol):
    """int8 pools with scales under an fp16 or an fp32 query, as the JAX
    package's engine stores them under a model of that dtype: the port's
    plain version (which the kernels' int8_f16 and int8_f32 instances are
    held against on the card) against the Pallas kernel in interpret mode,
    which dequantizes to fp32 whatever the query's type. The output takes
    the query's type on both sides; in fp16 the two fp32 results may round
    to neighbouring fp16 values, one fp16 step (2^-10 relative) apart."""
    lens = [0, 1, 5, 13, 24, 7]
    q, kp, vp, table, ln, ks, vs = _paged_case(lens, hq, hkv, seed=11 + hq,
                                               int8=True)
    q = q.astype(qdt)
    ref = jax_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                    jnp.asarray(table), jnp.asarray(ln), jnp.asarray(ks),
                    jnp.asarray(vs))
    out = ops.paged_decode_mha(_t(q), _t(kp), _t(vp), _t(table), _t(ln),
                               _t(ks), _t(vs))
    assert out.dtype == _t(q).dtype and str(ref.dtype) == str(q.dtype)
    np.testing.assert_allclose(_np(out.float().numpy()), _np(ref),
                               atol=atol, rtol=rtol)
    assert torch.equal(out[0], torch.zeros_like(out[0]))   # len 0 -> zeros


def test_paged_decode_ignores_pages_past_length():
    """Entries past a row's length are never read: garbage ids there (and
    garbage in the pages they name) change nothing."""
    q, kp, vp, table, ln, _, _ = _paged_case([3, 9], 4, 2, seed=7)
    base = ops.paged_decode_mha(_t(q), _t(kp), _t(vp), _t(table), _t(ln))
    t2 = table.copy()
    t2[0, 1:] = 0
    t2[1, 3:] = 1
    out = ops.paged_decode_mha(_t(q), _t(kp), _t(vp), _t(t2), _t(ln))
    np.testing.assert_allclose(out.numpy(), base.numpy(), **TOL)


# -- the split of the context over blocks (K4, K7) ---------------------------


@pytest.mark.parametrize("batch,hkv,group,ctx,unit", [
    (8, 32, 1, 1024, 64),      # the 7B serve batch
    (1, 32, 1, 4096, 64),      # batch 1 at Llama-2's context
    (8, 8, 4, 1024, 64),       # GQA 32/8
    (8, 32, 1, 700, 64),       # a capacity no split divides
    (3, 2, 16, 40, 64),        # shorter than one unit: one split
    (2, 1, 9, 24, 4),          # K4 unit of page size 4
    (64, 32, 1, 1024, 64),     # the unsplit grid fills the card already
    (1, 1, 1, 0, 64),          # an empty cache
    (4, 8, 1, 1024, 128),      # K4 unit of page size 128
    (1, 32, 1, 704, 64)])      # 44 pages of 16
def test_split_plan_covers_the_context_once(batch, hkv, group, ctx, unit):
    """Every position of the capacity lies in exactly one split, splits are
    whole units, one split where the plan says so; the plan is a function
    of ints (shapes) alone, so no length is ever read back from the card."""
    split, n = port_decode.split_plan(batch, hkv, group, ctx, 132, unit)
    assert type(split) is int and type(n) is int
    assert split > 0 and split % unit == 0 and n >= 1
    owner = np.arange(ctx) // split
    assert np.array_equal(np.bincount(owner, minlength=n)[:n - 1],
                          np.full(n - 1, split))
    assert owner.max(initial=0) == n - 1 if ctx else n == 1
    blocks = batch * hkv * -(-group // 8)
    target = port_decode._BLOCKS_PER_SM * 132
    if blocks >= target or ctx <= unit:
        assert n == 1
    else:   # within 2x of the target, never past it, or the smallest splits
        assert blocks * n >= target / 2 or split == unit
        assert blocks * (n - 1) < target
    assert port_decode.split_plan(batch, hkv, group, ctx, 132, unit) == (
        split, n)


@pytest.mark.parametrize("ps", [1, 4, 16, 20, 48, 64, 128])
def test_k4_split_unit_is_whole_pages(ps):
    unit = port_paged.split_unit(ps)
    assert unit % ps == 0 and unit >= min(ps, 64)
    if 64 % ps == 0:
        assert unit == 64      # a whole tile of the kernel


@pytest.mark.parametrize("lens,hq,hkv,ps,maxp,split,int8,cap", [
    ([24, 16, 8, 9, 7], 4, 4, 4, 6, 8, False, None),   # on split boundaries
    ([5, 1, 0, 3], 8, 1, 4, 6, 8, False, None),        # shorter than a split
    ([24, 13, 1, 0], 9, 1, 4, 6, 8, True, None),       # int8 with scales
    ([24, 20, 7, 16, 0], 16, 1, 4, 6, 12, False, 5.0),  # soft cap, group 16
    ([700, 600, 120, 60, 1, 0], 2, 2, 20, 35, 60, False, None)])  # cap 700
def test_paged_split_combine_matches_pallas(lens, hq, hkv, ps, maxp, split,
                                            int8, cap):
    """K4's split algebra on the CPU: per-split partials and their combine,
    with the partials of splits past each row's length poisoned (the
    combine must not read them), against the Pallas kernel in interpret
    mode (uncapped; the stock kernel's cap has no Pallas twin here) and the
    unsplit plain version, at atol 1e-5."""
    q, kp, vp, table, ln, ks, vs = _paged_case(lens, hq, hkv, ps=ps,
                                               maxp=maxp, seed=len(lens),
                                               int8=int8)
    tscales = () if ks is None else (_t(ks), _t(vs))
    args = (_t(q), _t(kp), _t(vp), _t(table), _t(ln), *tscales)
    acc, m, l = port_paged.paged_decode_partials_ref(*args, split=split,
                                                     soft_cap=cap)
    assert acc.shape[0] == -(-(maxp * ps) // split)
    live = -(-_t(ln).long() // split)
    for r in range(len(lens)):
        acc[live[r]:, r] = m[live[r]:, r] = l[live[r]:, r] = float("nan")
    out = port_decode.combine_partials_ref(acc, m, l, _t(ln), split,
                                           torch.float32)
    want = ops.paged_decode_mha_ref(*args, soft_cap=cap)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-5, rtol=0)
    if cap is None:
        scales = () if ks is None else (jnp.asarray(ks), jnp.asarray(vs))
        ref = jax_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                        jnp.asarray(table), jnp.asarray(ln), *scales)
        np.testing.assert_allclose(out.numpy(), _np(ref), **TOL)
    for r, n in enumerate(lens):
        if n == 0:
            assert torch.equal(out[r], torch.zeros_like(out[r]))


def test_int8_constants_are_the_reference_ones():
    assert port_paged.KV_QMAX == jax_kv.KV_QMAX
    assert port_paged.KV_SCALE_FLOOR == jax_kv.KV_SCALE_FLOOR


# -- the wrappers' dispatch: entry point, width, or the documented refusal --


port_decode = importlib.import_module("paddle_tpu_torch.ops.decode_attention")
port_flash = importlib.import_module(
    "paddle_tpu_torch.ops.flash_attention_kernel")


@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv"])
@pytest.mark.parametrize("dtype,lib,suffix", [
    (torch.bfloat16, None, "bf16"), (torch.float16, None, "f16"),
    (torch.float32, "flash_f32", "f32")])
@pytest.mark.parametrize("d,width", [(1, 64), (16, 64), (64, 64), (96, 128),
                                     (128, 128)])
def test_flash_dispatch_table(kernel, dtype, lib, suffix, d, width):
    """bf16 and fp16 go to the tensor-core kernels of flash_fwd.cu and
    flash_bwd.cu, fp32 to the CUDA-core instances of flash_f32.cu; a head
    dim is padded to the next instantiated width, 64 or 128."""
    bf16_lib = "flash_fwd" if kernel == "flash_fwd" else "flash_bwd"
    assert port_flash.kernel_for(kernel, dtype, d) == (
        lib or bf16_lib, f"{kernel}_{suffix}", width)


@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv"])
def test_flash_dispatch_refusals(kernel):
    """fp64 and head dims above 128 (or empty) have no kernel."""
    with pytest.raises(ValueError, match="no kernel for torch.float64"):
        port_flash.kernel_for(kernel, torch.float64, 64)
    for d in (0, 129, 256):
        with pytest.raises(ValueError, match="head_dim 1 to 128"):
            port_flash.kernel_for(kernel, torch.bfloat16, d)


@pytest.mark.parametrize("dtype,entry", [(torch.bfloat16, "decode_mha_bf16"),
                                         (torch.float16, "decode_mha_f16"),
                                         (torch.float32, "decode_mha_f32")])
@pytest.mark.parametrize("d,width", [(16, 32), (32, 32), (64, 64), (96, 128),
                                     (128, 128)])
@pytest.mark.parametrize("group,blocks", [(1, 1), (8, 1), (9, 2), (16, 2)])
def test_decode_mha_dispatch_table(dtype, entry, d, width, group, blocks):
    """K7: the tile's width (32, 64 or 128, lanes past D masked) and one
    block per 8 query heads of a group."""
    assert port_decode.kernel_for(dtype, d, group) == (entry, width, blocks)


@pytest.mark.parametrize("qd,pd,entry", [
    (torch.bfloat16, torch.bfloat16, "paged_decode_bf16"),
    (torch.bfloat16, torch.int8, "paged_decode_int8"),
    (torch.float16, torch.int8, "paged_decode_int8_f16"),
    (torch.float32, torch.int8, "paged_decode_int8_f32"),
    (torch.float16, torch.float16, "paged_decode_f16"),
    (torch.float32, torch.float32, "paged_decode_f32")])
@pytest.mark.parametrize("d,width", [(16, 32), (64, 64), (96, 128),
                                     (128, 128)])
@pytest.mark.parametrize("group,blocks", [(1, 1), (4, 1), (16, 2),
                                          (17, 3)])
def test_paged_decode_dispatch_table(qd, pd, entry, d, width, group, blocks):
    assert port_paged.kernel_for(qd, pd, d, group) == (entry, width, blocks)


def test_decode_dispatch_refusals():
    """fp64, mixed float types and head dims above 128 have no kernel."""
    with pytest.raises(ValueError, match="no kernel for torch.float64"):
        port_decode.kernel_for(torch.float64, 64, 1)
    with pytest.raises(ValueError, match="head_dim 1 to 128"):
        port_decode.kernel_for(torch.bfloat16, 256, 1)
    for qd, pd in ((torch.float64, torch.float64),
                   (torch.float64, torch.int8),
                   (torch.bfloat16, torch.float32),
                   (torch.float16, torch.bfloat16)):
        with pytest.raises(ValueError, match="no kernel for a"):
            port_paged.kernel_for(qd, pd, 64, 1)
    with pytest.raises(ValueError, match="head_dim 1 to 128"):
        port_paged.kernel_for(torch.float32, torch.float32, 160, 1)


@pytest.mark.parametrize("d", [16, 96])
def test_decode_plain_versions_take_any_head_dim_and_group(d):
    """The plain versions the kernels are held against on the card at the
    new widths and a group of 16: K7's against the JAX package's grouped
    einsum branch, K4's against the Pallas kernel in interpret mode."""
    from paddle_tpu.ops import _decode as jax_decode

    rng = np.random.RandomState(d)
    b, s, hkv, g = 3, 40, 2, 16
    q = rng.randn(b, hkv * g, d).astype(np.float32)
    kc = rng.randn(b, s, hkv, d).astype(np.float32)
    vc = rng.randn(b, s, hkv, d).astype(np.float32)
    lens = np.asarray([40, 17, 0], np.int32)
    ref = jax_decode.gqa_decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens))
    out = ops.decode_mha(_t(q), _t(kc), _t(vc), _t(lens))
    np.testing.assert_allclose(out.numpy(), _np(ref), **TOL)
    q, kp, vp, table, ln, _, _ = _paged_case([0, 9, 24], hkv * g, hkv, d=d,
                                             seed=d)
    ref = jax_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                    jnp.asarray(table), jnp.asarray(ln))
    out = ops.paged_decode_mha(_t(q), _t(kp), _t(vp), _t(table), _t(ln))
    np.testing.assert_allclose(out.numpy(), _np(ref), **TOL)


# -- wrappers: the plain version is for CPU tensors only ---------------------


def test_cpu_calls_do_not_count_as_launches():
    ops.reset_launch_counts()
    x = torch.randn(2, 3, 4, 8)
    ops.rms_norm(x, torch.ones(8))
    ops.fused_rope(x, torch.ones(3, 4), torch.zeros(3, 4))
    ops.flash_attention_bshd(x, x, x, causal=True)
    ops.prefix_chunk_attention(x, x, x, torch.tensor(1, dtype=torch.int32))
    ops.paged_decode_mha(x[:, 0], x, x, torch.zeros(2, 1, dtype=torch.int32),
                         torch.ones(2, dtype=torch.int32))
    out, lse = ops.flash_attention_bshd(x, x, x, causal=True)
    ops.flash_attention_bwd(x, x, x, out, lse, x, True)
    ops.decode_mha(x[:, 0], x, x, torch.ones(2, dtype=torch.int32))
    ops.fused_layer_norm(x, x)
    ops.fused_linear_param_grad_add(x, x, torch.zeros(8, 8))
    ops.grouped_matmul(x[0, 0], x[0].transpose(1, 2), torch.tensor([1, 1, 2]))
    assert ops.launch_counts() == {"rms_norm": 0, "fused_rope": 0,
                                   "flash_fwd": 0, "flash_fwd_prefix": 0,
                                   "paged_decode": 0,
                                   "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                                   "decode_mha": 0, "fused_layer_norm": 0,
                                   "grad_add": 0, "grouped_matmul": 0}


def test_non_cpu_tensor_never_takes_the_plain_version():
    """A tensor off the CPU launches the kernel or raises: here (no CUDA)
    a ``meta`` tensor stands in for any non-CPU device."""
    x = torch.empty(2, 3, 4, 8, device="meta")
    t = torch.empty(2, 1, dtype=torch.int32, device="meta")
    n = torch.empty(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        ops.rms_norm(x, torch.empty(8, device="meta"))
    with pytest.raises(ValueError):
        ops.fused_rope(x, torch.empty(3, 4, device="meta"),
                       torch.empty(3, 4, device="meta"))
    with pytest.raises(ValueError):
        ops.flash_attention_bshd(x, x, x)
    with pytest.raises(ValueError):
        ops.paged_decode_mha(x[:, 0], x, x, t, n)
    lse = torch.empty(2, 4, 3, device="meta")
    with pytest.raises(ValueError):
        ops.flash_attention_bwd(x, x, x, x, lse, x)
    with pytest.raises(ValueError):
        ops.flash_attention_bwd_dq(x, x, x, x, lse, lse)
    with pytest.raises(ValueError):
        ops.flash_attention_bwd_dkv(x, x, x, x, lse, lse)
    with pytest.raises(ValueError):
        ops.decode_mha(x[:, 0], x, x, n)
    with pytest.raises(ValueError):
        ops.fused_layer_norm(x, x)
    with pytest.raises(ValueError):
        ops.fused_linear_param_grad_add(x, x, torch.empty(8, 8,
                                                          device="meta"))
    with pytest.raises(ValueError):
        ops.grouped_matmul(x[0, 0], x[0].transpose(1, 2), n[:1].expand(3))
