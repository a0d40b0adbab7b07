"""paddle_tpu_torch's ``paddle.nn.functional`` against paddle_tpu's, on the
CPU: every function of the reference's ``nn/functional/activation.py``,
``common.py``, ``norm.py``, ``extension.py`` and ``flash_attention.py``
(a name without a case fails), output and the gradients of ``sum(out *
ct)`` for every floating input, on the same seeded numpy inputs; a subset
again in bf16.

- The functions that draw random numbers (the dropouts in training,
  ``rrelu`` in training, ``gumbel_softmax``, ``class_center_sample``) are
  compared where they are deterministic and held by their statistics and
  their own seeds where they are not: the port draws from torch's
  generators, the reference from threefry.
- ``flash_attention`` without dropout against the reference's route on the
  CPU (its ``_sdpa_ref`` composition); the port runs K3's plain version
  and, for the gradients, K5/K6's. In fp32 within 1e-5. In bf16 within
  K3's limit of ``chip_smoke.py`` (``TOL["flash_fwd"]``: atol 1e-4 + one
  bf16 step 2^-7 of the value, for all but 1e-4 of the elements, and 2^-5
  for every element): K3 rounds the unnormalized P of each 64-key tile to
  bf16 for P V where the composition rounds the normalized P (C-port-4).
  With dropout at an explicit seed, against
  ``paddle_tpu.ops.pallas.flash_attention`` (the Pallas kernel in
  interpret mode) under ``jax.vjp``: output and (dq, dk, dv) within 1e-5,
  and, with V the identity, the dropped (query, key) positions identical.
  GQA, and causal with Sq != Sk.
- ``tests/test_functional_vs_torch.py``'s case tables (interpolate modes,
  the grid_sample matrix, pad modes) as extra oracles: the port against
  ``torch.nn.functional`` at that file's tolerance.

Other tolerances as ``tests/torch_nn_cases.py`` states; ``grid_sample``,
``interpolate``, ``pdist`` and ``flash_attention`` atol 1e-5: their input
gradients sum up to 16 taps (or a row of scores) an element, scattered in
another order than the reference's, which moves values of order 1 by a
few fp32 ulps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as torch_F

import paddle_tpu
import paddle_tpu_torch as pt
import test_functional_vs_torch as fvt
import torch_nn_cases as C
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops import flash_attention_kernel as jax_flash
from paddle_tpu.ops import pallas as jax_pallas
from paddle_tpu_torch.nn import functional as TF

port_cpu = pytest.fixture(autouse=True)(C.port_cpu)

S3 = (2, 3, 4)
_eye16 = np.eye(16, dtype=np.float32)


def _cu(*offs):
    return np.asarray(offs, np.int32)


# id -> (function name, call(F, *tensors), input specs)
CASES = {
    # activation
    "relu": ("relu", lambda F, x: F.relu(x), [S3]),
    "relu_": ("relu_", lambda F, x: F.relu_(x), [S3]),
    "relu6": ("relu6", lambda F, x: F.relu6(x * 4), [S3]),
    "elu": ("elu", lambda F, x: F.elu(x, 0.7), [S3]),
    "elu_": ("elu_", lambda F, x: F.elu_(x), [S3]),
    "selu": ("selu", lambda F, x: F.selu(x), [S3]),
    "celu": ("celu", lambda F, x: F.celu(x, 0.8), [S3]),
    "gelu": ("gelu", lambda F, x: F.gelu(x), [S3]),
    "gelu_tanh": ("gelu", lambda F, x: F.gelu(x, True), [S3]),
    "silu": ("silu", lambda F, x: F.silu(x), [S3]),
    "swish": ("swish", lambda F, x: F.swish(x), [S3]),
    "sigmoid": ("sigmoid", lambda F, x: F.sigmoid(x), [S3]),
    "hardsigmoid": ("hardsigmoid", lambda F, x: F.hardsigmoid(x * 4), [S3]),
    "hardswish": ("hardswish", lambda F, x: F.hardswish(x * 4), [S3]),
    "hardtanh": ("hardtanh", lambda F, x: F.hardtanh(x, -0.5, 0.7), [S3]),
    "hardshrink": ("hardshrink", lambda F, x: F.hardshrink(x, 0.4), [S3]),
    "softshrink": ("softshrink", lambda F, x: F.softshrink(x, 0.3), [S3]),
    "tanhshrink": ("tanhshrink", lambda F, x: F.tanhshrink(x), [S3]),
    "leaky_relu": ("leaky_relu", lambda F, x: F.leaky_relu(x, 0.1), [S3]),
    "log_sigmoid": ("log_sigmoid", lambda F, x: F.log_sigmoid(x), [S3]),
    "log_softmax": ("log_softmax", lambda F, x: F.log_softmax(x, 1), [S3]),
    "maxout": ("maxout", lambda F, x: F.maxout(x, 2, 1), [(2, 4, 3, 3)]),
    "prelu": ("prelu", lambda F, x, w: F.prelu(x, w), [(2, 3, 4, 4), (3,)]),
    "prelu_scalar": ("prelu", lambda F, x, w: F.prelu(x, w), [S3, (1,)]),
    "rrelu": ("rrelu", lambda F, x: F.rrelu(x, 0.1, 0.3), [S3]),
    "softmax": ("softmax", lambda F, x: F.softmax(x, 1), [S3]),
    "softmax_": ("softmax_", lambda F, x: F.softmax_(x, -1), [S3]),
    "softplus": ("softplus", lambda F, x: F.softplus(x * 5, 2.0, 3.0), [S3]),
    "softsign": ("softsign", lambda F, x: F.softsign(x), [S3]),
    "mish": ("mish", lambda F, x: F.mish(x), [S3]),
    "tanh": ("tanh", lambda F, x: F.tanh(x), [S3]),
    "tanh_": ("tanh_", lambda F, x: F.tanh_(x), [S3]),
    "thresholded_relu": ("thresholded_relu",
                         lambda F, x: F.thresholded_relu(x, 0.5), [S3]),
    "glu": ("glu", lambda F, x: F.glu(x, -1), [(2, 3, 8)]),
    "gumbel_softmax": ("gumbel_softmax",
                       lambda F, x: F.gumbel_softmax(x * 1e4, 0.5), [S3]),
    # common
    "linear": ("linear", lambda F, x, w, b: F.linear(x, w, b),
               [S3, (4, 5), (5,)]),
    "linear_nobias": ("linear", lambda F, x, w: F.linear(x, w),
                      [S3, (4, 5)]),
    "dropout": ("dropout", lambda F, x: F.dropout(x, 0.3, training=False),
                [S3]),
    "dropout_downscale": ("dropout", lambda F, x: F.dropout(
        x, 0.3, training=False, mode="downscale_in_infer"), [S3]),
    "dropout2d": ("dropout2d", lambda F, x: F.dropout2d(x, training=False),
                  [(2, 3, 4, 4)]),
    "dropout3d": ("dropout3d", lambda F, x: F.dropout3d(x, training=False),
                  [(2, 3, 2, 2, 2)]),
    "alpha_dropout": ("alpha_dropout", lambda F, x: F.alpha_dropout(
        x, 0.3, training=False), [S3]),
    "embedding": ("embedding", lambda F, i, w: F.embedding(i, w, 2),
                  [("ids", (2, 5), 6), (6, 4)]),
    "one_hot": ("one_hot", lambda F, i: F.one_hot(i, 7), [("ids", (2, 5), 7)]),
    "pad_constant": ("pad", lambda F, x: F.pad(x, [1, 2, 0, 1], value=0.5),
                     [(1, 2, 3, 4)]),
    "pad_reflect": ("pad", lambda F, x: F.pad(x, [2, 1], mode="reflect"),
                    [(2, 3, 5)]),
    "pad_replicate_nhwc": ("pad", lambda F, x: F.pad(
        x, [1, 0, 2, 1], mode="replicate", data_format="NHWC"),
        [(1, 3, 4, 2)]),
    "pad_circular": ("pad", lambda F, x: F.pad(x, [1, 1, 1, 1, 1, 1],
                                               mode="circular"),
                     [(1, 1, 3, 3, 3)]),
    "pad_full": ("pad", lambda F, x: F.pad(x, [0, 1, 2, 0, 1, 1]),
                 [(2, 3, 4)]),
    "zeropad2d": ("zeropad2d", lambda F, x: F.zeropad2d(x, [1, 0, 0, 2]),
                  [(1, 2, 3, 3)]),
    "interpolate_nearest": ("interpolate", lambda F, x: F.interpolate(
        x, size=[5, 7]), [(1, 2, 3, 4)]),
    "interpolate_nearest_align": ("interpolate", lambda F, x: F.interpolate(
        x, size=[5, 7], align_corners=True), [(1, 2, 3, 4)]),
    "interpolate_bilinear": ("interpolate", lambda F, x: F.interpolate(
        x, size=[6, 9], mode="bilinear"), [(1, 2, 3, 4)]),
    "interpolate_bilinear_down": ("interpolate", lambda F, x: F.interpolate(
        x, size=[3, 5], mode="bilinear"), [(1, 2, 7, 11)]),
    "interpolate_bilinear_align": ("interpolate", lambda F, x: F.interpolate(
        x, scale_factor=2, mode="bilinear", align_corners=True),
        [(1, 2, 3, 4)]),
    "interpolate_bicubic": ("interpolate", lambda F, x: F.interpolate(
        x, size=[6, 7], mode="bicubic"), [(1, 2, 4, 5)]),
    "interpolate_area": ("interpolate", lambda F, x: F.interpolate(
        x, size=[3, 2], mode="area"), [(1, 2, 7, 5)]),
    "interpolate_linear_nwc": ("interpolate", lambda F, x: F.interpolate(
        x, size=[9], mode="linear", data_format="NWC"), [(2, 4, 3)]),
    "interpolate_trilinear": ("interpolate", lambda F, x: F.interpolate(
        x, size=[3, 4, 5], mode="trilinear"), [(1, 1, 2, 3, 3)]),
    "upsample": ("upsample", lambda F, x: F.upsample(x, scale_factor=2),
                 [(1, 2, 3, 4)]),
    "bilinear": ("bilinear",
                 lambda F, a, b, w, bias: F.bilinear(a, b, w, bias),
                 [(2, 3), (2, 4), (5, 3, 4), (5,)]),
    "cosine_similarity": ("cosine_similarity",
                          lambda F, a, b: F.cosine_similarity(a, b, axis=1),
                          [(3, 5), (3, 5)]),
    "pixel_shuffle": ("pixel_shuffle", lambda F, x: F.pixel_shuffle(x, 2),
                      [(1, 8, 3, 3)]),
    "pixel_shuffle_nhwc": ("pixel_shuffle", lambda F, x: F.pixel_shuffle(
        x, 2, "NHWC"), [(1, 3, 3, 8)]),
    "pixel_unshuffle": ("pixel_unshuffle",
                        lambda F, x: F.pixel_unshuffle(x, 2), [(1, 2, 4, 6)]),
    "channel_shuffle": ("channel_shuffle",
                        lambda F, x: F.channel_shuffle(x, 2), [(1, 4, 3, 3)]),
    "label_smooth": ("label_smooth",
                     lambda F, x: F.label_smooth(x, epsilon=0.2), [(2, 5)]),
    "unfold": ("unfold", lambda F, x: F.unfold(x, [2, 3], 1, [1, 0, 0, 1]),
               [(1, 2, 4, 5)]),
    "unfold_strided": ("unfold", lambda F, x: F.unfold(x, 2, 2, 0, 1),
                       [(2, 3, 4, 4)]),
    "fold": ("fold", lambda F, x: F.fold(x, [4, 5], 2), [(1, 12, 12)]),
    "fold_padded": ("fold", lambda F, x: F.fold(x, [3, 3], 2, 1, 1),
                    [(1, 8, 16)]),
    # norm
    "batch_norm_train": ("batch_norm", lambda F, x, m, v, w, b: F.batch_norm(
        x, m, v, w, b, training=True), [(4, 3, 2, 2), (3,), ("pos", (3,)),
                                        (3,), (3,)]),
    "batch_norm_eval": ("batch_norm", lambda F, x, m, v, w, b: F.batch_norm(
        x, m, v, w, b), [(4, 3, 5), ("const", (3,)), ("constpos", (3,)),
                         (3,), (3,)]),
    "batch_norm_nhwc": ("batch_norm", lambda F, x, m, v: F.batch_norm(
        x, m, v, training=True, data_format="NHWC"),
        [(2, 2, 2, 3), (3,), ("pos", (3,))]),
    "layer_norm": ("layer_norm", lambda F, x, w, b: F.layer_norm(
        x, [3, 4], w, b), [S3, (3, 4), (3, 4)]),
    "layer_norm_plain": ("layer_norm", lambda F, x: F.layer_norm(x, 4), [S3]),
    "instance_norm": ("instance_norm", lambda F, x, w, b: F.instance_norm(
        x, weight=w, bias=b), [(2, 3, 4, 4), (3,), (3,)]),
    "group_norm": ("group_norm", lambda F, x, w, b: F.group_norm(
        x, 2, 1e-5, w, b), [(2, 4, 3, 3), (4,), (4,)]),
    "group_norm_nhwc": ("group_norm", lambda F, x: F.group_norm(
        x, 2, data_format="NHWC"), [(2, 3, 3, 4)]),
    "local_response_norm": ("local_response_norm",
                            lambda F, x: F.local_response_norm(x, 3),
                            [(2, 5, 3, 3)]),
    "normalize": ("normalize", lambda F, x: F.normalize(x), [(3, 5)]),
    "normalize_p1": ("normalize", lambda F, x: F.normalize(x, 1, -1), [S3]),
    # extension
    "pairwise_distance": ("pairwise_distance",
                          lambda F, a, b: F.pairwise_distance(a, b),
                          [(3, 5), (3, 5)]),
    "pdist": ("pdist", lambda F, x: F.pdist(x), [(4, 3)]),
    "sequence_mask": ("sequence_mask", lambda F, x: F.sequence_mask(x, 6),
                      [("ids", (2, 3), 6)]),
    "diag_embed": ("diag_embed", lambda F, x: F.diag_embed(x, 1), [(2, 3)]),
    "diag_embed_dims": ("diag_embed", lambda F, x: F.diag_embed(x, -1, 0, 2),
                        [(2, 3)]),
    "temporal_shift": ("temporal_shift",
                       lambda F, x: F.temporal_shift(x, 2, 0.25),
                       [(4, 4, 2, 2)]),
    "affine_grid": ("affine_grid", lambda F, t: F.affine_grid(t, [2, 1, 3, 4]),
                    [(2, 2, 3)]),
    "affine_grid_half": ("affine_grid", lambda F, t: F.affine_grid(
        t, [1, 1, 4, 3], align_corners=False), [(1, 2, 3)]),
    "grid_sample": ("grid_sample", lambda F, x, g: F.grid_sample(x, g * 0.6),
                    [(1, 2, 4, 5), (1, 3, 3, 2)]),
    "grid_sample_nearest": ("grid_sample", lambda F, x, g: F.grid_sample(
        x, g * 0.6, mode="nearest", align_corners=False),
        [(1, 2, 4, 5), (1, 3, 3, 2)]),
    "grid_sample_reflection": ("grid_sample", lambda F, x, g: F.grid_sample(
        x, g * 0.8, padding_mode="reflection", align_corners=False),
        [(1, 2, 4, 5), (1, 3, 3, 2)]),
    "grid_sample_border": ("grid_sample", lambda F, x, g: F.grid_sample(
        x, g * 0.8, padding_mode="border"), [(1, 2, 4, 5), (1, 3, 3, 2)]),
    "npair_loss": ("npair_loss", lambda F, a, p, l: F.npair_loss(a, p, l),
                   [(4, 3), (4, 3), ("ids", (4,), 2)]),
    # attention
    "flash_attention": ("flash_attention", lambda F, q, k, v:
                        F.flash_attention(q, k, v),
                        [(1, 16, 4, 16), (1, 16, 4, 16), (1, 16, 4, 16)]),
    "flash_attention_causal_gqa": (
        "flash_attention", lambda F, q, k, v: F.flash_attention(
            q, k, v, causal=True),
        [(2, 8, 4, 16), (2, 16, 2, 16), (2, 16, 2, 16)]),
    "flash_attention_eval_dropout": (
        "flash_attention", lambda F, q, k, v: F.flash_attention(
            q, k, v, dropout=0.3, training=False),
        [(1, 16, 2, 8), (1, 16, 2, 8), (1, 16, 2, 8)]),
    "flash_attn_unpadded": (
        "flash_attn_unpadded",
        lambda F, q, k, v, cq, ck: F.flash_attn_unpadded(
            q, k, v, cq, ck, 5, 5, 0.3, causal=True),
        [(9, 2, 8), (9, 2, 8), (9, 2, 8), _cu(0, 4, 9), _cu(0, 4, 9)]),
    "scaled_dot_product_attention": (
        "scaled_dot_product_attention",
        lambda F, q, k, v, m: F.scaled_dot_product_attention(q, k, v, m),
        [(2, 6, 2, 8), (2, 6, 2, 8), (2, 6, 2, 8), ("const", (2, 1, 6, 6))]),
    "scaled_dot_product_attention_causal": (
        "scaled_dot_product_attention",
        lambda F, q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, dropout_p=0.5, training=False),
        [(1, 4, 4, 8), (1, 6, 2, 8), (1, 6, 2, 8)]),
    "sparse_attention_gather": (
        "sparse_attention", lambda F, q, k, v, o, c: F.sparse_attention(
            q, k, v, o, c),
        [(1, 1, 16, 8), (1, 1, 16, 8), (1, 1, 16, 8),
         _cu(*range(0, 33, 2)).reshape(1, 1, 17),
         np.asarray([[[i, (i + 3) % 16] for i in range(16)]],
                    np.int32).reshape(1, 1, 32)]),
    "sparse_attention_dense": (
        "sparse_attention", lambda F, q, k, v, o, c: F.sparse_attention(
            q, k, v, o, c),
        [(1, 2, 4, 8), (1, 2, 4, 8), (1, 2, 4, 8),
         np.tile(_cu(0, 3, 6, 9, 12), (1, 2, 1)),
         np.tile(np.asarray([0, 1, 2, 1, 2, 3, 0, 2, 3, 0, 1, 3], np.int32),
                 (1, 2, 1))]),
}
RANDOM_ONLY = {"class_center_sample", "sdp_kernel"}    # tests of their own
TOLS = {"grid_sample": dict(rtol=1e-5, atol=1e-5),
        "interpolate": dict(rtol=1e-5, atol=1e-5),
        "flash_attention": dict(rtol=1e-5, atol=1e-5),
        "pdist": dict(rtol=1e-5, atol=1e-5)}
BF16 = ["gelu", "silu", "softmax", "linear", "layer_norm", "embedding",
        "group_norm", "batch_norm_train", "interpolate_bilinear",
        "scaled_dot_product_attention"]
MODULES = ("activation", "common", "norm", "extension", "flash_attention")


def test_every_reference_function_has_a_case():
    import importlib

    covered = {fn for fn, _, _ in CASES.values()} | RANDOM_ONLY
    for m in MODULES:
        ref = importlib.import_module(f"paddle_tpu.nn.functional.{m}")
        port = importlib.import_module(f"paddle_tpu_torch.nn.functional.{m}")
        assert sorted(port.__all__) == sorted(ref.__all__), m
        assert set(ref.__all__) <= covered, set(ref.__all__) - covered
        assert set(ref.__all__) <= set(TF.__all__)
    for m in ("conv", "pooling", "sequence_loss"):    # A14b's
        ref = importlib.import_module(f"paddle_tpu.nn.functional.{m}")
        port = importlib.import_module(f"paddle_tpu_torch.nn.functional.{m}")
        assert sorted(port.__all__) == sorted(ref.__all__), m
        assert set(ref.__all__) <= set(TF.__all__), m
    assert "ctc_loss" in TF.__all__


def _run(case_id, dtype="float32"):
    fn, call, specs = CASES[case_id]
    arrays = C.make_inputs(specs, seed=len(case_id))
    want, wg, _ = C.run_jax(lambda *t: call(JF, *t), arrays, len(case_id),
                            dtype=dtype)
    tdtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    got, gg, _ = C.run_port(lambda *t: call(TF, *t), arrays, len(case_id),
                            dtype=tdtype)
    return fn, want, wg, got, gg


@pytest.mark.parametrize("case_id", sorted(CASES))
def test_function_matches_reference(case_id):
    fn, want, wg, got, gg = _run(case_id)
    if fn == "gumbel_softmax":      # x * 1e4: the noise moves no argmax
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        return
    if fn == "one_hot" or fn == "sequence_mask":
        np.testing.assert_array_equal(got, want)
        return
    tol = TOLS.get(fn)
    C.close(got, want, tol=tol, what="out")
    for i, (g, w) in enumerate(zip(gg, wg)):
        C.close(g, w, tol=tol, what=f"grad {i}")


def _flash_limit(got, want):
    """K3's bf16 limit: atol 1e-4 + 2^-7 |want| for all but 1e-4 of the
    elements, 2^-5 for every element."""
    err = np.abs(got - want)
    outside = (err > 1e-4 + 2.0 ** -7 * np.abs(want)).mean()
    assert outside <= 1e-4 and err.max() <= 2.0 ** -5, (outside, err.max())


@pytest.mark.parametrize("case_id", BF16)
def test_function_matches_reference_bf16(case_id):
    fn, want, wg, got, gg = _run(case_id, "bfloat16")
    C.close(got, want, "bfloat16", what="out")
    for i, (g, w) in enumerate(zip(gg, wg)):
        C.close(g, w, "bfloat16", what=f"grad {i}")


@pytest.mark.parametrize("case_id", ["flash_attention",
                                     "flash_attention_causal_gqa"])
def test_flash_attention_bf16(case_id):
    """Against the reference's CPU route, which computes the scores in
    bf16, within the file's bf16 tolerance; against the Pallas kernel in
    interpret mode, which rounds as K3 does, within K3's limit."""
    _, want, wg, got, gg = _run(case_id, "bfloat16")
    C.close(got, want, "bfloat16", what="out")
    for g, w in zip(gg, wg):
        C.close(g, w, "bfloat16", what="grad")
    q, k, v = C.make_inputs(CASES[case_id][2], seed=len(case_id))
    causal = case_id.endswith("gqa")
    bf = [jnp.asarray(a.transpose(0, 2, 1, 3), jnp.bfloat16)
          for a in (q, k, v)]
    # one key block, as K3's 64-key tile holds every key here: both round
    # P at the same running max
    kernel = jax_flash.flash_attention_bhsd(
        *bf, causal=causal, block_q=q.shape[1], block_k=k.shape[1],
        interpret=True)
    kernel = np.asarray(kernel.astype(jnp.float32)).transpose(0, 2, 1, 3)
    out, _ = TF.flash_attention(*(torch.from_numpy(a).bfloat16()
                                  for a in (q, k, v)), causal=causal)
    _flash_limit(out.float().numpy(), kernel)


@pytest.mark.parametrize("sq,sk,hq,hkv,causal", [
    (16, 16, 4, 4, False), (16, 16, 4, 2, True), (8, 16, 4, 2, True),
    (16, 8, 2, 2, False)])
def test_flash_attention_dropout_matches_pallas_kernel(sq, sk, hq, hkv,
                                                       causal):
    """At an explicit seed the port's F.flash_attention drops the Pallas
    kernel's positions (V the identity shows them: out = P_drop) and its
    output and gradients match the kernel in interpret mode."""
    p, seed, d = 0.3, 1234, 16
    rng = np.random.RandomState(sq + hkv)
    q = rng.randn(1, sq, hq, d).astype(np.float32)
    k = rng.randn(1, sk, hkv, d).astype(np.float32)
    v = rng.randn(1, sk, hkv, d).astype(np.float32)
    do = rng.randn(1, sq, hq, d).astype(np.float32)
    eye = np.broadcast_to(_eye16[:sk, None, :d], (1, sk, hkv, d)).copy()

    def jf(q_, k_, v_):
        return jax_pallas.flash_attention(q_, k_, v_, causal=causal,
                                          dropout_p=p, seed=seed)

    def tf(q_, k_, v_):
        return TF.flash_attention(q_, k_, v_, dropout=p, causal=causal,
                                  fixed_seed_offset=seed)[0]

    out_j, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (q, k, v)))
    grads_j = vjp(jnp.asarray(do))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tf(qt, kt, vt)
    out.backward(torch.from_numpy(do))
    C.close(out.detach().numpy(), np.asarray(out_j), tol=TOLS[
        "flash_attention"])
    for g, w in zip((qt.grad, kt.grad, vt.grad), grads_j):
        C.close(g.numpy(), np.asarray(w), tol=TOLS["flash_attention"])
    pj = np.asarray(jf(jnp.asarray(q), jnp.asarray(k), jnp.asarray(eye)))
    pt_ = tf(*(torch.from_numpy(a) for a in (q, k, eye))).detach().numpy()
    dropped_j, dropped_t = pj == 0, pt_ == 0
    assert dropped_j.any()
    np.testing.assert_array_equal(dropped_t, dropped_j)


def test_dropout_functions_in_training():
    x = torch.randn(300, 200)
    pt.seed(5)
    y = TF.dropout(x, 0.4)
    assert abs((y == 0).float().mean().item() - 0.4) < 0.02
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] / 0.6)
    pt.seed(5)
    assert torch.equal(TF.dropout(x, 0.4), y)
    y = TF.dropout(x, 0.4, axis=0)
    rows = (y == 0).all(1)
    assert ((y == 0).any(1) == rows).all()
    y = TF.dropout(x, 0.4, mode="downscale_in_infer")
    torch.testing.assert_close(y[y != 0], x[y != 0])
    torch.testing.assert_close(TF.dropout(x, 0.4, training=False,
                                          mode="downscale_in_infer"), x * 0.6)
    x4 = torch.randn(50, 40, 3, 3)
    y = TF.dropout2d(x4, 0.5)
    ch = (y == 0).flatten(2).all(-1)
    assert ((y == 0).flatten(2).any(-1) == ch).all()
    assert abs(ch.float().mean().item() - 0.5) < 0.05
    y = TF.alpha_dropout(torch.randn(400, 400), 0.2)
    assert abs(y.mean().item()) < 0.02 and abs(y.std().item() - 1) < 0.02


# inputs exactly on the clipping activations' bounds (and past them)
TIES = np.array([-6, -3, -2.5, -1, -0.5, 0, 0.5, 0.7, 1, 2.5, 3, 6, 20],
                np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn,kw", [("relu6", {}), ("hardtanh", {}),
                                   ("hardtanh", {"min": -0.5, "max": 0.7}),
                                   ("hardswish", {}),
                                   ("hardsigmoid", {"slope": 0.5,
                                                    "offset": 0.5})])
def test_clip_activations_split_ties_like_reference(fn, kw, dtype):
    """On a bound the reference's ``jnp.clip`` gives half the gradient;
    the port must give the same (``torch.clamp`` gives all), within the
    file's tolerances."""
    want, (wg,), _ = C.run_jax(lambda t: getattr(JF, fn)(t, **kw), [TIES],
                               0, dtype=dtype)
    got, (gg,), _ = C.run_port(lambda t: getattr(TF, fn)(t, **kw), [TIES],
                               0, dtype=getattr(torch, dtype))
    C.close(got, want, dtype, what="out")
    C.close(gg, wg, dtype, what="grad")


def test_random_activations_in_training():
    x = -torch.rand(200, 200) - 0.5
    slope = TF.rrelu(x, 0.1, 0.3, training=True) / x
    assert slope.min() >= 0.1 and slope.max() <= 0.3
    assert abs(slope.mean().item() - 0.2) < 0.01
    g = TF.gumbel_softmax(torch.zeros(4000, 5), hard=True)
    assert torch.equal(g.sum(-1), torch.ones(4000))
    counts = g.sum(0) / 4000
    assert (counts - 0.2).abs().max() < 0.03
    soft = TF.gumbel_softmax(torch.randn(3, 5), temperature=0.7)
    torch.testing.assert_close(soft.sum(-1), torch.ones(3))


def test_class_center_sample():
    label = np.array([3, 7, 3, 9, 1], np.int64)
    for n_samples in (8, 2):
        jr, js = JF.class_center_sample(paddle_tpu.to_tensor(label), 20,
                                        n_samples)
        tr, ts = TF.class_center_sample(torch.from_numpy(label), 20,
                                        n_samples)
        js, ts = C._np(js), ts.numpy()
        assert len(ts) == len(js) == max(n_samples, 4)
        assert set([1, 3, 7, 9]) <= set(ts.tolist())
        assert (np.diff(ts) > 0).all()
        np.testing.assert_array_equal(ts[tr.numpy()], label)
        np.testing.assert_array_equal(C._np(js)[C._np(jr)], label)


def test_sdp_kernel_is_a_no_op_context():
    with TF.sdp_kernel(enable_math=False) as ctx:
        assert isinstance(ctx, TF.sdp_kernel)


# -- tests/test_functional_vs_torch.py's case tables as extra oracles ------

def _params(fn, argnames):
    """The values of ``fn``'s ``parametrize`` mark over ``argnames``."""
    return next(m.args[1] for m in fn.pytestmark
                if m.name == "parametrize" and m.args[0] == argnames)


_GRID = fvt.TestGridSample.test_grid_sample_full_matrix


@pytest.mark.parametrize("mode,align", _params(
    fvt.TestInterpolate.test_upsample_2d_modes, "mode,align"))
def test_interpolate_against_the_torch_oracle(mode, align):
    """The reference's interpolate cases against torch hold for the port
    too, at the reference test's tolerance (rtol = atol = 1e-3)."""
    x = torch.from_numpy(fvt.rand(2, 3, 5, 7, seed=1))
    kw = {} if mode == "nearest" else {"align_corners": align}
    np.testing.assert_allclose(
        TF.interpolate(x, size=(10, 13), mode=mode, **kw).numpy(),
        torch_F.interpolate(x, size=(10, 13), mode=mode, **kw).numpy(),
        rtol=fvt.RTOL, atol=fvt.ATOL)


@pytest.mark.parametrize("align", _params(_GRID, "align"))
@pytest.mark.parametrize("pad", _params(_GRID, "pad"))
@pytest.mark.parametrize("mode", _params(_GRID, "mode"))
def test_grid_sample_against_the_torch_oracle(mode, pad, align):
    x = torch.from_numpy(fvt.rand(2, 3, 6, 7, seed=6))
    grid = torch.from_numpy(np.random.RandomState(7).rand(2, 5, 4, 2)
                            .astype(np.float32) * 2.4 - 1.2)
    np.testing.assert_allclose(
        TF.grid_sample(x, grid, mode=mode, padding_mode=pad,
                       align_corners=align).numpy(),
        torch_F.grid_sample(x, grid, mode=mode, padding_mode=pad,
                            align_corners=align).numpy(),
        rtol=fvt.RTOL, atol=fvt.ATOL)


@pytest.mark.parametrize("mode", _params(
    fvt.TestPadAndShuffle.test_pad_modes_4d, "mode"))
def test_pad_against_the_torch_oracle(mode):
    x = torch.from_numpy(fvt.rand(2, 3, 5, 6, seed=8))
    np.testing.assert_array_equal(
        TF.pad(x, [1, 2, 2, 1], mode=mode).numpy(),
        torch_F.pad(x, [1, 2, 2, 1], mode=mode).numpy())
