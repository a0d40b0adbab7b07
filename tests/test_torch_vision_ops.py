"""paddle_tpu_torch's ``vision.ops`` against paddle_tpu's, on the CPU.

Every operator of the reference's ``__all__`` runs on the same seeded
inputs through both packages:

- the RoI family (``roi_align`` with and without ``aligned``, a fixed and
  the default sampling ratio; ``roi_pool``; ``psroi_pool``) with boxes
  that reach past the image (the clamped samples), outputs and the
  gradient into ``x``;
- ``box_coder`` (both code types, both variance forms, both axes),
  ``yolo_box`` (with ``scale_x_y``; ``iou_aware`` raises in both),
  ``yolo_loss`` (zero-width padding rows, ``gt_score``, label smoothing on
  and off) and its gradient in ``x``, ``prior_box``;
- ``deform_conv2d`` v1 and v2 with deformable groups, groups, stride,
  padding and dilation, the gradients into every input, the layer, and
  zero offsets with a unit mask against the port's ``conv2d``;
- ``nms`` (with scores, without, by category, ``top_k``), ``matrix_nms``
  (linear and gaussian), ``generate_proposals`` and
  ``distribute_fpn_proposals``, index for index, on scores drawn without
  ties (each test asserts that: the reference's unstable sort and the
  port's stable one order ties differently);
- ``read_file`` and ``decode_jpeg`` where PIL is present.

Tolerances: numeric outputs and gradients fp32 within ``rtol`` 1e-5 and
``atol`` 1e-5 of the compared array's largest magnitude (the same formulas
summed in another order); indices, counts and the host-side selections'
RoIs and scores bitwise.
"""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.vision.ops as J
import paddle_tpu_torch.vision.ops as P
import torch_nn_cases as C
from paddle_tpu_torch.nn import functional as TF
from torch_jax_state import jax_reference_state  # noqa: F401

port_cpu = pytest.fixture(autouse=True)(C.port_cpu)


def near(got, want, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale,
                               err_msg=what)


def equal(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


def jt(a):
    return paddle_tpu.to_tensor(np.asarray(a))


def tt(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def tie_free(s):
    s = np.asarray(s)
    assert len(np.unique(s)) == s.size, "scores must have no ties"
    return s


def compare(jcall, tcall, arrays, seed, what):
    """Output and the gradients of every float32 input (float64 arrays are
    constants), JAX against the port."""
    want, wg, _ = C.run_jax(jcall, arrays, seed)
    got, gg, _ = C.run_port(tcall, arrays, seed)
    near(got, want, f"{what} output")
    for i, (g, w) in enumerate(zip(gg, wg)):
        near(g, w, f"{what} grad {i}")
    return got


def test_all_names_are_ported():
    assert sorted(P.__all__) == sorted(J.__all__)
    for n in P.__all__:
        assert callable(getattr(P, n)), n


def _rois(rng, n, H, W, scale, past=0.3):
    """Boxes in input coordinates, some reaching past the image."""
    x1 = rng.uniform(-past * W, W, n) / scale
    y1 = rng.uniform(-past * H, H, n) / scale
    w = rng.uniform(0.5, 0.8 * W, n) / scale
    h = rng.uniform(0.5, 0.8 * H, n) / scale
    return np.stack([x1, y1, x1 + w, y1 + h], 1)        # float64: constant


ROI_CASES = [
    ("roi_align", dict(output_size=3, spatial_scale=0.5)),
    ("roi_align", dict(output_size=(2, 4), spatial_scale=1.0,
                       sampling_ratio=3, aligned=False)),
    ("roi_align", dict(output_size=2, spatial_scale=0.25, sampling_ratio=1,
                       aligned=True)),
    ("roi_pool", dict(output_size=3, spatial_scale=0.5)),
    ("roi_pool", dict(output_size=(2, 3), spatial_scale=1.0)),
    ("psroi_pool", dict(output_size=3, spatial_scale=0.5)),
    ("psroi_pool", dict(output_size=(2, 2), spatial_scale=1.0)),
]


@pytest.mark.parametrize("op,kw", ROI_CASES,
                         ids=[f"{o}-{i}" for i, (o, _) in
                              enumerate(ROI_CASES)])
def test_roi_family_matches_reference(op, kw):
    rng = np.random.RandomState(len(op) + len(kw))
    oh, ow = ((kw["output_size"],) * 2 if isinstance(kw["output_size"], int)
              else kw["output_size"])
    c = 2 * oh * ow if op == "psroi_pool" else 3
    H, W = 10, 13
    x = rng.randn(2, c, H, W).astype(np.float32)
    boxes = _rois(rng, 5, H, W, kw["spatial_scale"])
    num = np.asarray([3, 2], np.int32)
    got = compare(lambda a, b, n: getattr(J, op)(a, b, n, **kw),
                  lambda a, b, n: getattr(P, op)(a, b, n, **kw),
                  [x, boxes, num], 3, op)
    assert got.shape == (5, c // (oh * ow) if op == "psroi_pool" else c,
                         oh, ow)


def test_roi_layers_match_functions():
    rng = np.random.RandomState(5)
    x = tt(rng.randn(1, 8, 6, 6).astype(np.float32))
    boxes = tt(_rois(rng, 3, 6, 6, 1.0).astype(np.float32))
    num = tt(np.asarray([3], np.int32))
    for layer, fn in ((P.RoIAlign(2), P.roi_align),
                      (P.RoIPool(2), P.roi_pool),
                      (P.PSRoIPool(2), P.psroi_pool)):
        equal(layer(x, boxes, num).numpy(), fn(x, boxes, num, 2).numpy())


def _boxes(rng, n, span=20.0):
    xy = rng.uniform(0, span, (n, 2))
    wh = rng.uniform(1, span / 2, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("case", ["scores", "no_scores", "categories",
                                  "top_k"])
def test_nms_matches_reference(case):
    rng = np.random.RandomState(len(case))
    b = _boxes(rng, 40)
    s = tie_free(rng.rand(40).astype(np.float32))
    kw = {"iou_threshold": 0.3}
    if case != "no_scores":
        kw["scores"] = s
    if case == "categories":
        kw["category_idxs"] = rng.randint(0, 3, 40)
        kw["categories"] = [0, 1, 2]
    if case == "top_k":
        kw["top_k"] = 5
    jk = {k: (jt(v) if isinstance(v, np.ndarray) else v)
          for k, v in kw.items()}
    tk = {k: (tt(v) if isinstance(v, np.ndarray) else v)
          for k, v in kw.items()}
    want = C._np(J.nms(jt(b), **jk))
    got = P.nms(tt(b), **tk)
    assert got.dtype == torch.int64
    equal(got.numpy(), want)
    assert 0 < len(want) < 40


@pytest.mark.parametrize("gaussian", [False, True])
def test_matrix_nms_matches_reference(gaussian):
    rng = np.random.RandomState(7 + gaussian)
    b = np.stack([_boxes(rng, 30) for _ in range(2)])
    s = rng.rand(2, 4, 30).astype(np.float32)
    tie_free(s[:, 1:].reshape(2, -1)[0])
    tie_free(s[:, 1:].reshape(2, -1)[1])
    kw = dict(score_threshold=0.2, post_threshold=0.1, nms_top_k=20,
              keep_top_k=25, use_gaussian=gaussian, return_index=True)
    want = J.matrix_nms(jt(b), jt(s), **kw)
    got = P.matrix_nms(tt(b), tt(s), **kw)
    assert len(got) == len(want) == 3
    for g, w, what in zip(got, want, ("rows", "index", "rois_num")):
        equal(g.numpy(), C._np(w), what)
    assert got[0].shape[1] == 6 and int(got[2].sum()) == got[0].shape[0]


def _proposal_inputs(seed, n=2, a=3, h=5, w=6):
    rng = np.random.RandomState(seed)
    scores = rng.rand(n, a, h, w).astype(np.float32)
    tie_free(scores[0])
    tie_free(scores[1])
    deltas = (rng.randn(n, 4 * a, h, w) * 0.3).astype(np.float32)
    cy, cx = np.meshgrid(np.arange(h) * 16 + 8, np.arange(w) * 16 + 8,
                         indexing="ij")
    sizes = np.asarray([16, 32, 64])[:a]
    anchors = np.stack([np.stack([cx - s / 2, cy - s / 2, cx + s / 2,
                                  cy + s / 2], -1) for s in sizes], 2)
    anchors = anchors.astype(np.float32)                      # [h, w, a, 4]
    variances = np.full_like(anchors, 1.0)
    img = np.asarray([[h * 16, w * 16]] * n, np.float32)
    return scores, deltas, img, anchors, variances


@pytest.mark.parametrize("rois_num", [False, True])
def test_generate_proposals_matches_reference(rois_num):
    args = _proposal_inputs(11)
    kw = dict(pre_nms_top_n=60, post_nms_top_n=20, nms_thresh=0.5,
              min_size=2.0, return_rois_num=rois_num)
    want = J.generate_proposals(*[jt(a) for a in args], **kw)
    got = P.generate_proposals(*[tt(a) for a in args], **kw)
    assert len(got) == len(want) == (3 if rois_num else 2)
    for g, w, what in zip(got, want, ("rois", "scores", "rois_num")):
        equal(g.numpy(), C._np(w), what)
    assert got[0].shape[0] > 10


@pytest.mark.parametrize("rois_num", [None, [7, 13]])
def test_distribute_fpn_proposals_matches_reference(rois_num):
    rng = np.random.RandomState(3)
    xy = rng.uniform(0, 400, (20, 2))
    wh = np.exp(rng.uniform(np.log(8), np.log(600), (20, 2)))
    rois = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    kw = dict(min_level=2, max_level=5, refer_level=4, refer_scale=224)
    jn = None if rois_num is None else jt(np.asarray(rois_num, np.int32))
    tn = None if rois_num is None else tt(np.asarray(rois_num, np.int32))
    want = J.distribute_fpn_proposals(jt(rois), rois_num=jn, **kw)
    got = P.distribute_fpn_proposals(tt(rois), rois_num=tn, **kw)
    assert len(got) == len(want)
    for g, w in zip(got[0], want[0]):
        equal(g.numpy(), C._np(w), "level rois")
    equal(got[1].numpy(), C._np(want[1]), "restore")
    if rois_num is not None:
        for g, w in zip(got[2], want[2]):
            equal(g.numpy(), C._np(w), "per-image counts")
    assert sum(len(g) for g in got[0]) == 20


@pytest.mark.parametrize("kw", [
    dict(min_sizes=[30.0], max_sizes=[60.0], aspect_ratios=[2.0],
         flip=True, clip=True),
    dict(min_sizes=[8.0, 16.0], aspect_ratios=[1.0, 3.0], steps=(4.0, 4.0),
         offset=0.25, variance=(0.1, 0.2, 0.3, 0.4))])
def test_prior_box_matches_reference(kw):
    feat, image = np.zeros((1, 4, 5, 6), np.float32), np.zeros(
        (1, 3, 40, 48), np.float32)
    want = J.prior_box(jt(feat), jt(image), **kw)
    got = P.prior_box(tt(feat), tt(image), **kw)
    for g, w in zip(got, want):
        equal(g.numpy(), C._np(w))


BOX_CODER = [("encode_center_size", True, 0, "2d"),
             ("encode_center_size", False, 0, "2d"),
             ("decode_center_size", True, 0, "2d"),
             ("decode_center_size", False, 1, "1d"),
             ("decode_center_size", True, 0, "1d")]


@pytest.mark.parametrize("code,normalized,axis,var", BOX_CODER)
def test_box_coder_matches_reference(code, normalized, axis, var):
    rng = np.random.RandomState(len(code) + axis)
    prior = _boxes(rng, 6, 1.0 if normalized else 30.0)
    pv = (rng.rand(6, 4) * 0.2 + 0.1).astype(np.float32)
    if var == "1d":
        pv = pv[0]
    if code.startswith("encode"):
        target = _boxes(rng, 4, 1.0 if normalized else 30.0)
    else:
        target = (rng.randn(*((4, 6, 4) if axis == 0 else (6, 4, 4)))
                  * 0.5).astype(np.float32)
    pv_j = jt(pv) if var == "2d" else pv
    compare(lambda p, t: J.box_coder(p, pv_j, t, code, normalized, axis),
            lambda p, t: P.box_coder(p, tt(pv), t, code, normalized, axis),
            [prior.astype(np.float64), target], 2, code)


YOLO = dict(anchors=[10, 13, 16, 30, 33, 23], class_num=4,
            downsample_ratio=8)


@pytest.mark.parametrize("clip,scale", [(True, 1.0), (False, 1.05)])
def test_yolo_box_matches_reference(clip, scale):
    rng = np.random.RandomState(int(clip))
    x = rng.randn(2, 3 * (5 + 4), 5, 6).astype(np.float32)
    img = np.asarray([[40, 48], [37, 50]], np.int32)
    kw = dict(YOLO, conf_thresh=0.3, clip_bbox=clip, scale_x_y=scale)
    want = J.yolo_box(jt(x), jt(img), **kw)
    got = P.yolo_box(tt(x), tt(img), **kw)
    for g, w, what in zip(got, want, ("boxes", "scores")):
        near(g.numpy(), C._np(w), what)
    assert got[0].shape == (2, 90, 4) and got[1].shape == (2, 90, 4)
    assert (got[1].numpy() == 0).any()           # masked cells
    with pytest.raises(NotImplementedError):
        P.yolo_box(tt(x), tt(img), iou_aware=True, **dict(kw))


def _gt(rng, n, b, pad):
    cxcy = rng.uniform(0.05, 0.95, (n, b, 2))
    wh = rng.uniform(0.02, 0.6, (n, b, 2))
    gt = np.concatenate([cxcy, wh], -1).astype(np.float32)
    gt[:, b - pad:, 2] = 0.0                          # padding rows
    return gt


@pytest.mark.parametrize("smooth,score", [(True, False), (False, True)])
def test_yolo_loss_matches_reference(smooth, score):
    rng = np.random.RandomState(3 + smooth)
    H, W = 6, 7
    anchors = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]
    x = rng.randn(2, 3 * 9, H, W).astype(np.float32)
    gt = _gt(rng, 2, 6, 2).astype(np.float64)
    label = rng.randint(0, 4, (2, 6)).astype(np.int32)
    gs = rng.uniform(0.5, 1.0, (2, 6)) if score else None
    kw = dict(anchors=anchors, anchor_mask=[3, 4, 5], class_num=4,
              ignore_thresh=0.5, downsample_ratio=32,
              use_label_smooth=smooth)
    arrays = [x, gt, label] + ([gs] if score else [])

    def jcall(xv, g, lab, *s):
        return J.yolo_loss(xv, g, lab, gt_score=s[0] if s else None, **kw)

    def tcall(xv, g, lab, *s):
        return P.yolo_loss(xv, g, lab, gt_score=s[0] if s else None, **kw)

    got = compare(jcall, tcall, arrays, 4, "yolo_loss")
    assert got.shape == (2,) and np.isfinite(got).all()


DCN = [
    dict(shape=(2, 4, 7, 8), oc=6, k=3, stride=1, padding=1, dilation=1,
         dg=1, groups=1, mask=False, bias=True),
    dict(shape=(2, 4, 9, 8), oc=4, k=3, stride=2, padding=1, dilation=2,
         dg=2, groups=2, mask=True, bias=True),
    dict(shape=(1, 6, 6, 7), oc=3, k=(2, 3), stride=1, padding=(0, 1),
         dilation=1, dg=3, groups=3, mask=True, bias=False),
]


def _dcn_arrays(rng, c):
    N, Cin, H, W = c["shape"]
    kh, kw = (c["k"], c["k"]) if isinstance(c["k"], int) else c["k"]
    st = (c["stride"],) * 2 if isinstance(c["stride"], int) else c["stride"]
    pd = ((c["padding"],) * 2 if isinstance(c["padding"], int)
          else c["padding"])
    dl = (c["dilation"],) * 2
    oh = (H + 2 * pd[0] - dl[0] * (kh - 1) - 1) // st[0] + 1
    ow = (W + 2 * pd[1] - dl[1] * (kw - 1) - 1) // st[1] + 1
    arrays = [rng.randn(N, Cin, H, W).astype(np.float32),
              (rng.randn(N, c["dg"] * kh * kw * 2, oh, ow) * 1.5).astype(
                  np.float32),
              (rng.randn(c["oc"], Cin // c["groups"], kh, kw) * 0.3).astype(
                  np.float32)]
    if c["bias"]:
        arrays.append(rng.randn(c["oc"]).astype(np.float32))
    if c["mask"]:
        arrays.append(rng.rand(N, c["dg"] * kh * kw, oh, ow).astype(
            np.float32))
    return arrays


@pytest.mark.parametrize("c", DCN, ids=["v1", "v2_groups", "v2_rect"])
def test_deform_conv2d_matches_reference(c):
    rng = np.random.RandomState(c["oc"])
    arrays = _dcn_arrays(rng, c)
    kw = dict(stride=c["stride"], padding=c["padding"],
              dilation=c["dilation"], deformable_groups=c["dg"],
              groups=c["groups"])

    def call(mod):
        def f(x, off, w, *rest):
            rest = list(rest)
            b = rest.pop(0) if c["bias"] else None
            m = rest.pop(0) if c["mask"] else None
            return mod.deform_conv2d(x, off, w, b, mask=m, **kw)
        return f

    got = compare(call(J), call(P), arrays, 6, "deform_conv2d")
    assert np.isfinite(got).all()


def test_deform_conv2d_zero_offsets_is_conv2d():
    rng = np.random.RandomState(9)
    x = tt(rng.randn(2, 4, 8, 9).astype(np.float32))
    w = tt(rng.randn(6, 2, 3, 3).astype(np.float32))
    b = tt(rng.randn(6).astype(np.float32))
    off = torch.zeros(2, 2 * 9 * 2, 4, 5)
    mask = torch.ones(2, 2 * 9, 4, 5)
    got = P.deform_conv2d(x, off, w, b, stride=2, padding=1,
                          deformable_groups=2, groups=2, mask=mask)
    want = TF.conv2d(x, w, b, stride=2, padding=1, groups=2)
    near(got.numpy(), want.numpy(), "zero offsets")


def test_deform_conv2d_zero_offsets_gradients_match_reference():
    """Zero offsets put every tap on the grid, the padded border's taps on
    the sampling clamp's bounds, where the reference's ``jnp.clip`` passes
    half the gradient to the offset."""
    rng = np.random.RandomState(10)
    arrays = [rng.randn(1, 2, 5, 6).astype(np.float32),
              np.zeros((1, 18, 5, 6), np.float32),
              (rng.randn(3, 2, 3, 3) * 0.3).astype(np.float32),
              np.ones((1, 9, 5, 6), np.float32)]

    def call(mod):
        return lambda x, off, w, m: mod.deform_conv2d(x, off, w, padding=1,
                                                      mask=m)

    compare(call(J), call(P), arrays, 11, "deform_conv2d zero offsets")


def test_deform_conv2d_layer_matches_reference():
    paddle_tpu.seed(3)
    jl = J.DeformConv2D(4, 6, 3, padding=1, deformable_groups=2)
    tl = P.DeformConv2D(4, 6, 3, padding=1, deformable_groups=2)
    C.carry(jl, tl)
    assert [k for k, _ in tl.named_parameters()] == ["weight", "bias"]
    rng = np.random.RandomState(2)
    x = rng.randn(1, 4, 5, 5).astype(np.float32)
    off = rng.randn(1, 2 * 9 * 2, 5, 5).astype(np.float32)
    mask = rng.rand(1, 2 * 9, 5, 5).astype(np.float32)
    want, wg, wp = C.run_jax(jl, [x, off, mask], 1,
                             params=list(jl.named_parameters()))
    got, gg, gp = C.run_port(tl, [x, off, mask], 1,
                             params=list(tl.named_parameters()))
    near(got, want, "layer out")
    for g, w in zip(gg, wg):
        near(g, w, "layer input grad")
    for k in wp:
        near(gp[k], wp[k], f"grad of {k}")
    assert P.DeformConv2D(4, 6, 3, bias_attr=False).bias is None


def test_read_file_and_decode_jpeg(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.RandomState(0)
    arr = rng.randint(0, 256, (12, 10, 3), np.uint8)
    path = str(tmp_path / "img.jpg")
    Image.fromarray(arr).save(path)
    raw = P.read_file(path)
    assert raw.dtype == torch.uint8 and raw.device.type == "cpu"
    equal(raw.numpy(), C._np(J.read_file(path)))
    for mode in ("unchanged", "rgb", "gray"):
        got = P.decode_jpeg(raw, mode=mode)
        want = C._np(J.decode_jpeg(J.read_file(path), mode=mode))
        equal(got.numpy(), want, mode)
    assert tuple(P.decode_jpeg(raw).shape) == (3, 12, 10)
