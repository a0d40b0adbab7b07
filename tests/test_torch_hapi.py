"""paddle_tpu_torch's losses, metrics, save/load and Model against
paddle_tpu's, on the CPU.

- Losses: every ported function of ``nn.functional.loss`` (the cross
  entropy with ignored labels, class weights, soft labels, label
  smoothing and a trailing label dim) and its layer class: the value and
  the input's gradient against the reference's, fp32, rtol 1e-5 (the same
  formulas, reductions in another order).
- Metrics: ``Accuracy`` (top-1 and top-3), ``Precision``, ``Recall``,
  ``Auc`` over two batches and ``accuracy``, against the reference's.
- ``save``/``load``: a state dict saved by the JAX package loads into the
  port's model and gives the same logits; a JAX-written bf16 array loads
  bitwise where ``ml_dtypes`` imports and raises, saying so, where it does
  not; the port's own bf16 format round-trips nested containers bitwise in
  an interpreter where ``ml_dtypes`` is blocked.
- ``Model.fit``: four batches with ``accumulate_grad_batches=2`` on the
  tiny Llama (AdamW, global-norm clip) against the JAX ``Model.fit``:
  per-batch losses, the callbacks' order and ``optimizer_step`` flags, and
  the parameters after (at the AdamW tolerance of test_torch_training.py);
  ``evaluate`` and ``predict``; a resume through ``Model.save``/``load``
  whose next ``train_batch`` is bitwise the uninterrupted one's.
- Callbacks: ``EarlyStopping``, the ``LRScheduler`` callback (which steps
  the scheduler here; the reference's never finds it), ``ReduceLROnPlateau``,
  ``ModelCheckpoint``, ``ProgBarLogger``, ``VisualDL``, ``WandbCallback``
  without wandb and ``MonitorCallback``; and what is not ported raises.
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import metric as jmetric
from paddle_tpu.framework import io as jio
from paddle_tpu.hapi.model import Model as JModel
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import llama_config as jax_config
from paddle_tpu.nn import clip as jclip
from paddle_tpu.nn import functional as jF
from paddle_tpu.nn.layer import loss as jloss
from paddle_tpu.optimizer import optimizer as jopt
from paddle_tpu_torch import (LlamaForCausalLM, Model, llama_config, load,
                              load_paddle_params, metric)
from paddle_tpu_torch import monitor
from paddle_tpu_torch.hapi import callbacks as tcb
from paddle_tpu_torch.nn import clip as tclip
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer import loss as tloss
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.optimizer import optimizer as topt

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(atol=5e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-5, rtol=1e-5)      # as test_torch_training.py


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the model is tiny, and a thread pool on a
    machine whose cores other test workers hold waits at every op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- losses ---------------------------------------------------------------------


def _r(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _loss_cases():
    rng = np.random.RandomState(0)
    logits, ids = _r(rng, 6, 5), rng.randint(0, 5, (6,))
    ids_ign = ids.copy()
    ids_ign[2] = -100
    w = rng.rand(5).astype(np.float32) + 0.5
    soft = np.abs(_r(rng, 6, 5))
    soft /= soft.sum(-1, keepdims=True)
    p = 1 / (1 + np.exp(-_r(rng, 6, 3)))
    y01 = (rng.rand(6, 3) > 0.5).astype(np.float32)
    a, b = _r(rng, 6, 3), _r(rng, 6, 3)
    ypm = np.where(rng.rand(6) > 0.5, 1.0, -1.0).astype(np.float32)
    tgt = np.abs(_r(rng, 6, 3)) + 0.1
    logp = np.log(soft)
    seg = rng.randint(0, 5, (6, 1))
    return {
        "ce": ("cross_entropy", [logits], dict(label=ids)),
        "ce_ignore_weight": ("cross_entropy", [logits], dict(
            label=ids_ign, weight=w)),
        "ce_smooth_sum": ("cross_entropy", [logits], dict(
            label=ids_ign, label_smoothing=0.1, reduction="sum")),
        "ce_soft": ("cross_entropy", [logits], dict(label=soft,
                                                    soft_label=True)),
        "ce_trailing_dim": ("cross_entropy", [logits], dict(
            label=ids[:, None], reduction="none")),
        "softmax_ce": ("softmax_with_cross_entropy", [logits], dict(
            label=ids_ign[:, None])),
        "bce": ("binary_cross_entropy", [p], dict(label=y01)),
        "bce_logits_pos": ("binary_cross_entropy_with_logits", [a], dict(
            label=y01, pos_weight=np.array([1.0, 2.0, 0.5], np.float32))),
        "bce_logits_w": ("binary_cross_entropy_with_logits", [a], dict(
            label=y01, weight=w[:3], reduction="sum")),
        "nll": ("nll_loss", [logp], dict(label=ids_ign)),
        "nll_weight": ("nll_loss", [logp], dict(label=ids, weight=w)),
        "l1": ("l1_loss", [a, b], {}),
        "mse_sum": ("mse_loss", [a, b], dict(reduction="sum")),
        "square_error": ("square_error_cost", [a, b], {}),
        "smooth_l1": ("smooth_l1_loss", [a * 2, b], dict(delta=0.7)),
        "kl_div": ("kl_div", [np.log(soft)], dict(label=soft[::-1].copy(),
                                                  reduction="batchmean")),
        "kl_div_log": ("kl_div", [np.log(soft)], dict(
            label=np.log(soft[::-1].copy()), log_target=True)),
        "margin_ranking": ("margin_ranking_loss", [a[:, 0], b[:, 0]], dict(
            label=ypm, margin=0.2)),
        "hinge_embedding": ("hinge_embedding_loss", [a[:, 0]], dict(
            label=ypm)),
        "cosine_embedding": ("cosine_embedding_loss", [a, b], dict(
            label=ypm, margin=0.1)),
        "soft_margin": ("soft_margin_loss", [a], dict(label=np.sign(b))),
        "multi_label_soft_margin": ("multi_label_soft_margin_loss", [a],
                                    dict(label=y01)),
        "triplet": ("triplet_margin_loss", [a, b, a[::-1].copy()], dict(
            swap=True)),
        "sigmoid_focal": ("sigmoid_focal_loss", [a], dict(label=y01)),
        "dice": ("dice_loss", [soft], dict(label=seg)),
        "log_loss": ("log_loss", [p], dict(label=y01)),
        "poisson_nll": ("poisson_nll_loss", [a], dict(label=tgt,
                                                     full=True)),
        "gaussian_nll": ("gaussian_nll_loss", [a, b], dict(
            variance=tgt, full=True)),
    }


LOSSES = _loss_cases()
# the label-like arguments that are tensors on both sides
_TENSOR_KW = ("label", "variance")


@pytest.mark.parametrize("case", sorted(LOSSES))
def test_loss_value_and_gradient_match_the_reference(case):
    name, inputs, kw = LOSSES[case]
    jin = [paddle.to_tensor(x, stop_gradient=False) for x in inputs]
    jkw = {k: paddle.to_tensor(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    jout = getattr(jF, name)(*jin, **jkw)
    jout.sum().backward()
    tin = [torch.from_numpy(x.copy()).requires_grad_() for x in inputs]
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    tout = getattr(F, name)(*tin, **tkw)
    tout.sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout.value),
                               **TOL)
    np.testing.assert_allclose(tin[0].grad.numpy(),
                               np.asarray(jin[0].grad.value), **TOL)


@pytest.mark.parametrize("layer,args,kw", [
    ("CrossEntropyLoss", ("ce_ignore_weight",), {}),
    ("NLLLoss", ("nll",), {}), ("BCELoss", ("bce",), {}),
    ("BCEWithLogitsLoss", ("bce_logits_pos",), {}),
    ("MSELoss", ("l1",), {}), ("L1Loss", ("l1",), {}),
    ("SmoothL1Loss", ("smooth_l1",), dict(delta=0.7)),
    ("KLDivLoss", ("kl_div",), dict(reduction="batchmean")),
    ("MarginRankingLoss", ("margin_ranking",), dict(margin=0.2)),
    ("HingeEmbeddingLoss", ("hinge_embedding",), {}),
    ("CosineEmbeddingLoss", ("cosine_embedding",), dict(margin=0.1)),
    ("TripletMarginLoss", ("triplet",), dict(swap=True)),
    ("MultiLabelSoftMarginLoss", ("multi_label_soft_margin",), {}),
    ("SoftMarginLoss", ("soft_margin",), {}),
    ("PoissonNLLLoss", ("poisson_nll",), dict(full=True)),
    ("GaussianNLLLoss", ("gaussian_nll",), dict(full=True))])
def test_loss_layers_match_the_reference(layer, args, kw):
    _, inputs, fkw = LOSSES[args[0]]
    extra = [fkw[k] for k in _TENSOR_KW if k in fkw]
    lkw = dict(kw)
    if "weight" in fkw:
        lkw["weight"] = fkw["weight"]
    if "pos_weight" in fkw:
        lkw["pos_weight"] = fkw["pos_weight"]
    jl = getattr(jloss, layer)(**{k: paddle.to_tensor(v) if isinstance(
        v, np.ndarray) else v for k, v in lkw.items()})
    tl = getattr(tloss, layer)(**{k: torch.from_numpy(v) if isinstance(
        v, np.ndarray) else v for k, v in lkw.items()})
    want = jl(*[paddle.to_tensor(x) for x in inputs + extra])
    got = tl(*[torch.from_numpy(x.copy()) for x in inputs + extra])
    np.testing.assert_allclose(got.numpy(), np.asarray(want.value), **TOL)


# -- metrics ----------------------------------------------------------------------


def test_metrics_match_the_reference():
    rng = np.random.RandomState(1)
    batches = [(_r(rng, 8, 5), rng.randint(0, 5, (8, 1))) for _ in range(2)]
    for topk in ((1,), (1, 3)):
        ta, ja = metric.Accuracy(topk=topk), jmetric.Accuracy(topk=topk)
        for pred, lab in batches:
            got = ta.update(ta.compute(torch.from_numpy(pred),
                                       torch.from_numpy(lab)))
            want = ja.update(ja.compute(paddle.to_tensor(pred),
                                        paddle.to_tensor(lab)))
            assert got == want
        assert ta.accumulate() == ja.accumulate()
        assert ta.name() == ja.name()
    probs = rng.rand(40).astype(np.float32)
    labels = (rng.rand(40) > 0.5).astype(np.int64)
    for cls in ("Precision", "Recall", "Auc"):
        tm, jm = getattr(metric, cls)(), getattr(jmetric, cls)()
        for lo, hi in ((0, 20), (20, 40)):
            tm.update(torch.from_numpy(probs[lo:hi]),
                      torch.from_numpy(labels[lo:hi]))
            jm.update(paddle.to_tensor(probs[lo:hi]),
                      paddle.to_tensor(labels[lo:hi]))
        assert tm.accumulate() == jm.accumulate(), cls
    pred, lab = batches[0]
    for k in (1, 2):
        assert float(metric.accuracy(torch.from_numpy(pred),
                                     torch.from_numpy(lab), k=k)) == \
            float(jmetric.accuracy(paddle.to_tensor(pred),
                                   paddle.to_tensor(lab), k=k).value)


# -- save / load --------------------------------------------------------------------


def _pair(layers=1, seed=3):
    paddle.seed(seed)
    jm = JaxLlama(jax_config("tiny", num_hidden_layers=layers))
    model = LlamaForCausalLM(llama_config("tiny", num_hidden_layers=layers),
                             device="cpu")
    load_paddle_params(model, {k: np.asarray(p.value)
                               for k, p in jm.named_parameters()})
    return jm, model


def _batches(n, seed=4):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rng.randint(0, 256, (8, 16)).astype(np.int64)
        labels = rng.randint(0, 256, (8, 16)).astype(np.int64)
        labels[0, :3] = -100
        out.append((ids, labels))
    return out


def test_a_jax_written_state_dict_loads_and_gives_the_same_logits(tmp_path):
    paddle.seed(8)
    jm = JaxLlama(jax_config("tiny", num_hidden_layers=1))
    path = str(tmp_path / "jax.pdparams")
    paddle.save(jm.state_dict(), path)
    model = LlamaForCausalLM(llama_config("tiny", num_hidden_layers=1),
                             device="cpu")
    sd = load(path, device="cpu")
    assert set(sd) == set(dict(model.named_parameters()))
    model.load_state_dict(sd)
    ids = _batches(1)[0][0]
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    want = np.asarray(jm(paddle.to_tensor(ids.astype(np.int32))).value)
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    numpy_sd = load(path, return_numpy=True)
    assert isinstance(numpy_sd["lm_head.weight"], np.ndarray)


_BLOCK = r"""
import importlib.abc, sys
BLOCKED = ("ml_dtypes", "jax", "jaxlib", "paddle_tpu")
for m in [m for m in sys.modules if m.split(".")[0] in BLOCKED]:
    del sys.modules[m]

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, Block())
sys.path.insert(0, %r)
"""


def _blocked(code, tmp_path):
    out = subprocess.run([sys.executable, "-c", _BLOCK % str(ROOT) + code],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_the_port_bf16_format_round_trips_without_ml_dtypes(tmp_path):
    code = r"""
import collections, torch
import paddle_tpu_torch as pt
Pair = collections.namedtuple("Pair", "a b")
g = torch.Generator().manual_seed(0)
w = torch.randn(4, 3, generator=g).to(torch.bfloat16).requires_grad_()
obj = {"w": w, "nested": {"list": [torch.arange(5), 1.5],
                          "pair": Pair(torch.ones(2, dtype=torch.bfloat16),
                                       "x")}, "step": 3}
pt.save(obj, "x.pdparams")
back = pt.load("x.pdparams", device="cpu")
assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], w)
assert back["w"].requires_grad
assert torch.equal(back["nested"]["list"][0], torch.arange(5))
assert back["nested"]["list"][1] == 1.5 and back["step"] == 3
assert isinstance(back["nested"]["pair"], Pair)
assert back["nested"]["pair"].a.dtype == torch.bfloat16
arr = pt.load("x.pdparams", return_numpy=True)["w"]
assert arr.dtype.name == "float32"
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("ok")
"""
    assert _blocked(code, tmp_path).split()[-1] == "ok"


def test_a_jax_written_bf16_array_needs_ml_dtypes(tmp_path):
    w = np.random.RandomState(2).randn(4, 3).astype(np.float32)
    jio.save({"w": paddle.to_tensor(jnp.asarray(w, jnp.bfloat16))},
             str(tmp_path / "bf16.pdparams"))
    got = load(str(tmp_path / "bf16.pdparams"), device="cpu")["w"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.float(), torch.from_numpy(
        np.array(jnp.asarray(w, jnp.bfloat16).astype(jnp.float32))))
    code = r"""
import pickle, paddle_tpu_torch as pt
try:
    pt.load("bf16.pdparams", device="cpu")
except pickle.UnpicklingError as e:
    assert "ml_dtypes" in str(e), e
    print("refused")
"""
    assert _blocked(code, tmp_path).split()[-1] == "refused"


def test_load_refuses_other_reference_classes(tmp_path):
    import pickle

    path = tmp_path / "bad.pdparams"
    path.write_bytes(b"cpaddle_tpu.core.tensor\nTensor\n.")   # a GLOBAL
    with pytest.raises(pickle.UnpicklingError, match="never classes"):
        load(str(path), device="cpu")


# -- Model -------------------------------------------------------------------------


class _Recorder:
    """The hooks fit calls, in order, with the logs that matter."""

    def __init__(self):
        self.calls = []

    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def __getattr__(self, name):
        if not name.startswith("on_"):
            raise AttributeError(name)

        def hook(*args):
            logs = args[-1] if args and isinstance(args[-1], dict) else {}
            step = args[0] if args and isinstance(args[0], int) else None
            self.calls.append((name, step, logs.get("loss"),
                               logs.get("optimizer_step")))
        return hook


def _fit(side, net, batches, **kw):
    rec = _Recorder()
    if side == "jax":
        m = JModel(net)
        opt = jopt.AdamW(learning_rate=1e-3, parameters=net.parameters(),
                         weight_decay=0.01,
                         grad_clip=jclip.ClipGradByGlobalNorm(1.0))
        m.prepare(opt, jloss.CrossEntropyLoss())
        data = [(b[0].astype(np.int32), b[1].astype(np.int32))
                for b in batches]
    else:
        m = Model(net)
        opt = topt.AdamW(learning_rate=1e-3, parameters=net.parameters(),
                         weight_decay=0.01,
                         grad_clip=tclip.ClipGradByGlobalNorm(1.0))
        m.prepare(opt, tloss.CrossEntropyLoss())
        data = batches
    m.fit(data, verbose=0, callbacks=[rec], **kw)
    return m, rec


def test_fit_with_accumulation_matches_the_reference():
    jm, model = _pair()
    batches = _batches(4)
    _, jrec = _fit("jax", jm, batches, accumulate_grad_batches=2)
    _, trec = _fit("torch", model, batches, accumulate_grad_batches=2)
    assert [c[:2] + c[3:] for c in trec.calls] == [
        c[:2] + c[3:] for c in jrec.calls]
    assert [c[3] for c in trec.calls if c[0] == "on_train_batch_end"] == [
        False, True, False, True]
    tl = [c[2] for c in trec.calls if c[0] == "on_train_batch_end"]
    jl = [c[2] for c in jrec.calls if c[0] == "on_train_batch_end"]
    np.testing.assert_allclose(tl, jl, **TOL)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(
            dict(jm.named_parameters())[k].value), **PARAM_TOL, err_msg=k)


def test_fit_flushes_an_iterable_that_ends_mid_accumulation():
    _, model = _pair()
    batches = _batches(3)
    steps = []
    m = Model(model)
    opt = topt.SGD(learning_rate=0.1, parameters=model.parameters())
    real = opt.step
    opt.step = lambda: steps.append(1) or real()
    m.prepare(opt, tloss.CrossEntropyLoss())
    m.fit(iter(batches), verbose=0, accumulate_grad_batches=2)
    assert len(steps) == 2                # after batch 2, then the flush
    assert all(p.grad is None for p in model.parameters())


def test_evaluate_and_predict():
    _, model = _pair()
    batches = _batches(2)
    m = Model(model)
    m.prepare(loss=tloss.CrossEntropyLoss(), metrics=metric.Accuracy())
    logs = m.evaluate(batches, verbose=0)
    assert set(logs) == {"loss", "acc"} and np.isfinite(logs["loss"])
    out = m.predict([(b[0],) for b in batches], stack_outputs=True)
    assert out[0].shape == (16, 16, 256)


def test_resume_through_save_and_load_is_bitwise(tmp_path):
    """Fit two batches, save; a fresh model and optimizer load it; the
    next train_batch on both gives bitwise the same parameters."""
    batches = _batches(3)

    def fresh(seed):
        model = LlamaForCausalLM(llama_config("tiny", num_hidden_layers=1),
                                 device="cpu",
                                 generator=torch.Generator().manual_seed(
                                     seed))
        m = Model(model)
        m.prepare(topt.AdamW(
            learning_rate=tlr.LinearWarmup(1e-3, 4, 0.0, 1e-3),
            parameters=model.parameters(), weight_decay=0.01,
            grad_clip=tclip.ClipGradByGlobalNorm(1.0)),
            tloss.CrossEntropyLoss())
        return m, model

    a, ma = fresh(0)
    a.fit(batches[:2], verbose=0)
    a.save(str(tmp_path / "ckpt" / "step2"))
    assert (tmp_path / "ckpt" / "step2.pdopt").exists()
    b, mb = fresh(1)
    b.load(str(tmp_path / "ckpt" / "step2"))
    assert b._optimizer.get_lr() == a._optimizer.get_lr() > 0
    la = a.train_batch([batches[2][0]], [batches[2][1]])
    lb = b.train_batch([batches[2][0]], [batches[2][1]])
    assert la == lb
    for (k, p), q in zip(ma.named_parameters(), mb.parameters()):
        assert torch.equal(p, q), k


def test_what_is_not_ported_raises(tmp_path):
    _, model = _pair()
    m = Model(model)
    m.prepare(topt.SGD(parameters=model.parameters()),
              tloss.CrossEntropyLoss())

    class Dataset(torch.utils.data.Dataset):
        def __getitem__(self, i):
            return _batches(1)[0]

        def __len__(self):
            return 1

    with pytest.raises(NotImplementedError, match="A14"):
        m.fit(Dataset(), verbose=0)
    with pytest.raises(NotImplementedError, match="A14"):
        m.save(str(tmp_path / "x"), training=False)
    with pytest.raises(NotImplementedError, match="A14"):
        m.summary()
    with pytest.raises(TypeError):
        m.prepare(loss="nope")
    with pytest.raises(TypeError):
        m.prepare(metrics="nope")


# -- callbacks -------------------------------------------------------------------


def _toy_model(lr=0.05):
    net = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.ReLU(),
                              torch.nn.Linear(8, 3))
    m = Model(net)
    m.prepare(topt.SGD(learning_rate=lr, parameters=net.parameters()),
              tloss.CrossEntropyLoss(), metrics=metric.Accuracy())
    rng = np.random.RandomState(0)
    data = [(rng.randn(6, 4).astype(np.float32),
             rng.randint(0, 3, (6,))) for _ in range(3)]
    return m, data


def test_lr_scheduler_callback_steps_the_optimizer_scheduler():
    m, data = _toy_model()
    sched = tlr.StepDecay(0.1, step_size=1, gamma=0.5)
    m._optimizer.set_lr_scheduler(sched)
    m.fit(data, epochs=1, verbose=0)
    assert sched.last_epoch == 3
    assert m._optimizer.get_lr() == 0.1 * 0.5 ** 3


def test_early_stopping_and_reduce_lr_on_plateau(capsys):
    m, data = _toy_model()
    es = tcb.EarlyStopping(monitor="loss", patience=0, min_delta=1e9,
                           save_best_model=False)
    m.fit(data, data, epochs=5, verbose=0, callbacks=[es])
    assert m.stop_training
    r = tcb.ReduceLROnPlateau(monitor="loss", factor=0.5, patience=1,
                              min_delta=1e9, verbose=0)
    r.set_model(m)
    for _ in range(2):
        r.on_eval_end({"loss": 1.0})
    assert m._optimizer.get_lr() == 0.025


def test_checkpoint_progbar_visualdl_and_wandb(tmp_path, capsys):
    m, data = _toy_model()
    m.fit(data, epochs=1, verbose=2, log_freq=1, save_dir=str(tmp_path),
          callbacks=[tcb.VisualDL(str(tmp_path / "vdl"))])
    out = capsys.readouterr().out
    assert "step 1/3" in out and "loss" in out
    assert (tmp_path / "0.pdparams").exists()
    assert (tmp_path / "final.pdopt").exists()
    lines = (tmp_path / "vdl" / "scalars.jsonl").read_text().splitlines()
    assert len(lines) == 3
    with pytest.raises(ModuleNotFoundError, match="wandb"):
        tcb.WandbCallback()


def test_monitor_callback_counts_steps_and_samples():
    monitor.reset()
    monitor.enable()
    try:
        m, data = _toy_model()
        m.fit(data, epochs=1, verbose=0, accumulate_grad_batches=2)
        snap = monitor.snapshot()
        names = str(snap)
        assert "paddle_tpu_train_batches_total" in names
        assert "paddle_tpu_train_steps_total" in names
        assert "paddle_tpu_train_samples_total" in names
    finally:
        monitor.disable()
        monitor.reset()
