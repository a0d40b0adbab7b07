"""High-level API callbacks (port of ``paddle_tpu/hapi/callbacks.py``):
``Callback``, ``CallbackList``, ``config_callbacks``, ``ProgBarLogger``,
``ModelCheckpoint``, ``EarlyStopping``, the ``LRScheduler`` callback,
``ReduceLROnPlateau``, ``MonitorCallback`` (over the port's ``monitor``
registry) and the ``VisualDL`` and ``WandbCallback`` stand-ins, which behave
as the reference's do without their packages (scalars to a jsonl file; a
``ModuleNotFoundError`` at construction).

One difference: the reference's ``LRScheduler`` callback looks for the
optimizer's scheduler under ``_learning_rate``, an attribute its optimizers
do not have (they keep it as ``_lr``), so it never steps the scheduler. The
port's optimizers keep it under ``_learning_rate``, as PaddlePaddle's do, so
here the callback steps it after every train batch (``by_step``) or epoch
(``by_epoch``).
"""
from __future__ import annotations

import numbers
import os
import time
from typing import List, Optional

import numpy as np

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "EarlyStopping",
           "LRScheduler", "VisualDL", "MonitorCallback", "config_callbacks"]


class Callback:
    """reference callbacks.py Callback — every hook is optional."""

    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    # train/eval/predict lifecycle hooks
    def on_train_begin(self, logs=None): ...
    def on_train_end(self, logs=None): ...
    def on_eval_begin(self, logs=None): ...
    def on_eval_end(self, logs=None): ...
    def on_predict_begin(self, logs=None): ...
    def on_predict_end(self, logs=None): ...
    def on_epoch_begin(self, epoch, logs=None): ...
    def on_epoch_end(self, epoch, logs=None): ...
    def on_train_batch_begin(self, step, logs=None): ...
    def on_train_batch_end(self, step, logs=None): ...
    def on_eval_batch_begin(self, step, logs=None): ...
    def on_eval_batch_end(self, step, logs=None): ...
    def on_predict_batch_begin(self, step, logs=None): ...
    def on_predict_batch_end(self, step, logs=None): ...


class CallbackList:
    def __init__(self, callbacks: Optional[List[Callback]] = None):
        self.callbacks = list(callbacks or [])

    def append(self, cb):
        self.callbacks.append(cb)

    def __iter__(self):
        return iter(self.callbacks)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def _call(self, name, *args):
        for c in self.callbacks:
            getattr(c, name)(*args)

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *a: self._call(name, *a)
        raise AttributeError(name)


class ProgBarLogger(Callback):
    """reference callbacks.py ProgBarLogger: periodic loss/metric lines."""

    def __init__(self, log_freq: int = 10, verbose: int = 2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_train_begin(self, logs=None):
        self.epochs = self.params.get("epochs")
        self.steps = self.params.get("steps")

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self._start = time.time()
        if self.verbose and self.epochs:
            print(f"Epoch {epoch + 1}/{self.epochs}")

    def _fmt(self, logs):
        out = []
        for k, v in (logs or {}).items():
            if k in ("batch_size", "optimizer_step"):  # metadata
                continue
            if isinstance(v, (numbers.Number, np.floating)):
                out.append(f"{k}: {float(v):.4f}")
            elif isinstance(v, (list, tuple)) and v and isinstance(
                    v[0], numbers.Number):
                out.append(f"{k}: " + "/".join(f"{float(x):.4f}" for x in v))
        return " - ".join(out)

    def on_train_batch_end(self, step, logs=None):
        if self.verbose == 2 and (step + 1) % self.log_freq == 0:
            print(f"step {step + 1}/{self.steps or '?'} - {self._fmt(logs)}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._start
            print(f"epoch {epoch + 1} done ({dt:.1f}s) - {self._fmt(logs)}")

    def on_eval_end(self, logs=None):
        if self.verbose:
            print(f"Eval - {self._fmt(logs)}")


class ModelCheckpoint(Callback):
    """reference callbacks.py ModelCheckpoint: save every N epochs + final."""

    def __init__(self, save_freq: int = 1, save_dir: Optional[str] = None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    """reference callbacks.py EarlyStopping (monitor/patience/min_delta)."""

    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        self.stopped_epoch = 0
        if mode not in ("auto", "min", "max"):
            mode = "auto"
        if mode == "min" or (mode == "auto" and "acc" not in monitor):
            self.monitor_op = np.less
            self.min_delta *= -1
        else:
            self.monitor_op = np.greater
        self.best_value = np.inf if self.monitor_op == np.less else -np.inf
        self.wait_epoch = 0

    def on_train_begin(self, logs=None):
        self.wait_epoch = 0
        if self.baseline is not None:
            self.best_value = self.baseline

    def on_eval_end(self, logs=None):
        if logs is None or self.monitor not in logs:
            return
        current = logs[self.monitor]
        if isinstance(current, (list, tuple)):
            current = current[0]
        current = float(current)
        if self.monitor_op(current - self.min_delta, self.best_value):
            self.best_value = current
            self.wait_epoch = 0
            if self.save_best_model and self.params.get("save_dir"):
                self.model.save(
                    os.path.join(self.params["save_dir"], "best_model"))
        else:
            self.wait_epoch += 1
        if self.wait_epoch > self.patience:
            self.model.stop_training = True
            if self.verbose:
                print(f"Early stopping: {self.monitor} did not improve for "
                      f"{self.patience} evals")


class LRScheduler(Callback):
    """reference callbacks.py LRScheduler: steps the optimizer's LR scheduler."""

    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        if by_step and by_epoch:
            raise ValueError("by_step and by_epoch are mutually exclusive")
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        return lr if hasattr(lr, "step") else None

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            s = self._sched()
            if s:
                s.step()

    def on_train_batch_end(self, step, logs=None):
        if self.by_step:
            s = self._sched()
            if s:
                s.step()


class VisualDL(Callback):
    """Stub: visualdl is GPU-stack tooling; scalars are appended to a jsonl
    file instead so training curves remain recoverable."""

    def __init__(self, log_dir="./log"):
        super().__init__()
        self.log_dir = log_dir
        self._step = 0

    def on_train_batch_end(self, step, logs=None):
        import json

        os.makedirs(self.log_dir, exist_ok=True)
        with open(os.path.join(self.log_dir, "scalars.jsonl"), "a") as f:
            rec = {"step": self._step}
            for k, v in (logs or {}).items():
                if k in ("batch_size", "optimizer_step"):  # metadata
                    continue
                if isinstance(v, (int, float, np.floating)):
                    rec[k] = float(v)
            f.write(json.dumps(rec) + "\n")
        self._step += 1


_FINISHED_FIT_LABELS: List[str] = []  # sessions awaiting series cleanup


class MonitorCallback(Callback):
    """Feed ``Model.fit`` training telemetry into ``paddle_tpu_torch.monitor``:
    step-time histogram, samples/sec + steps/sec throughput gauges, step
    and sample counters, and — when the per-sample cost is known — MFU.

    ``flops_per_sample`` is the model's forward+backward FLOPs for ONE
    sample (≈ 6 * params for a dense transformer LM over its sequence);
    ``peak_flops_per_sec`` is the accelerator's peak (e.g. 989e12, an
    H100 SXM's dense bf16 tensor-core peak on its data sheet). Both must
    be given for the MFU gauge; neither is guessed — a wrong denominator
    is worse than no MFU.

    ``config_callbacks`` installs this automatically whenever the
    monitor is enabled, so a plain ``Model.fit`` run already exports
    throughput; off-monitor it no-ops per batch after one bool check.
    """

    def __init__(self, flops_per_sample: Optional[float] = None,
                 peak_flops_per_sec: Optional[float] = None):
        super().__init__()
        self.flops_per_sample = flops_per_sample
        self.peak_flops_per_sec = peak_flops_per_sec
        self._t0 = None
        self._fit_label = None  # assigned per train session

    def _monitor(self):
        from .. import monitor

        return monitor if monitor.enabled() else None

    _GAUGES = (
        ("paddle_tpu_train_throughput_samples_per_sec",
         "instantaneous Model.fit throughput (latest batch), per fit "
         "session"),
        ("paddle_tpu_train_throughput_batches_per_sec",
         "instantaneous train_batch rate (latest batch; equals optimizer "
         "steps/sec only without grad accumulation), per fit session"),
        ("paddle_tpu_train_mfu_ratio",
         "model FLOPs utilization: achieved / peak, per fit session"),
    )

    def _fit_gauge(self, mon, idx):
        name, help_ = self._GAUGES[idx]
        return mon.gauge(name, help_, ("fit",))

    def on_train_begin(self, logs=None):
        mon = self._monitor()
        if mon is not None:
            # per-session gauge label: two concurrently fitting Models
            # in one process must not clobber each other's throughput
            # (same idiom as the engine/loader/pool labels). The series
            # deliberately OUTLIVES fit so the final throughput stays
            # visible in post-run snapshots — cleanup of FINISHED
            # sessions is deferred to the next fit, which bounds
            # cardinality at live sessions + one
            while _FINISHED_FIT_LABELS:
                stale = _FINISHED_FIT_LABELS.pop()
                for i in range(len(self._GAUGES)):
                    self._fit_gauge(mon, i).remove(fit=stale)
            self._fit_label = mon.instance_label("fit")

    def on_train_end(self, logs=None):
        if self._fit_label is not None:
            _FINISHED_FIT_LABELS.append(self._fit_label)

    def on_train_batch_begin(self, step, logs=None):
        self._t0 = time.perf_counter()

    def on_train_batch_end(self, step, logs=None):
        mon = self._monitor()
        # the flag gate is EXPLICIT at this per-batch seam (PT005):
        # _monitor() already returns None while disabled, but the
        # enabled() check keeps the near-zero-when-off contract visible
        # (and correct even for a caller holding a stale module ref)
        if mon is None or not mon.enabled() or self._t0 is None:
            return
        if self._fit_label is None:  # monitor enabled mid-session
            self._fit_label = mon.instance_label("fit")
        dt = time.perf_counter() - self._t0
        # the fit loop reports the ACTUAL row count per batch (tail
        # batches can be short); configured size is only the fallback
        batch_size = ((logs or {}).get("batch_size")
                      or self.params.get("batch_size") or 1)
        mon.histogram(
            "paddle_tpu_train_step_seconds",
            "wall time of one train_batch (forward+backward, plus the "
            "update on optimizer-step batches)").observe(dt)
        mon.counter("paddle_tpu_train_batches_total",
                    "train_batch calls run by Model.fit").inc()
        if (logs or {}).get("optimizer_step", True):
            # with grad accumulation only every k-th batch steps the
            # optimizer — the steps counter must reflect that
            mon.counter("paddle_tpu_train_steps_total",
                        "optimizer steps run by Model.fit").inc()
        mon.counter("paddle_tpu_train_samples_total",
                    "samples consumed by Model.fit").inc(batch_size)
        sps = batch_size / dt if dt > 0 else 0.0
        self._fit_gauge(mon, 0).labels(fit=self._fit_label).set(sps)
        self._fit_gauge(mon, 1).labels(fit=self._fit_label).set(
            1.0 / dt if dt > 0 else 0.0)
        if self.flops_per_sample and self.peak_flops_per_sec:
            self._fit_gauge(mon, 2).labels(fit=self._fit_label).set(
                sps * self.flops_per_sample / self.peak_flops_per_sec)


def config_callbacks(callbacks=None, model=None, batch_size=None, epochs=None,
                     steps=None, log_freq=10, verbose=2, save_freq=1,
                     save_dir=None, metrics=None, mode="train"):
    """reference callbacks.py config_callbacks: install defaults."""
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks = [ProgBarLogger(log_freq, verbose=verbose)] + cbks
    if not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks = cbks + [ModelCheckpoint(save_freq, save_dir)]
    if not any(isinstance(c, LRScheduler) for c in cbks):
        cbks = cbks + [LRScheduler()]
    from .. import monitor

    if monitor.enabled() and not any(
            isinstance(c, MonitorCallback) for c in cbks):
        cbks = cbks + [MonitorCallback()]
    cb_list = CallbackList(cbks)
    cb_list.set_model(model)
    params = {
        "batch_size": batch_size, "epochs": epochs, "steps": steps,
        "log_freq": log_freq, "verbose": verbose, "metrics": metrics or [],
        "save_dir": save_dir,
    }
    cb_list.set_params(params)
    return cb_list


class ReduceLROnPlateau(Callback):
    """Reduce LR when a monitored metric plateaus (reference
    hapi/callbacks.py ReduceLROnPlateau)."""

    def __init__(self, monitor="loss", factor=0.1, patience=10,
                 verbose=1, mode="auto", min_delta=1e-4, cooldown=0,
                 min_lr=0):
        super().__init__()
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.cooldown = cooldown
        self.min_lr = min_lr
        if mode == "min" or (mode == "auto" and "acc" not in monitor):
            self._is_better = lambda cur, best: cur < best - self.min_delta
            self.best = float("inf")
        else:
            self._is_better = lambda cur, best: cur > best + self.min_delta
            self.best = -float("inf")
        self.cooldown_counter = 0
        self.wait = 0

    def _get_value(self, logs):
        v = (logs or {}).get(self.monitor)
        if isinstance(v, (list, tuple)):
            v = v[0]
        return v

    def on_eval_end(self, logs=None):
        self._step(self._get_value(logs))

    def on_epoch_end(self, epoch, logs=None):
        self._step(self._get_value(logs))

    def _step(self, current):
        if current is None:
            return
        current = float(current)
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        if self._is_better(current, self.best):
            self.best = current
            self.wait = 0
            return
        self.wait += 1
        if self.wait < self.patience or self.cooldown_counter > 0:
            return
        opt = getattr(self.model, "_optimizer", None)
        if opt is None:
            return
        old = float(opt.get_lr())
        new = max(old * self.factor, self.min_lr)
        if old - new > 1e-12:
            opt.set_lr(new)
            if self.verbose:
                print(f"ReduceLROnPlateau: lr {old:.3g} -> {new:.3g}")
        self.cooldown_counter = self.cooldown
        self.wait = 0


class WandbCallback(Callback):
    """Weights & Biases logging callback (reference hapi/callbacks.py
    WandbCallback). wandb is not bundled (zero-egress image) — the
    constructor raises with instructions rather than failing at first
    log."""

    def __init__(self, *args, **kwargs):
        try:
            import wandb  # noqa: F401
        except ImportError as e:
            raise ModuleNotFoundError(
                "WandbCallback requires the `wandb` package, which is not "
                "bundled in this image (no network egress); install it on "
                "a connected machine.") from e


__all__ += ["ReduceLROnPlateau", "WandbCallback"]
