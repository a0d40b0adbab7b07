"""``paddle.Model``, the high-level training API (port of
``paddle_tpu/hapi/model.py``).

``prepare`` (optimizer, loss, metrics, ``amp_configs``), ``train_batch``,
``eval_batch``, ``predict_batch``, ``fit`` (with the reference's
``accumulate_grad_batches``, its step on the epoch's last batch and after
an iterable that ends mid-accumulation, and ``optimizer_step`` in the
logs), ``evaluate``, ``predict``, and ``save``/``load`` of ``.pdparams`` and
``.pdopt`` through ``framework.io``. A batch costs one host read, the
loss's ``float()``, as in the reference.

The model follows its network's device: inputs and labels are moved to the
device of the network's first parameter. ``fit``, ``evaluate`` and
``predict`` take iterables of batches; a ``Dataset``, which the reference
wraps in its ``io.DataLoader``, raises, as do ``save(training=False)``
(an inference export through ``jit``) and ``summary``: those are not
ported yet (ROADMAP A14).
"""
from __future__ import annotations

import os
from typing import List

import numpy as np
import torch
from torch import nn

from ..metric import Metric
from .callbacks import config_callbacks

__all__ = ["Model"]

_NOT_PORTED = "not ported yet (ROADMAP A14, {})"


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _to_tensor(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


class Model:
    """reference hapi/model.py:1050 parity."""

    def __init__(self, network: nn.Module, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self.stop_training = False

    # -- configuration -----------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        if loss is not None and not (isinstance(loss, nn.Module)
                                     or callable(loss)):
            raise TypeError(
                "'loss' must be sub classes of `paddle.nn.Layer` or any "
                "callable function.")
        self._loss = loss
        for m in _to_list(metrics):
            if not isinstance(m, Metric):
                raise TypeError(
                    f"{type(m).__name__} is not a valid paddle.metric.Metric")
        self._metrics = _to_list(metrics)
        self._amp_level = None
        if isinstance(amp_configs, str):
            self._amp_level = amp_configs
        elif isinstance(amp_configs, dict):
            self._amp_level = amp_configs.get("level")

    # -- single-batch ops ---------------------------------------------------
    def _compute_loss(self, outputs, labels):
        outs = _to_list(outputs)
        labs = _to_list(labels)
        if self._loss is None:
            raise RuntimeError("loss not set; call prepare(loss=...)")
        loss = self._loss(*(outs + labs))
        if isinstance(loss, (list, tuple)):
            loss = sum(l.sum() for l in loss)
        if loss.ndim > 0:
            loss = loss.mean()
        return loss

    def _device(self):
        return next(iter(self.network.parameters())).device

    def train_batch(self, inputs, labels=None, update=True):
        """Forward, loss, backward, and (``update``) the optimizer's step
        and ``clear_grad``; returns ``[loss]`` (and the metrics)."""
        self.network.train()
        dev = self._device()
        inputs = [_to_tensor(x, dev) for x in _to_list(inputs)]
        labels = [_to_tensor(y, dev) for y in _to_list(labels)]

        if self._amp_level in ("O1", "O2"):
            from .. import amp as amp_mod

            with amp_mod.auto_cast(level=self._amp_level):
                outputs = self.network(*inputs)
                loss = self._compute_loss(outputs, labels)
        else:
            outputs = self.network(*inputs)
            loss = self._compute_loss(outputs, labels)
        loss.backward()
        if update:
            self._optimizer.step()
            self._optimizer.clear_grad()
        metrics = self._update_metrics(outputs, labels)
        if metrics:
            return [float(loss.detach())], metrics
        return [float(loss.detach())]

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        dev = self._device()
        inputs = [_to_tensor(x, dev) for x in _to_list(inputs)]
        labels = [_to_tensor(y, dev) for y in _to_list(labels)]
        with torch.no_grad():
            outputs = self.network(*inputs)
            loss = self._compute_loss(outputs, labels) if self._loss else None
        metrics = self._update_metrics(outputs, labels)
        losses = [] if loss is None else [float(loss.detach())]
        # always (losses, metrics) when metrics exist so _pack_logs can't
        # mislabel a metric value as the loss
        if metrics:
            return (losses, metrics)
        return losses

    def predict_batch(self, inputs):
        self.network.eval()
        dev = self._device()
        inputs = [_to_tensor(x, dev) for x in _to_list(inputs)]
        with torch.no_grad():
            out = self.network(*inputs)
        return [o.detach().cpu().numpy() for o in _to_list(out)]

    def _update_metrics(self, outputs, labels):
        res = []
        outs = _to_list(outputs)
        for m in self._metrics:
            stats = m.compute(*(outs + labels))
            r = m.update(*_to_list(stats))
            res.append(r)
        return res

    # -- loops --------------------------------------------------------------
    def _make_loader(self, data, batch_size, shuffle, num_workers):
        if data is None:
            return None
        if any(c.__name__ == "Dataset" for c in type(data).__mro__):
            raise NotImplementedError(
                "a Dataset for fit/evaluate/predict is "
                + _NOT_PORTED.format("io.DataLoader") + "; pass an "
                "iterable of batches")
        return data  # an iterable of batches

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        """Train over ``train_data``, an iterable of batches (``[inputs...,
        label]``), for ``epochs``."""
        loader = self._make_loader(train_data, batch_size, shuffle,
                                   num_workers)
        eval_loader = self._make_loader(eval_data, batch_size, False,
                                        num_workers)
        steps = len(loader) if hasattr(loader, "__len__") else None
        cbks = config_callbacks(
            callbacks, model=self, batch_size=batch_size, epochs=epochs,
            steps=steps, log_freq=log_freq, verbose=verbose,
            save_freq=save_freq, save_dir=save_dir, metrics=self._metrics)
        self.stop_training = False
        cbks.on_train_begin()
        it = 0
        for epoch in range(epochs):
            if self.stop_training:
                break
            cbks.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            logs = {}
            update = True
            for step, batch in enumerate(loader):
                cbks.on_train_batch_begin(step)
                ins, labs = self._split_batch(batch)
                # always step on the epoch's last batch (reference
                # model.py:2320): with accumulation and an epoch length not
                # divisible by accumulate_grad_batches, tail-batch grads
                # would otherwise leak into the next epoch
                update = ((step + 1) % accumulate_grad_batches == 0
                          or (steps is not None and step + 1 == steps))
                out = self.train_batch(ins, labs, update=update)
                logs = self._pack_logs(out)
                # ACTUAL rows in this batch (reference fit:1870 passes
                # batch_size in logs) — the tail batch can be short, and
                # throughput consumers must not bill the configured size
                try:
                    logs["batch_size"] = int(ins[0].shape[0])
                except Exception:
                    pass
                # with grad accumulation only every k-th batch is an
                # optimizer step; metric consumers must not count 4x
                logs["optimizer_step"] = bool(update)
                cbks.on_train_batch_end(step, logs)
                it += 1
                if num_iters is not None and it >= num_iters:
                    self.stop_training = True
                    break
            if not update:
                # iterable loaders (no __len__) can end mid-accumulation:
                # flush the pending grads so they don't leak into next epoch
                self._optimizer.step()
                self._optimizer.clear_grad()
            cbks.on_epoch_end(epoch, logs)
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                self.evaluate(eval_loader, batch_size=batch_size,
                              verbose=verbose, callbacks=cbks,
                              _inner=True)
        cbks.on_train_end()

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None,
                 _inner=False):
        loader = self._make_loader(eval_data, batch_size, False, num_workers)
        cbks = callbacks if _inner else config_callbacks(
            callbacks, model=self, batch_size=batch_size, verbose=verbose,
            metrics=self._metrics, mode="eval")
        for m in self._metrics:
            m.reset()
        cbks.on_eval_begin()
        logs = {}
        for step, batch in enumerate(loader):
            cbks.on_eval_batch_begin(step)
            ins, labs = self._split_batch(batch)
            out = self.eval_batch(ins, labs)
            logs = self._pack_logs(out)
            cbks.on_eval_batch_end(step, logs)
        # final accumulated metric values
        for m in self._metrics:
            logs[m.name()[0] if isinstance(m.name(), list) else m.name()] = (
                m.accumulate())
        cbks.on_eval_end(logs)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        loader = self._make_loader(test_data, batch_size, False, num_workers)
        outputs = []
        for batch in loader:
            ins, _ = self._split_batch(batch, has_label=False)
            outputs.append(self.predict_batch(ins))
        if stack_outputs and outputs:
            n_out = len(outputs[0])
            return [np.concatenate([o[i] for o in outputs])
                    for i in range(n_out)]
        return outputs

    def _split_batch(self, batch, has_label=True):
        if isinstance(batch, (list, tuple)):
            if has_label and len(batch) >= 2:
                return batch[:-1] if len(batch) > 2 else [batch[0]], [batch[-1]]
            return list(batch), []
        return [batch], []

    def _pack_logs(self, out):
        logs = {}
        if isinstance(out, tuple):
            losses, metrics = out
            if losses:
                logs["loss"] = losses[0]
            for m, r in zip(self._metrics, metrics):
                name = m.name()
                logs[name[0] if isinstance(name, list) else name] = r
        elif isinstance(out, list) and out:
            logs["loss"] = out[0]
        return logs

    # -- io ------------------------------------------------------------------
    def save(self, path: str, training: bool = True):
        """The network's parameters to ``path.pdparams`` and the optimizer's
        state to ``path.pdopt``."""
        if not training:
            raise NotImplementedError(
                "Model.save(training=False), an inference export through "
                "jit, is " + _NOT_PORTED.format("jit"))
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        from ..framework import io as fio

        fio.save(self.network.state_dict(), path + ".pdparams")
        if self._optimizer is not None:
            fio.save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path: str, skip_mismatch: bool = False,
             reset_optimizer=False):
        from ..framework import io as fio

        dev = self._device()
        self.network.load_state_dict(fio.load(path + ".pdparams",
                                              device=dev))
        opt_path = path + ".pdopt"
        if (not reset_optimizer and self._optimizer is not None
                and os.path.exists(opt_path)):
            self._optimizer.set_state_dict(fio.load(opt_path, device=dev))

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        raise NotImplementedError("Model.summary is "
                                  + _NOT_PORTED.format("hapi.model_summary"))
