"""The Llama training step as functions (port of
``paddle_tpu/models/llama_functional.py``: ``forward``, ``build_loss_fn``,
``build_train_step``, :116-185), the entry point ``bench.py`` trains with.

The reference stacks the per-layer parameters into leading-[L] arrays
(``stack_params``) and runs one ``lax.scan`` over the decoder body, so XLA
compiles the layer once whatever the depth. That is a TPU compile-time
device: PyTorch runs eagerly and compiles nothing, so the port walks the
model's ``nn.ModuleList`` in a Python loop over the same modules (and the
same kernels) as the Layer API, and its parameters stay the model's named
parameters. Weights trained by the reference in stacked form come across
through ``models.convert.load_stacked_params``.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..device import get_device
from ..distributed.fleet.recompute import recompute
from ..optimizer.functional import (AdamWState, adamw_init, adamw_update,
                                    clip_by_global_norm)
from .llama import LlamaConfig, LlamaForCausalLM

__all__ = ["forward", "build_loss_fn", "build_train_step"]


def _full_remat(remat) -> bool:
    """True/"full": recompute each layer in the backward; False/"none": keep
    its activations. The reference's selective policies are not ported."""
    if remat in (True, "full"):
        return True
    if remat in (False, "none"):
        return False
    if remat in ("attn_out", "dots"):
        raise NotImplementedError(
            f"remat={remat!r} (save only named activations) is not ported "
            f"yet: use 'full' or 'none'")
    raise ValueError(f"unknown remat spec {remat!r}")


def forward(model: LlamaForCausalLM, ids: torch.Tensor,
            remat=True) -> torch.Tensor:
    """Logits [B, S, V] of ids [B, S], each decoder layer under
    :func:`~paddle_tpu_torch.distributed.fleet.recompute` when ``remat``."""
    full = _full_remat(remat)
    m = model.model
    x = m.embed_tokens(ids)
    cos, sin = m._tables(ids.shape[1], x)
    for layer in m.layers:
        x = recompute(layer, x, cos, sin) if full else layer(x, cos, sin)
    return model.logits(m.norm(x))


def build_loss_fn(cfg: LlamaConfig, remat=True, ignore_index: int = -100
                  ) -> Callable[..., torch.Tensor]:
    """(model, ids, labels) -> mean cross entropy over the labels that are
    not ``ignore_index``, in the reference's lse - logit form (labels
    clipped into the vocabulary, the ignored ones masked out)."""
    _full_remat(remat)

    def loss_fn(model, ids, labels):
        logits = forward(model, ids, remat)
        lbl = labels.long().clamp(0, cfg.vocab_size - 1)
        lse = torch.logsumexp(logits.float(), dim=-1)
        tgt = torch.gather(logits, -1, lbl[..., None])[..., 0]
        nll = lse - tgt.float()
        mask = (labels != ignore_index).float()
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)

    return loss_fn


def build_train_step(cfg: LlamaConfig, lr: float = 1e-4,
                     clip_norm: float = 1.0, remat=True,
                     moment_dtype: Optional[torch.dtype] = None,
                     device=None) -> Tuple[Callable, Callable]:
    """AdamW train step: returns ``(step, init)``.

    ``init(model)`` builds the optimizer state for the model's named
    parameters (``moment_dtype=torch.bfloat16`` stores the first moment in
    bf16; the math stays fp32). ``step(model, state, ids, labels)`` runs
    forward, backward, the global-norm clip and AdamW, updating the
    parameters and ``state`` in place, and returns the loss (fp32, before
    the update). The model must live on ``device`` (default: the CUDA
    card, see :func:`~paddle_tpu_torch.get_device`)."""
    dev = get_device(device)
    loss_fn = build_loss_fn(cfg, remat)

    def _params(model):
        if model.device.type != dev.type:
            raise ValueError(f"the train step was built for {dev}, the "
                             f"model lives on {model.device}")
        return dict(model.named_parameters())

    def init(model) -> AdamWState:
        return adamw_init(_params(model), moment_dtype=moment_dtype)

    def step(model, state: AdamWState, ids, labels) -> torch.Tensor:
        params = _params(model)
        for p in params.values():
            p.grad = None
        loss = loss_fn(model, ids.to(model.device), labels.to(model.device))
        loss.backward()
        missing = sorted(k for k, p in params.items() if p.grad is None)
        if missing:
            raise RuntimeError(f"backward left no gradient for {missing}")
        grads = {k: p.grad for k, p in params.items()}
        clip_by_global_norm(grads, clip_norm)
        adamw_update(grads, state, params, lr=lr)
        return loss.detach()

    return step, init
