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

Remat policies (the reference's ``_remat_policy``, :85-113, a
``jax.checkpoint`` policy on the scan body):

- ``True``/``"full"``: each decoder layer under non-reentrant
  ``torch.utils.checkpoint``, its forward rerun in the backward (two
  flash forwards a layer and step);
- ``False``/``"none"``: every activation kept;
- ``"attn_out"``: the reference saves only the flash output (its
  ``checkpoint_name(ctx, "attn_out")``). K3 is an ``autograd.Function``
  over a kernel launch, which torch's selective checkpointing cannot see
  into, so the layer runs as two checkpointed segments around the
  attention core: the norm, projections and RoPE before it, and the
  output projection, residual and MLP after it. The core itself is not
  recomputed: K3's output and log-sum-exp stay saved (with its inputs q,
  k, v, which the backward kernels read), so the backward reruns the two
  segments and no flash forward (one flash forward a layer and step);
- ``"dots"``: the reference's ``dots_with_no_batch_dims_saveable``: each
  layer checkpointed with a selective policy that saves the outputs of
  ``aten.mm`` and ``aten.addmm`` (the linears' products over flattened
  tokens; a batched ``bmm`` is recomputed) and recomputes everything else,
  K3 included, as in the reference, where the Pallas call is not a dot
  (two flash forwards a layer and step).
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import resolve_device
from ..distributed.fleet.recompute import amp_contexts, recompute
from ..ops.attention import flash_attention
from ..optimizer.functional import (AdamWState, adamw_init, adamw_update,
                                    clip_by_global_norm)
from .llama import LlamaConfig, LlamaForCausalLM

__all__ = ["forward", "build_loss_fn", "build_train_step"]


_POLICIES = ("full", "none", "attn_out", "dots")


def _remat_policy(remat) -> str:
    """The remat spec as one of ``_POLICIES``; raises on anything else."""
    if remat is True:
        return "full"
    if remat is False:
        return "none"
    if remat in _POLICIES:
        return remat
    raise ValueError(f"unknown remat spec {remat!r}")


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _qkv_segment(layer, x, cos, sin):
    return layer.self_attn._qkv(layer.input_layernorm(x), cos, sin)


def _post_segment(layer, x, ctx):
    x = x + layer.self_attn._out(ctx)
    return x + layer.mlp(layer.post_attention_layernorm(x))


def _layer(layer, x, cos, sin, policy: str):
    """One decoder layer under ``policy`` (the module docstring's)."""
    if policy == "none":
        return layer(x, cos, sin)
    if policy == "full":
        return recompute(layer, x, cos, sin)
    if policy == "attn_out":
        qh, kh, vh = recompute(_qkv_segment, layer, x, cos, sin)
        ctx = flash_attention(qh, kh, vh, causal=True)
        return recompute(_post_segment, layer, x, ctx)
    return checkpoint(layer, x, cos, sin, use_reentrant=False,
                      context_fn=partial(amp_contexts, partial(
                          create_selective_checkpoint_contexts, _save_dots)))


def forward(model: LlamaForCausalLM, ids: torch.Tensor,
            remat=True) -> torch.Tensor:
    """Logits [B, S, V] of ids [B, S], each decoder layer under the remat
    policy ``remat``."""
    policy = _remat_policy(remat)
    m = model.model
    x = m.embed_tokens(ids)
    cos, sin = m._tables(ids.shape[1], x)
    for layer in m.layers:
        x = _layer(layer, x, cos, sin, policy)
    return model.logits(m.norm(x))


def build_loss_fn(cfg: LlamaConfig, remat=True, ignore_index: int = -100
                  ) -> Callable[..., torch.Tensor]:
    """(model, ids, labels) -> mean cross entropy over the labels that are
    not ``ignore_index``, in the reference's lse - logit form (labels
    clipped into the vocabulary, the ignored ones masked out)."""
    _remat_policy(remat)

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
    card, see :func:`~paddle_tpu_torch.device.resolve_device`)."""
    dev = resolve_device(device)
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
