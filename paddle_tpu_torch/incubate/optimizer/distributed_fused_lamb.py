"""DistributedFusedLamb (port of
``paddle_tpu/incubate/optimizer/distributed_fused_lamb.py:29-105``;
reference python/paddle/incubate/optimizer/distributed_fused_lamb.py:111
with distributed_fused_lamb_op.cu).

The reference fuses the whole LAMB update over flattened fp16/fp32 buffers
into a few CUDA kernels, with the moments sharded across data-parallel
ranks. Here it is the port's ``Lamb`` with the reference's arguments and
its gradient accumulation: on one card the update is the single-device
case, which ``tests/test_coverage_tail.py::test_matches_lamb_single_device``
holds for the JAX package. ``clip_after_allreduce`` keeps its meaning
there: with one rank the gradient is the post-allreduce one, so True (the
default) clips it. The ZeRO placement of the moments over a ``sharding``
mesh axis (the JAX package's ``_shard_states``) waits for the port's
hybrid-parallel mesh (ROADMAP A13).
"""
from __future__ import annotations

from ...optimizer.optimizer import Lamb

__all__ = ["DistributedFusedLamb"]


class DistributedFusedLamb(Lamb):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 clip_after_allreduce=True, is_grad_scaled_by_nranks=True,
                 alignment=128, use_master_param_norm=True,
                 gradient_accumulation_steps=1, use_master_acc_grad=True,
                 nproc_per_node=None, use_hierarchical_allreduce=False,
                 name=None):
        super().__init__(
            learning_rate=learning_rate,
            lamb_weight_decay=lamb_weight_decay, beta1=beta1, beta2=beta2,
            epsilon=epsilon, parameters=parameters, grad_clip=grad_clip,
            exclude_from_weight_decay_fn=exclude_from_weight_decay_fn,
            name=name)
        self._clip_after_allreduce = clip_after_allreduce
        self._is_grad_scaled_by_nranks = is_grad_scaled_by_nranks
        self._acc_steps = max(1, int(gradient_accumulation_steps))
        self._acc_count = 0
        self._grad_bank = {}

    def step(self):
        """One LAMB step, or, under gradient accumulation, the fp32 sum of
        this step's gradients until the last of ``acc_steps`` steps, which
        updates with their mean."""
        self._acc_count += 1
        if self._acc_steps > 1:
            pgs = self._collect_params_grads()
            for p, g in pgs:
                if g is None:
                    continue
                k = self._key(p)
                g32 = g.float()
                prev = self._grad_bank.get(k)
                self._grad_bank[k] = g32 if prev is None else prev + g32
            if self._acc_count % self._acc_steps:
                self.clear_grad()
                return
            for p, _ in pgs:
                k = self._key(p)
                if k in self._grad_bank:
                    p.grad = (self._grad_bank[k] / self._acc_steps).to(
                        p.dtype)
            self._grad_bank.clear()
        super().step()
