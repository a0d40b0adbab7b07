"""Program-level quantization passes (port of
``paddle_tpu/static/quantization.py``; reference
python/paddle/static/quantization/quantization_pass.py:
QuantizationTransformPass inserts fake quantize/dequantize ops in front of
quantizable ops, QuantizationFreezePass rewrites them to fixed scales).

A pass is a rewrite of a recorded Program's node list: absmax fake-quant
nodes go in front of the float inputs of matmul-class ops (QAT: the scale
is each run's absmax and the gradient straight-through, so
``append_backward`` / ``minimize`` train through them), and the freeze
pass fixes the weight scales from the calibrated scope. The int8
simulation is ``quantization._fake_quant``.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import torch

from ..core import dispatch
from .program import Program, Scope, StaticNode, global_scope

__all__ = ["QuantizationTransformPass", "QuantizationFreezePass",
           "quant_aware", "convert"]

_QUANT_OP_TYPES = ("matmul", "mul", "conv2d", "linear")
_FQ_NAME = "fake_quantize_dequantize_absmax"
_FLOATS = (torch.float16, torch.bfloat16, torch.float32, torch.float64)


def _dyn_fake_quant(x, bits: int):
    """Absmax fake quant with the run's scale (the QAT forward); the
    straight-through backward is ``_FakeQuant``'s."""
    from ..quantization import _fake_quant

    scale = x.detach().abs().max().clamp_min(1e-9)
    return _fake_quant(x, scale, float(2 ** (bits - 1) - 1))


def _fixed_fake_quant(x, scale: float, bits: int):
    from ..quantization import _fake_quant

    return _fake_quant(x, torch.tensor(scale, dtype=x.dtype,
                                       device=x.device),
                       float(2 ** (bits - 1) - 1))


class QuantizationTransformPass:
    """Insert fake-quant nodes on every float tensor input of quantizable
    ops (reference QuantizationTransformPass.apply: the
    _transform_forward insertion walk)."""

    def __init__(self, weight_bits: int = 8, activation_bits: int = 8,
                 quantizable_op_type: Iterable[str] = _QUANT_OP_TYPES):
        self._wbits = int(weight_bits)
        self._abits = int(activation_bits)
        self._types = tuple(quantizable_op_type)

    def _quantizable(self, node: StaticNode) -> bool:
        # exact op-type match, as the reference matches op types
        return (node.name or "").lower() in self._types

    def apply(self, program: Program) -> Program:
        with dispatch.internal():
            return self._apply(program)

    def _apply(self, program: Program) -> Program:
        out = program.clone()
        param_ids = set(program.param_vars.values())
        new_nodes = []
        n_inserted = 0
        quantized: Dict[Tuple[int, int], int] = {}  # (src id, bits) -> qid
        for node in out.nodes:
            if not self._quantizable(node):
                new_nodes.append(node)
                continue
            new_slots = []
            for kind, v in node.in_ids:
                if kind != "var" or v not in out.var_meta:
                    new_slots.append((kind, v))
                    continue
                name, value = out.var_meta[v]
                if value.dtype not in _FLOATS or value.dim() < 1:
                    new_slots.append((kind, v))
                    continue
                bits = self._wbits if v in param_ids else self._abits
                qid = quantized.get((v, bits))  # one quant a var (reference
                if qid is None:                 # dequantized_vars cache)
                    q = torch.empty(tuple(value.shape), dtype=value.dtype,
                                    device="meta")
                    qid = quantized[(v, bits)] = id(q)
                    out.add_var(qid, f"{name}.quantized", q)
                    new_nodes.append(StaticNode(
                        fn=lambda x, _b=bits: _dyn_fake_quant(x, _b),
                        in_ids=[("var", v)], const_args=None,
                        out_ids=[qid], name=_FQ_NAME))
                    n_inserted += 1
                new_slots.append(("var", qid))
            new_nodes.append(StaticNode(
                fn=node.fn, in_ids=new_slots, const_args=node.const_args,
                out_ids=node.out_ids, name=node.name))
        out.nodes = new_nodes
        out._quant_inserted = n_inserted
        out._quant_bits = (self._wbits, self._abits)
        return out


class QuantizationFreezePass:
    """Freeze the WEIGHT fake-quants to fixed scales read from the
    (calibrated) scope (reference QuantizationFreezePass: scale transfer
    and op rewrite). Activation quants keep their per-run scales."""

    def __init__(self, weight_bits: int = 8):
        self._wbits = int(weight_bits)

    def apply(self, program: Program,
              scope: Optional[Scope] = None) -> Program:
        with dispatch.internal():
            return self._apply(program, scope)

    def _apply(self, program: Program, scope: Optional[Scope]) -> Program:
        scope = scope or global_scope()
        out = program.clone()
        id_to_pname = {vid: n for n, vid in program.param_vars.items()}
        scales: Dict[str, float] = {}
        new_nodes = []
        for node in out.nodes:
            src = node.in_ids[0][1] if node.in_ids else None
            if node.name == _FQ_NAME and src in id_to_pname:
                pname = id_to_pname[src]
                val = scope.var(pname)
                if val is None:
                    val = out.param_objs[pname]
                val = torch.as_tensor(val)
                # a zero-initialized param (a bias) divides by the floor
                scale = max(float(val.detach().abs().max()), 1e-9)
                scales[pname] = scale
                new_nodes.append(StaticNode(
                    fn=lambda x, _s=scale, _b=self._wbits:
                        _fixed_fake_quant(x, _s, _b),
                    in_ids=node.in_ids, const_args=None,
                    out_ids=node.out_ids,
                    name="fake_quantize_dequantize_frozen"))
            else:
                new_nodes.append(node)
        out.nodes = new_nodes
        out._quant_scales = scales
        return out


def quant_aware(program: Program, weight_bits: int = 8,
                activation_bits: int = 8,
                quantizable_op_type: Iterable[str] = _QUANT_OP_TYPES
                ) -> Program:
    """One-call QAT program transform (reference paddleslim-style
    quant_aware over a static program)."""
    return QuantizationTransformPass(
        weight_bits, activation_bits, quantizable_op_type).apply(program)


def convert(program: Program, scope: Optional[Scope] = None,
            weight_bits: int = 8) -> Program:
    """Freeze the trained or calibrated quant program for inference."""
    return QuantizationFreezePass(weight_bits).apply(program, scope)
