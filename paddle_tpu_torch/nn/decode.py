"""Seq2seq decoding (port of ``paddle_tpu/nn/decode.py``):
``BeamSearchDecoder`` over a step cell and ``dynamic_decode``.

The decode loop is host-driven, as the reference's: each step's math runs
on the cell's device, and the loop reads ``finished`` back once a step to
stop early. Beam selection takes the ``beam_size`` best of ``beam * V``
continuations per batch row in descending order, ties to the lowest flat
index (``jax.lax.top_k``'s rule); the port gets that order from a stable
descending sort, since ``torch.topk`` on the card does not promise it.
Token ids are int64 (the port's index dtype); the reference's are int32.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["BeamSearchDecoder", "dynamic_decode"]


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [_tree_map(fn, v) for v in tree]
        return type(tree)(out) if isinstance(tree, list) else tuple(out)
    return fn(torch.as_tensor(tree))


def _first_leaf(tree):
    if isinstance(tree, dict):
        return _first_leaf(next(iter(tree.values())))
    if isinstance(tree, (tuple, list)):
        return _first_leaf(tree[0])
    return tree


class BeamSearchDecoder:
    """Beam search over ``cell(inputs, states) -> (outputs, new_states)``;
    ``embedding_fn`` maps token ids to the cell's inputs and
    ``output_fn`` its outputs to vocabulary logits."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """[batch, ...] -> [batch * beam, ...], each row repeated."""
        x = torch.as_tensor(x)
        return x.repeat_interleave(beam_size, dim=0)

    def initialize(self, initial_cell_states):
        states = _tree_map(lambda s: self.tile_beam_merge_with_batch(
            s, self.beam_size), initial_cell_states)
        some = _first_leaf(states)
        batch = some.shape[0] // self.beam_size
        dev = some.device
        tokens = torch.full((batch, self.beam_size), self.start_token,
                            dtype=torch.long, device=dev)
        # only beam 0 is live at first (log prob 0, the others -1e9)
        log_probs = torch.where(
            torch.arange(self.beam_size, device=dev)[None, :] == 0,
            0.0, -1e9) * torch.ones((batch, 1), device=dev)
        finished = torch.zeros((batch, self.beam_size), dtype=torch.bool,
                               device=dev)
        return tokens, {"cell": states, "log_probs": log_probs,
                        "finished": finished}

    def step(self, time, inputs, states):
        batch, beam = states["log_probs"].shape
        ids = inputs.reshape(-1)
        step_in = self.embedding_fn(ids) if self.embedding_fn else ids
        out, new_cell = self.cell(step_in, states["cell"])
        logits = self.output_fn(out) if self.output_fn else out
        V = logits.shape[-1]
        logp = torch.log_softmax(logits.float(), -1).reshape(batch, beam, V)
        # a finished beam continues only with end_token, at no cost
        frozen = states["finished"]
        cont = torch.where(
            torch.arange(V, device=logp.device)[None, None, :]
            == self.end_token, 0.0, -1e9)
        logp = torch.where(frozen[..., None], cont, logp)
        flat = (states["log_probs"][..., None] + logp).reshape(batch,
                                                               beam * V)
        top_lp, top_idx = torch.sort(flat, dim=1, descending=True,
                                     stable=True)
        top_lp, top_idx = top_lp[:, :beam], top_idx[:, :beam]
        parent = top_idx // V
        token = top_idx % V
        new_finished = frozen.gather(1, parent) | (token == self.end_token)

        def regather(s):
            sv = s.reshape((batch, beam) + tuple(s.shape[1:]))
            idx = parent.reshape(tuple(parent.shape) + (1,) * (sv.dim() - 2))
            out = sv.gather(1, idx.expand((batch, beam)
                                          + tuple(sv.shape[2:])))
            return out.reshape((batch * beam,) + tuple(sv.shape[2:]))

        new_states = {"cell": _tree_map(regather, new_cell),
                      "log_probs": top_lp, "finished": new_finished}
        outputs = {"token": token, "parent": parent, "log_probs": top_lp}
        return outputs, new_states, token, new_finished

    def finalize(self, outputs, final_states, sequence_lengths=None):
        """Backtrace the beams to token sequences [T, batch, beam]."""
        from .functional.sequence_loss import gather_tree

        ids = torch.stack([o["token"] for o in outputs])
        parents = torch.stack([o["parent"] for o in outputs])
        return gather_tree(ids, parents)


def dynamic_decode(decoder, inits=None, max_step_num=None,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Step ``decoder`` until every beam finishes or ``max_step_num``
    steps (default 100); returns the backtraced ids, [batch, T, beam]
    (``output_time_major``: [T, batch, beam]), and with
    ``return_length`` each beam's length, the step of its end token
    included."""
    max_step_num = max_step_num or 100
    inputs, states = decoder.initialize(inits)
    step_outputs = []
    lengths = prev_fin = None
    for t in range(int(max_step_num)):
        outputs, states, inputs, finished = decoder.step(t, inputs, states)
        step_outputs.append(outputs)
        fin = finished.cpu().numpy()
        if lengths is None:
            lengths = np.zeros(fin.shape, np.int64)
            prev_fin = np.zeros(fin.shape, bool)
        lengths = np.where(prev_fin, lengths, t + 1)
        prev_fin = fin
        if fin.all():
            break
    final = decoder.finalize(step_outputs, states)
    out = final if output_time_major else final.movedim(0, 1)
    if return_length:
        return out, torch.from_numpy(lengths).to(final.device)
    return out
