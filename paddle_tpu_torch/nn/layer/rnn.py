"""Recurrent layers (port of ``paddle_tpu/nn/layer/rnn.py``).

The reference runs one ``lax.scan`` over time; the port runs a loop over
the time steps on device tensors, with the reference's step math:

- ``SimpleRNNCell``: ``act(x W_ih^T + b_ih + h W_hh^T + b_hh)``;
- ``LSTMCell``: gates ``x W_ih^T + b_ih + h W_hh^T + b_hh`` split as
  ``i, f, g, o``; ``c' = sigmoid(f) c + sigmoid(i) tanh(g)``,
  ``h' = sigmoid(o) tanh(c')``;
- ``GRUCell``: ``r, z`` from the summed gates, ``c = tanh(x_c + r h_c)``
  with ``h_c`` carrying ``b_hh``, ``h' = (1 - z) c + z h``.

``RNN`` computes the input projection ``x W_ih^T`` of every step as one
matrix product before the loop (each element is the same dot product the
step would take), then adds the biases and the recurrent term in the
reference's order a step at a time. With ``sequence_length`` a step past a
row's length keeps that row's state and outputs zeros; the reverse
direction runs over the flipped sequence, so a row's padding comes first
and leaves its initial state untouched. Parameter names are the
reference's: ``rnns.{i}.cell.*`` one way, ``rnns.{i}.rnn_fw.cell.*`` and
``rnns.{i}.rnn_bw.cell.*`` both ways; ``weight_ih`` ``[G h, in]``,
``weight_hh`` ``[G h, h]``, both biases ``[G h]``, all from
``Uniform(-1 / sqrt(h), 1 / sqrt(h))``.
"""
from __future__ import annotations

import math

import torch

from .. import functional as F
from ..initializer import Uniform
from .container import LayerList
from .layers import Layer

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell",
           "RNN", "BiRNN", "SimpleRNN", "LSTM", "GRU"]


def _simple_step(act):
    def step(xw, h, wh, bi, bh):
        return act(xw + bi + h @ wh.t() + bh)
    return step


def _lstm_step(xw, st, wh, bi, bh):
    h, c = st
    i, f, g, o = (xw + bi + h @ wh.t() + bh).chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def _gru_step(xw, h, wh, bi, bh):
    xr, xz, xc = (xw + bi).chunk(3, dim=-1)
    hr, hz, hc = (h @ wh.t() + bh).chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    c = torch.tanh(xc + r * hc)
    return (1 - z) * c + z * h


class RNNCellBase(Layer):
    def _params(self, input_size, hidden_size, gates, weight_ih_attr,
                weight_hh_attr, bias_ih_attr, bias_hh_attr):
        std = 1.0 / math.sqrt(hidden_size)
        init = Uniform(-std, std)
        self.weight_ih = self.create_parameter(
            [gates * hidden_size, input_size], weight_ih_attr,
            default_initializer=init)
        self.weight_hh = self.create_parameter(
            [gates * hidden_size, hidden_size], weight_hh_attr,
            default_initializer=init)
        self.bias_ih = self.create_parameter(
            [gates * hidden_size], bias_ih_attr, is_bias=True,
            default_initializer=init)
        self.bias_hh = self.create_parameter(
            [gates * hidden_size], bias_hh_attr, is_bias=True,
            default_initializer=init)
        self.input_size = input_size
        self.hidden_size = hidden_size

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """States of ``init_value`` for ``batch_ref``'s batch: a tuple
        for a cell of several states (LSTM), else one tensor."""
        batch = batch_ref.shape[batch_dim_idx]
        dt = dtype or batch_ref.dtype

        def full(s):
            return torch.full([batch] + list(s), init_value, dtype=dt,
                              device=batch_ref.device)
        shape = self.state_shape
        if isinstance(shape[0], (tuple, list)):
            return tuple(full(s) for s in shape)
        return full(shape)

    def _weights(self):
        return self.weight_hh, self.bias_ih, self.bias_hh


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        self._params(input_size, hidden_size, 1, weight_ih_attr,
                     weight_hh_attr, bias_ih_attr, bias_hh_attr)
        self.activation = activation
        self._step = _simple_step(torch.tanh if activation == "tanh"
                                  else torch.relu)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h = self._step(inputs @ self.weight_ih.t(), states, *self._weights())
        return h, h


class LSTMCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 proj_size=0, name=None):
        super().__init__()
        self._params(input_size, hidden_size, 4, weight_ih_attr,
                     weight_hh_attr, bias_ih_attr, bias_hh_attr)
        self._step = _lstm_step

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h, c = self._step(inputs @ self.weight_ih.t(), tuple(states),
                          *self._weights())
        return h, (h, c)


class GRUCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self._params(input_size, hidden_size, 3, weight_ih_attr,
                     weight_hh_attr, bias_ih_attr, bias_hh_attr)
        self._step = _gru_step

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h = self._step(inputs @ self.weight_ih.t(), states, *self._weights())
        return h, h


class RNN(Layer):
    """A cell run over the time axis (``[B, T, I]``, or ``[T, B, I]`` with
    ``time_major``); returns ``(outputs, final states)``."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        cell = self.cell
        is_lstm = isinstance(cell, LSTMCell)
        xs = inputs if self.time_major else inputs.transpose(0, 1)
        T, B = xs.shape[0], xs.shape[1]
        if initial_states is None:
            z = xs.new_zeros(B, cell.hidden_size)
            initial_states = (z, z) if is_lstm else z
        st = tuple(initial_states) if is_lstm else initial_states
        if self.is_reverse:
            xs = xs.flip(0)
        xw = xs @ cell.weight_ih.t()                          # [T, B, G h]
        weights = cell._weights()
        lens = (None if sequence_length is None else torch.as_tensor(
            sequence_length, device=xs.device).reshape(-1, 1))
        outs = []
        for t in range(T):
            new = cell._step(xw[t], st, *weights)
            out = new[0] if is_lstm else new
            if lens is not None:
                keep = ((T - 1 - t) if self.is_reverse else t) < lens
                if is_lstm:
                    new = (torch.where(keep, new[0], st[0]),
                           torch.where(keep, new[1], st[1]))
                else:
                    new = torch.where(keep, new, st)
                out = torch.where(keep, out, torch.zeros_like(out))
            st = new
            outs.append(out)
        ys = (torch.stack(outs) if outs
              else xs.new_zeros(0, B, cell.hidden_size))
        if self.is_reverse:
            ys = ys.flip(0)
        if not self.time_major:
            ys = ys.transpose(0, 1)
        return ys, st


class BiRNN(Layer):
    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        if initial_states is None:
            states_fw = states_bw = None
        else:
            states_fw, states_bw = initial_states
        out_fw, st_fw = self.rnn_fw(inputs, states_fw, sequence_length)
        out_bw, st_bw = self.rnn_bw(inputs, states_bw, sequence_length)
        return torch.cat([out_fw, out_bw], dim=-1), (st_fw, st_bw)


class _RNNBase(Layer):
    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None):
        super().__init__()
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.direction = direction
        self.time_major = time_major
        self.dropout = dropout
        bidirect = 2 if direction in ("bidirect", "bidirectional") else 1
        self.num_directions = bidirect

        def make_cell(in_sz):
            kw = dict(weight_ih_attr=weight_ih_attr,
                      weight_hh_attr=weight_hh_attr,
                      bias_ih_attr=bias_ih_attr, bias_hh_attr=bias_hh_attr)
            if mode == "LSTM":
                return LSTMCell(in_sz, hidden_size, **kw)
            if mode == "GRU":
                return GRUCell(in_sz, hidden_size, **kw)
            act = "tanh" if mode == "RNN_TANH" else "relu"
            return SimpleRNNCell(in_sz, hidden_size, activation=act, **kw)

        self.rnns = LayerList()
        for layer in range(num_layers):
            in_sz = input_size if layer == 0 else hidden_size * bidirect
            if bidirect == 2:
                self.rnns.append(BiRNN(make_cell(in_sz), make_cell(in_sz),
                                       time_major))
            else:
                self.rnns.append(RNN(make_cell(in_sz),
                                     time_major=time_major))

    def forward(self, inputs, initial_states=None, sequence_length=None):
        """``initial_states``: ``[L * D, B, H]`` (LSTM: a pair); returns
        ``(outputs, final states)`` of the same layout."""
        is_lstm = self.mode == "LSTM"
        D, L = self.num_directions, self.num_layers
        per_layer = [None] * L
        if initial_states is not None:
            if is_lstm:
                h0, c0 = initial_states
                pairs = list(zip(h0.unbind(0), c0.unbind(0)))
            else:
                pairs = list(initial_states.unbind(0))
            for l in range(L):
                per_layer[l] = ((pairs[2 * l], pairs[2 * l + 1]) if D == 2
                                else pairs[l])
        out = inputs
        finals = []
        for l, rnn in enumerate(self.rnns):
            out, st = rnn(out, per_layer[l], sequence_length)
            finals.append(st)
            if self.dropout > 0 and l < L - 1:
                out = F.dropout(out, self.dropout, training=self.training)
        flat = [s[d] for s in finals for d in range(2)] if D == 2 else finals
        if is_lstm:
            return out, (torch.stack([s[0] for s in flat]),
                         torch.stack([s[1] for s in flat]))
        return out, torch.stack(flat)


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        mode = "RNN_TANH" if activation == "tanh" else "RNN_RELU"
        super().__init__(mode, input_size, hidden_size, num_layers,
                         direction, time_major, dropout, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, proj_size=0,
                 name=None):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)
