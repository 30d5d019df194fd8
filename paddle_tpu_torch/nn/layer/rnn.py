"""Recurrent layers (counterpart of ``paddle_tpu/nn/layer/rnn.py``).

The cells (``SimpleRNNCell``, ``LSTMCell``, ``GRUCell``) keep the
reference's parameters and layouts: ``weight_ih`` ``[G * H, in]``,
``weight_hh`` ``[G * H, H]`` and their biases, the LSTM's gates in the order
i, f, g, o and the GRU's r, z, n with ``bias_hh`` inside the reset product.
``RNN`` and ``BiRNN`` run a cell over time, one step at a time.
``SimpleRNN``, ``LSTM`` and ``GRU`` hold those cells in the reference's
tree (``layer_list.<i>.cell`` or ``layer_list.<i>.rnn_fw.cell`` /
``rnn_bw.cell``), so a reference ``state_dict`` loads by name, and run the
whole stack as one call of PyTorch's multi-layer recurrent op
(``torch._VF.lstm``, ``gru``, ``rnn_tanh``, ``rnn_relu``): cuDNN's RNN on
the card, PyTorch's own kernels on the CPU. On the card the cells' weights
are views of one buffer in cuDNN's layout, as
``torch.nn.LSTM.flatten_parameters`` makes them, so cuDNN reads them in
place rather than compacting a copy at every call; they are flattened
again when one was rebound (``decorate``, ``to``). No Pallas kernel lies
under the reference's loop, so no kernel of this port does either.

Where the reference drops an argument, this port raises: the multi-layer
nets' ``initial_states`` and ``sequence_length`` and ``RNN``'s and
``BiRNN``'s ``sequence_length`` raise ``NotImplementedError`` at a value
other than None (ROADMAP §C). The reference's ``SimpleRNN`` passes the
weight attributes where its cell takes ``activation``: with
``activation="relu"`` it raises ``TypeError``, and with "tanh" its cells
get None and run relu. This one passes them by name and runs the
activation asked for.
"""
from __future__ import annotations

import math

import torch

from ...core.dispatch import apply_op
from ..initializer import Uniform
from .container import LayerList
from .layers import Layer


def _no_seq_len(name, sequence_length):
    if sequence_length is not None:
        raise NotImplementedError(
            f"{name}(sequence_length=...): the reference ignores the "
            f"argument; pass None and mask the padded steps yourself")


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        from ... import ops

        b = batch_ref.shape[batch_dim_idx]
        shape = shape or self.state_shape
        if isinstance(shape[0], (list, tuple)):
            return tuple(ops.full([b] + list(s), init_value,
                                  dtype or "float32") for s in shape)
        return ops.full([b] + list(shape), init_value, dtype or "float32")

    def _init_weights(self, gates, input_size, hidden_size, attrs):
        wi, wh, bi, bh = attrs
        std = 1.0 / math.sqrt(hidden_size)
        init = Uniform(-std, std)
        g = gates * hidden_size
        self.weight_ih = self.create_parameter(
            [g, input_size], wi, default_initializer=init)
        self.weight_hh = self.create_parameter(
            [g, hidden_size], wh, default_initializer=init)
        self.bias_ih = self.create_parameter(
            [g], bi, is_bias=True, default_initializer=init)
        self.bias_hh = self.create_parameter(
            [g], bh, is_bias=True, default_initializer=init)
        self.hidden_size = hidden_size
        self.input_size = input_size


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        self._init_weights(1, input_size, hidden_size,
                           (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                            bias_hh_attr))
        self.activation = activation

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        act = torch.tanh if self.activation == "tanh" else torch.relu

        def _cell(x, h, wi, wh, bi, bh):
            return act(x @ wi.t() + bi + h @ wh.t() + bh)

        h = apply_op(_cell, inputs, states, self.weight_ih, self.weight_hh,
                     self.bias_ih, self.bias_hh, _op_name="simple_rnn_cell")
        return h, h


class LSTMCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 proj_size=None, name=None):
        super().__init__()
        self._init_weights(4, input_size, hidden_size,
                           (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                            bias_hh_attr))

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs, self.state_shape)
        h, c = states

        def _cell(x, h, c, wi, wh, bi, bh):
            gates = x @ wi.t() + bi + h @ wh.t() + bh
            i, f, g, o = gates.chunk(4, dim=-1)
            i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
            new_c = f * c + i * torch.tanh(g)
            return o * torch.tanh(new_c), new_c

        new_h, new_c = apply_op(
            _cell, inputs, h, c, self.weight_ih, self.weight_hh,
            self.bias_ih, self.bias_hh, _op_name="lstm_cell")
        return new_h, (new_h, new_c)


class GRUCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self._init_weights(3, input_size, hidden_size,
                           (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                            bias_hh_attr))

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)

        def _cell(x, h, wi, wh, bi, bh):
            i_r, i_z, i_n = (x @ wi.t() + bi).chunk(3, dim=-1)
            h_r, h_z, h_n = (h @ wh.t() + bh).chunk(3, dim=-1)
            r = torch.sigmoid(i_r + h_r)
            z = torch.sigmoid(i_z + h_z)
            n = torch.tanh(i_n + r * h_n)
            return (1 - z) * n + z * h

        new_h = apply_op(_cell, inputs, states, self.weight_ih,
                         self.weight_hh, self.bias_ih, self.bias_hh,
                         _op_name="gru_cell")
        return new_h, new_h


class RNN(Layer):
    """Runs ``cell`` over the time axis, one step at a time."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        from ... import ops

        _no_seq_len("RNN", sequence_length)
        time_axis = 0 if self.time_major else 1
        xs = ops.unbind(inputs, axis=time_axis)
        if self.is_reverse:
            xs = xs[::-1]
        states = initial_states
        outs = []
        for x in xs:
            out, states = self.cell(x, states)
            outs.append(out)
        if self.is_reverse:
            outs = outs[::-1]
        return ops.stack(outs, axis=time_axis), states


class BiRNN(Layer):
    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        from ... import ops

        _no_seq_len("BiRNN", sequence_length)
        s_fw, s_bw = (initial_states if initial_states is not None
                      else (None, None))
        out_fw, st_fw = self.rnn_fw(inputs, s_fw)
        out_bw, st_bw = self.rnn_bw(inputs, s_bw)
        return ops.concat([out_fw, out_bw], axis=-1), (st_fw, st_bw)


_CELLS = {"LSTM": LSTMCell, "GRU": GRUCell, "RNN_TANH": SimpleRNNCell,
          "RNN_RELU": SimpleRNNCell}
_VF_OPS = {"LSTM": "lstm", "GRU": "gru", "RNN_TANH": "rnn_tanh",
           "RNN_RELU": "rnn_relu"}


class _RNNBase(Layer):
    """A multi-layer, optionally bidirectional recurrent net: the
    reference's tree of cells, run as one multi-layer recurrent op."""

    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.bidirect = direction in ("bidirect", "bidirectional")
        num_dir = 2 if self.bidirect else 1
        kwargs = dict(weight_ih_attr=weight_ih_attr,
                      weight_hh_attr=weight_hh_attr,
                      bias_ih_attr=bias_ih_attr, bias_hh_attr=bias_hh_attr)
        if mode == "RNN_RELU":
            kwargs["activation"] = "relu"
        layers = []
        for layer in range(num_layers):
            in_sz = input_size if layer == 0 else hidden_size * num_dir
            fw = _CELLS[mode](in_sz, hidden_size, **kwargs)
            if self.bidirect:
                bw = _CELLS[mode](in_sz, hidden_size, **kwargs)
                layers.append(BiRNN(fw, bw, time_major))
            else:
                layers.append(RNN(fw, False, time_major))
        self.layer_list = LayerList(layers)
        self._flat_ptrs = None

    def _cells(self):
        for rnn in self.layer_list:
            if self.bidirect:
                yield rnn.rnn_fw.cell
                yield rnn.rnn_bw.cell
            else:
                yield rnn.cell

    def _flatten(self, weights):
        """Make the card's ``weights`` views of one cuDNN buffer, unless
        they still are since the last call."""
        ptrs = tuple((w.data_ptr(), w.dtype) for w in weights)
        if ptrs == self._flat_ptrs:
            return
        first = weights[0]
        if not (first.is_cuda and torch.backends.cudnn.is_acceptable(first)
                and all(w.is_cuda and w.dtype == first.dtype
                        for w in weights)):
            return
        from torch.backends.cudnn import rnn as cudnn_rnn

        with torch.no_grad():
            torch._cudnn_rnn_flatten_weight(
                weights, 4, self.input_size,
                cudnn_rnn.get_cudnn_mode(self.mode), self.hidden_size, 0,
                self.num_layers, not self.time_major, self.bidirect)
        self._flat_ptrs = tuple((w.data_ptr(), w.dtype) for w in weights)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        if initial_states is not None:
            raise NotImplementedError(
                f"{type(self).__name__}(initial_states=...): the reference "
                f"ignores the argument and starts every layer from zeros")
        _no_seq_len(type(self).__name__, sequence_length)
        weights = [p for cell in self._cells() for p in (
            cell.weight_ih, cell.weight_hh, cell.bias_ih, cell.bias_hh)]
        self._flatten([w._data for w in weights])
        op = getattr(torch._VF, _VF_OPS[self.mode])
        lstm = self.mode == "LSTM"
        shape = (self.num_layers * (2 if self.bidirect else 1),
                 inputs.shape[1 if self.time_major else 0], self.hidden_size)

        def _run(x, *params):
            h0 = x.new_zeros(shape)
            out = op(x, (h0, h0) if lstm else h0, list(params), True,
                     self.num_layers, float(self.dropout), self.training,
                     self.bidirect, not self.time_major)
            return out if lstm else tuple(out)

        if lstm:
            out, h, c = apply_op(_run, inputs, *weights,
                                 _op_name=_VF_OPS[self.mode])
            return out, (h, c)
        out, h = apply_op(_run, inputs, *weights,
                          _op_name=_VF_OPS[self.mode])
        return out, h


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kw):
        mode = "RNN_TANH" if activation == "tanh" else "RNN_RELU"
        super().__init__(mode, input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)
