"""Per-node-type temporal LSTM over past gradient features: the optional
`history` branch of the regressor. A 2-layer LSTM (gate order i, f, g, o)
runs over the de-interleaved window of past per-feature gradients, and its
last hidden state is concatenated to the graph encoder's output.

Parameters keep the JAX package's layout: per layer w_ih [in, 4H],
w_hh [H, 4H], b_ih [4H], b_hh [4H]."""

from __future__ import annotations

import math

import torch
from torch import nn

NUM_LAYERS = 2


class LSTMLayer(nn.Module):
    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.w_ih = nn.Parameter(torch.zeros(in_dim, 4 * hidden))
        self.w_hh = nn.Parameter(torch.zeros(hidden, 4 * hidden))
        self.b_ih = nn.Parameter(torch.zeros(4 * hidden))
        self.b_hh = nn.Parameter(torch.zeros(4 * hidden))


class LSTM(nn.Module):
    """x [N, T, D] -> the last step's hidden state of the top layer [N, H]."""

    def __init__(self, input_dim: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.layers = nn.ModuleList(
            [LSTMLayer(input_dim if i == 0 else hidden, hidden)
             for i in range(NUM_LAYERS)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H = self.hidden
        seq = list(x.unbind(1))                     # T tensors [N, D]
        for layer in self.layers:
            h = x.new_zeros((x.shape[0], H))
            c = x.new_zeros((x.shape[0], H))
            out = []
            for x_t in seq:
                gates = (x_t @ layer.w_ih + layer.b_ih
                         + h @ layer.w_hh + layer.b_hh)
                i = torch.sigmoid(gates[:, 0 * H : 1 * H])
                f = torch.sigmoid(gates[:, 1 * H : 2 * H])
                g = torch.tanh(gates[:, 2 * H : 3 * H])
                o = torch.sigmoid(gates[:, 3 * H : 4 * H])
                c = f * c + i * g
                h = o * torch.tanh(c)
                out.append(h)
            seq = out
        return seq[-1]


@torch.no_grad()
def init_lstm(lstm: LSTM, generator: torch.Generator) -> LSTM:
    """torch.nn.LSTM's default init: U(-1/sqrt(H), 1/sqrt(H)) for every
    parameter; in place, returns lstm."""
    bound = 1.0 / math.sqrt(lstm.hidden)
    for layer in lstm.layers:
        for p in (layer.w_ih, layer.w_hh, layer.b_ih, layer.b_hh):
            p.uniform_(-bound, bound, generator=generator)
    return lstm


def history_inputs(x: torch.Tensor, dim: int, seq_len: int) -> torch.Tensor:
    """The trailing seq_len*dim gradient columns of x, de-interleaved into a
    time-major window, oldest first: [N, seq_len, dim]."""
    feats = []
    for i in range(dim):
        cols = x[:, x.shape[1] - seq_len * dim + i :: dim]    # [N, seq_len]
        feats.append(torch.flip(cols, dims=(1,)))
    return torch.stack(feats, dim=2)
