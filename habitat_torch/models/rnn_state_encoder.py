"""Recurrent state encoder: LSTM or GRU with episode-boundary masking (port
of ``habitat_tpu/models/rnn_state_encoder.py``).

Hidden state layout (N, num_layers, S, H): S = 2 for the LSTM (the cell
state first) and 1 for the GRU, as in the JAX package. The states are
multiplied by the "not done" mask before the cell, so a new episode starts
from zeros. The single-step act path takes x (N, D) and masks (N,); the
update's sequence mode takes x (T, N, D) and masks (T, N) and loops over T
with the same mask-gated reset at each step."""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from habitat_torch.device import resolve_device

RNN_TYPES = ("LSTM", "GRU")


def initial_hidden_state(
    batch: int, hidden_size: int, num_layers: int = 1, device=None, rnn_type: str = "LSTM"
) -> torch.Tensor:
    """Zero hidden state (N, L, S, H) on ``device`` (``None`` = cuda)."""
    s = 2 if rnn_type.upper() == "LSTM" else 1
    return torch.zeros(batch, num_layers, s, hidden_size, device=resolve_device(device))


class GRUCell(nn.Module):
    """Flax ``nn.GRUCell``: biases on the input kernels ir, iz, in and on
    the recurrent hn only (``torch.nn.GRUCell`` carries six, and a
    redundant trained bias would move twice as fast under Adam).

        r = sigmoid(x W_ir + b_ir + h W_hr)
        z = sigmoid(x W_iz + b_iz + h W_hz)
        n = tanh(x W_in + b_in + r * (h W_hn + b_hn))
        h' = (1 - z) * n + z * h

    ``weight_i`` (3H, D) and ``weight_h`` (3H, H) hold the r, z, n rows
    in that order, ``bias_i`` (3H,) likewise; ``bias_hn`` (H,). Init as
    Flax's: lecun-normal input kernels, orthogonal recurrent ones, zero
    biases."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.weight_i = nn.Parameter(torch.empty(3 * hidden_size, input_size))
        self.weight_h = nn.Parameter(torch.empty(3 * hidden_size, hidden_size))
        self.bias_i = nn.Parameter(torch.zeros(3 * hidden_size))
        self.bias_hn = nn.Parameter(torch.zeros(hidden_size))
        std = math.sqrt(1.0 / input_size) / 0.87962566103423978
        for w in self.weight_i.chunk(3):
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std)
        for w in self.weight_h.chunk(3):
            nn.init.orthogonal_(w)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        gi = x @ self.weight_i.t() + self.bias_i
        gh = h @ self.weight_h.t()
        H = self.hidden_size
        r = torch.sigmoid(gi[..., :H] + gh[..., :H])
        z = torch.sigmoid(gi[..., H:2 * H] + gh[..., H:2 * H])
        n = torch.tanh(gi[..., 2 * H:] + r * (gh[..., 2 * H:] + self.bias_hn))
        return (1.0 - z) * n + z * h


class RNNStateEncoder(nn.Module):
    def __init__(self, input_size: int, hidden_size: int = 512, num_layers: int = 1, rnn_type: str = "LSTM"):
        super().__init__()
        rnn_type = rnn_type.upper()
        if rnn_type not in RNN_TYPES:
            raise ValueError(f"rnn_type {rnn_type!r}: {RNN_TYPES}")
        self.hidden_size, self.num_layers, self.rnn_type = hidden_size, num_layers, rnn_type
        cell = nn.LSTMCell if rnn_type == "LSTM" else GRUCell
        self.cells = nn.ModuleList(
            cell(input_size if l == 0 else hidden_size, hidden_size) for l in range(num_layers)
        )
        if rnn_type == "LSTM":
            # Flax's OptimizedLSTMCell has one bias, on the recurrent kernels
            # (bias_hh); bias_ih stays zero and untrained, so an update moves
            # the same parameters as the JAX package's
            for c in self.cells:
                nn.init.zeros_(c.bias_ih)
                c.bias_ih.requires_grad_(False)

    def _step(self, x: torch.Tensor, hidden: torch.Tensor, masks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        m = masks.to(hidden.dtype)[:, None]
        inp = x
        layers = []
        for l, cell in enumerate(self.cells):
            if self.rnn_type == "LSTM":
                c = hidden[:, l, 0] * m
                h = hidden[:, l, 1] * m
                h, c = cell(inp, (h, c))
                layers.append(torch.stack([c, h], dim=1))
            else:
                h = cell(inp, hidden[:, l, 0] * m)
                layers.append(h[:, None])
            inp = h
        return inp, torch.stack(layers, dim=1)

    def forward(
        self, x: torch.Tensor, hidden: torch.Tensor, masks: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (N, D) or (T, N, D), hidden (N, L, S, H), masks (N,) or (T, N)
        — 0 where the previous step ended an episode. Returns (out (N, H) or
        (T, N, H), the final hidden state)."""
        if x.dim() == 2:
            return self._step(x, hidden, masks)
        outs = []
        for t in range(x.shape[0]):
            out, hidden = self._step(x[t], hidden, masks[t])
            outs.append(out)
        return torch.stack(outs), hidden
