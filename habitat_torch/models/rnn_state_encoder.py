"""Recurrent state encoder: LSTM with episode-boundary masking (port of
``habitat_tpu/models/rnn_state_encoder.py``, single-step act path).

Hidden state layout (N, num_layers, 2, H) with the cell state first, as in
the JAX package. Both states are multiplied by the "not done" mask before
the cell, so a new episode starts from zeros."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn


def initial_hidden_state(batch: int, hidden_size: int, num_layers: int = 1, device=None) -> torch.Tensor:
    return torch.zeros(batch, num_layers, 2, hidden_size, device=device)


class RNNStateEncoder(nn.Module):
    def __init__(self, input_size: int, hidden_size: int = 512, num_layers: int = 1):
        super().__init__()
        self.hidden_size, self.num_layers = hidden_size, num_layers
        self.cells = nn.ModuleList(
            nn.LSTMCell(input_size if l == 0 else hidden_size, hidden_size)
            for l in range(num_layers)
        )

    def forward(
        self, x: torch.Tensor, hidden: torch.Tensor, masks: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (N, D), hidden (N, L, 2, H), masks (N,) — 0 where the previous
        step ended an episode. Returns (out (N, H), new hidden)."""
        m = masks.to(hidden.dtype)[:, None]
        inp = x
        layers = []
        for l, cell in enumerate(self.cells):
            c = hidden[:, l, 0] * m
            h = hidden[:, l, 1] * m
            h, c = cell(inp, (h, c))
            layers.append(torch.stack([c, h], dim=1))
            inp = h
        return inp, torch.stack(layers, dim=1)
