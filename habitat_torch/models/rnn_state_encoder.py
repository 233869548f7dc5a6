"""Recurrent state encoder: LSTM with episode-boundary masking (port of
``habitat_tpu/models/rnn_state_encoder.py``).

Hidden state layout (N, num_layers, 2, H) with the cell state first, as in
the JAX package. Both states are multiplied by the "not done" mask before
the cell, so a new episode starts from zeros. The single-step act path takes
x (N, D) and masks (N,); the update's sequence mode takes x (T, N, D) and
masks (T, N) and loops over T with the same mask-gated reset at each step."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from habitat_torch.device import resolve_device


def initial_hidden_state(batch: int, hidden_size: int, num_layers: int = 1, device=None) -> torch.Tensor:
    """Zero hidden state (N, L, 2, H) on ``device`` (``None`` = cuda)."""
    return torch.zeros(batch, num_layers, 2, hidden_size, device=resolve_device(device))


class RNNStateEncoder(nn.Module):
    def __init__(self, input_size: int, hidden_size: int = 512, num_layers: int = 1):
        super().__init__()
        self.hidden_size, self.num_layers = hidden_size, num_layers
        self.cells = nn.ModuleList(
            nn.LSTMCell(input_size if l == 0 else hidden_size, hidden_size)
            for l in range(num_layers)
        )
        # Flax's OptimizedLSTMCell has one bias, on the recurrent kernels
        # (bias_hh); bias_ih stays zero and untrained, so an update moves the
        # same parameters as the JAX package's
        for cell in self.cells:
            nn.init.zeros_(cell.bias_ih)
            cell.bias_ih.requires_grad_(False)

    def _step(self, x: torch.Tensor, hidden: torch.Tensor, masks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
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

    def forward(
        self, x: torch.Tensor, hidden: torch.Tensor, masks: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (N, D) or (T, N, D), hidden (N, L, 2, H), masks (N,) or (T, N)
        — 0 where the previous step ended an episode. Returns (out (N, H) or
        (T, N, H), the final hidden state)."""
        if x.dim() == 2:
            return self._step(x, hidden, masks)
        outs = []
        for t in range(x.shape[0]):
            out, hidden = self._step(x[t], hidden, masks[t])
            outs.append(out)
        return torch.stack(outs), hidden
