"""Auxiliary losses: CPC|A, action-conditional contrastive predictive coding
(port of ``habitat_tpu/baselines/aux_losses.py``; reference
rl/ppo/cpc_aux_loss.py).

From each step's belief (the RNN output) a GRU rolls forward, conditioned
on the actions taken, and a classifier tells the true future visual
embedding from a time-shuffled negative, k = 1..K steps ahead; episode
boundaries mask the targets. The parameters live beside the policy's: the
learner adds ``aux_loss_coef`` times the loss inside its update and trains
them with the same optimizer (their own parameter group).

The loss is a ratio of two sums over (t, env): ``forward`` returns both, so
a DD-PPO rank can all-reduce numerator and denominator separately. The
negatives' time permutation ``perm`` comes from the caller (the learner
draws it from the replicated generator).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from habitat_torch.core.registry import registry
from habitat_torch.models.rnn_state_encoder import GRUCell


def _dense(cin: int, cout: int) -> nn.Linear:
    """Flax's Dense init: lecun-normal kernel, zero bias."""
    lin = nn.Linear(cin, cout)
    std = (1.0 / cin) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(lin.weight, 0.0, std, -2 * std, 2 * std)
    nn.init.zeros_(lin.bias)
    return lin


@registry.register_auxiliary_loss(name="cpca")
class CPCA(nn.Module):
    """k-step action-conditional CPC over beliefs (T, N, ``belief_size``)
    and visual embeddings (T, N, ``visual_size``). Flax infers the input
    widths at init; a torch module declares them."""

    def __init__(self, belief_size: int, visual_size: int, num_steps: int = 4, action_embed: int = 32,
                 hidden: int = 128, num_actions: int = 4, loss_scale: float = 0.1):
        super().__init__()
        self.num_steps, self.hidden, self.loss_scale = num_steps, hidden, loss_scale
        self.action_embed = nn.Embedding(num_actions + 1, action_embed)
        nn.init.normal_(self.action_embed.weight, std=1.0 / action_embed ** 0.5)  # Flax's Embed: variance 1/features
        self.gru = GRUCell(action_embed, hidden)
        self.proj_in = _dense(belief_size, hidden)
        self.target_proj = _dense(visual_size, hidden)
        self.cls = _dense(hidden, 1)

    def forward(
        self, beliefs: torch.Tensor, visual_feats: torch.Tensor, actions: torch.Tensor, masks: torch.Tensor,
        perm: torch.Tensor,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """beliefs (T, N, H), visual_feats (T, N, F) (targets, detached
        here), actions (T, N) int, masks (T, N) (1 = the episode continues
        into this step), perm (T,) the negatives' time order. Returns
        (loss_scale * the masked sum of the binary NCE terms, the number of
        valid terms): the loss is their ratio, the denominator at least 1."""
        T, N, _ = beliefs.shape
        a_emb = self.action_embed(actions.long())
        tgt = self.target_proj(visual_feats.detach())
        neg = tgt[perm]
        total = beliefs.new_zeros((), dtype=torch.float32)
        h = self.proj_in(beliefs)
        h_step = None
        for k, valid in enumerate(self._valid_chain(masks), start=1):
            # k = 1 starts from the belief; k > 1 continues the last state
            h_prev = h[:T - k] if k == 1 else h_step[:-1]
            h_step = self.gru(a_emb[k - 1:T - 1], h_prev)
            pos = self.cls(h_step * tgt[k:])[..., 0]
            neg_logit = self.cls(h_step * neg[k:])[..., 0]
            loss_k = -F.logsigmoid(pos) - F.logsigmoid(-neg_logit)
            total = total + (loss_k * valid).sum()
        return self.loss_scale * total, self.count(masks)

    def _valid_chain(self, masks: torch.Tensor):
        """For k = 1..K the (T-k, N) validity of predicting k steps ahead:
        the chain of not-done from t+1 to t+k."""
        valid = torch.ones_like(masks, dtype=torch.float32)
        for k in range(1, self.num_steps + 1):
            valid = valid[:masks.shape[0] - k] * masks[k:]
            yield valid

    def count(self, masks: torch.Tensor) -> torch.Tensor:
        """The loss's denominator (valid terms) from the masks alone."""
        return sum(v.sum() for v in self._valid_chain(masks))
