"""PACMAN EQA navigation by imitation: the planner / controller of Das et
al. (port of ``habitat_tpu/baselines/il/pacman.py``; reference
habitat-baselines il/trainers/pacman_trainer.py and il/models/models.py:
NavPlannerControllerModel, MaskedNLLCriterion).

A planner GRU picks a macro action from [image feature, question, previous
action]; a controller MLP then decides at each following frame whether to
keep executing it (1) or to hand control back (0). Both are cloned by
masked NLL from expert runs of the batched envs' greedy geodesic follower.

The three token-sequence rules of the port are each the JAX package's own:
the policy keeps its LSTM's output at the last valid token, VQA keeps the
carry across padded tokens, and ``QuestionEncoder`` here returns the
LSTM's output at the last position, padding included.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from habitat_torch.baselines.il.eqa_trainers import adam, lecun_normal_
from habitat_torch.core.registry import registry
from habitat_torch.models.rnn_state_encoder import GRUCell
from habitat_torch.ops.navgrid import greedy_follower_step


class QuestionEncoder(nn.Module):
    """Embedding and an LSTM over all L positions from a zero state;
    returns the output at position L - 1, padded or not
    (QuestionLstmEncoder). The LSTM keeps OptimizedLSTMCell's one bias."""

    def __init__(self, vocab_size: int = 256, wordvec_dim: int = 64, hidden: int = 64):
        super().__init__()
        self.embed = nn.Embedding(vocab_size, wordvec_dim)
        self.lstm = nn.LSTM(wordvec_dim, hidden, batch_first=True)
        nn.init.zeros_(self.lstm.bias_ih_l0)
        self.lstm.bias_ih_l0.requires_grad_(False)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        ys, _ = self.lstm(self.embed(tokens.long()))
        return ys[:, -1]


class PacmanModel(nn.Module):
    """NavPlannerControllerModel: ``forward(questions (B, L), img_feats
    (B, T, F), actions_in (B, T), mask)`` -> (planner logits (B, T, A),
    controller logits (B, T, 2)). The planner is a GRU (Flax's GRUCell)
    over T from a zero state; ``mask`` is taken and not read, as in the
    JAX model."""

    def __init__(self, num_actions: int = 4, feat_dim: int = 64, image_feat_dim: int = 128,
                 action_embed_dim: int = 32, planner_hidden: int = 1024, question_hidden: int = 64,
                 vocab_size: int = 256, controller_fc: int = 256):
        super().__init__()
        self.planner_hidden = planner_hidden
        self.cnn_fc = lecun_normal_(nn.Linear(feat_dim, image_feat_dim))
        self.q_rnn = QuestionEncoder(vocab_size=vocab_size, hidden=question_hidden)
        self.ques_tr = lecun_normal_(nn.Linear(question_hidden, question_hidden))
        self.action_embed = nn.Embedding(num_actions + 1, action_embed_dim)
        self.planner_gru = GRUCell(image_feat_dim + question_hidden + action_embed_dim, planner_hidden)
        self.planner_head = lecun_normal_(nn.Linear(planner_hidden, num_actions))
        self.controller_fc0 = lecun_normal_(nn.Linear(image_feat_dim + action_embed_dim + planner_hidden,
                                                      controller_fc))
        self.controller_head = lecun_normal_(nn.Linear(controller_fc, 2))

    def forward(self, questions, img_feats, actions_in, mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
        B, T, _ = img_feats.shape
        img = F.relu(self.cnn_fc(img_feats))
        q = F.relu(self.ques_tr(self.q_rnn(questions)))
        a_emb = self.action_embed(actions_in.long() + 1)
        x = torch.cat([img, q[:, None].expand(B, T, q.shape[-1]), a_emb], dim=-1)
        h = x.new_zeros(B, self.planner_hidden)
        hs = []
        for t in range(T):
            h = self.planner_gru(x[:, t], h)
            hs.append(h)
        hs = torch.stack(hs, dim=1)  # (B, T, H)
        c = F.relu(self.controller_fc0(torch.cat([img, a_emb, hs], dim=-1)))
        return self.planner_head(hs), self.controller_head(c)


def masked_nll(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """MaskedNLLCriterion: the NLL summed over the mask, over max(Σ mask, 1)."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def build_pacman_supervision(actions, valid, max_controller_actions: int = 5):
    """Expert actions (B, T) and valid (B, T) -> (planner_mask,
    controller_targets, controller_mask), numpy (B, T): within a run of
    the same action the first step is a planner decision and up to
    ``max_controller_actions`` - 1 following steps are controller
    continue = 1 steps; the step after a run ends is controller continue =
    0 with the next planner decision."""
    a = np.asarray(actions)
    v = np.asarray(valid).astype(bool)
    B, T = a.shape
    pm = np.zeros((B, T), np.float32)
    ct = np.zeros((B, T), np.int32)
    cm = np.zeros((B, T), np.float32)
    for b in range(B):
        run = 0
        for t in range(T):
            if not v[b, t]:
                break
            if t == 0 or a[b, t] != a[b, t - 1] or run >= max_controller_actions:
                pm[b, t] = 1.0  # the planner decides here
                if t > 0:
                    ct[b, t] = 0  # the controller handed control back
                    cm[b, t] = 1.0
                run = 1
            else:
                ct[b, t] = 1  # the controller keeps executing
                cm[b, t] = 1.0
                run += 1
    return pm, ct, cm


@registry.register_trainer(name="pacman")
class PacmanTrainer:
    """Clone the planner and controller on expert EQA runs of the batched
    env's greedy geodesic follower toward each episode's goal. The model
    and its Adam are built by ``init_fn``."""

    def __init__(self, env, num_actions: int = 3, feat_dim: int = 64, lr: float = 1e-3, max_T: int = 48,
                 max_controller_actions: int = 5):
        self.env = env
        self.num_actions = num_actions
        self.max_T = max_T
        self.mca = max_controller_actions
        self.feat_dim = feat_dim
        self.lr = lr
        self.model: Optional[PacmanModel] = None
        self.optimizer = None

    def teacher(self, env_state) -> torch.Tensor:
        """(N,) the follower's action (0 stop, 1 fwd, 2 left, 3 right) on
        each env's own episode field, read by episode index."""
        env, ep = self.env, env_state.ep_idx
        return greedy_follower_step(
            env.pack, env.table.scene_idx[ep].long(), env.table.dist_field, ep, env_state.pos, env_state.yaw,
            goal_radius=0.5, forward_step=0.25, turn_angle=float(np.deg2rad(10.0)))

    def collect_expert(self, seed: int = 0):
        """Run the follower in the batched env for up to ``max_T`` steps;
        returns numpy (questions (N, L), feats (N, T, F), actions (N, T),
        valid (N, T)). A feature is the pointgoal and its angle's cos and
        sin, zero-padded to ``feat_dim``. Each step moves the teacher's
        actions, the pointgoal and the dones to the host."""
        env = self.env
        n = env.num_envs
        state, obs = env.reset_fn()
        qs = obs["question"].cpu().numpy()
        feats = np.zeros((n, self.max_T, self.feat_dim), np.float32)
        acts = np.zeros((n, self.max_T), np.int32)
        valid = np.zeros((n, self.max_T), np.float32)
        alive = np.ones((n,), bool)
        for t in range(self.max_T):
            a = self.teacher(state)
            # the follower's 1/2/3 are the EQA env's fwd/left/right; its stop
            # (0) becomes forward too, as in the reference: the EQA nav set
            # has no stop
            a_env = (a - 1).clamp(min=0)
            pg = obs["pointgoal_with_gps_compass"].cpu().numpy()
            feats[:, t, 0:2] = pg
            feats[:, t, 2] = np.cos(pg[:, 1])
            feats[:, t, 3] = np.sin(pg[:, 1])
            acts[:, t] = a_env.cpu().numpy()
            valid[:, t] = alive.astype(np.float32)
            with torch.no_grad():
                state, obs, _, d, _ = env.step_fn(state, a_env)
            alive = alive & ~d.cpu().numpy()
            if not alive.any():
                break
        return qs, feats, acts, valid

    def init_fn(self, seed: int = 0, batch=None) -> PacmanModel:
        """A fresh model from ``torch.manual_seed(seed)`` (the global RNG's
        state is restored after) and its Adam; returns the model."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = PacmanModel(num_actions=self.num_actions, feat_dim=self.feat_dim, image_feat_dim=128,
                                planner_hidden=256)
        self.model = model.to(self.env.device)
        self.optimizer = adam(self.model.parameters(), self.lr)
        return self.model

    def prepare_batch(self, batch):
        """The supervision masks and the shifted action inputs, as device
        tensors: (questions, feats, actions, valid, planner mask,
        controller targets, controller mask, actions in)."""
        qs, feats, acts, valid = batch
        pm, ct, cm = build_pacman_supervision(acts, valid, self.mca)
        a_in = np.concatenate([np.full((acts.shape[0], 1), -1), acts[:, :-1]], axis=1)
        return tuple(torch.as_tensor(np.asarray(x), device=self.env.device)
                     for x in (qs, feats, acts, valid, pm, ct, cm, a_in))

    def train_step(self, prepared) -> Dict[str, torch.Tensor]:
        """One Adam step on planner + controller NLL; returns
        {"planner_nll", "controller_nll", "loss"} as 0-d tensors."""
        qs, feats, acts, valid, pm, ct, cm, a_in = prepared
        pl, cl = self.model(qs, feats, a_in, valid)
        lp = masked_nll(pl, acts, pm * valid)
        lc = masked_nll(cl, ct, cm * valid)
        loss = lp + lc
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return {"planner_nll": lp.detach(), "controller_nll": lc.detach(), "loss": loss.detach()}

    def train(self, num_epochs: int = 20, seed: int = 0) -> Dict[str, float]:
        """Collect one expert batch, then ``num_epochs`` steps on it; the
        last step's metrics as floats."""
        batch = self.collect_expert(seed)
        prepared = self.prepare_batch(batch)
        self.init_fn(seed, batch)
        hist = {}
        for _ in range(num_epochs):
            hist = {k: v.item() for k, v in self.train_step(prepared).items()}
        return hist
