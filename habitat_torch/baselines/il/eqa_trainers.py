"""EQA imitation trainers: CNN pretraining and VQA (port of
``habitat_tpu/baselines/il/eqa_trainers.py``; reference habitat-baselines
il/trainers/eqa_cnn_pretrain_trainer.py, vqa_trainer.py and il/models/
models.py: MultitaskCNN, VqaLstmCnnAttentionModel).

The frames come straight from the batched env's renders, not from a disk
dataset of pre-rendered frames.

``MultitaskCNN`` mirrors the Flax module's arithmetic: the input is rounded
to bfloat16 and the convolutions run in float32 (Flax promotes the bf16
input against float32 parameters); "SAME" padding of the stride-2 5x5
convolutions is asymmetric (1 before and 2 after on an even side), padded
explicitly; GroupNorm's epsilon is Flax's 1e-6; the decoders' nearest x2
resize is a repeat. Images enter and leave channels-last, (N, H, W, C), as
in the JAX package, and the encoder's flat embedding is in its (H, W, C)
order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from habitat_torch.core.registry import registry

ENC_CHANNELS = (8, 16, 32, 32)
DEC_CHANNELS = (32, 16, 8)
GN_EPS = 1e-6  # flax.linen.GroupNorm's


def same_pad(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of Flax / XLA "SAME" along one side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def lecun_normal_(module: nn.Module) -> nn.Module:
    """Flax's default Dense / Conv initialisation: truncated-normal kernels
    of variance 1 / fan_in, zero biases."""
    w = module.weight
    fan_in = w.shape[1] * math.prod(w.shape[2:])
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std)
    if module.bias is not None:
        nn.init.zeros_(module.bias)
    return module


class SameConv(nn.Conv2d):
    """A 5x5 convolution with Flax's "SAME" padding at ``stride``."""

    def __init__(self, cin: int, cout: int, stride: int = 1, kernel: int = 5):
        super().__init__(cin, cout, kernel, stride=stride)
        lecun_normal_(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (t, b), (l, r) = (same_pad(x.shape[-2], self.kernel_size[0], self.stride[0]),
                          same_pad(x.shape[-1], self.kernel_size[1], self.stride[1]))
        return super().forward(F.pad(x, (l, r, t, b)))


def _gn(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(4, channels, eps=GN_EPS)


def encoder_hw(h: int, w: int) -> Tuple[int, int]:
    """The embedding's spatial size: four halvings, rounded up."""
    for _ in ENC_CHANNELS:
        h, w = -(-h // 2), -(-w // 2)
    return h, w


class MultitaskCNN(nn.Module):
    """Encoder (four 5x5 stride-2 convolutions, 8/16/32/32 channels, each
    with GroupNorm(4) and ReLU) and three decoders (rgb, depth, seg: nearest
    x2, 5x5 conv, GroupNorm, ReLU, three times; then x2 and the 5x5 output
    conv). ``forward(rgb)`` takes (N, H, W, 3) in [0, 1] and returns the
    sigmoid rgb (N, H, W, 3), the sigmoid depth (N, H, W, 1) and the seg
    logits (N, H, W, num_classes); with ``only_encoder`` it returns the
    flat (N, H/16 * W/16 * 32) embedding and holds no decoder."""

    HEADS = ("rgb", "depth", "seg")

    def __init__(self, num_classes: int = 41, only_encoder: bool = False):
        super().__init__()
        self.num_classes, self.only_encoder = num_classes, only_encoder
        cins = (3,) + ENC_CHANNELS[:-1]
        self.enc = nn.ModuleList(SameConv(ci, co, stride=2) for ci, co in zip(cins, ENC_CHANNELS))
        self.enc_gn = nn.ModuleList(_gn(c) for c in ENC_CHANNELS)
        if only_encoder:
            return
        outs = {"rgb": 3, "depth": 1, "seg": num_classes}
        dins = (ENC_CHANNELS[-1],) + DEC_CHANNELS[:-1]
        self.dec = nn.ModuleDict({k: nn.ModuleList(SameConv(ci, co) for ci, co in zip(dins, DEC_CHANNELS))
                                  for k in self.HEADS})
        self.dec_gn = nn.ModuleDict({k: nn.ModuleList(_gn(c) for c in DEC_CHANNELS) for k in self.HEADS})
        self.out = nn.ModuleDict({k: SameConv(DEC_CHANNELS[-1], outs[k]) for k in self.HEADS})

    def encode(self, rgb: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) -> the (N, 32, H/16, W/16) embedding."""
        x = rgb.to(torch.bfloat16).float().permute(0, 3, 1, 2)
        for conv, gn in zip(self.enc, self.enc_gn):
            x = F.relu(gn(conv(x)))
        return x

    def _decode(self, head: str, feat: torch.Tensor) -> torch.Tensor:
        y = feat
        for conv, gn in zip(self.dec[head], self.dec_gn[head]):
            y = F.relu(gn(conv(y.repeat_interleave(2, -2).repeat_interleave(2, -1))))
        y = self.out[head](y.repeat_interleave(2, -2).repeat_interleave(2, -1))
        return y.permute(0, 2, 3, 1)

    def forward(self, rgb: torch.Tensor):
        feat = self.encode(rgb)
        if self.only_encoder:
            return feat.permute(0, 2, 3, 1).reshape(rgb.shape[0], -1)
        return (torch.sigmoid(self._decode("rgb", feat)), torch.sigmoid(self._decode("depth", feat)),
                self._decode("seg", feat))


def adam(params, lr: float) -> torch.optim.Adam:
    """optax.adam(lr): betas (0.9, 0.999), eps 1e-8 outside the root."""
    return torch.optim.Adam(params, lr=lr, eps=1e-8)


@dataclasses.dataclass
class EQACNNPretrainState:
    env_state: Any
    update_idx: int = 0


@registry.register_trainer(name="eqa-cnn-pretrain")
class EQACNNPretrainLearner:
    """Autoencoder pretraining of the EQA encoder on frames the batched env
    renders: each step random-walks the envs (actions uniform in {1, 2, 3}
    of a nav env whose action 0 is stop, from ``generator``) and takes one
    Adam step on MSE(rgb) + MSE(depth) + CE(semantic % num_classes). The
    frames are those of the env step (one render per update)."""

    def __init__(self, env, num_classes: int = 41, lr: float = 1e-3):
        self.env = env
        self.num_classes = num_classes
        self.model = MultitaskCNN(num_classes=num_classes).to(env.device)
        self.optimizer = adam(self.model.parameters(), lr)
        self.generator = torch.Generator(device=env.device)

    def frames(self, obs: Dict[str, torch.Tensor]):
        """(rgb in [0, 1], depth, semantic class ids) of an observation."""
        rgb = obs["rgb"].float() / 255.0
        depth = obs["depth"].float()
        sem = obs["semantic"][..., 0].long() % self.num_classes
        return rgb, depth, sem

    def init(self, seed: int = 0) -> EQACNNPretrainState:
        """Reset the envs and seed the walk's generator."""
        self.generator.manual_seed(seed)
        env_state, _ = self.env.reset_fn()
        return EQACNNPretrainState(env_state)

    def update(self, rgb: torch.Tensor, depth: torch.Tensor, sem: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One Adam step on MSE(rgb) + MSE(depth) + CE(sem) of the model's
        reconstructions; the losses as 0-d tensors."""
        rgb_hat, depth_hat, seg = self.model(rgb)
        l_rgb = (rgb_hat - rgb).square().mean()
        l_depth = (depth_hat - depth).square().mean()
        l_seg = F.cross_entropy(seg.reshape(-1, self.num_classes), sem.reshape(-1))
        loss = l_rgb + l_depth + l_seg
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        metrics = {"losses/total": loss, "losses/rgb": l_rgb, "losses/depth": l_depth, "losses/seg": l_seg}
        return {k: v.detach() for k, v in metrics.items()}

    def train_step(self, st: EQACNNPretrainState, actions: Optional[torch.Tensor] = None):
        """One walk step (``actions``, or drawn) and ``update`` on its
        frames. Returns (state, {"losses/total", "losses/rgb",
        "losses/depth", "losses/seg"})."""
        if actions is None:
            actions = torch.randint(1, 4, (self.env.num_envs,), generator=self.generator, device=self.env.device)
        with torch.no_grad():
            env_state, obs, *_ = self.env.step_fn(st.env_state, actions)
        return EQACNNPretrainState(env_state, st.update_idx + 1), self.update(*self.frames(obs))


class VqaModel(nn.Module):
    """Question LSTM and question-conditioned attention over the frames'
    encodings -> answer logits (VqaLstmCnnAttentionModel).

    frames (N, K, H, W, 3) in [0, 1] go through ``MultitaskCNN``'s encoder,
    ``frame_proj`` and tanh; the question (N, L) through ``q_embed`` and an
    LSTM-``q_hidden`` (``q_lstm``, the one bias of Flax's
    OptimizedLSTMCell) step by step from a zero state, a padded step (token
    0) keeping the previous state; its hidden state is q. Attention
    softmax(feat . q / sqrt(q_hidden)) over the K frames gives v; then
    [q, v, q * v] -> ``fc1`` (128) + ReLU -> ``answer_head``."""

    def __init__(self, vocab_size: int, num_answers: int, q_hidden: int = 64, num_classes: int = 41,
                 input_hw: Tuple[int, int] = (64, 64)):
        super().__init__()
        self.q_hidden = q_hidden
        self.cnn = MultitaskCNN(num_classes=num_classes, only_encoder=True)
        h, w = encoder_hw(*input_hw)
        self.frame_proj = lecun_normal_(nn.Linear(h * w * ENC_CHANNELS[-1], q_hidden))
        self.q_embed = nn.Embedding(vocab_size, q_hidden)
        self.q_lstm = nn.LSTMCell(q_hidden, q_hidden)
        nn.init.zeros_(self.q_lstm.bias_ih)
        self.q_lstm.bias_ih.requires_grad_(False)
        self.fc1 = lecun_normal_(nn.Linear(3 * q_hidden, 128))
        self.answer_head = lecun_normal_(nn.Linear(128, num_answers))

    def forward(self, frames: torch.Tensor, questions: torch.Tensor) -> torch.Tensor:
        n, k = frames.shape[:2]
        feat = self.cnn(frames.reshape(n * k, *frames.shape[2:])).reshape(n, k, -1)
        feat = torch.tanh(self.frame_proj(feat))  # (N, K, H)
        questions = questions.long()
        emb = self.q_embed(questions)
        h = c = emb.new_zeros(n, self.q_hidden)
        mask = (questions > 0).float()[..., None]
        for t in range(questions.shape[1]):
            h2, c2 = self.q_lstm(emb[:, t], (h, c))
            m = mask[:, t]
            h, c = h2 * m + h * (1 - m), c2 * m + c * (1 - m)
        att = torch.softmax(torch.einsum("nkh,nh->nk", feat, h) / math.sqrt(self.q_hidden), dim=-1)
        v = torch.einsum("nk,nkh->nh", att, feat)
        x = F.relu(self.fc1(torch.cat([h, v, h * v], dim=-1)))
        return self.answer_head(x)


def resize_like_jax(img: torch.Tensor, hw: Sequence[int]) -> torch.Tensor:
    """(N, H, W, C) float -> (N, h, w, C), as ``jax.image.resize(...,
    "bilinear")``: half-pixel centres, weights renormalised at the border,
    and on a downscale a triangle filter widened by the scale (antialias),
    which ``F.interpolate(..., antialias=True)`` computes."""
    if tuple(img.shape[1:3]) == tuple(hw):
        return img
    x = F.interpolate(img.permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear", align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1)


@registry.register_trainer(name="vqa")
class VQALearner:
    """Supervised VQA on the current view and the episode's stored goal view
    (the reference pairs the question with frames at the end of the
    shortest path; the table holds the goal views, rendered once): cross
    entropy against ``extras["answer_token"]``, Adam."""

    def __init__(self, env, vocab_size: int = 256, num_answers: int = 32, lr: float = 3e-4):
        self.env = env
        hw = tuple(env.observation_shapes["rgb"][0][:2])
        self.model = VqaModel(vocab_size, num_answers, input_hw=hw).to(env.device)
        self.optimizer = adam(self.model.parameters(), lr)
        self.update_idx = 0

    def batch(self, env_state, obs: Optional[Dict[str, torch.Tensor]] = None):
        """(frames (N, 2, H, W, 3), questions, answers) of the envs' current
        episodes: the agent's view (``obs["rgb"]`` of this state, rendered
        when not given) and the goal view, resized to the view's size when
        it differs."""
        if obs is None:
            obs = self.env._observations(env_state)
        cur = obs["rgb"].float() / 255.0
        tbl = self.env.table
        goal = resize_like_jax(tbl.goal_image[env_state.ep_idx].float() / 255.0, cur.shape[1:3])
        return (torch.stack([cur, goal], dim=1), tbl.extras["question_tokens"][env_state.ep_idx],
                tbl.extras["answer_token"][env_state.ep_idx].long())

    def train_step(self, env_state, obs: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """One Adam step on the batch of ``env_state``; returns
        {"losses/vqa", "metrics/answer_accuracy"} as 0-d tensors."""
        frames, questions, answers = self.batch(env_state, obs)
        logits = self.model(frames, questions)
        loss = F.cross_entropy(logits, answers)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.update_idx += 1
        acc = (logits.argmax(-1) == answers).float().mean()
        return {"losses/vqa": loss.detach(), "metrics/answer_accuracy": acc}
