"""Actor-critic policies (port of ``habitat_tpu/models/policy.py``).

The net concatenates, in the JAX net's order: visual_fc (unless blind) |
goal_visual_fc per image goal (a second ResNetEncoder over the goal RGB) |
goal_fc per goal sensor | state_fc per state sensor | objectgoal_embed |
the instruction encoder | the previous action; the recurrent encoder (an
LSTM, or a GRU with ``rnn_type="GRU"``) reads the concatenation. The pointgoal
(rho, phi) enters as (rho, cos(-phi), sin(-phi)) and the objectgoal id as
one float; each state sensor goes through its own Linear(width, 32). A
discrete previous action enters as index + 1, or 0 at an episode start,
through an embedding; a continuous one through Linear(A, 32), unmasked.
The rearrangement head cameras ``robot_head_rgb`` / ``robot_head_depth``
are read as the encoder's rgb / depth. The instruction encoder reads the
VLN ``instruction`` tokens, or else the EQA ``question``: Embedding(128, 32),
then an LSTM-128 over the padded tokens from a zero state, keeping its
output at the last valid position (length = the count of tokens > 0, at
least 1).

Heads: ``ActorCritic`` gives logits (categorical); ``GaussianActorCritic``
gives (mu, log_std) of a diagonal Gaussian whose log std is one parameter
per action dimension, clipped to [-5, 2]. Unlike Flax, a torch module
declares its input widths at construction: ``obs_inputs_of`` reads the
state sensors, the image goals, the object goal and the language input
from an env's ``observation_shapes``.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from habitat_torch.core.registry import registry
from habitat_torch.device import resolve_device
from habitat_torch.models.resnet import ResNetEncoder
from habitat_torch.models.rnn_state_encoder import RNNStateEncoder, initial_hidden_state

POINTGOAL_KEYS = ("pointgoal_with_gps_compass", "pointgoal")
# goal sensors the net embeds through goal_fc, with their input widths
GOAL_WIDTHS = {"pointgoal_with_gps_compass": 3, "pointgoal": 3, "objectgoal": 1}
# image goals, each through its own RGB encoder, in the JAX net's order
IMAGE_GOAL_KEYS = ("imagegoal", "instance_imagegoal")
# the state sensors the net embeds, in the JAX package's fixed concatenation
# order: the nav ones, the rearrangement ones, then the referent VLN and EQA
# tables
NAV_STATE_KEYS = ("gps", "compass", "heading", "proximity")
STATE_KEYS = ("obj_start_sensor", "obj_goal_sensor", "joint", "is_holding", "ee_pos", "relative_resting_position")
LANGUAGE_TABLE_KEYS = ("vln_candidates", "eqa_objects")
EMBED_ORDER = NAV_STATE_KEYS + STATE_KEYS + LANGUAGE_TABLE_KEYS
# the token inputs the instruction encoder reads, the first present
LANGUAGE_KEYS = ("instruction", "question")


def state_keys_of(observation_shapes: Mapping[str, Tuple[Tuple[int, ...], torch.dtype]]) -> Dict[str, int]:
    """{key: width} of the state sensors an env emits, from its
    ``observation_shapes``, in ``EMBED_ORDER``: what the JAX package's net
    embeds when those keys are in its observations."""
    return {k: int(observation_shapes[k][0][0]) for k in EMBED_ORDER if k in observation_shapes}


def obs_inputs_of(observation_shapes: Mapping[str, Tuple[Tuple[int, ...], torch.dtype]]) -> Dict:
    """The net's keyword arguments that an env's observations decide:
    ``state_keys``, ``image_goals`` ({key: (H, W)}),
    ``objectgoal_embed`` (whether ``objectgoal`` is observed) and
    ``instruction_encoder`` (whether ``instruction`` or ``question`` is)."""
    return dict(
        state_keys=state_keys_of(observation_shapes),
        image_goals={k: tuple(observation_shapes[k][0][:2]) for k in IMAGE_GOAL_KEYS if k in observation_shapes},
        objectgoal_embed="objectgoal" in observation_shapes,
        instruction_encoder=any(k in observation_shapes for k in LANGUAGE_KEYS),
    )


class InstructionEncoder(nn.Module):
    """Embedding(128, 32) and an LSTM-128 over (B, L) padded tokens from a
    zero state; returns the LSTM's output at each row's last valid position
    (the count of tokens > 0, at least 1). The LSTM has the one bias of
    Flax's OptimizedLSTMCell, ``bias_hh_l0``; ``bias_ih_l0`` stays zero and
    untrained."""

    def __init__(self, vocab: int = 128, embed: int = 32, hidden: int = 128):
        super().__init__()
        self.embed = nn.Embedding(vocab, embed)
        self.lstm = nn.LSTM(embed, hidden, batch_first=True)
        nn.init.zeros_(self.lstm.bias_ih_l0)
        self.lstm.bias_ih_l0.requires_grad_(False)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        tokens = tokens.long()
        hs, _ = self.lstm(self.embed(tokens))  # (B, L, H)
        last = (tokens > 0).sum(-1).clamp(min=1) - 1
        return hs[torch.arange(hs.shape[0], device=hs.device), last]


class PointNavResNetNet(nn.Module):
    def __init__(
        self,
        num_actions: int,
        *,
        visual_inputs: Sequence[str] = ("rgb", "depth"),
        input_hw: Tuple[int, int] = (128, 128),
        backbone: str = "resnet18",
        hidden_size: int = 512,
        rnn_type: str = "LSTM",
        num_recurrent_layers: int = 1,
        base_planes: int = 32,
        ngroups: int = 16,
        normalize_visual_inputs: bool = False,
        has_visual: bool = True,
        goal_keys: Sequence[str] = ("pointgoal_with_gps_compass",),
        state_keys: Mapping[str, int] = (),
        image_goals: Mapping[str, Tuple[int, int]] = (),
        objectgoal_embed: bool = False,
        instruction_encoder: bool = False,
        discrete_actions: bool = True,
        dtype=torch.bfloat16,
    ):
        """``num_actions``: the action count of a discrete policy, the
        action's width of a continuous one (``discrete_actions=False``);
        ``instruction_encoder`` reads ``instruction`` (or ``question``)."""
        super().__init__()
        for k in goal_keys:
            if k not in GOAL_WIDTHS:
                raise ValueError(f"goal sensor {k!r} not ported; have {tuple(GOAL_WIDTHS)}")
        state_keys, image_goals = dict(state_keys), dict(image_goals)
        for k in state_keys:
            if k not in EMBED_ORDER:
                raise ValueError(f"state sensor {k!r} not ported; have {EMBED_ORDER}")
        for k in image_goals:
            if k not in IMAGE_GOAL_KEYS:
                raise ValueError(f"image goal {k!r} not ported; have {IMAGE_GOAL_KEYS}")
        self.num_actions = num_actions
        self.discrete_actions = discrete_actions
        self.hidden_size = hidden_size
        self.rnn_type = rnn_type.upper()
        self.num_recurrent_layers = num_recurrent_layers
        enc_kw = dict(backbone=backbone, base_planes=base_planes, ngroups=ngroups, dtype=dtype,
                      normalize_visual_inputs=normalize_visual_inputs)
        self.encoder = self.visual_fc = None
        if has_visual:
            self.encoder = ResNetEncoder(visual_inputs, input_hw, **enc_kw)
            self.visual_fc = nn.Linear(self.encoder.output_dim, hidden_size)
        self.image_goal_keys = tuple(k for k in IMAGE_GOAL_KEYS if k in image_goals)
        self.goal_encoder = nn.ModuleDict(
            {k: ResNetEncoder(("rgb",), image_goals[k], **enc_kw) for k in self.image_goal_keys})
        self.goal_visual_fc = nn.ModuleDict(
            {k: nn.Linear(self.goal_encoder[k].output_dim, hidden_size) for k in self.image_goal_keys})
        self.goal_keys = tuple(goal_keys)
        self.goal_fc = nn.ModuleDict({k: nn.Linear(GOAL_WIDTHS[k], 32) for k in self.goal_keys})
        # declared as {key: width}, embedded in EMBED_ORDER
        self.state_keys = tuple(k for k in EMBED_ORDER if k in state_keys)
        self.state_fc = nn.ModuleDict({k: nn.Linear(state_keys[k], 32) for k in self.state_keys})
        self.objectgoal_embed = nn.Embedding(64, 32) if objectgoal_embed else None
        self.instruction = InstructionEncoder() if instruction_encoder else None
        if discrete_actions:
            self.prev_action_embed = nn.Embedding(num_actions + 1, 32)
        else:
            self.prev_action_fc = nn.Linear(num_actions, 32)
        width = (
            hidden_size * (has_visual + len(self.image_goal_keys))
            + 32 * (len(self.goal_keys) + len(self.state_keys) + objectgoal_embed + 1)
            + 128 * instruction_encoder
        )
        self.rnn = RNNStateEncoder(width, hidden_size, num_recurrent_layers, rnn_type)

    def forward(
        self,
        obs: Dict[str, torch.Tensor],
        hidden: torch.Tensor,
        prev_actions: torch.Tensor,
        masks: torch.Tensor,
        with_feats: bool = False,
    ) -> Tuple[torch.Tensor, ...]:
        """obs leaves (N, ...), prev_actions (N,) or (N, A) and masks (N,)
        for one step, or obs leaves (T, N, ...), prev_actions (T, N) or
        (T, N, A) and masks (T, N) for the update's sequence mode; hidden
        (N, L, S, H). Returns (features (N, H) or (T, N, H), the final
        hidden state), and with ``with_feats`` also the visual embedding
        (the ReLU of ``visual_fc``, (N*T, H) in sequence mode; None when
        blind), which the JAX net sows for auxiliary losses."""
        seq = masks.dim() == 2

        def flat(v):
            return v.reshape(-1, *v.shape[2:]) if seq else v

        obs = {k: flat(v) for k, v in obs.items()}
        for k in ("rgb", "depth"):
            if f"robot_head_{k}" in obs:
                obs[k] = obs[f"robot_head_{k}"]
        parts = []
        visual = None
        if self.encoder is not None:
            visual = F.relu(self.visual_fc(self.encoder(obs)))
            parts.append(visual)
        for k in self.image_goal_keys:
            parts.append(F.relu(self.goal_visual_fc[k](self.goal_encoder[k]({"rgb": obs[k]}))))
        for k in self.goal_keys:
            g = obs[k].float()
            if k in POINTGOAL_KEYS and g.shape[-1] == 2:
                g = torch.stack([g[..., 0], torch.cos(-g[..., 1]), torch.sin(-g[..., 1])], dim=-1)
            parts.append(self.goal_fc[k](g))
        for k in self.state_keys:
            parts.append(self.state_fc[k](obs[k].float()))
        if self.objectgoal_embed is not None:
            parts.append(self.objectgoal_embed(obs["objectgoal"][..., 0].long()))
        if self.instruction is not None:
            parts.append(self.instruction(next(obs[k] for k in LANGUAGE_KEYS if k in obs)))
        pa = flat(prev_actions)
        if self.discrete_actions:
            parts.append(self.prev_action_embed(torch.where(flat(masks) > 0, pa.long() + 1, 0)))
        else:
            parts.append(self.prev_action_fc(pa.float()))
        x = torch.cat(parts, dim=-1)
        if seq:
            x = x.reshape(*masks.shape, -1)
        feats, new_hidden = self.rnn(x, hidden, masks)
        return (feats, new_hidden, visual) if with_feats else (feats, new_hidden)


class ActorCritic(nn.Module):
    """net -> (the action head's output, value), per step or over a (T, N)
    sequence; the head is the categorical logits' Linear unless given."""

    def __init__(self, net: PointNavResNetNet, action_head: Optional[nn.Module] = None):
        super().__init__()
        self.net = net
        if action_head is None:
            action_head = nn.Linear(net.hidden_size, net.num_actions)
            nn.init.orthogonal_(action_head.weight, gain=0.01)
            nn.init.zeros_(action_head.bias)
        self.action_head = action_head
        self.critic = nn.Linear(net.hidden_size, 1)
        nn.init.orthogonal_(self.critic.weight, gain=1.0)
        nn.init.zeros_(self.critic.bias)

    def forward(self, obs, hidden, prev_actions, masks, with_feats: bool = False):
        """(head output, value, hidden); with ``with_feats`` also the visual
        embedding and the RNN output (the beliefs), the two features the
        JAX net sows for CPC|A."""
        out = self.net(obs, hidden, prev_actions, masks, with_feats=with_feats)
        feats = out[0]
        head = (self.action_head(feats), self.critic(feats)[..., 0], out[1])
        return head + (out[2], feats) if with_feats else head

    def initial_hidden(self, batch: int) -> torch.Tensor:
        return initial_hidden_state(
            batch, self.net.hidden_size, self.net.num_recurrent_layers,
            device=self.critic.weight.device, rnn_type=self.net.rnn_type,
        )


class GaussianHead(nn.Linear):
    """mu = Linear(x) (orthogonal(0.01) weight, zero bias) and a
    state-independent ``log_std`` parameter, clipped to [min_log_std,
    max_log_std] and broadcast to mu's shape."""

    def __init__(self, in_features: int, num_outputs: int, std_init: float = 0.0,
                 min_log_std: float = -5.0, max_log_std: float = 2.0):
        super().__init__(in_features, num_outputs)
        nn.init.orthogonal_(self.weight, gain=0.01)
        nn.init.zeros_(self.bias)
        self.log_std = nn.Parameter(torch.full((num_outputs,), float(std_init)))
        self.min_log_std, self.max_log_std = min_log_std, max_log_std

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mu = super().forward(x)
        return mu, self.log_std.clamp(self.min_log_std, self.max_log_std).expand_as(mu)


class GaussianActorCritic(ActorCritic):
    """Continuous-control actor-critic: (mu, log_std), value, hidden."""

    def __init__(self, net: PointNavResNetNet, num_outputs: int, std_init: float = 0.0):
        super().__init__(net, GaussianHead(net.hidden_size, num_outputs, std_init))
        self.num_outputs = num_outputs


def sample_action(
    logits: torch.Tensor, generator: torch.Generator, deterministic: bool = False,
    exponential: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Categorical sample (or argmax) + its log prob. The sample is
    ``torch.multinomial``'s own draw of one sample per row, argmax over the
    actions of p / q with q ~ Exp(1) per (row, action): ``exponential``
    (N, A), or drawn from ``generator``, which gives multinomial's numbers
    from the same generator state. A row's action depends on its own q
    only, so DD-PPO ranks draw q at the global batch and keep their rows."""
    logp = F.log_softmax(logits.float(), dim=-1)
    if deterministic:
        act = logits.argmax(dim=-1)
    else:
        p = logp.exp()
        q = torch.empty_like(p).exponential_(1, generator=generator) if exponential is None else exponential
        act = torch.argmax(p / q, dim=-1)
    return act.to(torch.int32), logp.gather(-1, act[:, None].long())[:, 0]


def evaluate_actions_stats(logits: torch.Tensor, actions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log prob of ``actions``, entropy) from logits, in float32."""
    logp = F.log_softmax(logits.float(), dim=-1)
    act_logp = logp.gather(-1, actions.long()[..., None])[..., 0]
    return act_logp, -(logp.exp() * logp).sum(-1)


_LOG_2PI = math.log(2 * math.pi)


def _gaussian_logp(mu, log_std, actions):
    return -0.5 * (((actions - mu) / torch.exp(log_std)) ** 2 + 2 * log_std + _LOG_2PI).sum(-1)


def sample_gaussian_action(
    mu: torch.Tensor, log_std: torch.Tensor, generator: torch.Generator, deterministic: bool = False,
    normal: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """mu + std * N(0, 1), the noise ``normal`` (mu's shape) or drawn from
    ``generator`` (mu itself when ``deterministic``), and its log prob, in
    float32."""
    mu, log_std = mu.float(), log_std.float()
    if deterministic:
        act = mu
    else:
        if normal is None:
            normal = torch.randn(mu.shape, generator=generator, device=mu.device)
        act = mu + torch.exp(log_std) * normal
    return act, _gaussian_logp(mu, log_std, act)


def evaluate_gaussian_actions(
    mu: torch.Tensor, log_std: torch.Tensor, actions: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log prob of stored continuous ``actions``, entropy), in float32."""
    mu, log_std = mu.float(), log_std.float()
    entropy = (log_std + 0.5 * math.log(2 * math.pi * math.e)).sum(-1)
    return _gaussian_logp(mu, log_std, actions.float()), entropy


@registry.register_policy(name="PointNavResNetPolicy")
def make_pointnav_resnet_policy(
    num_actions: int,
    *,
    visual_inputs: Sequence[str] = ("rgb", "depth"),
    input_hw: Tuple[int, int] = (128, 128),
    backbone: str = "resnet18",
    hidden_size: int = 512,
    rnn_type: str = "LSTM",
    num_recurrent_layers: int = 1,
    normalize_visual_inputs: bool = False,
    has_visual: bool = True,
    goal_keys: Sequence[str] = ("pointgoal_with_gps_compass",),
    state_keys: Mapping[str, int] = (),
    image_goals: Mapping[str, Tuple[int, int]] = (),
    objectgoal_embed: bool = False,
    instruction_encoder: bool = False,
    dtype=torch.bfloat16,
    device=None,
) -> ActorCritic:
    """PointNavResNetPolicy on ``device`` (``None`` = cuda). ``state_keys``
    maps each embedded state sensor to its width and ``image_goals`` each
    image goal to its (H, W) (``obs_inputs_of`` reads them from an env's
    ``observation_shapes``)."""
    dev = resolve_device(device)
    return ActorCritic(
        PointNavResNetNet(
            num_actions,
            visual_inputs=visual_inputs,
            input_hw=input_hw,
            backbone=backbone,
            hidden_size=hidden_size,
            rnn_type=rnn_type,
            num_recurrent_layers=num_recurrent_layers,
            normalize_visual_inputs=normalize_visual_inputs,
            has_visual=has_visual,
            goal_keys=goal_keys,
            state_keys=state_keys,
            image_goals=image_goals,
            objectgoal_embed=objectgoal_embed,
            instruction_encoder=instruction_encoder,
            dtype=dtype,
        )
    ).to(dev)


@registry.register_policy(name="PointNavBaselinePolicy")
def make_pointnav_baseline_policy(num_actions: int, hidden_size: int = 512, **kw) -> ActorCritic:
    """The reference's SimpleCNN baseline name, built as the JAX package
    builds it: the resnet9 PointNavResNetPolicy (a ``backbone`` given is
    overridden)."""
    return make_pointnav_resnet_policy(num_actions, hidden_size=hidden_size, **{**kw, "backbone": "resnet9"})


@registry.register_policy(name="GaussianResNetPolicy")
def make_gaussian_resnet_policy(
    num_outputs: int,
    *,
    visual_inputs: Sequence[str] = ("rgb", "depth"),
    input_hw: Tuple[int, int] = (128, 128),
    backbone: str = "resnet18",
    hidden_size: int = 512,
    rnn_type: str = "LSTM",
    num_recurrent_layers: int = 1,
    has_visual: bool = True,
    goal_keys: Sequence[str] = (),
    state_keys: Mapping[str, int] = (),
    image_goals: Mapping[str, Tuple[int, int]] = (),
    objectgoal_embed: bool = False,
    instruction_encoder: bool = False,
    std_init: float = 0.0,
    dtype=torch.bfloat16,
    device=None,
) -> GaussianActorCritic:
    """The continuous-control policy on ``device`` (``None`` = cuda): the
    same net, its previous action (N, ``num_outputs``) through
    ``prev_action_fc``, and the Gaussian head."""
    dev = resolve_device(device)
    net = PointNavResNetNet(
        num_outputs,
        visual_inputs=visual_inputs,
        input_hw=input_hw,
        backbone=backbone,
        hidden_size=hidden_size,
        rnn_type=rnn_type,
        num_recurrent_layers=num_recurrent_layers,
        has_visual=has_visual,
        goal_keys=goal_keys,
        state_keys=state_keys,
        image_goals=image_goals,
        objectgoal_embed=objectgoal_embed,
        instruction_encoder=instruction_encoder,
        discrete_actions=False,
        dtype=dtype,
    )
    return GaussianActorCritic(net, num_outputs, std_init).to(dev)
