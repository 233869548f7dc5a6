"""PointNav actor-critic (port of the PointNavResNetPolicy parts of
``habitat_tpu/models/policy.py``).

The net concatenates visual_fc | goal_fc | state_fc | prev_action_embed and
feeds the LSTM; the pointgoal (rho, phi) enters as (rho, cos(-phi),
sin(-phi)), each state sensor through its own Linear(width, 32), and the
previous action as index + 1, or 0 at an episode start. The rearrangement
head cameras ``robot_head_rgb`` / ``robot_head_depth`` are read as the
encoder's rgb / depth."""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from habitat_torch.core.registry import registry
from habitat_torch.device import resolve_device
from habitat_torch.models.resnet import ResNetEncoder
from habitat_torch.models.rnn_state_encoder import RNNStateEncoder, initial_hidden_state

POINTGOAL_KEYS = ("pointgoal_with_gps_compass", "pointgoal")
# the rearrangement state sensors the net embeds, in the JAX package's fixed
# concatenation order (its other state keys, gps/compass/heading/proximity
# and the VLN/EQA tables, are not ported)
STATE_KEYS = ("obj_start_sensor", "obj_goal_sensor", "joint", "is_holding", "ee_pos", "relative_resting_position")


def state_keys_of(observation_shapes: Mapping[str, Tuple[Tuple[int, ...], torch.dtype]]) -> Dict[str, int]:
    """{key: width} of the state sensors an env emits, from its
    ``observation_shapes``, in ``STATE_KEYS`` order: what the JAX package's
    net embeds when those keys are in its observations."""
    return {k: int(observation_shapes[k][0][0]) for k in STATE_KEYS if k in observation_shapes}


class PointNavResNetNet(nn.Module):
    def __init__(
        self,
        num_actions: int,
        *,
        visual_inputs: Sequence[str] = ("rgb", "depth"),
        input_hw: Tuple[int, int] = (128, 128),
        backbone: str = "resnet18",
        hidden_size: int = 512,
        num_recurrent_layers: int = 1,
        base_planes: int = 32,
        ngroups: int = 16,
        goal_keys: Sequence[str] = ("pointgoal_with_gps_compass",),
        state_keys: Mapping[str, int] = (),
        dtype=torch.bfloat16,
    ):
        super().__init__()
        for k in goal_keys:
            if k not in POINTGOAL_KEYS:
                raise ValueError(f"goal sensor {k!r} not ported; have {POINTGOAL_KEYS}")
        state_keys = dict(state_keys)
        for k in state_keys:
            if k not in STATE_KEYS:
                raise ValueError(f"state sensor {k!r} not ported; have {STATE_KEYS}")
        self.num_actions = num_actions
        self.hidden_size = hidden_size
        self.num_recurrent_layers = num_recurrent_layers
        self.encoder = ResNetEncoder(
            visual_inputs, input_hw, backbone, base_planes, ngroups, dtype=dtype
        )
        self.visual_fc = nn.Linear(self.encoder.output_dim, hidden_size)
        self.goal_keys = tuple(goal_keys)
        self.goal_fc = nn.ModuleDict({k: nn.Linear(3, 32) for k in self.goal_keys})
        # declared as {key: width}, embedded in STATE_KEYS order
        self.state_keys = tuple(k for k in STATE_KEYS if k in state_keys)
        self.state_fc = nn.ModuleDict({k: nn.Linear(state_keys[k], 32) for k in self.state_keys})
        self.prev_action_embed = nn.Embedding(num_actions + 1, 32)
        self.rnn = RNNStateEncoder(
            hidden_size + 32 * (len(self.goal_keys) + len(self.state_keys)) + 32, hidden_size, num_recurrent_layers
        )

    def forward(
        self,
        obs: Dict[str, torch.Tensor],
        hidden: torch.Tensor,
        prev_actions: torch.Tensor,
        masks: torch.Tensor,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """obs leaves (N, ...), prev_actions and masks (N,) for one step, or
        obs leaves (T, N, ...), prev_actions and masks (T, N) for the update's
        sequence mode; hidden (N, L, 2, H). Returns (features (N, H) or
        (T, N, H), the final hidden state)."""
        seq = masks.dim() == 2

        def flat(v):
            return v.reshape(-1, *v.shape[2:]) if seq else v

        obs = {k: flat(v) for k, v in obs.items()}
        for k in ("rgb", "depth"):
            if f"robot_head_{k}" in obs:
                obs[k] = obs[f"robot_head_{k}"]
        parts = [F.relu(self.visual_fc(self.encoder(obs)))]
        for k in self.goal_keys:
            g = obs[k].float()
            if g.shape[-1] == 2:
                g = torch.stack([g[..., 0], torch.cos(-g[..., 1]), torch.sin(-g[..., 1])], dim=-1)
            parts.append(self.goal_fc[k](g))
        for k in self.state_keys:
            parts.append(self.state_fc[k](obs[k].float()))
        pa_idx = torch.where(flat(masks) > 0, flat(prev_actions).long() + 1, 0)
        parts.append(self.prev_action_embed(pa_idx))
        x = torch.cat(parts, dim=-1)
        if seq:
            x = x.reshape(*masks.shape, -1)
        return self.rnn(x, hidden, masks)


class ActorCritic(nn.Module):
    """net -> (logits, value), per step or over a (T, N) sequence."""

    def __init__(self, net: PointNavResNetNet):
        super().__init__()
        self.net = net
        self.action_head = nn.Linear(net.hidden_size, net.num_actions)
        self.critic = nn.Linear(net.hidden_size, 1)
        nn.init.orthogonal_(self.action_head.weight, gain=0.01)
        nn.init.zeros_(self.action_head.bias)
        nn.init.orthogonal_(self.critic.weight, gain=1.0)
        nn.init.zeros_(self.critic.bias)

    def forward(self, obs, hidden, prev_actions, masks):
        feats, new_hidden = self.net(obs, hidden, prev_actions, masks)
        return self.action_head(feats), self.critic(feats)[..., 0], new_hidden

    def initial_hidden(self, batch: int) -> torch.Tensor:
        return initial_hidden_state(
            batch, self.net.hidden_size, self.net.num_recurrent_layers,
            device=self.action_head.weight.device,
        )


def sample_action(
    logits: torch.Tensor, generator: torch.Generator, deterministic: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Categorical sample (or argmax) + its log prob."""
    logp = F.log_softmax(logits.float(), dim=-1)
    if deterministic:
        act = logits.argmax(dim=-1)
    else:
        act = torch.multinomial(logp.exp(), 1, generator=generator)[:, 0]
    return act.to(torch.int32), logp.gather(-1, act[:, None].long())[:, 0]


def evaluate_actions_stats(logits: torch.Tensor, actions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log prob of ``actions``, entropy) from logits, in float32."""
    logp = F.log_softmax(logits.float(), dim=-1)
    act_logp = logp.gather(-1, actions.long()[..., None])[..., 0]
    return act_logp, -(logp.exp() * logp).sum(-1)


@registry.register_policy(name="PointNavResNetPolicy")
def make_pointnav_resnet_policy(
    num_actions: int,
    *,
    visual_inputs: Sequence[str] = ("rgb", "depth"),
    input_hw: Tuple[int, int] = (128, 128),
    backbone: str = "resnet18",
    hidden_size: int = 512,
    num_recurrent_layers: int = 1,
    goal_keys: Sequence[str] = ("pointgoal_with_gps_compass",),
    state_keys: Mapping[str, int] = (),
    dtype=torch.bfloat16,
    device=None,
) -> ActorCritic:
    """PointNavResNetPolicy on ``device`` (``None`` = cuda). ``state_keys``
    maps each embedded state sensor to its width (``state_keys_of`` reads
    them from an env's ``observation_shapes``)."""
    dev = resolve_device(device)
    return ActorCritic(
        PointNavResNetNet(
            num_actions,
            visual_inputs=visual_inputs,
            input_hw=input_hw,
            backbone=backbone,
            hidden_size=hidden_size,
            num_recurrent_layers=num_recurrent_layers,
            goal_keys=goal_keys,
            state_keys=state_keys,
            dtype=dtype,
        )
    ).to(dev)


def _not_ported(name: str):
    def build(*args, **kwargs):
        raise NotImplementedError(f"{name} is not ported to habitat_torch yet (ROADMAP Queue 1 item 4)")

    return build


# the reference's other policy names: SimpleCNN and the Gaussian
# (continuous-action) actor-critic are not ported
for _name in ("PointNavBaselinePolicy", "GaussianResNetPolicy"):
    registry.register_policy(_not_ported(_name), name=_name)
