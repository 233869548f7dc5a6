"""Deployable PPO agent (port of ``habitat_tpu/baselines/agents/ppo_agents.py``;
reference habitat-baselines/habitat_baselines/agents/ppo_agents.py): a
trained PointNav policy behind the ``Agent`` ABC, one observation at a time
on the policy's device, with an LSTM carry of batch 1.

The visual inputs are given to the constructor (a Flax net infers them from
its first observation; a torch module declares them when it is built).
``load_checkpoint`` reads a port trainer's checkpoint (``ckpt.{i}`` or
``latest``, a ``torch.save`` file) or a JAX-free export (a ``.pt`` file
with its ``.json`` beside it, ``models/convert.load_policy_file``). An
orbax checkpoint directory of the JAX package cannot be read without JAX:
export it first with ``scripts/export_flagship_torch.py`` (or
``scripts/export_bc_gate_torch.py``'s pattern).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import torch

from habitat_torch.core.agent import Agent
from habitat_torch.device import resolve_device
from habitat_torch.models.policy import ActorCritic, make_pointnav_resnet_policy
from habitat_torch.utils import threefry


class PPOAgent(Agent):
    """Acts from ``policy``, or from a PointNavResNetPolicy built from the
    keyword arguments on ``device`` (``None`` = cuda); ``deterministic``
    takes the argmax, else samples as the JAX agent does: a Threefry key
    ``PRNGKey(seed)`` split at every act, the action
    ``categorical(k, logits)`` (argmax of Gumbel noise plus logits). The
    (1, A) noise is drawn on the host and copied without waiting on the
    card."""

    def __init__(
        self,
        policy: Optional[ActorCritic] = None,
        *,
        num_actions: int = 4,
        visual_inputs: Sequence[str] = ("rgb", "depth"),
        input_hw: Tuple[int, int] = (128, 128),
        backbone: str = "resnet18",
        hidden_size: int = 512,
        goal_sensor_uuid: str = "pointgoal_with_gps_compass",
        deterministic: bool = False,
        seed: int = 0,
        dtype=torch.bfloat16,
        device=None,
    ):
        if policy is None:
            policy = make_pointnav_resnet_policy(
                num_actions, visual_inputs=visual_inputs, input_hw=input_hw, backbone=backbone,
                hidden_size=hidden_size, goal_keys=(goal_sensor_uuid,), dtype=dtype, device=resolve_device(device))
        self.policy = policy.eval()
        self.device = policy.critic.weight.device
        self.deterministic = deterministic
        self._key = threefry.prng_key(seed)
        self.reset()

    def reset(self) -> None:
        self.hidden = self.policy.initial_hidden(1)
        self.prev_action = torch.zeros(1, dtype=torch.int32, device=self.device)
        self.mask = torch.zeros(1, device=self.device)

    def load_checkpoint(self, path: str, name: str = "latest") -> None:
        """Load the policy's weights from an export file ``path`` (``.pt``
        with ``.json`` beside it; the policy is rebuilt from the JSON) or
        from the trainer checkpoint ``name`` in the folder ``path``."""
        from habitat_torch.models.convert import load_policy_file

        if os.path.isfile(path):
            self.policy = load_policy_file(path, device=self.device).eval()
            self.reset()
            return
        ckpt = os.path.join(path, name)
        if os.path.isdir(ckpt):
            raise ValueError(
                f"{ckpt} is a directory, as the JAX package's orbax checkpoints are: habitat_torch reads no orbax "
                "checkpoint; export its parameters with scripts/export_flagship_torch.py (JAX, on the CPU) and "
                "load the .pt file")
        with open(ckpt, "rb") as f:
            state = torch.load(f, map_location=self.device, weights_only=True)
        self.policy.load_state_dict(state["policy"])

    @torch.no_grad()
    def act(self, observations: Dict) -> int:
        """The action for one observation (leaves without the batch axis,
        numpy or tensors)."""
        obs = {k: torch.as_tensor(v, device=self.device)[None] for k, v in observations.items()}
        if not self.deterministic:
            self._key, k = threefry.split(self._key)
            noise = threefry.gumbel(k, (1, self.policy.net.num_actions))
            noise = torch.from_numpy(noise).to(self.device, non_blocking=True)
        logits, _, self.hidden = self.policy(obs, self.hidden, self.prev_action, self.mask)
        logits = logits.float()
        action = (logits if self.deterministic else logits + noise).argmax(-1).to(torch.int32)
        self.prev_action = action
        self.mask = torch.ones(1, device=self.device)
        return int(action[0])
