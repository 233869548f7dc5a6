"""Flax PointNav actor-critic parameters -> the port's ``state_dict``.

``params_from_jax`` takes the Flax parameter tree flattened to numpy arrays
under "/"-joined paths (a leading "params/" is accepted), as
``flax.traverse_util.flatten_dict(params, sep="/")`` gives it:

- Conv kernels HWIO -> OIHW; Dense kernels (in, out) -> Linear (out, in);
- GroupNorm scale/bias -> weight/bias; Embed embedding -> weight;
- the image-goal encoders ``goal_encoder_<key>`` map as the observation
  encoder ``ResNetEncoder_0`` does, under ``net.goal_encoder.<key>``; the
  Gaussian head's Dense and ``log_std`` -> ``action_head`` (a Linear with a
  ``log_std`` parameter);
- ``OptimizedLSTMCell`` gates: input kernels ii/if/ig/io (no bias) and
  recurrent kernels hi/hf/hg/ho (with bias) -> ``nn.LSTMCell`` weight_ih /
  weight_hh / bias_hh in torch's i, f, g, o order, bias_ih = 0;
- ``GRUCell`` kernels ir/iz/in (with bias) and hr/hz/hn (hn with bias) ->
  the port's ``GRUCell`` weight_i / bias_i / weight_h in r, z, n order
  and bias_hn;
- the blocks of every backbone: ``BasicBlock_k`` convs 0-2 -> conv1, conv2,
  down; ``Bottleneck_k`` convs 0-3 -> conv1, conv2 (grouped: HWIO's I is
  Cin/groups, as torch's), conv3, down, with their GroupNorms alike, and
  ``SEBlock_0/Dense_0|1`` -> se.fc1|fc2.

``cpca_params_from_jax`` converts the parameters of CPC|A
(``habitat_tpu/baselines/aux_losses.CPCA``: Embed, GRUCell, three Dense)
to ``baselines/aux_losses.CPCA``'s state dict.

The language inputs of the policy: ``net/instruction_embed`` ->
``net.instruction.embed`` and the OptimizedLSTMCell ``net/instruction_lstm``
-> the ``nn.LSTM`` ``net.instruction.lstm`` (``*_l0``, bias_ih_l0 = 0);
``state_fc_vln_candidates`` / ``state_fc_eqa_objects`` as every state_fc.

``multitask_cnn_params_from_jax``, ``vqa_params_from_jax`` and
``pacman_params_from_jax`` convert the EQA imitation models
(``habitat_tpu/baselines/il/``: MultitaskCNN's ``enc<i>``, ``enc_gn<i>``,
``<head>_dec<i>``, ``<head>_gn<i>``, ``<head>_out``; VqaModel's encoder
``MultitaskCNN_0``, ``frame_proj``, ``q_embed``, ``q_lstm``, ``fc1``,
``answer_head``; PacmanModel's ``cnn_fc``, ``q_rnn`` (Embed and
OptimizedLSTMCell), ``ques_tr``, ``action_embed``, the planner's
``GRUCell_0``, ``planner_head``, ``controller_fc0``, ``controller_head``)
to the port's modules of ``baselines/il/eqa_trainers.py`` and
``baselines/il/pacman.py``.

``high_level_params_from_jax`` converts HRL-PPO's ``HighLevelNet``
(``habitat_tpu/baselines/hrl/hrl_ppo.py``: ``Dense_0``, ``Dense_1``,
``actor``, ``critic``) to ``baselines/hrl/hrl_ppo.HighLevelNet``'s
(``fc0``, ``fc1``, ``actor``, ``critic``).

``two_agent_params_from_jax`` converts ``TwoAgentPPOLearner``'s two
parameter sets (``ts["params"]`` of ``habitat_tpu/baselines/multi_agent.py``,
each flattened) to the two policies' state dicts, and
``population_params_from_jax`` a stacked population (leaves with a leading
population axis K, ``stack_params``) to the port's stacked state dict, each
set converted as ``params_from_jax`` converts one.

``load_policy_file`` reads such a state dict back without JAX, as
``scripts/export_flagship_torch.py`` writes it: the ``torch.save`` file and,
beside it with the suffix ``.json``, its sha256 and the policy's build
arguments.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from typing import Dict

import numpy as np
import torch

from habitat_torch.device import resolve_device
from habitat_torch.models.policy import make_pointnav_resnet_policy

_BLOCK_CONVS = {"BasicBlock": ("conv1", "conv2", "down"), "Bottleneck": ("conv1", "conv2", "conv3", "down")}
_BLOCK_NORMS = {"BasicBlock": ("norm1", "norm2", "down_norm"),
                "Bottleneck": ("norm1", "norm2", "norm3", "down_norm")}
_GATES = "ifgo"
_GRU_GATES = "rzn"


def _dense(prefix: str, leaf: str, v: np.ndarray) -> Dict[str, np.ndarray]:
    return {f"{prefix}.weight": v.T} if leaf == "kernel" else {f"{prefix}.bias": v}


def _norm(prefix: str, leaf: str, v: np.ndarray) -> Dict[str, np.ndarray]:
    return {f"{prefix}.{'weight' if leaf == 'scale' else 'bias'}": v}


def _conv(prefix: str, v: np.ndarray) -> Dict[str, np.ndarray]:
    return {f"{prefix}.weight": v.transpose(3, 2, 0, 1)}


def _encoder(rest: str, enc: str, v: np.ndarray) -> Dict[str, np.ndarray]:
    """A ResNetEncoder's parameter (its Flax path ``rest`` below the
    encoder) -> the port's, under the encoder's port prefix ``enc``."""
    res = f"{enc}.backbone"
    if rest == "Conv_0/kernel":
        return _conv(f"{enc}.compression", v)
    m = re.fullmatch(r"GroupNorm_0/(scale|bias)", rest)
    if m:
        return _norm(f"{enc}.compression_norm", m[1], v)
    if rest == "ResNet_0/Conv_0/kernel":
        return _conv(f"{res}.stem", v)
    m = re.fullmatch(r"ResNet_0/GroupNorm_0/(scale|bias)", rest)
    if m:
        return _norm(f"{res}.stem_norm", m[1], v)
    m = re.fullmatch(r"ResNet_0/(BasicBlock|Bottleneck)_(\d+)/Conv_(\d)/kernel", rest)
    if m:
        return _conv(f"{res}.blocks.{m[2]}.{_BLOCK_CONVS[m[1]][int(m[3])]}", v)
    m = re.fullmatch(r"ResNet_0/(BasicBlock|Bottleneck)_(\d+)/GroupNorm_(\d)/(scale|bias)", rest)
    if m:
        return _norm(f"{res}.blocks.{m[2]}.{_BLOCK_NORMS[m[1]][int(m[3])]}", m[4], v)
    m = re.fullmatch(r"ResNet_0/Bottleneck_(\d+)/SEBlock_0/Dense_(\d)/(kernel|bias)", rest)
    if m:
        return _dense(f"{res}.blocks.{m[1]}.se.fc{int(m[2]) + 1}", m[3], v)
    raise KeyError(f"no port counterpart for encoder parameter {rest!r} of {enc}")


def _lstm(prefix: str, g: Dict[str, np.ndarray], suffix: str = "") -> Dict[str, np.ndarray]:
    """A Flax OptimizedLSTMCell's {"ii/kernel": ..., "hi/bias": ...} -> a
    torch LSTM cell under ``prefix`` (``suffix`` "_l0" for ``nn.LSTM``):
    i, f, g, o rows, the recurrent bias as bias_hh, bias_ih zero."""
    out = {
        f"{prefix}.weight_ih{suffix}": np.concatenate([g[f"i{k}/kernel"].T for k in _GATES]),
        f"{prefix}.weight_hh{suffix}": np.concatenate([g[f"h{k}/kernel"].T for k in _GATES]),
        f"{prefix}.bias_hh{suffix}": np.concatenate([g[f"h{k}/bias"] for k in _GATES]),
    }
    out[f"{prefix}.bias_ih{suffix}"] = np.zeros_like(out[f"{prefix}.bias_hh{suffix}"])
    return out


def _convert_one(path, v):
    p = "/".join(path)
    m = re.fullmatch(r"(action_head|critic)/Dense_0/(kernel|bias)", p)
    if m:
        return _dense(m[1], m[2], v)
    if p == "action_head/log_std":
        return {"action_head.log_std": v}
    m = re.fullmatch(r"net/Dense_0/(kernel|bias)", p)
    if m:
        return _dense("net.visual_fc", m[1], v)
    m = re.fullmatch(r"net/(goal_fc|state_fc|goal_visual_fc)_(\w+)/(kernel|bias)", p)
    if m:
        return _dense(f"net.{m[1]}.{m[2]}", m[3], v)
    m = re.fullmatch(r"net/prev_action_fc/(kernel|bias)", p)
    if m:
        return _dense("net.prev_action_fc", m[1], v)
    m = re.fullmatch(r"net/(prev_action_embed|objectgoal_embed)/embedding", p)
    if m:
        return {f"net.{m[1]}.weight": v}
    if p == "net/instruction_embed/embedding":
        return {"net.instruction.embed.weight": v}
    m = re.fullmatch(r"net/(ResNetEncoder_0|goal_encoder_(imagegoal|instance_imagegoal))/(.*)", p)
    if m:
        return _encoder(m[3], "net.encoder" if m[2] is None else f"net.goal_encoder.{m[2]}", v)
    raise KeyError(f"no port counterpart for Flax parameter {p!r}")


def _gru(prefix: str, g: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A Flax GRUCell's {"ir/kernel": ..., "hn/bias": ...} -> the port's
    ``GRUCell`` under ``prefix``."""
    return {
        f"{prefix}.weight_i": np.concatenate([g[f"i{k}/kernel"].T for k in _GRU_GATES]),
        f"{prefix}.bias_i": np.concatenate([g[f"i{k}/bias"] for k in _GRU_GATES]),
        f"{prefix}.weight_h": np.concatenate([g[f"h{k}/kernel"].T for k in _GRU_GATES]),
        f"{prefix}.bias_hn": g["hn/bias"],
    }


def _tensors(out: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in out.items()}


def _leaves(flat: Dict[str, np.ndarray]):
    """(path below a leading "params", float32 value) of each leaf."""
    for key, value in flat.items():
        path = key.split("/")
        if path[0] == "params":
            path = path[1:]
        yield "/".join(path), np.asarray(value, np.float32)


def params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flattened Flax ActorCritic params -> ``ActorCritic.state_dict()``."""
    out: Dict[str, np.ndarray] = {}
    cells: Dict[tuple, Dict[str, np.ndarray]] = {}
    instruction: Dict[str, np.ndarray] = {}
    for p, v in _leaves(flat):
        m = re.fullmatch(r"net/RNNStateEncoder_0/(lstm|gru)_(\d+)/([ih][ifgorzn])/(kernel|bias)", p)
        if m:
            cells.setdefault((m[1], m[2]), {})[f"{m[3]}/{m[4]}"] = v
            continue
        m = re.fullmatch(r"net/instruction_lstm/([ih][ifgo]/(?:kernel|bias))", p)
        if m:
            instruction[m[1]] = v
            continue
        out.update(_convert_one(p.split("/"), v))
    for (kind, layer), g in sorted(cells.items()):
        prefix = f"net.rnn.cells.{layer}"
        out.update(_gru(prefix, g) if kind == "gru" else _lstm(prefix, g))
    if instruction:
        out.update(_lstm("net.instruction.lstm", instruction, "_l0"))
    return _tensors(out)


def two_agent_params_from_jax(flats) -> list:
    """The two agents' flattened Flax ActorCritic params -> their
    ``ActorCritic.state_dict()``s, in agent order."""
    return [params_from_jax(flat) for flat in flats]


def population_params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A flattened stacked population (each leaf (K, ...)) -> the port's
    stacked state dict (each tensor (K, ...))."""
    leaves = {k: np.asarray(v) for k, v in flat.items()}
    k_sets = {v.shape[0] for v in leaves.values()}
    if len(k_sets) != 1:
        raise ValueError(f"population leaves disagree on the population size: {sorted(k_sets)}")
    sets = [params_from_jax({k: v[i] for k, v in leaves.items()}) for i in range(k_sets.pop())]
    return {k: torch.stack([s[k] for s in sets]) for k in sets[0]}


def _cnn_one(p: str, v: np.ndarray, prefix: str) -> Dict[str, np.ndarray]:
    """One MultitaskCNN parameter (its Flax path ``p``) -> the port's."""
    m = re.fullmatch(r"(?:enc(\d)|(rgb|depth|seg)_(dec(\d)|out))/(kernel|bias)", p)
    if m:
        name = (f"enc.{m[1]}" if m[1] is not None
                else f"out.{m[2]}" if m[3] == "out" else f"dec.{m[2]}.{m[4]}")
        return _conv(prefix + name, v) if m[5] == "kernel" else {f"{prefix}{name}.bias": v}
    m = re.fullmatch(r"(?:enc_gn(\d)|(rgb|depth|seg)_gn(\d))/(scale|bias)", p)
    if m:
        return _norm(prefix + (f"enc_gn.{m[1]}" if m[1] is not None else f"dec_gn.{m[2]}.{m[3]}"), m[4], v)
    raise KeyError(f"no port counterpart for MultitaskCNN parameter {p!r}")


def multitask_cnn_params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flattened Flax MultitaskCNN params -> ``MultitaskCNN.state_dict()``
    (conv kernels HWIO -> OIHW)."""
    out: Dict[str, np.ndarray] = {}
    for p, v in _leaves(flat):
        out.update(_cnn_one(p, v, ""))
    return _tensors(out)


def _split_cells(flat: Dict[str, np.ndarray], cells):
    """(the other leaves, {cell: {"ii/kernel": ...}}) for the Flax cell
    paths ``cells``."""
    rest, found = {}, {c: {} for c in cells}
    for p, v in _leaves(flat):
        for c in cells:
            if p.startswith(c + "/"):
                found[c][p[len(c) + 1:]] = v
                break
        else:
            rest[p] = v
    return rest, found


def vqa_params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flattened Flax VqaModel params -> ``VqaModel.state_dict()``."""
    rest, cells = _split_cells(flat, ("q_lstm",))
    out = _lstm("q_lstm", cells["q_lstm"])
    for p, v in rest.items():
        if p.startswith("MultitaskCNN_0/"):
            out.update(_cnn_one(p[len("MultitaskCNN_0/"):], v, "cnn."))
        elif p == "q_embed/embedding":
            out["q_embed.weight"] = v
        elif (m := re.fullmatch(r"(frame_proj|fc1|answer_head)/(kernel|bias)", p)):
            out.update(_dense(m[1], m[2], v))
        else:
            raise KeyError(f"no port counterpart for VqaModel parameter {p!r}")
    return _tensors(out)


def pacman_params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flattened Flax PacmanModel params -> ``PacmanModel.state_dict()``."""
    rest, cells = _split_cells(flat, ("q_rnn/OptimizedLSTMCell_0", "GRUCell_0"))
    out = {**_lstm("q_rnn.lstm", cells["q_rnn/OptimizedLSTMCell_0"], "_l0"), **_gru("planner_gru", cells["GRUCell_0"])}
    for p, v in rest.items():
        if p == "q_rnn/Embed_0/embedding":
            out["q_rnn.embed.weight"] = v
        elif p == "action_embed/embedding":
            out["action_embed.weight"] = v
        elif (m := re.fullmatch(r"(cnn_fc|ques_tr|planner_head|controller_fc0|controller_head)/(kernel|bias)", p)):
            out.update(_dense(m[1], m[2], v))
        else:
            raise KeyError(f"no port counterpart for PacmanModel parameter {p!r}")
    return _tensors(out)


# CPC|A's Flax Dense modules in creation order: proj_in, target_proj, cls
_CPCA_DENSE = ("proj_in", "target_proj", "cls")


def cpca_params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flattened Flax CPCA params -> ``aux_losses.CPCA.state_dict()``."""
    out: Dict[str, np.ndarray] = {}
    gru: Dict[str, np.ndarray] = {}
    for p, v in _leaves(flat):
        if p == "Embed_0/embedding":
            out["action_embed.weight"] = v
        elif p.startswith("GRUCell_0/"):
            gru[p[len("GRUCell_0/"):]] = v
        elif (m := re.fullmatch(r"Dense_(\d)/(kernel|bias)", p)):
            out.update(_dense(_CPCA_DENSE[int(m[1])], m[2], v))
        else:
            raise KeyError(f"no port counterpart for CPCA parameter {p!r}")
    out.update(_gru("gru", gru))
    return _tensors(out)


_HIGH_LEVEL = {"Dense_0": "fc0", "Dense_1": "fc1", "actor": "actor", "critic": "critic"}


def high_level_params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flattened Flax HighLevelNet params -> ``HighLevelNet.state_dict()``."""
    out: Dict[str, np.ndarray] = {}
    for p, v in _leaves(flat):
        m = re.fullmatch(r"(Dense_0|Dense_1|actor|critic)/(kernel|bias)", p)
        if not m:
            raise KeyError(f"no port counterpart for HighLevelNet parameter {p!r}")
        out.update(_dense(_HIGH_LEVEL[m[1]], m[2], v))
    return _tensors(out)


def load_policy_file(path: str, device=None):
    """The policy saved at ``path`` (a state dict of ``params_from_jax``) on
    ``device`` (``None`` = cuda): checks the file's sha256 against the JSON
    beside it, builds ``make_pointnav_resnet_policy`` from the JSON's
    arguments and loads the weights with ``strict=True``."""
    dev = resolve_device(device)
    with open(os.path.splitext(path)[0] + ".json") as f:
        meta = json.load(f)
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if digest != meta["sha256"]:
        raise ValueError(f"{path}: sha256 {digest}, expected {meta['sha256']}")
    kw = dict(meta["policy"])
    policy = make_pointnav_resnet_policy(
        kw.pop("num_actions"), visual_inputs=tuple(kw.pop("visual_inputs")), input_hw=tuple(kw.pop("input_hw")),
        goal_keys=tuple(kw.pop("goal_keys")), device=dev, **kw,
    )
    policy.load_state_dict(torch.load(path, map_location=dev, weights_only=True), strict=True)
    return policy
