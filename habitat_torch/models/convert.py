"""Flax PointNav actor-critic parameters -> the port's ``state_dict``.

``params_from_jax`` takes the Flax parameter tree flattened to numpy arrays
under "/"-joined paths (a leading "params/" is accepted), as
``flax.traverse_util.flatten_dict(params, sep="/")`` gives it:

- Conv kernels HWIO -> OIHW; Dense kernels (in, out) -> Linear (out, in);
- GroupNorm scale/bias -> weight/bias; Embed embedding -> weight;
- ``OptimizedLSTMCell`` gates: input kernels ii/if/ig/io (no bias) and
  recurrent kernels hi/hf/hg/ho (with bias) -> ``nn.LSTMCell`` weight_ih /
  weight_hh / bias_hh in torch's i, f, g, o order, bias_ih = 0.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

_BLOCK_CONVS = ("conv1", "conv2", "down")
_BLOCK_NORMS = ("norm1", "norm2", "down_norm")
_GATES = "ifgo"


def _dense(prefix: str, leaf: str, v: np.ndarray) -> Dict[str, np.ndarray]:
    return {f"{prefix}.weight": v.T} if leaf == "kernel" else {f"{prefix}.bias": v}


def _norm(prefix: str, leaf: str, v: np.ndarray) -> Dict[str, np.ndarray]:
    return {f"{prefix}.{'weight' if leaf == 'scale' else 'bias'}": v}


def _conv(prefix: str, v: np.ndarray) -> Dict[str, np.ndarray]:
    return {f"{prefix}.weight": v.transpose(3, 2, 0, 1)}


def _convert_one(path, v):
    enc, res = "net.encoder", "net.encoder.backbone"
    p = "/".join(path)
    m = re.fullmatch(r"(action_head|critic)/Dense_0/(kernel|bias)", p)
    if m:
        return _dense(m[1], m[2], v)
    m = re.fullmatch(r"net/Dense_0/(kernel|bias)", p)
    if m:
        return _dense("net.visual_fc", m[1], v)
    m = re.fullmatch(r"net/goal_fc_(\w+)/(kernel|bias)", p)
    if m:
        return _dense(f"net.goal_fc.{m[1]}", m[2], v)
    if p == "net/prev_action_embed/embedding":
        return {"net.prev_action_embed.weight": v}
    m = re.fullmatch(r"net/ResNetEncoder_0/Conv_0/kernel", p)
    if m:
        return _conv(f"{enc}.compression", v)
    m = re.fullmatch(r"net/ResNetEncoder_0/GroupNorm_0/(scale|bias)", p)
    if m:
        return _norm(f"{enc}.compression_norm", m[1], v)
    m = re.fullmatch(r"net/ResNetEncoder_0/ResNet_0/Conv_0/kernel", p)
    if m:
        return _conv(f"{res}.stem", v)
    m = re.fullmatch(r"net/ResNetEncoder_0/ResNet_0/GroupNorm_0/(scale|bias)", p)
    if m:
        return _norm(f"{res}.stem_norm", m[1], v)
    m = re.fullmatch(r"net/ResNetEncoder_0/ResNet_0/BasicBlock_(\d+)/Conv_(\d)/kernel", p)
    if m:
        return _conv(f"{res}.blocks.{m[1]}.{_BLOCK_CONVS[int(m[2])]}", v)
    m = re.fullmatch(r"net/ResNetEncoder_0/ResNet_0/BasicBlock_(\d+)/GroupNorm_(\d)/(scale|bias)", p)
    if m:
        return _norm(f"{res}.blocks.{m[1]}.{_BLOCK_NORMS[int(m[2])]}", m[3], v)
    raise KeyError(f"no port counterpart for Flax parameter {p!r}")


def params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flattened Flax ActorCritic params -> ``ActorCritic.state_dict()``."""
    out: Dict[str, np.ndarray] = {}
    lstm: Dict[str, Dict[str, np.ndarray]] = {}
    for key, value in flat.items():
        path = key.split("/")
        if path[0] == "params":
            path = path[1:]
        v = np.asarray(value, np.float32)
        m = re.fullmatch(r"net/RNNStateEncoder_0/lstm_(\d+)/([ih][ifgo])/(kernel|bias)", "/".join(path))
        if m:
            lstm.setdefault(m[1], {})[f"{m[2]}/{m[3]}"] = v
            continue
        out.update(_convert_one(path, v))
    for layer, g in sorted(lstm.items()):
        prefix = f"net.rnn.cells.{layer}"
        out[f"{prefix}.weight_ih"] = np.concatenate([g[f"i{k}/kernel"].T for k in _GATES])
        out[f"{prefix}.weight_hh"] = np.concatenate([g[f"h{k}/kernel"].T for k in _GATES])
        out[f"{prefix}.bias_hh"] = np.concatenate([g[f"h{k}/bias"] for k in _GATES])
        out[f"{prefix}.bias_ih"] = np.zeros_like(out[f"{prefix}.bias_hh"])
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in out.items()}
