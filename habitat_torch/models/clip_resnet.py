"""CLIP-RN50 visual encoder (port of ``habitat_tpu/models/clip_resnet.py``;
reference habitat-baselines/habitat_baselines/rl/ddppo/policy/
resnet_policy.py:279-391, which wraps OpenAI's ``clip.load("RN50").visual``
as a frozen feature extractor).

Architecture (the public CLIP RN50 visual trunk; ``CLIPResNet``):

- a stem of three 3x3 convs (the first stride 2) with batch norm and ReLU,
  then a 2x2 average pool;
- four stages of bottlenecks, (3, 4, 6, 3) at width 64, whose stride-2
  blocks pool 2x2 after conv2 and in the shortcut instead of striding a
  conv;
- ``AttentionPool2d``: the mean token and the 7x7 grid tokens plus a learned
  positional embedding, one multi-head attention readout with the mean
  token as the query (embed 2048, 32 heads, output 1024); or a plain
  average (``avgpool``), or the map itself (``none``).

The submodules carry the names of OpenAI's ``visual.*`` state dict
(``conv1``, ``bn1``, ``layer1.0.downsample.0``, ``attnpool.q_proj``, ...), so
``load_clip_rn50_weights`` strips the ``visual.`` prefix and loads, from a
``.pt`` state dict or an ``.npz`` of the same names alike.

Numerics follow the JAX trunk: convs and the attention's projections run in
bfloat16 (inputs and weights cast), batch norm is the affine of the stored
statistics in float32, ``(x - mean) * (rsqrt(var + eps) * scale) + bias``,
and the softmax is float32. The trunk is frozen, as the JAX package wraps it
in ``stop_gradient``: its parameters have ``requires_grad=False`` and it runs
under ``torch.no_grad()``.

``clip_preprocess`` resizes the shortest edge to 224 with an antialiased
bilinear filter (``jax.image.resize(..., "bilinear")`` antialiases when it
shrinks; ``F.interpolate(..., antialias=True)`` gives the same filter either
way), crops the centre and normalises with CLIP's mean and std.
``ResNetCLIPEncoder`` runs rgb and/or depth (repeated to three channels)
through one trunk; with both, the two maps are summed and averaged to
(2048,).
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
CLIP_RESOLUTION = 224
POOLINGS = ("attnpool", "avgpool", "none")
ATTN_HEADS = 32


class FrozenBatchNorm(nn.Module):
    """Eval-mode batch norm in float32, named as ``nn.BatchNorm2d``
    (weight, bias, running_mean, running_var) on NCHW maps."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(features), requires_grad=False)
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        c = (-1, 1, 1)
        return (x.float() - self.running_mean.view(c)) * inv.view(c) + self.bias.view(c)


class _Conv(nn.Conv2d):
    """Bias-free conv with "same" padding for odd kernels, run in bfloat16."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1):
        super().__init__(cin, cout, kernel, stride=stride, padding=kernel // 2, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.to(torch.bfloat16), self.weight.to(torch.bfloat16), None, self.stride, self.padding)


class _Linear(nn.Linear):
    """Linear run in bfloat16."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(torch.bfloat16), self.weight.to(torch.bfloat16), self.bias.to(torch.bfloat16))


class CLIPBottleneck(nn.Module):
    """CLIP's anti-aliased bottleneck: every conv stride 1; a stride-2 block
    average-pools after conv2 and in the shortcut."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out_ch = planes * self.expansion
        self.stride = stride
        self.conv1, self.bn1 = _Conv(inplanes, planes, 1), FrozenBatchNorm(planes)
        self.conv2, self.bn2 = _Conv(planes, planes, 3), FrozenBatchNorm(planes)
        self.conv3, self.bn3 = _Conv(planes, out_ch, 1), FrozenBatchNorm(out_ch)
        self.downsample = None
        if stride > 1 or inplanes != out_ch:
            self.downsample = nn.Sequential(OrderedDict([
                ("-1", nn.AvgPool2d(stride)), ("0", _Conv(inplanes, out_ch, 1)), ("1", FrozenBatchNorm(out_ch))]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        if self.stride > 1:
            y = F.avg_pool2d(y, self.stride)
        y = self.bn3(self.conv3(y))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(y + x)


class AttentionPool2d(nn.Module):
    """CLIP's attention readout: the mean token queries the mean and grid
    tokens with a learned positional embedding."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int, output_dim: int):
        super().__init__()
        self.positional_embedding = nn.Parameter(torch.randn(spacial_dim ** 2 + 1, embed_dim) / embed_dim ** 0.5)
        self.q_proj = _Linear(embed_dim, embed_dim)
        self.k_proj = _Linear(embed_dim, embed_dim)
        self.v_proj = _Linear(embed_dim, embed_dim)
        self.c_proj = _Linear(embed_dim, output_dim)
        self.num_heads = num_heads

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (N, C, H, W) float32
        n, c = x.shape[:2]
        tokens = x.flatten(2).transpose(1, 2)
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1) + self.positional_embedding
        hd = c // self.num_heads
        q = self.q_proj(tokens[:, :1]).reshape(n, 1, self.num_heads, hd)
        k = self.k_proj(tokens).reshape(n, -1, self.num_heads, hd)
        v = self.v_proj(tokens).reshape(n, -1, self.num_heads, hd)
        att = torch.einsum("nqhd,nkhd->nhqk", q, k).float() / hd ** 0.5
        att = att.softmax(dim=-1).to(v.dtype)
        out = torch.einsum("nhqk,nkhd->nqhd", att, v).reshape(n, c)
        return self.c_proj(out)


class CLIPResNet(nn.Module):
    """The CLIP modified-ResNet visual trunk on (N, 3, 224, 224) normalised
    input: (N, output) float32 with ``attnpool``, (N, 32*width) with
    ``avgpool``, the (N, 7, 7, 32*width) map with ``none``."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), width: int = 64, embed_dim: int = 1024,
                 pooling: str = "attnpool"):
        super().__init__()
        if pooling not in POOLINGS:
            raise ValueError(f"pooling {pooling!r}: {POOLINGS}")
        self.pooling = pooling
        self.conv1, self.bn1 = _Conv(3, width // 2, 3, 2), FrozenBatchNorm(width // 2)
        self.conv2, self.bn2 = _Conv(width // 2, width // 2, 3), FrozenBatchNorm(width // 2)
        self.conv3, self.bn3 = _Conv(width // 2, width, 3), FrozenBatchNorm(width)
        inplanes = width
        for stage, depth in enumerate(layers):
            planes = width * 2 ** stage
            blocks = []
            for b in range(depth):
                blocks.append(CLIPBottleneck(inplanes, planes, 2 if (b == 0 and stage > 0) else 1))
                inplanes = planes * CLIPBottleneck.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.num_stages = len(layers)
        self.out_channels = inplanes
        if pooling == "attnpool":
            self.attnpool = AttentionPool2d(CLIP_RESOLUTION // 32, inplanes, ATTN_HEADS, embed_dim)
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = F.avg_pool2d(x, 2)
        for stage in range(self.num_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        if self.pooling == "attnpool":
            x = self.attnpool(x)
        elif self.pooling == "avgpool":
            x = x.mean(dim=(2, 3))
        else:
            x = x.permute(0, 2, 3, 1)
        return x.float()


def clip_preprocess(img: torch.Tensor) -> torch.Tensor:
    """uint8 or float (N, H, W, 3) -> CLIP-normalised (N, 3, 224, 224)
    float32: the shortest edge resized to 224 (antialiased bilinear), the
    centre cropped, [0, 1] values standardised with CLIP's mean and std."""
    x = img.float()
    if img.dtype == torch.uint8:
        x = x / 255.0
    n, h, w, c = x.shape
    x = x.permute(0, 3, 1, 2)
    if (h, w) != (CLIP_RESOLUTION, CLIP_RESOLUTION):
        scale = CLIP_RESOLUTION / min(h, w)
        nh, nw = max(CLIP_RESOLUTION, round(h * scale)), max(CLIP_RESOLUTION, round(w * scale))
        x = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False, antialias=True)
        top, left = (nh - CLIP_RESOLUTION) // 2, (nw - CLIP_RESOLUTION) // 2
        x = x[:, :, top:top + CLIP_RESOLUTION, left:left + CLIP_RESOLUTION]
    mean = torch.tensor(CLIP_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(CLIP_STD, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


class ResNetCLIPEncoder(nn.Module):
    """Frozen CLIP observation encoder (reference resnet_policy.py:279):
    ``pooling`` "attnpool" -> (N, 1024), "avgpool" -> (N, 2048), "none" ->
    (N, 7*7*2048) for one of rgb / depth; rgb and depth together -> the sum
    of their (7, 7, 2048) maps averaged to (N, 2048). ``visual_inputs``
    names the observations it reads. The trunk is RN50."""

    def __init__(self, pooling: str = "attnpool", visual_inputs: Sequence[str] = ("rgb",)):
        super().__init__()
        self.visual_inputs = tuple(k for k in ("rgb", "depth") if k in visual_inputs)
        if not self.visual_inputs:
            raise ValueError("ResNetCLIPEncoder requires rgb and/or depth")
        both = len(self.visual_inputs) == 2
        self.pooling = pooling
        self.backbone = CLIPResNet(pooling="none" if both else pooling)

    @staticmethod
    def output_dim(obs_keys, pooling: str = "attnpool") -> int:
        both = "rgb" in obs_keys and "depth" in obs_keys
        if both or pooling == "avgpool":
            return 2048
        if pooling == "none":
            return 2048 * 7 * 7
        return 1024

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.no_grad():
            feats = []
            if "rgb" in self.visual_inputs:
                feats.append(self.backbone(clip_preprocess(obs["rgb"])))
            if "depth" in self.visual_inputs:
                d = obs["depth"][..., 0:1].float().clamp(0.0, 1.0)
                feats.append(self.backbone(clip_preprocess(d.repeat(1, 1, 1, 3))))
            if len(feats) == 2:
                return (feats[0] + feats[1]).mean(dim=(1, 2))
            x = feats[0]
            return x.reshape(x.shape[0], -1) if self.backbone.pooling == "none" else x


def load_clip_rn50_weights(module: nn.Module, path: str) -> nn.Module:
    """Load CLIP RN50 visual weights from a LOCAL file into a ``CLIPResNet``
    or a module that holds one as ``backbone`` (``ResNetCLIPEncoder``), in
    place. ``path``: an ``.npz`` of arrays, or a ``.pt`` state dict (or a
    module), keyed by OpenAI's names with or without the ``visual.`` prefix.
    Nothing is downloaded: a missing file raises FileNotFoundError. Every
    parameter and statistic of the trunk must be in the file."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if path.endswith(".npz"):
        with np.load(path) as z:
            sd = {k: torch.from_numpy(np.asarray(z[k], np.float32)) for k in z.files}
    else:
        raw = torch.load(path, map_location="cpu")
        raw = raw.state_dict() if hasattr(raw, "state_dict") else raw
        sd = {k: v.float() for k, v in raw.items()}
    sd = {k[len("visual."):]: v for k, v in sd.items() if k.startswith("visual.")} or sd
    trunk = module.backbone if hasattr(module, "backbone") else module
    own = trunk.state_dict()
    missing = sorted(set(own) - set(sd))
    if missing:
        raise KeyError(f"{path} lacks {len(missing)} CLIP weights, e.g. {missing[:3]}")
    trunk.load_state_dict({k: sd[k] for k in own})
    return module
