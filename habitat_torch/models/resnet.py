"""GroupNorm ResNet visual encoder (port of ``habitat_tpu/models/resnet.py``):
every backbone of its ``SPECS``, basic-block (resnet9, resnet18) and
bottleneck (resnet50, resneXt50, se_resnet50, se_resneXt50,
se_resneXt101: 1x1, 3x3 strided and grouped by ``cardinality``, 1x1 x
``expansion``, a GroupNorm after each, an optional squeeze-excitation, a
projection shortcut when shape or stride changes).

Public inputs stay in the JAX package's layout (NHWC observations) and the
encoder output is flattened in H, W, C order, so converted Dense weights read
the same features. Inside, convolutions are NCHW. Numerics follow the Flax
modules:

- "SAME" padding as XLA computes it, which is asymmetric for stride 2 (the
  7x7/2 stem pads (2, 3), 3x3/2 pads (0, 1), 1x1/2 pads 0), applied with
  ``F.pad`` before an unpadded op;
- the stem's 3x3/2 max pool is ``ops.pool.max_pool_3x3s2`` (pads (0, 1)
  with -inf), whose backward is a CUDA kernel on the card and credits every
  tied input where ``flax.linen.max_pool``'s credits one;
- convolutions and block GroupNorms run in the compute dtype (bfloat16 by
  default) with float32 group statistics; the compression GroupNorm outputs
  float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from habitat_torch.ops.pool import max_pool_3x3s2


@dataclasses.dataclass(frozen=True)
class ResNetSpec:
    block: str  # "basic" | "bottleneck"
    layers: Tuple[int, ...]
    cardinality: int = 1
    use_se: bool = False
    expansion: int = 1


# the JAX package's SPECS (base planes and groups come from the encoder)
SPECS = {
    "resnet9": ResNetSpec("basic", (1, 1, 1, 1)),
    "resnet18": ResNetSpec("basic", (2, 2, 2, 2)),
    "resnet50": ResNetSpec("bottleneck", (3, 4, 6, 3), expansion=4),
    "resneXt50": ResNetSpec("bottleneck", (3, 4, 6, 3), cardinality=32, expansion=2),
    "se_resnet50": ResNetSpec("bottleneck", (3, 4, 6, 3), use_se=True, expansion=4),
    "se_resneXt50": ResNetSpec("bottleneck", (3, 4, 6, 3), cardinality=32, use_se=True, expansion=2),
    "se_resneXt101": ResNetSpec("bottleneck", (3, 4, 23, 3), cardinality=32, use_se=True, expansion=2),
}


def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """Pad an NCHW tensor like XLA's "SAME" for kernel k, stride s."""
    top, bottom = _same_pads(x.shape[2], k, s)
    left, right = _same_pads(x.shape[3], k, s)
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom))


def _lecun_normal_(w: torch.Tensor) -> None:
    """Flax's default kernel init: truncated normal, variance 1/fan_in."""
    fan_in = w[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std)


class Conv2dSame(nn.Module):
    """Bias-free convolution with XLA "SAME" padding, in ``groups`` groups
    (Flax's ``feature_group_count``); the float32 weight is cast to the
    input's dtype."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, groups: int = 1):
        super().__init__()
        self.k, self.stride, self.groups = k, stride, groups
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        _lecun_normal_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(same_pad(x, self.k, self.stride), self.weight.to(x.dtype), stride=self.stride,
                        groups=self.groups)


class GroupNorm(nn.Module):
    """Flax ``nn.GroupNorm``: float32 statistics (E[x^2] - E[x]^2, clipped at
    0), y = (x - mean) * (rsqrt(var + eps) * scale) + bias in float32, cast
    to ``out_dtype`` (None: float32)."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-5, out_dtype=None):
        super().__init__()
        self.num_groups, self.eps, self.out_dtype = num_groups, eps, out_dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        N, C, H, W = x.shape
        G = self.num_groups
        xf = x.float().reshape(N, G, C // G, H * W)
        mean = xf.mean(dim=(2, 3), keepdim=True)
        var = ((xf * xf).mean(dim=(2, 3), keepdim=True) - mean * mean).clamp(min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.reshape(1, G, C // G, 1)
        y = (xf - mean) * mul + self.bias.reshape(1, G, C // G, 1)
        return y.reshape(N, C, H, W).to(self.out_dtype or torch.float32)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int, ngroups: int, dtype):
        super().__init__()
        self.conv1 = Conv2dSame(cin, planes, 3, stride)
        self.norm1 = GroupNorm(ngroups, planes, out_dtype=dtype)
        self.conv2 = Conv2dSame(planes, planes, 3)
        self.norm2 = GroupNorm(ngroups, planes, out_dtype=dtype)
        self.down = None
        if cin != planes or stride != 1:
            self.down = Conv2dSame(cin, planes, 1, stride)
            self.down_norm = GroupNorm(ngroups, planes, out_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = self.norm2(self.conv2(y))
        if self.down is not None:
            x = self.down_norm(self.down(x))
        return F.relu(x + y)


class SEBlock(nn.Module):
    """Squeeze-excitation: per-image channel means (float32 sums) ->
    Linear(C, max(C/16, 4)) -> ReLU -> Linear(C) -> sigmoid, scaling the
    input's channels; the Linears run in the input's dtype, as Flax's
    ``Dense(dtype=...)``."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Linear(channels, max(channels // reduction, 4))
        self.fc2 = nn.Linear(max(channels // reduction, 4), channels)
        for fc in (self.fc1, self.fc2):
            _lecun_normal_(fc.weight)
            nn.init.zeros_(fc.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        s = x.float().mean(dim=(2, 3)).to(dt)
        s = F.relu(F.linear(s, self.fc1.weight.to(dt), self.fc1.bias.to(dt)))
        s = torch.sigmoid(F.linear(s, self.fc2.weight.to(dt), self.fc2.bias.to(dt)))
        return x * s[:, :, None, None]


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int, ngroups: int, dtype, cardinality: int = 1,
                 use_se: bool = False, expansion: int = 4):
        super().__init__()
        out = planes * expansion
        self.conv1 = Conv2dSame(cin, planes, 1)
        self.norm1 = GroupNorm(ngroups, planes, out_dtype=dtype)
        self.conv2 = Conv2dSame(planes, planes, 3, stride, groups=cardinality)
        self.norm2 = GroupNorm(ngroups, planes, out_dtype=dtype)
        self.conv3 = Conv2dSame(planes, out, 1)
        self.norm3 = GroupNorm(ngroups, out, out_dtype=dtype)
        self.se = SEBlock(out) if use_se else None
        self.down = None
        if cin != out or stride != 1:
            self.down = Conv2dSame(cin, out, 1, stride)
            self.down_norm = GroupNorm(ngroups, out, out_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        y = self.norm3(self.conv3(y))
        if self.se is not None:
            y = self.se(y)
        if self.down is not None:
            x = self.down_norm(self.down(x))
        return F.relu(x + y)


class ResNet(nn.Module):
    """Stem (7x7/2 conv + GroupNorm + ReLU + 3x3/2 max pool) and four stages
    of ``spec``'s blocks; returns the final NCHW feature map of
    ``out_channels`` (the JAX package's ``final_channels``)."""

    def __init__(self, in_channels: int, spec: ResNetSpec, base_planes: int, ngroups: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.stem = Conv2dSame(in_channels, base_planes, 7, 2)
        self.stem_norm = GroupNorm(ngroups, base_planes, out_dtype=dtype)
        blocks = []
        cin, planes = base_planes, base_planes
        for i, n_blocks in enumerate(spec.layers):
            for b in range(n_blocks):
                stride = 2 if (i > 0 and b == 0) else 1
                if spec.block == "basic":
                    blocks.append(BasicBlock(cin, planes, stride, ngroups, dtype))
                    cin = planes
                else:
                    blocks.append(Bottleneck(cin, planes, stride, ngroups, dtype, spec.cardinality, spec.use_se,
                                             spec.expansion))
                    cin = planes * spec.expansion
            planes *= 2
        self.blocks = nn.ModuleList(blocks)
        self.out_channels = cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.stem_norm(self.stem(x.to(self.dtype))))
        x = max_pool_3x3s2(x)
        for blk in self.blocks:
            x = blk(x)
        return x


class ResNetEncoder(nn.Module):
    """rgb/255 then depth -> resnet -> 3x3 compression conv + GroupNorm +
    ReLU -> flat (N, h*w*c) float32 in H, W, C order. ``input_hw`` fixes the
    compression width (~``output_size`` features). With
    ``normalize_visual_inputs`` each image is standardised over all its
    pixels and channels in float32 first, (x - mean) / sqrt(var + 1e-5), as
    the JAX package stands in for the reference's RunningMeanAndVar."""

    def __init__(
        self,
        visual_inputs: Sequence[str] = ("rgb", "depth"),
        input_hw: Tuple[int, int] = (128, 128),
        backbone: str = "resnet18",
        base_planes: int = 32,
        ngroups: int = 16,
        output_size: int = 2048,
        dtype=torch.bfloat16,
        normalize_visual_inputs: bool = False,
    ):
        super().__init__()
        self.normalize_visual_inputs = normalize_visual_inputs
        if backbone not in SPECS:
            raise ValueError(f"backbone {backbone!r} not ported; have {sorted(SPECS)}")
        unknown = set(visual_inputs) - {"rgb", "depth"}
        if unknown or not visual_inputs:
            raise ValueError(f"visual inputs must be rgb and/or depth, got {visual_inputs}")
        self.visual_inputs = tuple(k for k in ("rgb", "depth") if k in visual_inputs)
        in_ch = 3 * ("rgb" in visual_inputs) + ("depth" in visual_inputs)
        self.backbone = ResNet(in_ch, SPECS[backbone], base_planes, ngroups, dtype)
        h, w = input_hw
        for _ in range(2 + len(SPECS[backbone].layers) - 1):  # stem, pool, 3 strided stages
            h, w = -(-h // 2), -(-w // 2)
        comp = max(output_size // (h * w), 1)
        comp = ((comp + 7) // 8) * 8
        self.compression = Conv2dSame(self.backbone.out_channels, comp, 3)
        self.compression_norm = GroupNorm(min(ngroups, comp), comp)
        self.output_dim = comp * h * w

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        imgs = []
        if "rgb" in self.visual_inputs:
            imgs.append(obs["rgb"].float() / 255.0)
        if "depth" in self.visual_inputs:
            imgs.append(obs["depth"].float())
        x = torch.cat(imgs, dim=-1)
        if self.normalize_visual_inputs:
            mean = x.mean(dim=(1, 2, 3), keepdim=True)
            var = ((x - mean) ** 2).mean(dim=(1, 2, 3), keepdim=True)
            x = (x - mean) / torch.sqrt(var + 1e-5)
        x = x.permute(0, 3, 1, 2)
        feat = self.backbone(x)
        y = F.relu(self.compression_norm(self.compression(feat)))
        return y.permute(0, 2, 3, 1).reshape(y.shape[0], -1).float()
