"""GroupNorm ResNet visual encoder (port of ``habitat_tpu/models/resnet.py``,
basic-block backbones).

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

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from habitat_torch.ops.pool import max_pool_3x3s2

# basic-block stage depths of the backbones the port supports
SPECS = {"resnet9": (1, 1, 1, 1), "resnet18": (2, 2, 2, 2)}


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
    """Bias-free convolution with XLA "SAME" padding; the float32 weight is
    cast to the input's dtype."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__()
        self.k, self.stride = k, stride
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        _lecun_normal_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(same_pad(x, self.k, self.stride), self.weight.to(x.dtype), stride=self.stride)


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


class ResNet(nn.Module):
    """Stem (7x7/2 conv + GroupNorm + ReLU + 3x3/2 max pool) and four stages
    of basic blocks; returns the final NCHW feature map."""

    def __init__(self, in_channels: int, layers: Sequence[int], base_planes: int, ngroups: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.stem = Conv2dSame(in_channels, base_planes, 7, 2)
        self.stem_norm = GroupNorm(ngroups, base_planes, out_dtype=dtype)
        blocks = []
        cin, planes = base_planes, base_planes
        for i, n_blocks in enumerate(layers):
            for b in range(n_blocks):
                stride = 2 if (i > 0 and b == 0) else 1
                blocks.append(BasicBlock(cin, planes, stride, ngroups, dtype))
                cin = planes
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
        for _ in range(2 + len(SPECS[backbone]) - 1):  # stem, pool, 3 strided stages
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
