"""ResNet trunk returning pooled features.

Port of ``hocon/models/backbone.py``: BasicBlock / Bottleneck ResNets with
explicit (1, 1) padding (torch semantics), batch norm frozen on its running
statistics, and an optional bf16 compute type that applies inside the trunk
only (``torch.autocast``); the pooled features come out in f32.

Module names follow the Flax tree (``conv_init``, ``bn_init``, blocks
numbered across stages, ``conv_proj`` / ``norm_proj``) so that
``hocon_torch.utils.flax_weights`` maps one onto the other by name.
Images arrive NHWC; ``x.permute(0, 3, 1, 2)`` of a contiguous NHWC tensor is
already channels-last in memory, which is the layout cuDNN prefers.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

STAGE_SIZES = {
    "resnet18": (2, 2, 2, 2),
    "resnet34": (3, 4, 6, 3),
    "resnet50": (3, 4, 6, 3),
}

BN_EPS = 1e-5


class FrozenBatchNorm2d(nn.Module):
    """Batch norm on running statistics only (Flax ``use_running_average``).

    Buffers and parameter names match ``nn.BatchNorm2d`` so state dicts
    carry the usual ``weight``/``bias``/``running_mean``/``running_var``.
    """

    def __init__(self, channels: int, zero_scale: bool = False):
        super().__init__()
        self.weight = nn.Parameter(
            torch.zeros(channels) if zero_scale else torch.ones(channels)
        )
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(
            x, self.running_mean, self.running_var, self.weight, self.bias,
            training=False, eps=BN_EPS,
        )


def _conv(cin: int, cout: int, k: int, stride: int = 1, pad: int = 0) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=pad, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int):
        super().__init__()
        self.conv0 = _conv(cin, filters, 3, stride, 1)
        self.bn0 = FrozenBatchNorm2d(filters)
        self.conv1 = _conv(filters, filters, 3, 1, 1)
        self.bn1 = FrozenBatchNorm2d(filters, zero_scale=True)
        if stride != 1 or cin != filters:
            self.conv_proj = _conv(cin, filters, 1, stride)
            self.norm_proj = FrozenBatchNorm2d(filters)
        else:
            self.conv_proj = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn0(self.conv0(x)))
        y = self.bn1(self.conv1(y))
        res = x if self.conv_proj is None else self.norm_proj(self.conv_proj(x))
        return F.relu(res + y)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int):
        super().__init__()
        self.conv0 = _conv(cin, filters, 1)
        self.bn0 = FrozenBatchNorm2d(filters)
        self.conv1 = _conv(filters, filters, 3, stride, 1)
        self.bn1 = FrozenBatchNorm2d(filters)
        self.conv2 = _conv(filters, filters * 4, 1)
        self.bn2 = FrozenBatchNorm2d(filters * 4, zero_scale=True)
        if stride != 1 or cin != filters * 4:
            self.conv_proj = _conv(cin, filters * 4, 1, stride)
            self.norm_proj = FrozenBatchNorm2d(filters * 4)
        else:
            self.conv_proj = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn0(self.conv0(x)))
        y = F.relu(self.bn1(self.conv1(y)))
        y = self.bn2(self.conv2(y))
        res = x if self.conv_proj is None else self.norm_proj(self.conv_proj(x))
        return F.relu(res + y)


class ResNet(nn.Module):
    """ResNet returning pooled (B, C_out) f32 features from NHWC images.

    ``dtype=torch.bfloat16`` runs the trunk under bf16 autocast (parameters
    stay f32), as the reference's ``dtype=jnp.bfloat16`` does.
    """

    def __init__(
        self,
        stage_sizes,
        block,
        num_filters: int = 64,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dtype = dtype
        self.conv_init = _conv(3, num_filters, 7, 2, 3)
        self.bn_init = FrozenBatchNorm2d(num_filters)
        blocks = []
        cin = num_filters
        for i, n in enumerate(stage_sizes):
            for j in range(n):
                stride = 2 if i > 0 and j == 0 else 1
                filters = num_filters * 2**i
                blocks.append(block(cin, filters, stride))
                cin = filters * block.expansion
        self.blocks = nn.ModuleList(blocks)
        self.out_features = cin

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2)  # NHWC storage, NCHW view
        with torch.autocast(
            device_type=x.device.type,
            dtype=self.dtype,
            enabled=self.dtype != torch.float32,
        ):
            x = F.relu(self.bn_init(self.conv_init(x)))
            x = F.max_pool2d(x, 3, stride=2, padding=1)
            for blk in self.blocks:
                x = blk(x)
        return x.mean(dim=(2, 3)).float()


def resnet18(**kw) -> ResNet:
    return ResNet(STAGE_SIZES["resnet18"], BasicBlock, **kw)


def resnet34(**kw) -> ResNet:
    return ResNet(STAGE_SIZES["resnet34"], BasicBlock, **kw)


def resnet50(**kw) -> ResNet:
    return ResNet(STAGE_SIZES["resnet50"], Bottleneck, **kw)


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """Flax's default kernel init: truncated normal, variance 1 / fan_in.

    0.8796 is the std of a unit normal truncated at +-2, so the kept draws
    have the target variance, as ``variance_scaling`` does it.
    """
    fan_in = w[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
