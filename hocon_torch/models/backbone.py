"""ResNet trunk returning pooled features.

Port of ``hocon/models/backbone.py``: BasicBlock / Bottleneck ResNets with
explicit (1, 1) padding (torch semantics), batch norm frozen on its running
statistics by default or trainable as Flax's (``freeze_batchnorm=False``),
and an optional bf16 compute type that applies inside the trunk only
(``torch.autocast``); the pooled features come out in f32.

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

from hocon_torch.train.sharding import global_mean

STAGE_SIZES = {
    "resnet18": (2, 2, 2, 2),
    "resnet34": (3, 4, 6, 3),
    "resnet50": (3, 4, 6, 3),
}

BN_EPS = 1e-5


class BatchNorm2d(nn.Module):
    """Batch norm as Flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``.

    ``frozen`` (the reference's ``freeze_batchnorm``), or the module in eval
    mode: normalise with the running statistics (``use_running_average``).
    Otherwise, in training mode: normalise with the batch's statistics and
    update the running ones as Flax does (``_compute_stats``):

    - mean E[x] and the *biased* variance E[x^2] - E[x]^2, clipped at 0,
      both reduced in f32 even when the trunk runs in bf16 autocast;
    - running = 0.9 * running + 0.1 * batch, under no gradient;
    - under a data-parallel ``mesh`` (set by ``sharding.replicate``) both
      moments are averaged over the ranks by a differentiable all-reduce:
      the statistics of the global batch, as Flax computes them under
      ``hocon``'s data mesh, forward and backward, and the same running
      statistics on every rank. ``nn.SyncBatchNorm`` refuses CPU tensors.

    ``F.batch_norm(training=True)`` would update ``running_var`` with the
    unbiased variance (16/15 of the biased one over the 2 x 2 x 4 values of
    a 64 px batch of 4 at the last stage). Parameter and buffer names are
    ``nn.BatchNorm2d``'s, without its ``num_batches_tracked``, so state
    dicts carry ``weight`` / ``bias`` / ``running_mean`` / ``running_var``
    only (the keys of the Flax bridge).
    """

    MOMENTUM = 0.9

    def __init__(self, channels: int, zero_scale: bool = False, frozen: bool = True):
        super().__init__()
        self.frozen = frozen
        self.weight = nn.Parameter(
            torch.zeros(channels) if zero_scale else torch.ones(channels)
        )
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.mesh = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.frozen or not self.training:
            return F.batch_norm(
                x, self.running_mean, self.running_var, self.weight, self.bias,
                training=False, eps=BN_EPS,
            )
        xf = x.float()
        moments = torch.stack([xf.mean(dim=(0, 2, 3)), (xf * xf).mean(dim=(0, 2, 3))])
        mean, mean_sq = global_mean(moments, self.mesh).unbind()
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.MOMENTUM
            self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


def _conv(cin: int, cout: int, k: int, stride: int = 1, pad: int = 0) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=pad, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int, freeze_batchnorm: bool = True):
        super().__init__()
        self.conv0 = _conv(cin, filters, 3, stride, 1)
        self.bn0 = BatchNorm2d(filters, frozen=freeze_batchnorm)
        self.conv1 = _conv(filters, filters, 3, 1, 1)
        self.bn1 = BatchNorm2d(filters, zero_scale=True, frozen=freeze_batchnorm)
        if stride != 1 or cin != filters:
            self.conv_proj = _conv(cin, filters, 1, stride)
            self.norm_proj = BatchNorm2d(filters, frozen=freeze_batchnorm)
        else:
            self.conv_proj = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn0(self.conv0(x)))
        y = self.bn1(self.conv1(y))
        res = x if self.conv_proj is None else self.norm_proj(self.conv_proj(x))
        return F.relu(res + y)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int, freeze_batchnorm: bool = True):
        super().__init__()
        self.conv0 = _conv(cin, filters, 1)
        self.bn0 = BatchNorm2d(filters, frozen=freeze_batchnorm)
        self.conv1 = _conv(filters, filters, 3, stride, 1)
        self.bn1 = BatchNorm2d(filters, frozen=freeze_batchnorm)
        self.conv2 = _conv(filters, filters * 4, 1)
        self.bn2 = BatchNorm2d(filters * 4, zero_scale=True, frozen=freeze_batchnorm)
        if stride != 1 or cin != filters * 4:
            self.conv_proj = _conv(cin, filters * 4, 1, stride)
            self.norm_proj = BatchNorm2d(filters * 4, frozen=freeze_batchnorm)
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
        freeze_batchnorm: bool = True,
    ):
        super().__init__()
        self.dtype = dtype
        self.conv_init = _conv(3, num_filters, 7, 2, 3)
        self.bn_init = BatchNorm2d(num_filters, frozen=freeze_batchnorm)
        blocks = []
        cin = num_filters
        for i, n in enumerate(stage_sizes):
            for j in range(n):
                stride = 2 if i > 0 and j == 0 else 1
                filters = num_filters * 2**i
                blocks.append(block(cin, filters, stride, freeze_batchnorm))
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
