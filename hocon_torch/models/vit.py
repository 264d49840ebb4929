"""ViT trunk in ViTPose's layout, as HaMeR uses it.

Written from ``hamer/models/backbones/vit.py`` (ViTPose; Xu et al., NeurIPS
2022; Pavlakos et al., CVPR 2024): a 16 x 16 patch convolution with stride
16 and padding 2, a learned absolute position embedding of which each token
gets ``pos_embed[1:] + pos_embed[:1]``, pre-norm blocks (LayerNorm at eps
1e-6, multi-head self-attention with a qkv bias, an exact-GELU MLP) and a
last LayerNorm. Parameter names follow ViTPose's. HaMeR's ViT-H/16 is
``ViT(img_size=(256, 192), dim=1280, depth=32, heads=16)``: 192 tokens of
a 256 x 192 input.

Departure: drop-path (0.55 in HaMeR) is left out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from hocon_torch.models.attention import attention

LN_EPS = 1e-6
PATCH_PADDING = 2  # ViTPose's at ratio 1: 16 x 12 tokens of a 256 x 192 input


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int = 16):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch, padding=PATCH_PADDING)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) -> (B, tokens, dim), tokens in row-major order."""
        return self.proj(x).flatten(2).transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4)
        out = attention(qkv[0], qkv[1], qkv[2])
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, mlp_ratio * dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class ViT(nn.Module):
    """(B, 3, H, W) images of ``img_size`` -> (B, tokens, dim) tokens after
    the last norm."""

    def __init__(
        self,
        img_size: tuple[int, int] = (256, 192),
        patch: int = 16,
        dim: int = 1280,
        depth: int = 32,
        heads: int = 16,
        mlp_ratio: int = 4,
    ):
        super().__init__()
        self.patch_embed = PatchEmbed(dim, patch)
        tokens = (img_size[0] // patch) * (img_size[1] // patch)
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens + 1, dim))
        self.blocks = nn.ModuleList(Block(dim, heads, mlp_ratio) for _ in range(depth))
        self.last_norm = nn.LayerNorm(dim, eps=LN_EPS)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """As ViTPose initialises it: linear weights and ``pos_embed`` from
        a normal of std 0.02 truncated at +-2 (timm's bounds, absolute),
        zero linear biases, LayerNorm at 1 and 0; the patch convolution at
        PyTorch's default (uniform at +-1 / sqrt(fan-in), weight and bias)."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, std=0.02, generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        proj = self.patch_embed.proj
        bound = proj.weight[0].numel() ** -0.5
        proj.weight.uniform_(-bound, bound, generator=generator)
        proj.bias.uniform_(-bound, bound, generator=generator)
        nn.init.trunc_normal_(self.pos_embed, std=0.02, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x)
        x = x + self.pos_embed[:, 1:] + self.pos_embed[:, :1]
        for blk in self.blocks:
            x = blk(x)
        return self.last_norm(x)
