"""Regression heads.

Port of ``hocon/models/heads.py``: separate MLPs for pose and shape, and
for object translation and rotation, as in the Flax tree. Each MLP's layers
are ``layers.{i}``, the counterpart of Flax's ``Dense_{i}``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from hocon_torch.geometry.rot import rodrigues, rot6d_to_matrix
from hocon_torch.models.backbone import lecun_normal_


class MLP(nn.Module):
    """ReLU MLP whose output layer starts near zero (std ``out_init_scale``)."""

    def __init__(
        self,
        in_dim: int,
        hidden: Sequence[int],
        out_dim: int,
        out_init_scale: float = 1e-3,
    ):
        super().__init__()
        dims = [in_dim, *hidden, out_dim]
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:])
        )
        self.out_init_scale = out_init_scale

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in self.layers[:-1]:
            lecun_normal_(layer.weight, generator)
            nn.init.zeros_(layer.bias)
        out = self.layers[-1]
        nn.init.normal_(out.weight, std=self.out_init_scale, generator=generator)
        nn.init.zeros_(out.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = F.relu(layer(x))
        return self.layers[-1](x)


class ManoHead(nn.Module):
    """Features -> (pose PCA coeffs, shape betas, root axis-angle)."""

    def __init__(self, in_dim: int, ncomps: int = 15, hidden: Sequence[int] = (512, 512)):
        super().__init__()
        self.ncomps = ncomps
        self.pose_mlp = MLP(in_dim, hidden, ncomps + 3)
        self.shape_mlp = MLP(in_dim, hidden, 10)

    def forward(self, feats: torch.Tensor):
        out = self.pose_mlp(feats)
        return out[..., : self.ncomps], self.shape_mlp(feats), out[..., self.ncomps :]


class AbsoluteHead(nn.Module):
    """Features -> root translation (meters) around depth ``z_init``."""

    def __init__(self, in_dim: int, hidden: Sequence[int] = (512,), z_init: float = 0.6):
        super().__init__()
        self.trans_mlp = MLP(in_dim, hidden, 3)
        self.z_init = z_init

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        out = self.trans_mlp(feats)
        return out + out.new_tensor([0.0, 0.0, self.z_init])


class ObjPoseHead(nn.Module):
    """Features -> object rotation matrix + translation (meters).

    ``block_rot`` freezes the rotation at identity and builds no rotation MLP.
    """

    def __init__(
        self,
        in_dim: int,
        hidden: Sequence[int] = (512,),
        rot_param: str = "6d",
        block_rot: bool = False,
        z_init: float = 0.6,
    ):
        super().__init__()
        if rot_param not in ("6d", "axisang"):
            raise ValueError(f"unknown rot_param {rot_param!r}")
        self.rot_param = rot_param
        self.block_rot = block_rot
        self.z_init = z_init
        self.objtrans_mlp = MLP(in_dim, hidden, 3)
        if block_rot:
            self.objrot_mlp = None
        else:
            self.objrot_mlp = MLP(in_dim, hidden, 6 if rot_param == "6d" else 3)

    def forward(self, feats: torch.Tensor):
        trans = self.objtrans_mlp(feats)
        trans = trans + trans.new_tensor([0.0, 0.0, self.z_init])
        if self.objrot_mlp is None:
            eye = torch.eye(3, dtype=feats.dtype, device=feats.device)
            return eye.expand(feats.shape[:-1] + (3, 3)), trans
        raw = self.objrot_mlp(feats)
        if self.rot_param == "6d":
            rot = rot6d_to_matrix(raw + raw.new_tensor([1.0, 0, 0, 0, 1.0, 0]))
        else:
            rot = rodrigues(raw)
        return rot, trans
