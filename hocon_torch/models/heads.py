"""Regression heads, and the hand in camera space.

Port of ``hocon/models/heads.py``: separate MLPs for pose and shape, and
for object translation and rotation, as in the Flax tree. Each MLP's layers
are ``layers.{i}``, the counterpart of Flax's ``Dense_{i}``.
``camera_space`` is the tail every model's output shares.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from hocon_torch.geometry.project import persp_project
from hocon_torch.geometry.rot import rodrigues, rot6d_to_matrix
from hocon_torch.models.backbone import lecun_normal_


@functools.cache
def _constant(values: tuple[float, ...], device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``values`` as a tensor on ``device``, made once per (values, device,
    dtype): ``new_tensor`` copies from the host, and waits on the stream, at
    every call (and a CUDA graph cannot hold that copy). The sums with it
    give ``new_tensor``'s bits."""
    return torch.tensor(values, dtype=dtype, device=device)


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
        return out + _constant((0.0, 0.0, self.z_init), out.device, out.dtype)


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
        trans = trans + _constant((0.0, 0.0, self.z_init), trans.device, trans.dtype)
        if self.objrot_mlp is None:
            eye = torch.eye(3, dtype=feats.dtype, device=feats.device)
            return eye.expand(feats.shape[:-1] + (3, 3)), trans
        raw = self.objrot_mlp(feats)
        if self.rot_param == "6d":
            rot = rot6d_to_matrix(raw + _constant((1.0, 0.0, 0.0, 0.0, 1.0, 0.0), raw.device,
                                                  raw.dtype))
        else:
            rot = rodrigues(raw)
        return rot, trans


def camera_space(
    verts_m: torch.Tensor,  # (B, V, 3) MANO's vertices, meters
    joints_m: torch.Tensor,  # (B, 21, 3) MANO's joints, meters
    trans: torch.Tensor,  # (B, 3) the hand's translation, meters
    camintr: torch.Tensor,  # (B, 3, 3)
    center_idx: int,
) -> dict:
    """MANO's hand moved by ``trans`` into camera space: ``verts_cam`` and
    ``joints_cam`` (meters), ``verts_c_mm`` and ``joints_c_mm`` (millimetres
    from the joint ``center_idx``), ``joints2d`` and ``verts2d`` (pixels) and
    ``center_cam`` (that joint, (B, 1, 3)): the keys the losses, the warp and
    the evaluation read of every model."""
    verts_cam = verts_m + trans[:, None]
    joints_cam = joints_m + trans[:, None]
    center = joints_cam[:, center_idx : center_idx + 1]
    return {
        "verts_cam": verts_cam,
        "joints_cam": joints_cam,
        "verts_c_mm": (verts_cam - center) * 1000.0,
        "joints_c_mm": (joints_cam - center) * 1000.0,
        "joints2d": persp_project(joints_cam, camintr),
        "verts2d": persp_project(verts_cam, camintr),
        "center_cam": center,
    }
