"""HOCNet: ResNet trunk -> MANO, absolute and object-pose heads.

Port of ``hocon/models/hocnet.py``; the output dict has the same keys and
units (camera-space meters, root-centred millimetres, pixels).
"""

from __future__ import annotations

import torch
from torch import nn

from hocon_torch.device import resolve_device
from hocon_torch.geometry.mano import ManoModel, mano_forward
from hocon_torch.geometry.project import persp_project, transform_points
from hocon_torch.models.backbone import (
    BatchNorm2d,
    lecun_normal_,
    resnet18,
    resnet34,
    resnet50,
)
from hocon_torch.models.heads import MLP, AbsoluteHead, ManoHead, ObjPoseHead
from hocon_torch.utils.trace import span

_BACKBONES = {"resnet18": resnet18, "resnet34": resnet34, "resnet50": resnet50}


class HOCNet(nn.Module):
    """Hand-object network.

    ``freeze_batchnorm`` (the default, as the reference's) keeps batch norm
    on its running statistics; with False, batch norm in training mode
    (``model.train()``) normalises with the batch's statistics and updates
    the running ones as Flax does, and in eval mode uses the running ones
    (``hocon_torch.models.backbone.BatchNorm2d``).

    Weights are initialised on the CPU from ``seed`` through a
    ``torch.Generator`` as Flax initialises them (lecun-normal kernels, zero
    biases, zero scale on each block's last norm, near-zero output layers),
    then moved to ``device`` (CUDA if None). Load Flax weights with
    ``hocon_torch.utils.flax_weights.load_flax_variables``.
    """

    def __init__(
        self,
        ncomps: int = 15,
        center_idx: int = 9,
        with_object: bool = True,
        block_rot: bool = False,
        obj_rot_param: str = "6d",
        backbone: str = "resnet18",
        freeze_batchnorm: bool = True,
        z_init: float = 0.6,
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
        device: str | torch.device | None = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.center_idx = center_idx
        self.with_object = with_object
        self.freeze_batchnorm = freeze_batchnorm
        self.trunk = _BACKBONES[backbone](dtype=dtype, freeze_batchnorm=freeze_batchnorm)
        nf = self.trunk.out_features
        self.mano_head = ManoHead(nf, ncomps=ncomps)
        self.absolute_head = AbsoluteHead(nf, z_init=z_init)
        self.obj_head = (
            ObjPoseHead(nf, rot_param=obj_rot_param, block_rot=block_rot,
                        z_init=z_init)
            if with_object else None
        )
        self.reset_parameters(torch.Generator().manual_seed(seed))
        self.to(dev)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, generator)
            elif isinstance(m, MLP):
                m.reset_parameters(generator)
            elif isinstance(m, BatchNorm2d):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)

    def forward(
        self,
        images: torch.Tensor,  # (B, H, W, 3), normalized
        camintr: torch.Tensor,  # (B, 3, 3)
        mano: ManoModel,
        obj_verts_can: torch.Tensor | None = None,  # (B, Vo, 3) meters
    ) -> dict:
        # Spans: the trunk; MANO's forward; the heads and everything else
        # around it (two ranges of one name).
        with span("model.trunk"):
            feats = self.trunk(images)
        with span("model.heads"):
            pose_pca, betas, root_rot = self.mano_head(feats)
            trans = self.absolute_head(feats)
        with span("model.mano"):
            verts_m, joints_m = mano_forward(
                mano, pose_pca, betas, root_rot, scale_mm=False
            )
        with span("model.heads"):
            verts_cam = verts_m + trans[:, None]
            joints_cam = joints_m + trans[:, None]
            center = joints_cam[:, self.center_idx : self.center_idx + 1]
            out = {
                "pose_pca": pose_pca,
                "betas": betas,
                "root_rot": root_rot,
                "trans": trans,
                "verts_cam": verts_cam,
                "joints_cam": joints_cam,
                "verts_c_mm": (verts_cam - center) * 1000.0,
                "joints_c_mm": (joints_cam - center) * 1000.0,
                "joints2d": persp_project(joints_cam, camintr),
                "verts2d": persp_project(verts_cam, camintr),
                "center_cam": center,
            }
            if self.obj_head is not None and obj_verts_can is not None:
                obj_rot, obj_trans = self.obj_head(feats)
                obj_cam = transform_points(obj_verts_can, obj_rot, obj_trans)
                out.update(
                    obj_rot=obj_rot,
                    obj_trans=obj_trans,
                    obj_verts_cam=obj_cam,
                    obj_verts_c_mm=(obj_cam - center) * 1000.0,
                    obj_verts2d=persp_project(obj_cam, camintr),
                )
        return out
