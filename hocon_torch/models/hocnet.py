"""HOCNet: ResNet trunk -> MANO, absolute and object-pose heads.

Port of ``hocon/models/hocnet.py``; the output dict has the same keys and
units (camera-space meters, root-centred millimetres, pixels).
"""

from __future__ import annotations

import functools

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
from hocon_torch.models.graphs import Graphs, graphed_mano, graphed_model
from hocon_torch.models.heads import MLP, AbsoluteHead, ManoHead, ObjPoseHead, camera_space
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

    On the card, the trunk and the heads' regressions (images to
    ``pose_pca``, ``betas``, ``root_rot``, ``trans`` and, where the object
    head runs, ``obj_rot`` and ``obj_trans``) replay one CUDA graph forward
    and one backward, and MANO's forward and backward two more, one pair
    per signature, all held in ``graphs`` (``hocon_torch.models.graphs``);
    the cache is not in the state dict, and a deep copy starts an empty
    one. Trainable batch norm over a data-parallel mesh reduces its
    statistics in a collective, which a capture cannot hold: that trunk
    runs eagerly.
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
        self.graphs = Graphs()

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
        # Spans: the trunk with the heads' regressions (one graph replay on
        # the card); MANO's forward; the rest, in camera space.
        with_obj = self.obj_head is not None and obj_verts_can is not None
        regress = functools.partial(self._regress, with_obj=with_obj)
        with span("model.trunk"):
            if self._collective_norms():
                heads = regress(images)
            else:
                heads = graphed_model(self.graphs, self, regress, (images,), (with_obj,))
        pose_pca, betas, root_rot, trans = heads[:4]
        with span("model.mano"):
            verts_m, joints_m = graphed_mano(self.graphs, mano_forward, mano, pose_pca, betas,
                                             root_rot)
        with span("model.heads"):
            out = {"pose_pca": pose_pca, "betas": betas, "root_rot": root_rot, "trans": trans,
                   **camera_space(verts_m, joints_m, trans, camintr, self.center_idx)}
            if with_obj:
                obj_rot, obj_trans = heads[4:]
                obj_cam = transform_points(obj_verts_can, obj_rot, obj_trans)
                out.update(
                    obj_rot=obj_rot,
                    obj_trans=obj_trans,
                    obj_verts_cam=obj_cam,
                    obj_verts_c_mm=(obj_cam - out["center_cam"]) * 1000.0,
                    obj_verts2d=persp_project(obj_cam, camintr),
                )
        return out

    def _regress(self, images: torch.Tensor, with_obj: bool) -> tuple:
        """Images to the heads' regressions: (pose_pca, betas, root_rot,
        trans) and, ``with_obj``, (obj_rot, obj_trans)."""
        feats = self.trunk(images)
        out = (*self.mano_head(feats), self.absolute_head(feats))
        if with_obj:
            out += self.obj_head(feats)
        return out

    def _collective_norms(self) -> bool:
        """Whether the trunk's batch norm reduces its statistics over a
        data-parallel mesh (trainable, under ``sharding.replicate``)."""
        return not self.freeze_batchnorm and any(
            isinstance(m, BatchNorm2d) and m.mesh is not None for m in self.trunk.modules())
