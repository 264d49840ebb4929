"""Supervised losses with per-sample supervision masks.

Port of ``hocon/models/losses.py``: masked means over annotated samples,
regularizers over every sample.
"""

from __future__ import annotations

import torch


def _masked_mean(per_sample: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.sum(per_sample * mask) / (torch.sum(mask) + 1e-6)


def _mse(pred, gt, dims):
    return torch.mean((pred - gt) ** 2, dim=dims)


def hand_losses(
    pred: dict,
    gt: dict,
    sup_mask: torch.Tensor,
    lambda_verts3d: float = 0.167,
    lambda_joints3d: float = 0.167,
    lambda_joints2d: float = 0.5,
    lambda_shape: float = 1e-6,
    lambda_pose: float = 1e-6,
) -> tuple[torch.Tensor, dict]:
    """Hand supervision: 3D terms in centred mm, 2D in pixels."""
    terms = {}
    total = 0.0
    if "verts_c_mm" in gt:
        v = _masked_mean(_mse(pred["verts_c_mm"], gt["verts_c_mm"], (1, 2)), sup_mask)
        terms["loss_hand_verts3d"] = v
        total = total + lambda_verts3d * v
    if "joints_c_mm" in gt:
        j = _masked_mean(
            _mse(pred["joints_c_mm"], gt["joints_c_mm"], (1, 2)), sup_mask
        )
        terms["loss_hand_joints3d"] = j
        total = total + lambda_joints3d * j
    if lambda_joints2d > 0 and "joints2d" in gt:
        j2 = _masked_mean(_mse(pred["joints2d"], gt["joints2d"], (1, 2)), sup_mask)
        terms["loss_hand_joints2d"] = j2
        total = total + lambda_joints2d * j2
    reg_b = torch.mean(torch.sum(pred["betas"] ** 2, dim=-1))
    reg_p = torch.mean(torch.sum(pred["pose_pca"] ** 2, dim=-1))
    terms["reg_shape"] = reg_b
    terms["reg_pose"] = reg_p
    total = total + lambda_shape * reg_b + lambda_pose * reg_p
    terms["loss_hand_total"] = total
    return total, terms


def object_losses(
    pred: dict,
    gt: dict,
    sup_mask: torch.Tensor,
    lambda_obj_verts3d: float = 0.167,
    lambda_obj_verts2d: float = 0.0,
) -> tuple[torch.Tensor, dict]:
    """Object supervision: posed canonical-mesh vertices, centred mm + px."""
    terms = {}
    total = 0.0
    if "obj_verts_c_mm" in gt and "obj_verts_c_mm" in pred:
        err = (pred["obj_verts_c_mm"] - gt["obj_verts_c_mm"]) ** 2  # (B,Vo,3)
        if "obj_verts_mask" in gt:
            vm = gt["obj_verts_mask"][..., None]
            per_sample = torch.sum(err * vm, dim=(1, 2)) / (
                torch.sum(vm, dim=(1, 2)) * 3.0 + 1e-6
            )
        else:
            per_sample = torch.mean(err, dim=(1, 2))
        v = _masked_mean(per_sample, sup_mask)
        terms["loss_obj_verts3d"] = v
        total = total + lambda_obj_verts3d * v
    if lambda_obj_verts2d > 0 and "obj_verts2d" in gt and "obj_verts2d" in pred:
        v2 = _masked_mean(
            _mse(pred["obj_verts2d"], gt["obj_verts2d"], (1, 2)), sup_mask
        )
        terms["loss_obj_verts2d"] = v2
        total = total + lambda_obj_verts2d * v2
    terms["loss_obj_total"] = total
    return total, terms


def total_supervised_loss(
    pred: dict,
    gt: dict,
    sup_mask: torch.Tensor,
    hand_lambdas: dict | None = None,
    obj_lambdas: dict | None = None,
) -> tuple[torch.Tensor, dict]:
    h, ht = hand_losses(pred, gt, sup_mask, **(hand_lambdas or {}))
    total = h
    terms = dict(ht)
    if "obj_verts_c_mm" in pred:
        o, ot = object_losses(pred, gt, sup_mask, **(obj_lambdas or {}))
        total = total + o
        terms.update(ot)
    terms["loss_total"] = total
    return total, terms
