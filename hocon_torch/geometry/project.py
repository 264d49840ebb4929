"""Batched pinhole projection and rigid transforms.

Port of ``hocon/geometry/project.py``.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def persp_project(points3d: torch.Tensor, camintr: torch.Tensor) -> torch.Tensor:
    """Camera-space points (..., N, 3) through intrinsics (..., 3, 3) to
    pixels (..., N, 2)."""
    hom = torch.einsum("...ij,...nj->...ni", camintr, points3d)
    return hom[..., :2] / (hom[..., 2:3] + _EPS)


def transform_points(
    points: torch.Tensor, rot: torch.Tensor, trans: torch.Tensor
) -> torch.Tensor:
    """``p' = R p + t`` for points (..., N, 3), rot (..., 3, 3), trans (..., 3)."""
    return torch.einsum("...ij,...nj->...ni", rot, points) + trans[..., None, :]
