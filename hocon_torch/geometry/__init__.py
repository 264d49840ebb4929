"""Geometry: rotations, projection and the MANO layer."""

from hocon_torch.geometry.project import persp_project, transform_points
from hocon_torch.geometry.rot import (
    matrix_to_rodrigues,
    rodrigues,
    rot6d_to_matrix,
    with_zeros_4x4,
)
