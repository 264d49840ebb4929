"""Query system.

Port of ``hocon/data/queries.py``: ``BaseQueries`` (raw ground truth a
dataset can serve) and ``TransQueries`` (the post-augmentation arrays the
model consumes), with the same string values, so batches of both packages
share their keys.
"""

from __future__ import annotations

import enum


class BaseQueries(str, enum.Enum):
    IMAGE = "base_image"
    JOINTS2D = "base_joints2d"
    JOINTS3D = "base_joints3d"
    VERTS3D = "base_verts3d"
    OBJVERTS3D = "base_objverts3d"
    OBJCORNERS = "base_objcorners"
    OBJVERTSCAN = "base_objverts_can"
    OBJFACES = "base_objfaces"
    OBJPOSE = "base_objpose"
    CAMINTR = "base_camintr"
    SIDE = "base_side"
    CENTER3D = "base_center3d"


class TransQueries(str, enum.Enum):
    IMAGE = "image"
    JOINTS2D = "joints2d"
    JOINTS3D = "joints3d"  # root-centered mm
    VERTS3D = "verts3d"  # root-centered mm
    OBJVERTS3D = "objverts3d"  # root-centered mm
    OBJCORNERS = "objcorners3d"  # posed bbox corners, root-centered mm
    OBJCORNERSCAN = "obj_corners_can"  # canonical bbox corners, meters
    OBJVERTSCAN = "obj_verts_can"  # canonical, meters
    CAMINTR = "camintr"  # crop-adjusted intrinsics
    CENTER3D = "center3d"  # hand center in camera frame, meters
    SUP_MASK = "sup_mask"  # 1.0 if this sample carries full supervision
    JOINTS_CAM = "joints_cam"  # absolute camera-frame joints, meters


def one_query_in(requested, available) -> bool:
    return any(q in available for q in requested)
