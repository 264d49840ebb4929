"""The model layers that every family shares, in plain PyTorch: the MANO
layer, the rotation and projection helpers and Flax's lecun-normal scale.

The MANO layer and the pinhole projection are written from the published
description (Romero et al., SIGGRAPH Asia 2017; Hasson et al., CVPR 2020)
and kept op for op in the order the port computes them, so that the two
agree to rounding. Each family's model (``reference/families/``) builds on
these.

Imports nothing of ``hocon``, ``hocon_torch`` or JAX.
"""

from __future__ import annotations

import math

import torch

EPS = 1e-8
MANO_PARENTS = (-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14)
FINGERTIP_VERT_IDS = (745, 317, 444, 556, 673)
JOINT_REORDER = (0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18, 10, 11, 12, 19, 7, 8, 9, 20)


def rodrigues(aa):
    theta_sq = torch.sum(aa * aa, dim=-1)
    theta = torch.sqrt(theta_sq + EPS * EPS)
    small = theta_sq < 1e-8
    sin_over = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    cos_term = torch.where(small, 0.5 - theta_sq / 24.0,
                           (1.0 - torch.cos(theta)) / (theta_sq + EPS * EPS))
    x, y, z = aa[..., 0], aa[..., 1], aa[..., 2]
    zeros = torch.zeros_like(x)
    k = torch.stack([torch.stack([zeros, -z, y], dim=-1),
                     torch.stack([z, zeros, -x], dim=-1),
                     torch.stack([-y, x, zeros], dim=-1)], dim=-2)
    k2 = torch.matmul(k, k)
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(k.shape)
    return eye + sin_over[..., None, None] * k + cos_term[..., None, None] * k2


def rot6d_to_matrix(x):
    a1, a2 = x[..., 0:3], x[..., 3:6]
    b1 = a1 / (torch.linalg.norm(a1, dim=-1, keepdim=True) + EPS)
    a2p = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2p / (torch.linalg.norm(a2p, dim=-1, keepdim=True) + EPS)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2).transpose(-1, -2)


def persp_project(points, camintr):
    hom = torch.einsum("...ij,...nj->...ni", camintr, points)
    return hom[..., :2] / (hom[..., 2:3] + EPS)


def transform_points(points, rot, trans):
    return torch.einsum("...ij,...nj->...ni", rot, points) + trans[..., None, :]


def mano_forward(mano: dict, pose_pca, betas, global_rot):
    """MANO in meters: PCA pose decode (plus the mean pose), Rodrigues,
    shape and pose blendshapes, joint regression, forward kinematics,
    linear blend skinning, fingertips and the 21-joint order."""
    b, dtype = pose_pca.shape[0], pose_pca.dtype
    full_pose = pose_pca @ mano["hands_components"][: pose_pca.shape[-1]] + mano["hands_mean"]
    rots = rodrigues(torch.cat([global_rot, full_pose], dim=-1).reshape(b, 16, 3))
    v_shaped = mano["v_template"][None] + torch.einsum("vds,bs->bvd", mano["shapedirs"], betas)
    j_rest = torch.einsum("jv,bvd->bjd", mano["joint_regressor"], v_shaped)
    eye = torch.eye(3, dtype=dtype, device=rots.device)
    pose_feat = (rots[:, 1:] - eye).reshape(b, 135)
    v_posed = v_shaped + torch.einsum("vdp,bp->bvd", mano["posedirs"], pose_feat)
    rel = [j_rest[:, 0]] + [j_rest[:, j] - j_rest[:, MANO_PARENTS[j]] for j in range(1, 16)]
    top = torch.cat([rots, torch.stack(rel, dim=1)[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=rots.device)
    local = torch.cat([top, bottom.expand(top.shape[:-2] + (1, 4))], dim=-2)
    glob = [local[:, 0]]
    for j in range(1, 16):
        glob.append(torch.matmul(glob[MANO_PARENTS[j]], local[:, j]))
    g = torch.stack(glob, dim=1)
    joints_kin = g[..., :3, 3]
    correction = torch.einsum("bjrc,bjc->bjr", g[..., :3, :3], j_rest)
    t_rot = torch.einsum("vj,bjrc->bvrc", mano["skin_weights"], g[..., :3, :3])
    t_t = torch.einsum("vj,bjr->bvr", mano["skin_weights"], g[..., :3, 3] - correction)
    verts = torch.einsum("bvrc,bvc->bvr", t_rot, v_posed) + t_t
    tips = verts[:, list(FINGERTIP_VERT_IDS)]
    joints = torch.cat([joints_kin, tips], dim=1)[:, list(JOINT_REORDER)]
    return verts, joints


def lecun_std(shape) -> float:
    """Flax's lecun-normal std for a kernel of ``shape`` (torch layout), over
    the std of a unit normal truncated at +-2."""
    fan_in = math.prod(shape[1:])
    return math.sqrt(1.0 / fan_in) / 0.87962566103423978
