"""HOCNet in plain PyTorch: the benchmark's reference for the model layers.

ResNet-18 trunk (frozen batch norm, bf16 autocast inside the trunk), the
MANO, absolute and object-pose heads, the MANO layer and the pinhole
projection, written from the published description (Hasson et al., CVPR
2020; hassony2/handobjectconsist) and kept op for op in the order the port
computes them, so that the two agree to rounding. Parameter names follow
the port's state dict, so one set of seeded weights loads into both.

Imports nothing of ``hocon``, ``hocon_torch`` or JAX.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
EPS = 1e-8
MANO_PARENTS = (-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14)
FINGERTIP_VERT_IDS = (745, 317, 444, 556, 673)
JOINT_REORDER = (0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18, 10, 11, 12, 19, 7, 8, 9, 20)


class FrozenBN(nn.Module):
    """Batch norm on its running statistics (``freeze_batchnorm``)."""

    def __init__(self, channels: int, zero_scale: bool = False):
        super().__init__()
        self.zero_scale = zero_scale
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, eps=BN_EPS)


def _conv(cin, cout, k, stride=1, pad=0):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=pad, bias=False)


class Block(nn.Module):
    """ResNet basic block; the last norm of the residual branch starts at zero."""

    def __init__(self, cin, filters, stride):
        super().__init__()
        self.conv0 = _conv(cin, filters, 3, stride, 1)
        self.bn0 = FrozenBN(filters)
        self.conv1 = _conv(filters, filters, 3, 1, 1)
        self.bn1 = FrozenBN(filters, zero_scale=True)
        if stride != 1 or cin != filters:
            self.conv_proj = _conv(cin, filters, 1, stride)
            self.norm_proj = FrozenBN(filters)
        else:
            self.conv_proj = None

    def forward(self, x):
        y = F.relu(self.bn0(self.conv0(x)))
        y = self.bn1(self.conv1(y))
        res = x if self.conv_proj is None else self.norm_proj(self.conv_proj(x))
        return F.relu(res + y)


class Trunk(nn.Module):
    """ResNet-18 on NHWC images; pooled f32 features."""

    def __init__(self, stage_sizes, widths, dtype):
        super().__init__()
        self.dtype = dtype
        self.conv_init = _conv(3, widths[0], 7, 2, 3)
        self.bn_init = FrozenBN(widths[0])
        blocks, cin = [], widths[0]
        for i, (n, filters) in enumerate(zip(stage_sizes, widths)):
            for j in range(n):
                blocks.append(Block(cin, filters, 2 if i > 0 and j == 0 else 1))
                cin = filters
        self.blocks = nn.ModuleList(blocks)
        self.out_features = cin

    def forward(self, images):
        x = images.permute(0, 3, 1, 2)  # channels-last storage, as the port feeds cuDNN
        with torch.autocast(device_type=x.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            x = F.relu(self.bn_init(self.conv_init(x)))
            x = F.max_pool2d(x, 3, stride=2, padding=1)
            for blk in self.blocks:
                x = blk(x)
        return x.mean(dim=(2, 3)).float()


class MLP(nn.Module):
    def __init__(self, dims):
        super().__init__()
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = F.relu(layer(x))
        return self.layers[-1](x)


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


class HOCNet(nn.Module):
    """Trunk -> MANO head (pose PCA + root rotation, shape), absolute head
    (root translation around ``z_init``), optional object head (6D rotation
    and translation of the known canonical mesh)."""

    def __init__(self, cfg: dict):
        super().__init__()
        m = cfg["model"]
        dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[m["trunk_dtype"]]
        self.center_idx, self.z_init = m["center_idx"], m["z_init"]
        self.ncomps = m["mano_ncomps"]
        self.trunk = Trunk(m["stage_sizes"], m["widths"], dtype)
        nf, hid = self.trunk.out_features, m["head_hidden"]
        self.mano_head = nn.Module()
        self.mano_head.pose_mlp = MLP([nf, hid, hid, self.ncomps + 3])
        self.mano_head.shape_mlp = MLP([nf, hid, hid, 10])
        self.absolute_head = nn.Module()
        self.absolute_head.trans_mlp = MLP([nf, hid, 3])
        self.obj_head = None
        if m["with_object"]:
            self.obj_head = nn.Module()
            self.obj_head.objtrans_mlp = MLP([nf, hid, 3])
            self.obj_head.objrot_mlp = MLP([nf, hid, 6])

    def forward(self, images, camintr, mano: dict, obj_verts_can=None) -> dict:
        feats = self.trunk(images)
        pose = self.mano_head.pose_mlp(feats)
        pose_pca, root_rot = pose[..., : self.ncomps], pose[..., self.ncomps:]
        betas = self.mano_head.shape_mlp(feats)
        trans = self.absolute_head.trans_mlp(feats)
        trans = trans + trans.new_tensor([0.0, 0.0, self.z_init])
        verts_m, joints_m = mano_forward(mano, pose_pca, betas, root_rot)
        verts_cam = verts_m + trans[:, None]
        joints_cam = joints_m + trans[:, None]
        center = joints_cam[:, self.center_idx: self.center_idx + 1]
        out = {
            "pose_pca": pose_pca, "betas": betas, "verts_cam": verts_cam,
            "verts_c_mm": (verts_cam - center) * 1000.0,
            "joints_c_mm": (joints_cam - center) * 1000.0,
            "joints2d": persp_project(joints_cam, camintr),
        }
        if self.obj_head is not None and obj_verts_can is not None:
            otrans = self.obj_head.objtrans_mlp(feats)
            otrans = otrans + otrans.new_tensor([0.0, 0.0, self.z_init])
            raw = self.obj_head.objrot_mlp(feats)
            rot = rot6d_to_matrix(raw + raw.new_tensor([1.0, 0, 0, 0, 1.0, 0]))
            obj_cam = transform_points(obj_verts_can, rot, otrans)
            out.update(obj_verts_cam=obj_cam, obj_verts_c_mm=(obj_cam - center) * 1000.0)
        return out


def lecun_std(shape) -> float:
    """Flax's lecun-normal std for a kernel of ``shape`` (torch layout), over
    the std of a unit normal truncated at +-2."""
    fan_in = math.prod(shape[1:])
    return math.sqrt(1.0 / fan_in) / 0.87962566103423978
