"""HOCNet in plain PyTorch: the ``hocnet`` family's reference.

ResNet trunk of basic blocks (frozen batch norm, bf16 autocast inside the
trunk), the MANO, absolute and object-pose heads, the MANO layer and the
pinhole projection, written from the published description (Hasson et al.,
CVPR 2020; hassony2/handobjectconsist) and kept op for op in the order the
port computes them, so that the two agree to rounding. Parameter names
follow the port's state dict, so one set of seeded weights loads into both.
The configuration's ``model`` gives ``stage_sizes``, ``widths``,
``head_hidden``, ``mano_ncomps``, ``center_idx``, ``z_init``,
``with_object`` and ``trunk_dtype``.

Imports nothing of ``hocon``, ``hocon_torch`` or JAX.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from reference.model import (lecun_std, mano_forward, persp_project, rot6d_to_matrix,
                             transform_points)

BN_EPS = 1e-5


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


class Model(nn.Module):
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


@torch.no_grad()
def weights(cfg: dict, generator: torch.Generator, device) -> dict:
    """The state dict as Flax initialises HOCNet, drawn from ``generator`` in
    two calls: a truncated normal for every kernel (lecun-normal: variance 1
    / fan-in), a normal of std 1e-3 for each MLP's output layer; zero biases;
    batch norm at scale 1 (0 on each block's last norm), shift 0, running
    mean 0 and variance 1."""
    with torch.device("meta"):
        model = Model(cfg)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    out_layers = {f"{name}.layers.{len(m.layers) - 1}.weight"
                  for name, m in model.named_modules() if hasattr(m, "layers")}
    zero_scale = {f"{name}.weight" for name, m in model.named_modules()
                  if getattr(m, "zero_scale", False)}
    lecun = [k for k, s in shapes.items()
             if k.endswith("weight") and len(s) > 1 and k not in out_layers]
    f32 = dict(device=device, dtype=torch.float32)
    n_lecun = sum(math.prod(shapes[k]) for k in lecun)
    trunc = torch.nn.init.trunc_normal_(torch.empty(n_lecun, **f32), a=-2.0, b=2.0,
                                        generator=generator)
    outs = torch.randn(sum(math.prod(shapes[k]) for k in out_layers), generator=generator,
                       **f32) * 1e-3
    sd, i, j = {}, 0, 0
    for k, s in shapes.items():
        n = math.prod(s)
        if k in out_layers:
            sd[k] = outs[j:j + n].reshape(s)
            j += n
        elif k in lecun:
            sd[k] = trunc[i:i + n].reshape(s) * lecun_std(s)
            i += n
        elif k.endswith("running_var") or (k.endswith(".weight") and k not in zero_scale):
            sd[k] = torch.ones(s, **f32)
        else:
            sd[k] = torch.zeros(s, **f32)
    return sd


def trunk_flops(stage_sizes, widths, size: int, images: int) -> float:
    """ResNet basic-block trunk, forward + backward, at ``size`` px."""
    def out(n, k, s, p):
        return (n + 2 * p - k) // s + 1

    convs = []  # (cin, cout, k, h_out)
    h = out(size, 7, 2, 3)
    convs.append((3, widths[0], 7, h))
    h = out(h, 3, 2, 1)
    cin = widths[0]
    for i, (n, cout) in enumerate(zip(stage_sizes, widths)):
        for j in range(n):
            stride = 2 if i > 0 and j == 0 else 1
            ho = out(h, 3, stride, 1)
            convs.append((cin, cout, 3, ho))
            convs.append((cout, cout, 3, ho))
            if stride != 1 or cin != cout:
                convs.append((cin, cout, 1, ho))
            cin, h = cout, ho
    fwd = [2.0 * ci * co * k * k * ho * ho for ci, co, k, ho in convs]
    return images * (3 * sum(fwd) - fwd[0])


def heads_flops(cfg: dict, images: int) -> float:
    m = cfg["model"]
    nf, hid = m["widths"][-1], m["head_hidden"]
    layers = [(nf, hid), (hid, hid), (hid, m["mano_ncomps"] + 3),
              (nf, hid), (hid, hid), (hid, 10), (nf, hid), (hid, 3)]
    if m["with_object"]:
        layers += [(nf, hid), (hid, 3), (nf, hid), (hid, 6)]
    return images * 3 * sum(2.0 * a * b for a, b in layers)


def flops(cfg: dict, images: int) -> float:
    """The trunk's convolutions forward (2 per multiply-add), their input and
    weight gradients backward (the stem's input gradient is not taken), and
    the heads' dense layers forward and backward, for ``images`` images."""
    m = cfg["model"]
    return (trunk_flops(m["stage_sizes"], m["widths"], cfg["data"]["image_size"], images)
            + heads_flops(cfg, images))
