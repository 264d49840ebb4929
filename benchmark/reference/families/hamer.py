"""HaMeR in plain PyTorch: the ``hamer`` family's reference.

Written from Pavlakos et al., "Reconstructing Hands in 3D with
Transformers", CVPR 2024 (arXiv 2312.05251) and its public code
(github.com/geopavlakos/hamer: ``hamer/models/backbones/vit.py``,
``hamer/models/components/pose_transformer.py``,
``hamer/models/heads/mano_head.py``, the ``hamer_vit_transformer``
experiment), and kept op for op in the order the port computes them.
Parameter names follow HaMeR's tree, as the port's state dict does, so one
set of seeded weights loads into both.

- Trunk: ViT-H/16 in ViTPose's layout on the middle 3/4 of each crop's
  width (HaMeR's ``x[..., 32:-32]`` at 256^2): a 16 x 16 patch convolution
  with stride 16 and padding 2, a learned absolute position embedding of
  which each token gets ``pos_embed[1:] + pos_embed[:1]``, pre-norm blocks
  (LayerNorm at eps 1e-6, multi-head self-attention with a qkv bias, an
  exact-GELU MLP), a last LayerNorm.
- Head: one query token embedded from a zero input (``Linear(1, dim)``
  plus a learned position), ``dec_depth`` layers of pre-norm
  self-attention, pre-norm cross-attention to the image tokens and a
  pre-norm GELU feed-forward (LayerNorm at eps 1e-5); query, key and value
  projections without bias, output projections with one; linear read-outs
  of the 16 joints' 6D rotations, 10 betas and a weak-perspective camera
  (s, tx, ty), each added to its initial value (one iteration).
- MANO from the 16 rotation matrices (``mano_rotmat``: ``reference.model``'s
  MANO after its Rodrigues), the pinhole projection.

Attention is ``softmax(Q K^T / sqrt(d)) V`` at the precision the
configuration states, bf16 flash attention: float32 scores and softmax,
the probabilities rounded to bf16 for the product with the values, and the
backward rounded where flash attention's rounds (``FlashAttend``). In
float32 it is exact. The trunk and the head's
transformer run in the configuration's ``trunk_dtype`` (bf16 autocast);
the read-outs, the camera, MANO and the projection in float32 (TF32 off:
``reference.step.run_steps`` sets it).

Departures from HaMeR, each also in the configuration's ``assumed``:

- the camera translation is ``(tx, ty, 2 f / (S s + 1e-9))`` with ``f`` the
  crop's own focal length from the intrinsics, ``S`` the crop's side
  (HaMeR: a fixed 5000 px at S = 256);
- drop-path (0.55 in HaMeR) is off, so that the port and the reference
  draw no masks;
- the initial pose is the identity, the initial shape zero and the initial
  camera ``(cam_scale_init, 0, 0)`` (HaMeR's come from
  ``mano_mean_params.npz``, not in the repository);
- weights are random from the seed (no ViTPose or HaMeR checkpoint);
- ``pose_pca``, the vector ``lambdas.pose`` regularises, is the 15 finger
  joints' ``R - I`` (HaMeR has no PCA pose).

The configuration's ``model`` gives ``patch``, ``patch_padding``,
``vit_dim``, ``vit_depth``, ``vit_heads``, ``vit_mlp_dim``, ``dec_dim``,
``dec_depth``, ``dec_heads``, ``dec_dim_head``, ``dec_mlp_dim``,
``dec_context_dim``, ``pose_out``, ``betas_out``, ``cam_out``,
``cam_scale_init``, ``center_idx`` and ``trunk_dtype``; the crop's side is
``data.image_size``.

Imports nothing of ``hocon``, ``hocon_torch`` or JAX.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from reference.model import (FINGERTIP_VERT_IDS, JOINT_REORDER, MANO_PARENTS, persp_project,
                             rot6d_to_matrix)

N_JOINTS = 16
VIT_LN_EPS = 1e-6


def attend(q, k, v):
    """softmax(q k^T / sqrt(d)) v over (B, heads, L, d), returned in ``q``'s
    dtype. In float32 it is exact (autograd's backward); in bf16 it rounds
    where bf16 flash attention rounds (``FlashAttend``). Over one key the
    softmax is exactly 1: the values come back, and the queries and keys
    take no gradient, as the port's attention gives."""
    if k.shape[-2] == 1:
        return v.expand(q.shape[:-1] + v.shape[-1:])
    with torch.autocast(device_type=q.device.type, enabled=False):
        if q.dtype == torch.bfloat16:
            return FlashAttend.apply(q, k, v)
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
        return torch.matmul(torch.softmax(s, dim=-1), v.float()).to(q.dtype)


def _key_blocks(n: int, d: int) -> list[slice]:
    """Flash attention's key blocks, in the order its forward visits them:
    64 keys for heads wider than 64, else 128, the last block first."""
    size = 64 if d > 64 else 128
    return [slice(i, i + size) for i in reversed(range(0, n, size))]


class FlashAttend(torch.autograd.Function):
    """Attention over bf16 inputs at the precision the configuration states
    (bf16 flash attention, FlashAttention-2's arithmetic): scores and the
    softmax in float32; the unnormalised probabilities ``exp(s - m)``, ``m``
    the running row maximum over the key blocks, rounded to bf16 for the
    product with the values, accumulated in float32 and divided by the
    float32 row sum at the end; the output rounded to bf16. The backward
    recomputes the probabilities from the row's log-sum-exp, rounds them to
    bf16 for the values' gradient, and rounds ``p (dp - rowsum(do o))`` to
    bf16 for the queries' and keys' gradients, each accumulated in float32
    and rounded to bf16."""

    @staticmethod
    def forward(ctx, q, k, v):
        scale = q.shape[-1] ** -0.5
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        m = acc = row = None
        for blk in _key_blocks(k.shape[-2], q.shape[-1]):
            sb = s[..., blk]
            m_new = sb.amax(-1, keepdim=True)
            if m is not None:
                m_new = torch.maximum(m, m_new)
            p = torch.exp(sb - m_new)
            pv = torch.matmul(p.to(torch.bfloat16).float(), v[..., blk, :].float())
            if m is None:
                acc, row = pv, p.sum(-1, keepdim=True)
            else:
                r = torch.exp(m - m_new)
                acc, row = acc * r + pv, row * r + p.sum(-1, keepdim=True)
            m = m_new
        out = (acc / row).to(q.dtype)
        ctx.save_for_backward(q, k, v, out, m + torch.log(row))
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        scale = q.shape[-1] ** -0.5
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        p = torch.exp(s - lse)
        g32 = g.float()
        dv = torch.matmul(p.to(torch.bfloat16).float().transpose(-1, -2), g32)
        dp = torch.matmul(g32, v.float().transpose(-1, -2))
        ds = (p * (dp - (g32 * out.float()).sum(-1, keepdim=True))).to(torch.bfloat16).float()
        dq = torch.matmul(ds, k.float()) * scale
        dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class PatchEmbed(nn.Module):
    def __init__(self, dim, patch, padding):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch, padding=padding)


class VitAttention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4)
        out = attend(qkv[0], qkv[1], qkv[2])
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class Block(nn.Module):
    def __init__(self, dim, heads, hidden):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=VIT_LN_EPS)
        self.attn = VitAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=VIT_LN_EPS)
        self.mlp = Mlp(dim, hidden)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x))))


class ViT(nn.Module):
    def __init__(self, m: dict, tokens: int):
        super().__init__()
        self.patch_embed = PatchEmbed(m["vit_dim"], m["patch"], m["patch_padding"])
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens + 1, m["vit_dim"]))
        self.blocks = nn.ModuleList(Block(m["vit_dim"], m["vit_heads"], m["vit_mlp_dim"])
                                    for _ in range(m["vit_depth"]))
        self.last_norm = nn.LayerNorm(m["vit_dim"], eps=VIT_LN_EPS)

    def forward(self, x):
        x = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
        x = x + self.pos_embed[:, 1:] + self.pos_embed[:, :1]
        for blk in self.blocks:
            x = blk(x)
        return self.last_norm(x)


def _heads(x, h):
    b, n, _ = x.shape
    return x.reshape(b, n, h, -1).transpose(1, 2)


def _merge(x):
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


class PreNorm(nn.Module):
    def __init__(self, dim, fn):
        super().__init__()
        self.norm = nn.LayerNorm(dim)
        self.fn = fn


class SelfAttention(nn.Module):
    def __init__(self, dim, heads, dim_head):
        super().__init__()
        self.heads = heads
        self.to_qkv = nn.Linear(dim, 3 * heads * dim_head, bias=False)
        self.to_out = nn.Sequential(nn.Linear(heads * dim_head, dim))

    def forward(self, x):
        q, k, v = (_heads(t, self.heads) for t in self.to_qkv(x).chunk(3, dim=-1))
        return self.to_out[0](_merge(attend(q, k, v)))


class CrossAttention(nn.Module):
    def __init__(self, dim, context_dim, heads, dim_head):
        super().__init__()
        self.heads = heads
        self.to_kv = nn.Linear(context_dim, 2 * heads * dim_head, bias=False)
        self.to_q = nn.Linear(dim, heads * dim_head, bias=False)
        self.to_out = nn.Sequential(nn.Linear(heads * dim_head, dim))

    def forward(self, x, context):
        k, v = (_heads(t, self.heads) for t in self.to_kv(context).chunk(2, dim=-1))
        q = _heads(self.to_q(x), self.heads)
        return self.to_out[0](_merge(attend(q, k, v)))


class FeedForward(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(dim, hidden), nn.GELU(), nn.Identity(),
                                 nn.Linear(hidden, dim))


class Layers(nn.Module):
    def __init__(self, m: dict):
        super().__init__()
        d, h, dh = m["dec_dim"], m["dec_heads"], m["dec_dim_head"]
        self.layers = nn.ModuleList(nn.ModuleList([
            PreNorm(d, SelfAttention(d, h, dh)),
            PreNorm(d, CrossAttention(d, m["dec_context_dim"], h, dh)),
            PreNorm(d, FeedForward(d, m["dec_mlp_dim"])),
        ]) for _ in range(m["dec_depth"]))


class Decoder(nn.Module):
    def __init__(self, m: dict):
        super().__init__()
        self.to_token_embedding = nn.Linear(1, m["dec_dim"])
        self.pos_embedding = nn.Parameter(torch.zeros(1, 1, m["dec_dim"]))
        self.transformer = Layers(m)

    def forward(self, context):
        x = self.to_token_embedding(context.new_zeros(context.shape[0], 1, 1))
        x = x + self.pos_embedding
        for sa, ca, ff in self.transformer.layers:
            x = sa.fn(sa.norm(x)) + x
            x = ca.fn(ca.norm(x), context) + x
            x = ff.fn.net(ff.norm(x)) + x
        return x[:, 0]


class Head(nn.Module):
    def __init__(self, m: dict):
        super().__init__()
        self.transformer = Decoder(m)
        self.decpose = nn.Linear(m["dec_dim"], m["pose_out"])
        self.decshape = nn.Linear(m["dec_dim"], m["betas_out"])
        self.deccam = nn.Linear(m["dec_dim"], m["cam_out"])
        self.register_buffer("init_hand_pose", torch.zeros(1, m["pose_out"]))
        self.register_buffer("init_betas", torch.zeros(1, m["betas_out"]))
        self.register_buffer("init_cam", torch.zeros(1, m["cam_out"]))


def crop_cut(size: int) -> int:
    """Columns cut from each side of a ``size``^2 crop: 32 at 256."""
    return size // 8


def trunk_tokens(cfg: dict) -> int:
    m, size = cfg["model"], cfg["data"]["image_size"]
    return (size // m["patch"]) * ((size - 2 * crop_cut(size)) // m["patch"])


def mano_rotmat(mano: dict, rots, betas):
    """MANO in meters from the 16 joints' rotation matrices (B, 16, 3, 3):
    ``reference.model.mano_forward`` after its Rodrigues."""
    b, dtype = rots.shape[0], rots.dtype
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


class Model(nn.Module):
    """ViT trunk -> transformer decoder -> 6D pose, betas, camera -> MANO."""

    def __init__(self, cfg: dict):
        super().__init__()
        m = cfg["model"]
        self.dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[m["trunk_dtype"]]
        self.center_idx = m["center_idx"]
        self.backbone = ViT(m, trunk_tokens(cfg))
        self.mano_head = Head(m)

    def forward(self, images, camintr, mano: dict, obj_verts_can=None) -> dict:
        b, size = images.shape[0], images.shape[1]
        cut = crop_cut(size)
        ac = dict(device_type=images.device.type, dtype=self.dtype,
                  enabled=self.dtype != torch.float32)
        with torch.autocast(**ac):
            tokens = self.backbone(images.permute(0, 3, 1, 2)[..., cut:size - cut])
        with torch.autocast(**ac):
            token = self.mano_head.transformer(tokens)
        head, token = self.mano_head, token.float()
        pose6d = head.decpose(token) + head.init_hand_pose
        betas = head.decshape(token) + head.init_betas
        cam = head.deccam(token) + head.init_cam
        rots = rot6d_to_matrix(pose6d.reshape(b, N_JOINTS, 6))
        trans = torch.stack([cam[:, 1], cam[:, 2],
                             2.0 * camintr[:, 0, 0] / (size * cam[:, 0] + 1e-9)], dim=-1)
        verts_m, joints_m = mano_rotmat(mano, rots, betas)
        verts_cam = verts_m + trans[:, None]
        joints_cam = joints_m + trans[:, None]
        center = joints_cam[:, self.center_idx: self.center_idx + 1]
        eye = torch.eye(3, dtype=rots.dtype, device=rots.device)
        return {
            "pose_pca": (rots[:, 1:] - eye).reshape(b, 9 * (N_JOINTS - 1)),
            "betas": betas, "verts_cam": verts_cam,
            "verts_c_mm": (verts_cam - center) * 1000.0,
            "joints_c_mm": (joints_cam - center) * 1000.0,
            "joints2d": persp_project(joints_cam, camintr),
        }


@torch.no_grad()
def weights(cfg: dict, generator: torch.Generator, device) -> dict:
    """The state dict as HaMeR initialises it, drawn from ``generator`` in
    three calls: a normal of std 0.02 truncated at +-2 (timm's bounds,
    absolute) for the ViT's linear weights and ``pos_embed``; one uniform
    draw for PyTorch's default init of the patch convolution and the
    decoder's linear layers (weight and bias at +-1 / sqrt(fan-in)) and for
    the read-outs' Xavier-uniform weights at gain 0.01 (their biases at
    PyTorch's default); a unit normal for the query's position. The ViT's
    linear biases are zero, every LayerNorm 1 and 0; the initial pose is
    the identity in 6D, the initial betas zero, the initial camera
    ``(cam_scale_init, 0, 0)``."""
    m = cfg["model"]
    with torch.device("meta"):
        model = Model(cfg)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    norms = {f"{n}.{p}" for n, mod in model.named_modules() if isinstance(mod, nn.LayerNorm)
             for p in ("weight", "bias")}
    readouts = {f"mano_head.{n}.weight" for n in ("decpose", "decshape", "deccam")}
    trunc, uniform, bound = [], [], {}
    for k, s in shapes.items():
        if k in norms or k.startswith("mano_head.init_"):
            continue
        if k.startswith("backbone.") and not k.startswith("backbone.patch_embed."):
            if k.endswith(".weight") or k == "backbone.pos_embed":
                trunc.append(k)
        elif k != "mano_head.transformer.pos_embedding":
            weight = shapes[k.rsplit(".", 1)[0] + ".weight"]
            fan_in, fan_out = math.prod(weight[1:]), weight[0]
            bound[k] = (0.01 * math.sqrt(6.0 / (fan_in + fan_out)) if k in readouts
                        else fan_in ** -0.5)
            uniform.append(k)
    f32 = dict(device=device, dtype=torch.float32)
    t = torch.nn.init.trunc_normal_(torch.empty(sum(math.prod(shapes[k]) for k in trunc), **f32),
                                    std=0.02, a=-2.0, b=2.0, generator=generator)
    u = torch.rand(sum(math.prod(shapes[k]) for k in uniform), generator=generator, **f32)
    pos = torch.randn(shapes["mano_head.transformer.pos_embedding"], generator=generator, **f32)
    sd, i, j = {}, 0, 0
    for k, s in shapes.items():
        n = math.prod(s)
        if k in trunc:
            sd[k] = t[i:i + n].reshape(s)
            i += n
        elif k in bound:
            sd[k] = (u[j:j + n].reshape(s) * 2.0 - 1.0) * bound[k]
            j += n
        elif k == "mano_head.transformer.pos_embedding":
            sd[k] = pos
        elif k == "mano_head.init_hand_pose":
            sd[k] = torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0], **f32).repeat(N_JOINTS)[None]
        elif k == "mano_head.init_cam":
            sd[k] = torch.tensor([[m["cam_scale_init"], 0.0, 0.0]], **f32)
        elif k in norms and k.endswith(".weight"):
            sd[k] = torch.ones(s, **f32)
        else:
            sd[k] = torch.zeros(s, **f32)
    return sd


def trunk_flops(cfg: dict, images: int) -> float:
    """The ViT's matrix FLOPs forward and backward for ``images`` images:
    the patch convolution (forward and weight gradient: the images take no
    gradient), each block's qkv, output projection, MLP and attention's
    Q K^T and P V (2 per multiply-add; backward twice the forward)."""
    m = cfg["model"]
    n, d, hid = trunk_tokens(cfg), m["vit_dim"], m["vit_mlp_dim"]
    conv = 2.0 * n * 3 * m["patch"] ** 2 * d
    block = 2.0 * n * d * (3 * d + d + 2 * hid) + 2 * 2.0 * n * n * d
    return images * (2 * conv + 3 * m["vit_depth"] * block)


def head_flops(cfg: dict, images: int) -> float:
    """The decoder and read-outs, forward and backward: per layer the
    query's self-attention projections (its attention over one key is the
    values: no work), its cross-attention projections (the context's keys
    and values over every image token) and attention, and the
    feed-forward."""
    m = cfg["model"]
    n, d, inner = trunk_tokens(cfg), m["dec_dim"], m["dec_heads"] * m["dec_dim_head"]
    self_attn = 2.0 * d * 3 * inner + 2.0 * inner * d
    cross = 2.0 * d * inner + 2.0 * n * m["dec_context_dim"] * 2 * inner + 2.0 * inner * d
    cross += 2 * 2.0 * n * inner
    ff = 2 * 2.0 * d * m["dec_mlp_dim"]
    out = 2.0 * d * (1 + m["pose_out"] + m["betas_out"] + m["cam_out"])
    return images * 3 * (m["dec_depth"] * (self_attn + cross + ff) + out)


def attn_flops(cfg: dict, images: int) -> float:
    """Attention's Q K^T and P V, forward and backward, in the trunk's
    blocks and the decoder's cross-attention (its self-attention over one
    key is the values: no work)."""
    m = cfg["model"]
    n = trunk_tokens(cfg)
    trunk = m["vit_depth"] * 2 * 2.0 * n * n * m["vit_dim"]
    dec = m["dec_depth"] * 2 * 2.0 * n * m["dec_heads"] * m["dec_dim_head"]
    return images * 3 * (trunk + dec)


def flops(cfg: dict, images: int) -> float:
    """The model's matrix FLOPs forward and backward for ``images`` images
    (``step.mfu``'s count): the trunk and the head."""
    return trunk_flops(cfg, images) + head_flops(cfg, images)


# The per-layer readers' counts by span (``harness/roofline.py``).
SPAN_FLOPS = {"model.trunk": trunk_flops, "model.attn": attn_flops}
