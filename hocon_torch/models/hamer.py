"""HaMeR: a ViT-H/16 trunk and a cross-attending MANO decoder.

Written from Pavlakos et al., "Reconstructing Hands in 3D with
Transformers", CVPR 2024 (arXiv 2312.05251), and its public code
(``hamer/models/components/pose_transformer.py``,
``hamer/models/heads/mano_head.py``; the trunk: ``hocon_torch.models.vit``).
Parameter names follow HaMeR's tree (``backbone.*``, ``mano_head.*``), so
that its checkpoint would load by name.

The trunk takes the middle 3/4 of each crop's width (HaMeR's
``x[..., 32:-32]`` at 256^2) and gives its tokens to the decoder as
context. The decoder embeds one query token from a zero input
(``Linear(1, dim)`` plus a learned position) and runs ``depth`` layers of
pre-norm self-attention, pre-norm cross-attention to the image tokens and
a pre-norm GELU feed-forward, with heads of ``heads`` x ``dim_head`` whose
query, key and value projections have no bias. Linear read-outs give the
16 joints' 6D rotations, 10 shape coefficients and a weak-perspective
camera (s, tx, ty), each added to its initial value (one iteration). MANO
runs from the rotation matrices (``mano_forward_rotmat``, replayed from
CUDA graphs on the card).

``HaMeR`` has HOCNet's ``forward(images, camintr, mano, obj_verts_can=None)``
and returns its keys and units; ``pose_pca`` is the 15 finger joints'
``R - I`` (135 values), what MANO's pose blend shapes read, which
``lambda_pose`` pulls toward the rest pose, and ``root_rot`` is the root's
rotation matrix.

Departures from HaMeR: the camera translation is ``(tx, ty, 2 f / (S s +
1e-9))`` with ``f`` the crop's own focal length from ``camintr`` (HaMeR:
a fixed 5000 px); drop-path is off; the initial pose is the identity, the
initial shape zero and the initial camera ``(cam_scale_init, 0, 0)`` (HaMeR
reads them from ``mano_mean_params.npz``); there is no object head.
"""

from __future__ import annotations

import torch
from torch import nn

from hocon_torch.device import resolve_device
from hocon_torch.geometry.mano import ManoModel, mano_forward_rotmat
from hocon_torch.geometry.rot import rot6d_to_matrix
from hocon_torch.models.attention import attention
from hocon_torch.models.graphs import Graphs, graphed_mano
from hocon_torch.models.heads import camera_space
from hocon_torch.models.vit import ViT
from hocon_torch.utils.trace import span

N_JOINTS = 16
IDENTITY_6D = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim)
        self.fn = fn

    def forward(self, x: torch.Tensor, **kw) -> torch.Tensor:
        return self.fn(self.norm(x), **kw)


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, _ = x.shape
    return x.reshape(b, n, heads, -1).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


class SelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads = heads
        self.to_qkv = nn.Linear(dim, 3 * heads * dim_head, bias=False)
        self.to_out = nn.Sequential(nn.Linear(heads * dim_head, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = (_split_heads(t, self.heads) for t in self.to_qkv(x).chunk(3, dim=-1))
        return self.to_out(_merge_heads(attention(q, k, v)))


class CrossAttention(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads = heads
        self.to_kv = nn.Linear(context_dim, 2 * heads * dim_head, bias=False)
        self.to_q = nn.Linear(dim, heads * dim_head, bias=False)
        self.to_out = nn.Sequential(nn.Linear(heads * dim_head, dim))

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        k, v = (_split_heads(t, self.heads) for t in self.to_kv(context).chunk(2, dim=-1))
        q = _split_heads(self.to_q(x), self.heads)
        return self.to_out(_merge_heads(attention(q, k, v)))


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        # HaMeR's indices: 0 and 3 are the linear layers (2 and 4 its dropouts).
        self.net = nn.Sequential(nn.Linear(dim, hidden), nn.GELU(), nn.Identity(),
                                 nn.Linear(hidden, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class TransformerCrossAttn(nn.Module):
    def __init__(self, dim, depth, heads, dim_head, mlp_dim, context_dim):
        super().__init__()
        self.layers = nn.ModuleList(nn.ModuleList([
            PreNorm(dim, SelfAttention(dim, heads, dim_head)),
            PreNorm(dim, CrossAttention(dim, context_dim, heads, dim_head)),
            PreNorm(dim, FeedForward(dim, mlp_dim)),
        ]) for _ in range(depth))

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        for self_attn, cross_attn, ff in self.layers:
            x = self_attn(x) + x
            x = cross_attn(x, context=context) + x
            x = ff(x) + x
        return x


class TransformerDecoder(nn.Module):
    """One query token from a zero input, through ``TransformerCrossAttn``."""

    def __init__(self, dim, depth, heads, dim_head, mlp_dim, context_dim):
        super().__init__()
        self.to_token_embedding = nn.Linear(1, dim)
        self.pos_embedding = nn.Parameter(torch.zeros(1, 1, dim))
        self.transformer = TransformerCrossAttn(dim, depth, heads, dim_head, mlp_dim,
                                                context_dim)

    def forward(self, context: torch.Tensor) -> torch.Tensor:
        token = context.new_zeros(context.shape[0], 1, 1)
        x = self.to_token_embedding(token) + self.pos_embedding
        return self.transformer(x, context=context)[:, 0]


class MANOTransformerDecoderHead(nn.Module):
    """Image tokens -> (16 x 6D pose, betas, weak-perspective camera)."""

    def __init__(self, dim, depth, heads, dim_head, mlp_dim, context_dim,
                 cam_scale_init: float):
        super().__init__()
        self.transformer = TransformerDecoder(dim, depth, heads, dim_head, mlp_dim, context_dim)
        self.decpose = nn.Linear(dim, 6 * N_JOINTS)
        self.decshape = nn.Linear(dim, 10)
        self.deccam = nn.Linear(dim, 3)
        self.cam_scale_init = cam_scale_init
        self.register_buffer("init_hand_pose", torch.zeros(1, 6 * N_JOINTS))
        self.register_buffer("init_betas", torch.zeros(1, 10))
        self.register_buffer("init_cam", torch.zeros(1, 3))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """As HaMeR initialises it: PyTorch's defaults for the decoder's
        linear layers (uniform at +-1 / sqrt(fan-in), weight and bias),
        LayerNorm at 1 and 0, a unit normal for the query's position,
        Xavier-uniform at gain 0.01 for the three read-outs' weights; the
        initial values as the module's docstring gives them."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                bound = m.weight.shape[1] ** -0.5
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        self.transformer.pos_embedding.normal_(generator=generator)
        for m in (self.decpose, self.decshape, self.deccam):
            nn.init.xavier_uniform_(m.weight, gain=0.01, generator=generator)
        self.init_hand_pose.copy_(self.init_hand_pose.new_tensor(IDENTITY_6D).repeat(N_JOINTS))
        self.init_betas.zero_()
        self.init_cam.copy_(self.init_cam.new_tensor([self.cam_scale_init, 0.0, 0.0]))

    def read_out(self, token: torch.Tensor):
        """The decoder's f32 output token -> (pose (B, 96), betas, camera)."""
        return (self.decpose(token) + self.init_hand_pose,
                self.decshape(token) + self.init_betas,
                self.deccam(token) + self.init_cam)


class HaMeR(nn.Module):
    """Hand mesh recovery with a ViT trunk and a transformer decoder.

    ``image_size`` is the square crop's side; the trunk sees its middle
    ``image_size`` x ``image_size - 2 * (image_size // 8)`` (256 x 192 at
    256^2). ``dtype`` is the compute dtype of the trunk and the decoder's
    transformer (bf16 autocast); the read-outs, the camera, MANO and the
    projections run in float32.

    Weights are initialised from ``seed`` through a ``torch.Generator`` on
    ``device`` (CUDA if None), where the model is built, as HaMeR initialises
    them (``ViT.reset_parameters``,
    ``MANOTransformerDecoderHead.reset_parameters``). MANO's CUDA graphs are
    held in ``graphs``, as HOCNet holds its own.
    """

    def __init__(
        self,
        image_size: int = 256,
        patch: int = 16,
        vit_dim: int = 1280,
        vit_depth: int = 32,
        vit_heads: int = 16,
        vit_mlp_ratio: int = 4,
        dec_dim: int = 1024,
        dec_depth: int = 6,
        dec_heads: int = 8,
        dec_dim_head: int = 64,
        dec_mlp_dim: int = 1024,
        cam_scale_init: float = 10.0,
        center_idx: int = 9,
        dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
        device: str | torch.device | None = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.center_idx = center_idx
        self.dtype = dtype
        self.cut = image_size // 8
        with torch.device("meta"):
            self.backbone = ViT((image_size, image_size - 2 * self.cut), patch, vit_dim,
                                vit_depth, vit_heads, vit_mlp_ratio)
            self.mano_head = MANOTransformerDecoderHead(
                dec_dim, dec_depth, dec_heads, dec_dim_head, dec_mlp_dim, vit_dim,
                cam_scale_init)
        self.to_empty(device=dev)
        generator = torch.Generator(device=dev).manual_seed(seed)
        self.backbone.reset_parameters(generator)
        self.mano_head.reset_parameters(generator)
        self.graphs = Graphs()

    def forward(
        self,
        images: torch.Tensor,  # (B, S, S, 3), normalized
        camintr: torch.Tensor,  # (B, 3, 3)
        mano: ManoModel,
        obj_verts_can: torch.Tensor | None = None,  # no object head: unused
    ) -> dict:
        b, size = images.shape[0], images.shape[1]
        autocast = dict(device_type=images.device.type, dtype=self.dtype,
                        enabled=self.dtype != torch.float32)
        with span("model.trunk"), torch.autocast(**autocast):
            tokens = self.backbone(images.permute(0, 3, 1, 2)[..., self.cut:size - self.cut])
        with span("model.heads"):
            with torch.autocast(**autocast):
                token = self.mano_head.transformer(tokens)
            pose6d, betas, cam = self.mano_head.read_out(token.float())
            rots = rot6d_to_matrix(pose6d.reshape(b, N_JOINTS, 6))
            focal = camintr[:, 0, 0]
            trans = torch.stack([cam[:, 1], cam[:, 2],
                                 2.0 * focal / (size * cam[:, 0] + 1e-9)], dim=-1)
        with span("model.mano"):
            verts_m, joints_m = graphed_mano(self.graphs, mano_forward_rotmat, mano, rots, betas)
        with span("model.heads"):
            eye = torch.eye(3, dtype=rots.dtype, device=rots.device)
            return {"pose_pca": (rots[:, 1:] - eye).reshape(b, 9 * (N_JOINTS - 1)),
                    "betas": betas, "root_rot": rots[:, 0], "trans": trans,
                    **camera_space(verts_m, joints_m, trans, camintr, self.center_idx)}
