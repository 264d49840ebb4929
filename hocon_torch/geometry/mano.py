"""Differentiable MANO hand layer in PyTorch.

Port of ``hocon/geometry/mano.py``: the same PCA pose decode, Rodrigues,
shape and pose blendshapes, joint regression, forward kinematics along the
fixed parent chain, linear blend skinning, fingertip joints and joint
reorder. ``synthetic_mano_model`` rebuilds the reference's licence-free
stand-in from the same seeded numpy and scipy calls, so both packages hold
identical arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hocon_torch.device import resolve_device
from hocon_torch.geometry.rot import rodrigues, with_zeros_4x4

MANO_PARENTS = (-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14)
FINGERTIP_VERT_IDS = (745, 317, 444, 556, 673)
JOINT_REORDER = (
    0, 13, 14, 15, 16,
    1, 2, 3, 17,
    4, 5, 6, 18,
    10, 11, 12, 19,
    7, 8, 9, 20,
)

N_VERTS = 778
N_JOINTS_KIN = 16


@dataclasses.dataclass(frozen=True)
class ManoModel:
    """MANO assets as tensors on one device.

    Shapes: v_template (V,3); shapedirs (V,3,10); posedirs (V,3,135);
    joint_regressor (16,V); skin_weights (V,16); hands_components (45,45)
    (rows = PCA basis vectors); hands_mean (45,); faces (F,3) int64.
    """

    v_template: torch.Tensor
    shapedirs: torch.Tensor
    posedirs: torch.Tensor
    joint_regressor: torch.Tensor
    skin_weights: torch.Tensor
    hands_components: torch.Tensor
    hands_mean: torch.Tensor
    faces: torch.Tensor
    side: str = "right"

    @property
    def n_verts(self) -> int:
        return self.v_template.shape[0]


def synthetic_mano_arrays(seed: int = 0) -> dict[str, np.ndarray]:
    """The reference's synthetic MANO arrays (``mano.py:183-257``), in numpy.

    A Fibonacci-sphere blob of exactly 778 vertices triangulated by its
    convex hull and wound outward, a 16-joint hand-like chain, soft-nearest
    joint regressor, distance-based skinning and small random blendshapes.
    """
    rng = np.random.default_rng(seed)
    n = N_VERTS
    idx = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * idx / n)
    theta = np.pi * (1.0 + 5.0**0.5) * idx
    pts = np.stack(
        [np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi), np.cos(phi)],
        axis=-1,
    )
    v_template = (pts * np.array([0.09, 0.05, 0.015])).astype(np.float32)

    from scipy.spatial import ConvexHull

    faces = ConvexHull(pts).simplices.astype(np.int32)
    tri = pts[faces]
    normals = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    flip = (normals * tri.mean(axis=1)).sum(-1) < 0
    faces[flip] = faces[flip][:, ::-1]

    joints = np.zeros((N_JOINTS_KIN, 3), dtype=np.float32)
    joints[0] = [-0.07, 0.0, 0.0]
    chains = {
        (1, 2, 3): 0.02,
        (4, 5, 6): 0.0,
        (7, 8, 9): -0.04,
        (10, 11, 12): -0.02,
        (13, 14, 15): 0.045,
    }
    for chain, y in chains.items():
        for k, j in enumerate(chain):
            joints[j] = [-0.02 + 0.035 * (k + 1), y, 0.0]

    d = np.linalg.norm(v_template[None] - joints[:, None], axis=-1)  # (16,V)
    jreg = np.exp(-((d / 0.01) ** 2))
    jreg /= jreg.sum(axis=1, keepdims=True) + 1e-9
    w = np.exp(-((d.T / 0.03) ** 2)) + 1e-6  # (V,16)
    w /= w.sum(axis=1, keepdims=True)

    shapedirs = (rng.standard_normal((n, 3, 10)) * 0.002).astype(np.float32)
    posedirs = (rng.standard_normal((n, 3, 135)) * 0.0005).astype(np.float32)
    comps = np.linalg.qr(rng.standard_normal((45, 45)))[0].astype(np.float32)
    hands_mean = (rng.standard_normal(45) * 0.1).astype(np.float32)
    return dict(
        v_template=v_template,
        shapedirs=shapedirs,
        posedirs=posedirs,
        joint_regressor=jreg.astype(np.float32),
        skin_weights=w.astype(np.float32),
        hands_components=comps,
        hands_mean=hands_mean,
        faces=faces,
    )


def synthetic_mano_model(
    seed: int = 0,
    side: str = "right",
    device: str | torch.device | None = None,
) -> ManoModel:
    """The synthetic MANO stand-in as tensors on ``device`` (CUDA if None)."""
    dev = resolve_device(device)
    arrays = synthetic_mano_arrays(seed)
    fields = {
        k: torch.from_numpy(v).to(
            device=dev, dtype=torch.int64 if k == "faces" else torch.float32
        )
        for k, v in arrays.items()
    }
    return ManoModel(**fields, side=side)


def pca_to_full_pose(
    model: ManoModel,
    pose_pca: torch.Tensor,
    use_pca: bool = True,
    flat_hand_mean: bool = False,
) -> torch.Tensor:
    """Pose coefficients (B, ncomps), or (B, 45) axis-angle when not
    ``use_pca``, to the full 45-dof axis-angle vector."""
    if use_pca:
        full = pose_pca @ model.hands_components[: pose_pca.shape[-1]]
    else:
        full = pose_pca
    if not flat_hand_mean:
        full = full + model.hands_mean
    return full


def mano_forward(
    model: ManoModel,
    pose_pca: torch.Tensor,
    betas: torch.Tensor,
    global_rot: torch.Tensor,
    trans: torch.Tensor | None = None,
    use_pca: bool = True,
    flat_hand_mean: bool = False,
    center_idx: int | None = None,
    scale_mm: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """MANO forward: verts (B, 778, 3) and joints (B, 21, 3).

    Same arguments and conventions as ``hocon.geometry.mano.mano_forward``:
    ``trans`` in meters is added before mm scaling, ``center_idx`` centres on
    a joint of the standard 21-joint order, and the two exclude each other.
    """
    b = pose_pca.shape[0]
    dtype = pose_pca.dtype
    full_pose = pca_to_full_pose(model, pose_pca, use_pca, flat_hand_mean)
    all_aa = torch.cat([global_rot, full_pose], dim=-1).reshape(b, 16, 3)
    rots = rodrigues(all_aa)  # (B,16,3,3)

    v_shaped = model.v_template[None] + torch.einsum(
        "vds,bs->bvd", model.shapedirs, betas
    )
    j_rest = torch.einsum("jv,bvd->bjd", model.joint_regressor, v_shaped)

    eye = torch.eye(3, dtype=dtype, device=rots.device)
    pose_feat = (rots[:, 1:] - eye).reshape(b, 135)
    v_posed = v_shaped + torch.einsum("vdp,bp->bvd", model.posedirs, pose_feat)

    rel_trans = [j_rest[:, 0]]
    for j in range(1, N_JOINTS_KIN):
        rel_trans.append(j_rest[:, j] - j_rest[:, MANO_PARENTS[j]])
    local = with_zeros_4x4(rots, torch.stack(rel_trans, dim=1))  # (B,16,4,4)

    glob = [local[:, 0]]
    for j in range(1, N_JOINTS_KIN):
        glob.append(torch.matmul(glob[MANO_PARENTS[j]], local[:, j]))
    g = torch.stack(glob, dim=1)

    joints_kin = g[..., :3, 3]
    correction = torch.einsum("bjrc,bjc->bjr", g[..., :3, :3], j_rest)
    g_skin_rot = g[..., :3, :3]
    g_skin_t = g[..., :3, 3] - correction

    t_rot = torch.einsum("vj,bjrc->bvrc", model.skin_weights, g_skin_rot)
    t_t = torch.einsum("vj,bjr->bvr", model.skin_weights, g_skin_t)
    verts = torch.einsum("bvrc,bvc->bvr", t_rot, v_posed) + t_t

    tips = verts[:, list(FINGERTIP_VERT_IDS)]
    joints = torch.cat([joints_kin, tips], dim=1)[:, list(JOINT_REORDER)]

    if trans is not None:
        if center_idx is not None:
            raise ValueError(
                "mano_forward: trans and center_idx are mutually exclusive "
                "(centering would algebraically cancel trans)"
            )
        verts = verts + trans[:, None]
        joints = joints + trans[:, None]
    if scale_mm:
        verts = verts * 1000.0
        joints = joints * 1000.0
    if center_idx is not None:
        center = joints[:, center_idx : center_idx + 1]
        verts = verts - center
        joints = joints - center
    return verts, joints
