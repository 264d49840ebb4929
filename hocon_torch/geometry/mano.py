"""Differentiable MANO hand layer in PyTorch.

Port of ``hocon/geometry/mano.py``: the same PCA pose decode, Rodrigues,
shape and pose blendshapes, joint regression, forward kinematics along the
fixed parent chain, linear blend skinning, fingertip joints and joint
reorder. ``synthetic_mano_model`` rebuilds the reference's licence-free
stand-in from the same seeded numpy and scipy calls, so both packages hold
identical arrays.

Assets: ``load_mano_model`` reads the official ``MANO_RIGHT.pkl`` /
``MANO_LEFT.pkl`` (chumpy-pickled) through the reference's chumpy-free
unpickler, and ``mirror_mano_model`` builds a left hand from a right one
(and back) with the reference's sign patterns; multiplying by +-1 is exact,
so both give the reference's arrays bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools
import io
import pickle
from typing import Any

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


@functools.cache
def mano_indices(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """``FINGERTIP_VERT_IDS`` and ``JOINT_REORDER`` as int64 tensors on
    ``device``, made once per device: indexing with a Python list copies it
    to the card, and waits on the stream, at every call (and a CUDA graph
    cannot hold that copy). The gathers give the list index's values."""
    return (torch.tensor(FINGERTIP_VERT_IDS, dtype=torch.int64, device=device),
            torch.tensor(JOINT_REORDER, dtype=torch.int64, device=device))


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


class _ChStub:
    """Stands in for any ``chumpy`` class in a MANO pickle: its state is the
    object's ``__dict__``, and ``__array__`` returns the numpy payload
    stored under ``r``, ``x``, ``a`` or ``v`` (the first present)."""

    def __setstate__(self, state):
        self.__dict__.update(state)

    def __array__(self, dtype=None, copy=None):
        for key in ("r", "x", "a", "v"):
            if key in self.__dict__:
                arr = np.asarray(self.__dict__[key])
                return arr.astype(dtype) if dtype is not None else arr
        raise ValueError("chumpy stub: no array payload found")


class _ChumpyFreeUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("chumpy"):
            return _ChStub
        if module == "scipy.sparse.csc" or module.endswith("csc_matrix"):
            import scipy.sparse

            return scipy.sparse.csc_matrix
        return super().find_class(module, name)


def _chumpy_free_load(path: str) -> dict:
    """Unpickle a MANO .pkl without the chumpy package (``hocon``'s
    ``_chumpy_free_load``): chumpy objects become ``_ChStub``s and the old
    ``scipy.sparse.csc`` module path maps to ``csc_matrix``."""
    with open(path, "rb") as f:
        data = f.read()
    return _ChumpyFreeUnpickler(io.BytesIO(data), encoding="latin1").load()


def _to_dense(x: Any) -> np.ndarray:
    if hasattr(x, "todense"):
        return np.asarray(x.todense())
    return np.asarray(x)


def load_mano_model(
    path: str,
    side: str = "right",
    device: str | torch.device | None = None,
) -> ManoModel:
    """Official MANO assets at ``path`` as a ``ManoModel`` on ``device``
    (CUDA if None): arrays dense f32, faces int64."""
    dev = resolve_device(device)
    raw = _chumpy_free_load(path)
    np32 = lambda k: np.asarray(_to_dense(raw[k]), dtype=np.float32)  # noqa: E731
    shapedirs = np32("shapedirs")
    if side == "left":
        # The left asset's shapedirs carry the right hand's sign in x (the
        # reference applies the same fix, as manopth does).
        shapedirs = shapedirs * np.array([-1.0, 1.0, 1.0], np.float32)[None, :, None]
    host = dict(
        v_template=np32("v_template"),
        shapedirs=shapedirs,
        posedirs=np32("posedirs"),
        joint_regressor=np32("J_regressor"),
        skin_weights=np32("weights"),
        hands_components=np32("hands_components"),
        hands_mean=np32("hands_mean"),
        faces=np.asarray(raw["f"], dtype=np.int64),
    )
    return ManoModel(**{k: torch.from_numpy(v).to(dev) for k, v in host.items()}, side=side)


def mirror_mano_model(model: ManoModel) -> ManoModel:
    """The model mirrored across x = 0 (right <-> left hand), on its device.

    Every quantity is conjugated with M = diag(-1, 1, 1), as the reference
    does: positions (template, shape blendshapes) flip in x; axis-angle
    vectors a become (a_x, -a_y, -a_z) in ``hands_mean`` and each 3-dof
    segment of ``hands_components``; entry (i, k) of each joint's 3 x 3 pose
    feature in ``posedirs`` takes the sign m_i m_k and its output row m_d;
    the face winding reverses so normals stay outward. ``mano_forward`` on
    the mirror with mirrored inputs (global_rot (r_x, -r_y, -r_z), trans
    M trans) gives M verts / M joints of the original's forward.
    """
    dev = model.v_template.device
    m = torch.tensor([-1.0, 1.0, 1.0], device=dev)
    aa_flip = torch.tensor([1.0, -1.0, -1.0], device=dev)
    s135 = torch.outer(m, m).reshape(9).repeat(15)
    flip45 = aa_flip.repeat(15)
    return ManoModel(
        v_template=model.v_template * m,
        shapedirs=model.shapedirs * m[None, :, None],
        posedirs=model.posedirs * m[None, :, None] * s135[None, None, :],
        joint_regressor=model.joint_regressor,
        skin_weights=model.skin_weights,
        hands_components=model.hands_components * flip45[None, :],
        hands_mean=model.hands_mean * flip45,
        faces=model.faces.flip(1),
        side="left" if model.side == "right" else "right",
    )


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
    full_pose = pca_to_full_pose(model, pose_pca, use_pca, flat_hand_mean)
    all_aa = torch.cat([global_rot, full_pose], dim=-1).reshape(b, 16, 3)
    return mano_forward_rotmat(model, rodrigues(all_aa), betas, trans=trans,
                               center_idx=center_idx, scale_mm=scale_mm)


def mano_forward_rotmat(
    model: ManoModel,
    rots: torch.Tensor,
    betas: torch.Tensor,
    trans: torch.Tensor | None = None,
    center_idx: int | None = None,
    scale_mm: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """MANO forward from the 16 joints' rotation matrices (B, 16, 3, 3),
    the root's first: ``mano_forward``'s body after Rodrigues, with its
    ``trans``, ``center_idx`` and ``scale_mm``. A model that regresses
    rotations (HaMeR's 6D) calls it directly, without a round trip through
    axis-angle."""
    b = rots.shape[0]
    dtype = rots.dtype
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

    tip_ids, reorder = mano_indices(verts.device)
    tips = verts[:, tip_ids]
    joints = torch.cat([joints_kin, tips], dim=1)[:, reorder]

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
