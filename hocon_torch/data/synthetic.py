"""Synthetic pose dataset: the rendered synthetic MANO hand plus an object.

Port of ``hocon/data/synthetic.py``. Videos are smooth interpolations of
MANO parameters drawn from ``default_rng(seed)`` in the reference's order;
an object (a 12-face box, or a UV sphere of ~``obj_n_faces`` triangles
standing in for a decimated YCB mesh) follows the wrist. Every frame is
rendered once at construction with the port's MANO, projection and soft
rasterizer (vertex colours, sigma 0.7, gamma 1/40, no backface culling):
on CUDA through kernel K1, as the reference renders through its Pallas
kernel on the TPU; on the CPU through the unculled ``xla`` backend, as the
reference does off the TPU. Arrays come back to the host as numpy.

The reference caches its renders on disk, because a render over its TPU
connection took minutes; the port renders all frames in one K1 launch and
keeps no cache.
"""

from __future__ import annotations

import numpy as np
import torch

from hocon_torch.data.meshes import orient_faces_outward
from hocon_torch.data.pairing import pair_target
from hocon_torch.data.queries import BaseQueries
from hocon_torch.device import resolve_device
from hocon_torch.geometry.mano import ManoModel, mano_forward, synthetic_mano_model
from hocon_torch.geometry.project import persp_project
from hocon_torch.render.raster import soft_rasterize

OBJ_SCALE = 0.06  # object size of the synthetic dataset (meters)
OBJ_OFFSET = np.array([0.0, 0.04, 0.02], np.float32)  # object centre from the wrist
RENDER_SIGMA = 0.7
BACKGROUND = 0.15  # grey level of uncovered pixels

_BOX_VERTS = (
    np.array(
        [
            [-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
            [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1],
        ],
        np.float32,
    )
    * 0.5
)
_BOX_FACES = np.array(
    [
        [0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],
        [0, 1, 5], [0, 5, 4], [2, 3, 7], [2, 7, 6],
        [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7],
    ],
    np.int32,
)


def synthetic_camintr(image_size: int) -> np.ndarray:
    """The synthetic dataset's intrinsics: f = 1.6 * S, centre S / 2."""
    f = image_size * 1.6
    return np.array(
        [[f, 0, image_size / 2], [0, f, image_size / 2], [0, 0, 1]], np.float32
    )


def uv_sphere(target_faces: int) -> tuple[np.ndarray, np.ndarray]:
    """Unit UV sphere with ~``target_faces`` triangles, wound outward."""
    nlon = max(8, int(round(np.sqrt(target_faces / 2.0))))
    nlat = max(3, int(round(target_faces / (2.0 * nlon))) + 1)
    ring_i = np.arange(1, nlat)
    theta = np.pi * ring_i / nlat
    phi = 2.0 * np.pi * np.arange(nlon) / nlon
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    rings = np.stack(
        [st * np.cos(phi)[None], st * np.sin(phi)[None],
         np.broadcast_to(ct, (nlat - 1, nlon))],
        axis=-1,
    ).reshape(-1, 3)
    verts = np.concatenate(
        [rings, [[0.0, 0.0, 1.0]], [[0.0, 0.0, -1.0]]], axis=0
    ).astype(np.float32)
    top, bot = len(rings), len(rings) + 1
    faces = []

    def idx(i, j):
        return i * nlon + (j % nlon)

    for j in range(nlon):  # pole fans
        faces.append([top, idx(0, j + 1), idx(0, j)])
        faces.append([bot, idx(nlat - 2, j), idx(nlat - 2, j + 1)])
    for i in range(nlat - 2):  # ring quads -> 2 triangles
        for j in range(nlon):
            a, b = idx(i, j), idx(i, j + 1)
            c, d = idx(i + 1, j), idx(i + 1, j + 1)
            faces.append([a, d, b])
            faces.append([a, c, d])
    return verts, orient_faces_outward(verts, np.asarray(faces, np.int32))


def vertex_colors(nv: int) -> np.ndarray:
    """High-frequency procedural vertex colours (photometric texture)."""
    i = np.arange(nv, dtype=np.float32)
    return np.stack(
        [
            0.5 + 0.5 * np.sin(i * 0.7),
            0.5 + 0.5 * np.sin(i * 1.3 + 1.0),
            0.5 + 0.5 * np.sin(i * 2.9 + 2.0),
        ],
        axis=-1,
    ).astype(np.float32)


def object_poses(joints: np.ndarray) -> np.ndarray:
    """(N, 4, 4) object poses: identity rotation, the wrist plus a fixed
    offset."""
    pose = np.tile(np.eye(4, dtype=np.float32), (len(joints), 1, 1))
    pose[:, :3, 3] = joints[:, 0] + OBJ_OFFSET
    return pose


@torch.no_grad()
def render_frames(
    verts: np.ndarray,
    faces: np.ndarray,
    camintr: np.ndarray,
    image_size: int,
    device: torch.device,
) -> np.ndarray:
    """uint8 (N, S, S, 3) frames of camera-space meshes (N, V, 3) with
    faces (F, 3), in ``vertex_colors``, as the reference forms them:
    ``clip(attr, 0, 1) * sil + 0.15 * (1 - sil)``, scaled by 255 and
    truncated. On CUDA the render runs kernel K1 (3 colour channels)."""
    dev = torch.device(device)
    v = torch.from_numpy(np.ascontiguousarray(verts, np.float32)).to(dev)
    n, nv = v.shape[:2]
    k = torch.from_numpy(camintr).to(dev)[None].expand(n, 3, 3)
    colors = torch.from_numpy(vertex_colors(nv)).to(dev)[None].expand(n, nv, 3)
    out = soft_rasterize(
        persp_project(v, k), v[..., 2], torch.from_numpy(np.asarray(faces)).to(dev),
        attrs=colors, image_size=(image_size, image_size), sigma=RENDER_SIGMA,
        backend="auto" if dev.type == "cuda" else "xla",
    )
    sil = out.sil.cpu().numpy()[..., None]
    rgb = np.clip(out.attr.cpu().numpy(), 0, 1) * sil + BACKGROUND * (1 - sil)
    return (rgb * 255).astype(np.uint8)


class SyntheticHandDataset:
    """Pose-dataset protocol over procedurally rendered clips.

    ``device`` is where the frames are rendered (``resolve_device``: CUDA
    when None, or raise); ``mano`` must live there.
    """

    def __init__(
        self,
        n_videos: int = 4,
        frames_per_video: int = 6,
        image_size: int = 64,
        seed: int = 0,
        mano: ManoModel | None = None,
        supervised_fraction: float = 1.0,
        with_object: bool = True,
        pair_spacing: int = 2,
        pair_fixed_spacing: bool = False,
        obj_n_faces: int = 0,
        device: str | torch.device | None = None,
    ):
        dev = resolve_device(device)
        self.mano = mano if mano is not None else synthetic_mano_model(0, device=dev)
        self.image_size = image_size
        self.pair_spacing = pair_spacing
        self.pair_fixed_spacing = pair_fixed_spacing
        self.frames_per_video = frames_per_video
        n = n_videos * frames_per_video
        rng = np.random.default_rng(seed)

        # Smoothly interpolated MANO parameters per video.
        pose0 = rng.standard_normal((n_videos, 15)).astype(np.float32) * 0.3
        pose1 = pose0 + rng.standard_normal((n_videos, 15)).astype(np.float32) * 0.4
        root0 = rng.standard_normal((n_videos, 3)).astype(np.float32) * 0.3
        root1 = root0 + rng.standard_normal((n_videos, 3)).astype(np.float32) * 0.3
        trans0 = np.concatenate(
            [rng.uniform(-0.03, 0.03, (n_videos, 2)), rng.uniform(0.55, 0.7, (n_videos, 1))],
            axis=1,
        ).astype(np.float32)
        trans1 = trans0 + rng.uniform(-0.04, 0.04, (n_videos, 3)).astype(np.float32)

        t = np.linspace(0.0, 1.0, frames_per_video, dtype=np.float32)

        def lerp(a, b):
            return (a[:, None] * (1 - t[None, :, None])
                    + b[:, None] * t[None, :, None]).reshape(n, -1)

        self.pose, self.root, self.trans = lerp(pose0, pose1), lerp(root0, root1), lerp(trans0, trans1)
        self.betas = np.zeros((n, 10), np.float32)
        self.camintr = synthetic_camintr(image_size)

        self.obj_scale = OBJ_SCALE
        if obj_n_faces and obj_n_faces > 12:
            sv, sf = uv_sphere(obj_n_faces)
            self.obj_verts_can = sv * (self.obj_scale * 0.5)
            self.obj_faces = sf
        else:
            self.obj_verts_can = _BOX_VERTS * self.obj_scale
            self.obj_faces = _BOX_FACES
        self.with_object = with_object

        with torch.no_grad():
            verts, joints = mano_forward(
                self.mano, *(torch.from_numpy(x).to(dev) for x in
                             (self.pose, self.betas, self.root)),
                trans=torch.from_numpy(self.trans).to(dev), scale_mm=False,
            )
        self.verts = verts.cpu().numpy()
        self.joints = joints.cpu().numpy()
        self.obj_pose = object_poses(self.joints)
        self.images = render_frames(*self.meshes(self.verts, self.joints), self.camintr,
                                    image_size, dev)

        # Sparse supervision: mark ~fraction of frames per video, always
        # including the first frame (the annotated "ref" anchor).
        self.supervised = np.zeros(n, bool)
        step = max(1, int(round(1.0 / max(supervised_fraction, 1e-6))))
        for v in range(n_videos):
            idx = np.arange(v * frames_per_video, (v + 1) * frames_per_video)
            self.supervised[idx[::step]] = True

    def meshes(self, verts: np.ndarray, joints: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """The rendered meshes of hands ``verts`` (N, 778, 3) with
        ``joints`` (N, 21, 3): (N, V, 3) camera-space vertices, the hand's
        and then (with an object) the object's at the wrist, and their
        (F, 3) faces."""
        faces = self.mano.faces.cpu().numpy()
        if not self.with_object:
            return verts, faces
        pose = object_poses(joints)
        obj_v = self.obj_verts_can[None] @ pose[:, :3, :3].transpose(0, 2, 1) + pose[:, None, :3, 3]
        return (np.concatenate([verts, obj_v], axis=1),
                np.concatenate([faces, self.obj_faces + verts.shape[1]], axis=0))

    def __getstate__(self):
        """Pickle without the MANO model, whose tensors may live on the card:
        the unpickled copy serves ``get_sample`` and ``sample_pair``, which
        are host code."""
        return {**self.__dict__, "mano": None}

    def available_queries(self) -> set:
        qs = {BaseQueries.IMAGE, BaseQueries.JOINTS2D, BaseQueries.JOINTS3D,
              BaseQueries.VERTS3D, BaseQueries.CAMINTR, BaseQueries.SIDE,
              BaseQueries.CENTER3D}
        if self.with_object:
            qs |= {BaseQueries.OBJVERTS3D, BaseQueries.OBJVERTSCAN,
                   BaseQueries.OBJFACES, BaseQueries.OBJPOSE,
                   BaseQueries.OBJCORNERS}
        return qs

    def __len__(self):
        return len(self.images)

    def get_sample(self, i: int) -> dict:
        return {
            "image": self.images[i],
            "joints3d_cam": self.joints[i],
            "verts3d_cam": self.verts[i],
            "camintr": self.camintr,
            "obj_verts_can": self.obj_verts_can if self.with_object else None,
            "obj_faces": self.obj_faces if self.with_object else None,
            "obj_pose": self.obj_pose[i] if self.with_object else None,
            "supervised": bool(self.supervised[i]),
            "seq_id": i // self.frames_per_video,
            "frame_idx": i % self.frames_per_video,
            "side": "right",
        }

    def sample_pair(self, i: int, rng: np.random.Generator) -> tuple[int, int]:
        """(annotated ref frame, temporally-offset tgt frame) in i's video."""
        video = i // self.frames_per_video
        base = video * self.frames_per_video
        sup = np.nonzero(self.supervised[base : base + self.frames_per_video])[0]
        local = i - base
        ref_local = int(sup[np.argmin(np.abs(sup - local))])
        tgt_local = pair_target(ref_local, self.frames_per_video,
                                self.pair_spacing, rng,
                                fixed=self.pair_fixed_spacing)
        return base + ref_local, base + tgt_local
