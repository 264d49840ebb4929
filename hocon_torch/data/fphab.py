"""FPHAB (First-Person Hand Action Benchmark, "fhbhands") dataset parser.

Port of ``hocon/data/fphab.py``: walks the annotation tree, builds the
per-frame sample index, converts world-frame skeletons to the colour camera
frame, loads the 4 object models and their per-frame 6-DoF poses, marks
the ``--fraction`` sparse supervision and samples temporal pairs, with the
reference's constants, order and ``rng`` calls, so both packages index the
same samples.

Expected directory layout (the official download):
  root/
    Video_files/Subject_K/<action>/<seq>/color/color_%04d.jpeg
    Hand_pose_annotation_v1/Subject_K/<action>/<seq>/skeleton.txt
        each line: frame_idx + 63 floats (21 joints x 3, world frame, mm)
    Object_6D_pose_annotation_v1_1/Subject_K/<action>/<seq>/object_pose.txt
        each line: frame_idx + 16 floats (row-major 4x4 object->world, mm)
    Object_models/<name>_model/<name>_model.ply
    fhbhands_fits/Subject_K/<action>/<seq>/fits.pkl   (optional MANO fits)

The MANO fit vertices are computed once at construction by the port's
``mano_forward`` on the MANO model's device; ``get_sample`` is host-side
indexing only.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np
import torch

from hocon_torch.data.meshes import decimate_mesh
from hocon_torch.data.pairing import pair_target
from hocon_torch.data.queries import BaseQueries

# Color-camera intrinsics (FPHAB documentation).
CAM_INTR = np.array(
    [
        [1395.749023, 0.0, 935.732544],
        [0.0, 1395.749268, 540.681030],
        [0.0, 0.0, 1.0],
    ],
    np.float32,
)

# World (skeleton) frame -> color camera frame; translation in mm.
CAM_EXTR = np.array(
    [
        [0.999988496304, -0.00468848412856, 0.000982563360594, 25.7],
        [0.00469115935266, 0.999985218048, -0.00273845880292, 1.22],
        [-0.000969709653873, 0.00274303671904, 0.99999576807, 3.902],
        [0.0, 0.0, 0.0, 1.0],
    ],
    np.float32,
)

# FPHAB skeleton order: [Wrist, TMCP, IMCP, MMCP, RMCP, PMCP, TPIP, TDIP,
# TTIP, IPIP, IDIP, ITIP, MPIP, MDIP, MTIP, RPIP, RDIP, RTIP, PPIP, PDIP,
# PTIP] -> standard [wrist, thumb(1..tip), index, middle, ring, pinky].
REORDER_IDX = (0, 1, 6, 7, 8, 2, 9, 10, 11, 3, 12, 13, 14, 4, 15, 16, 17, 5, 18, 19, 20)

OBJECTS = ("juice_bottle", "liquid_soap", "milk", "salt")

# Subject split used by the reference for train/test.
TRAIN_SUBJECTS = ("Subject_1", "Subject_3", "Subject_4")
TEST_SUBJECTS = ("Subject_2", "Subject_5", "Subject_6")

# Actions with object 6-DoF annotations (the subset the reference trains
# the object branch on).
OBJECT_ACTIONS = {
    "open_juice_bottle": "juice_bottle",
    "close_juice_bottle": "juice_bottle",
    "pour_juice_bottle": "juice_bottle",
    "open_liquid_soap": "liquid_soap",
    "close_liquid_soap": "liquid_soap",
    "pour_liquid_soap": "liquid_soap",
    "open_milk": "milk",
    "close_milk": "milk",
    "pour_milk": "milk",
    "put_salt": "salt",
}


def load_skeletons(path: str) -> dict[int, np.ndarray]:
    """skeleton.txt -> {frame_idx: (21, 3) world-frame mm}."""
    out = {}
    with open(path) as f:
        for line in f:
            vals = line.split()
            if len(vals) != 64:
                continue
            out[int(float(vals[0]))] = np.asarray(vals[1:], np.float32).reshape(21, 3)
    return out


def load_object_poses(path: str) -> dict[int, np.ndarray]:
    """object_pose.txt -> {frame_idx: (4, 4) object->world, mm translation}."""
    out = {}
    with open(path) as f:
        for line in f:
            vals = line.split()
            if len(vals) != 17:
                continue
            out[int(float(vals[0]))] = np.asarray(vals[1:], np.float32).reshape(4, 4)
    return out


def load_ply(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Minimal ASCII/binary-LE PLY loader -> (verts (V,3), faces (F,3))."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            header.append(line)
            if line == "end_header":
                break
        n_vert = n_face = 0
        fmt = "ascii"
        vert_props = []
        in_vertex = False
        for line in header:
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element vertex"):
                n_vert = int(line.split()[-1])
                in_vertex = True
            elif line.startswith("element face"):
                n_face = int(line.split()[-1])
                in_vertex = False
            elif line.startswith("property") and in_vertex:
                vert_props.append(line.split()[1])
        if fmt == "ascii":
            verts = [[float(v) for v in f.readline().split()[:3]] for _ in range(n_vert)]
            faces = [[int(v) for v in f.readline().split()[1:4]] for _ in range(n_face)]
            return np.asarray(verts, np.float32), np.asarray(faces, np.int32)
        # binary_little_endian with float vertex properties
        n_props = len(vert_props)
        vert_data = np.frombuffer(f.read(n_vert * n_props * 4), dtype="<f4").reshape(n_vert, n_props)
        verts = vert_data[:, :3].copy()
        faces = np.empty((n_face, 3), np.int32)
        for i in range(n_face):
            (cnt,) = np.frombuffer(f.read(1), dtype=np.uint8)
            idx = np.frombuffer(f.read(int(cnt) * 4), dtype="<i4")
            faces[i] = idx[:3]
        return verts, faces


def load_mano_fits(path: str) -> dict[int, dict]:
    """Per-sequence precomputed MANO fits: ``fits.pkl`` maps ``frame_idx ->
    {"pose": (48,) axis-angle incl. root, "shape"|"betas": (10,), "trans":
    (3,) meters}`` in the colour-camera frame (the reference's
    "fhbhands_fits" layout, to re-verify against the real download)."""
    with open(path, "rb") as f:
        raw = pickle.load(f, encoding="latin1")
    out = {}
    for k, v in raw.items():
        out[int(k)] = {
            "pose": np.asarray(v["pose"], np.float32).reshape(48),
            "betas": np.asarray(v.get("betas", v.get("shape")), np.float32).reshape(10),
            "trans": np.asarray(v.get("trans", np.zeros(3)), np.float32),
        }
    return out


def _mark_supervised(n_frames_per_seq: list[int], fraction: float, seed: int = 0) -> np.ndarray:
    """Per-frame supervision mask: ~fraction of frames per sequence, evenly
    spaced, always including frame 0 (the reference's reading of
    ``--fraction``, to re-verify against its published code)."""
    flags = []
    step = max(1, int(round(1.0 / max(fraction, 1e-6))))
    for n in n_frames_per_seq:
        m = np.zeros(n, bool)
        m[::step] = True
        flags.append(m)
    return np.concatenate(flags) if flags else np.zeros(0, bool)


def fit_vertices(mano, pose: np.ndarray, betas: np.ndarray, trans: np.ndarray,
                 chunk: int = 1024) -> np.ndarray:
    """MANO vertices (N, 778, 3) f32 on the host for full-pose fits: pose
    (N, 48) axis-angle with the root first, betas (N, 10), trans (N, 3) in
    meters. Runs ``mano_forward`` on the model's device, ``chunk`` frames
    per call."""
    from hocon_torch.geometry.mano import mano_forward

    dev = mano.v_template.device
    out = np.empty((len(pose), mano.n_verts, 3), np.float32)
    with torch.no_grad():
        for s0 in range(0, len(pose), chunk):
            p, b, t = (torch.from_numpy(np.ascontiguousarray(a[s0:s0 + chunk])).to(dev)
                       for a in (pose, betas, trans))
            v, _ = mano_forward(mano, p[:, 3:], b, p[:, :3], trans=t, use_pca=False,
                                flat_hand_mean=False, scale_mm=False)
            out[s0:s0 + len(p)] = v.cpu().numpy()
    return out


def sequence_pair(ds, i: int, rng: np.random.Generator) -> tuple[int, int]:
    """(nearest annotated ref, i's frame or a spaced neighbour) in i's
    sequence, for a parser with ``_seq_bounds``, ``_sample_seq`` and
    ``supervised``; offsets as ``pairing.pair_target``."""
    start, count = ds._seq_bounds[ds._sample_seq[i]]
    sup_local = np.nonzero(ds.supervised[start:start + count])[0]
    ref = int(sup_local[np.argmin(np.abs(sup_local - (i - start)))])
    tgt = pair_target(ref, count, ds.pair_spacing, rng, fixed=ds.pair_fixed_spacing)
    return start + ref, start + tgt


class FPHAB:
    """Pose-dataset-protocol implementation for FPHAB."""

    def __init__(
        self,
        root: str,
        split: str = "train",
        fraction: float = 1.0,
        use_objects: bool = False,
        pair_spacing: int = 8,
        pair_fixed_spacing: bool = False,
        decimate_objects_to: Optional[int] = None,
        mano=None,
    ):
        """``mano``: optional ManoModel; with it and MANO fits under
        ``root/fhbhands_fits/``, samples carry GT hand vertices.
        ``decimate_objects_to``: face budget for the object meshes."""
        self.root = root
        self.split = split
        self.pair_spacing = pair_spacing
        self.pair_fixed_spacing = pair_fixed_spacing
        self.mano = mano
        subjects = TRAIN_SUBJECTS if split == "train" else TEST_SUBJECTS

        skel_root = os.path.join(root, "Hand_pose_annotation_v1")
        video_root = os.path.join(root, "Video_files")
        obj_pose_root = os.path.join(root, "Object_6D_pose_annotation_v1_1")
        fits_root = os.path.join(root, "fhbhands_fits")

        self.objects = {}
        if use_objects:
            for name in OBJECTS:
                ply = os.path.join(root, "Object_models", f"{name}_model", f"{name}_model.ply")
                if os.path.exists(ply):
                    verts, faces = load_ply(ply)
                    if decimate_objects_to:
                        verts, faces = decimate_mesh(verts, faces, decimate_objects_to)
                    self.objects[name] = (verts / 1000.0, faces)  # mm -> m

        self.samples = []  # per frame: image path, camera-frame joints, object, fit
        seq_lengths = []
        self._seq_bounds = []  # (start, length) per sequence
        for subject in sorted(subjects):
            subj_dir = os.path.join(skel_root, subject)
            if not os.path.isdir(subj_dir):
                continue
            for action in sorted(os.listdir(subj_dir)):
                if use_objects and action not in OBJECT_ACTIONS:
                    continue
                act_dir = os.path.join(subj_dir, action)
                for seq in sorted(os.listdir(act_dir)):
                    skel_path = os.path.join(act_dir, seq, "skeleton.txt")
                    if not os.path.exists(skel_path):
                        continue
                    skels = load_skeletons(skel_path)
                    fits = {}
                    if mano is not None:
                        fit_pkl = os.path.join(fits_root, subject, action, seq, "fits.pkl")
                        if os.path.exists(fit_pkl):
                            fits = load_mano_fits(fit_pkl)
                    obj_poses = {}
                    obj_name = OBJECT_ACTIONS.get(action)
                    if use_objects and obj_name in self.objects:
                        p = os.path.join(obj_pose_root, subject, action, seq, "object_pose.txt")
                        if os.path.exists(p):
                            obj_poses = load_object_poses(p)
                    start = len(self.samples)
                    count = 0
                    for frame_idx in sorted(skels):
                        if use_objects and frame_idx not in obj_poses:
                            continue
                        img = os.path.join(video_root, subject, action, seq, "color",
                                           f"color_{frame_idx:04d}.jpeg")
                        world_mm = skels[frame_idx][list(REORDER_IDX)]
                        cam_mm = world_mm @ CAM_EXTR[:3, :3].T + CAM_EXTR[:3, 3]
                        self.samples.append(dict(
                            image_path=img,
                            joints3d_cam=cam_mm / 1000.0,
                            obj_name=obj_name if obj_poses else None,
                            obj_pose_world=obj_poses.get(frame_idx),
                            mano_fit=fits.get(frame_idx),
                            seq_id=(subject, action, seq),
                            frame_idx=frame_idx,
                        ))
                        count += 1
                    if count:
                        seq_lengths.append(count)
                        self._seq_bounds.append((start, count))

        self.supervised = (
            _mark_supervised(seq_lengths, fraction)
            if split == "train"
            else np.ones(len(self.samples), bool)
        )
        self._sample_seq = np.zeros(len(self.samples), np.int64)
        for si, (start, count) in enumerate(self._seq_bounds):
            self._sample_seq[start:start + count] = si
        self._precompute_fit_verts()

    def _precompute_fit_verts(self, chunk: int = 1024):
        """The MANO forward over every fitted frame, once, at construction:
        ``get_sample`` then only indexes one host array."""
        self._fit_row = np.full(len(self.samples), -1, np.int64)
        if self.mano is None:
            return
        rows = [i for i, s in enumerate(self.samples) if s.get("mano_fit") is not None]
        if not rows:
            return
        pose, betas, trans = (
            np.stack([self.samples[i]["mano_fit"][k] for i in rows])
            for k in ("pose", "betas", "trans")
        )
        self._fit_verts = fit_vertices(self.mano, pose, betas, trans, chunk)
        self._fit_row[rows] = np.arange(len(rows))

    def __getstate__(self):
        """Pickle without the MANO model, whose tensors may live on the card:
        the unpickled copy serves ``get_sample`` and ``sample_pair``, which
        are host code."""
        return {**self.__dict__, "mano": None}

    def available_queries(self) -> set:
        qs = {BaseQueries.IMAGE, BaseQueries.JOINTS2D, BaseQueries.JOINTS3D,
              BaseQueries.CAMINTR, BaseQueries.SIDE, BaseQueries.CENTER3D}
        if self.objects:
            qs |= {BaseQueries.OBJVERTS3D, BaseQueries.OBJVERTSCAN,
                   BaseQueries.OBJFACES, BaseQueries.OBJPOSE,
                   BaseQueries.OBJCORNERS}
        if self.mano is not None and any(s.get("mano_fit") is not None for s in self.samples):
            qs.add(BaseQueries.VERTS3D)
        return qs

    def __len__(self):
        return len(self.samples)

    def get_sample(self, i: int) -> dict:
        s = self.samples[i]
        out = {
            "image_path": s["image_path"],
            "joints3d_cam": s["joints3d_cam"].astype(np.float32),
            "verts3d_cam": self._fit_verts[self._fit_row[i]] if self._fit_row[i] >= 0 else None,
            "camintr": CAM_INTR,
            "obj_verts_can": None,
            "obj_faces": None,
            "obj_pose": None,
            "supervised": bool(self.supervised[i]),
            "seq_id": s["seq_id"],
            "frame_idx": s["frame_idx"],
            "side": "right",
        }
        if s["obj_name"] is not None and s["obj_pose_world"] is not None:
            verts, faces = self.objects[s["obj_name"]]
            pose = CAM_EXTR @ s["obj_pose_world"]  # object -> camera, mm
            pose[:3, 3] /= 1000.0  # m
            out.update(obj_verts_can=verts, obj_faces=faces, obj_pose=pose)
        return out

    def sample_pair(self, i: int, rng: np.random.Generator) -> tuple[int, int]:
        """(nearest annotated ref, i's frame or a spaced neighbour) in i's
        sequence (``pairing.pair_target``)."""
        return sequence_pair(self, i, rng)
