"""HO-3D (v2) dataset parser.

Port of ``hocon/data/ho3d.py``: per-frame meta pickles (handJoints3D,
handPose (48), handBeta, objRot / objTrans / objName, camMat), YCB object
models, the fully annotated train split and the evaluation split with only
the root and the object pose (predictions go to the CodaLab server; see
``hocon_torch.evaluation.codalab``).

Layout (official download):
  root/train/<seq>/rgb/%04d.png     + meta/%04d.pkl
  root/evaluation/<seq>/rgb/%04d.png + meta/%04d.pkl
  root/evaluation.txt, root/train.txt (frame lists "seq/%04d")
  ycb_root/models/<objName>/points.xyz (+ textured_simple.obj)

HO-3D annotations use the OpenGL camera convention: y and z are negated
relative to the CV convention used everywhere else (``COORD_FLIP``). Joint
order in the pickles is MANO kinematic order + appended fingertips;
``MANO_TO_STANDARD`` reorders to the standard evaluation order.

Every meta pickle is parsed once at construction, the MANO fit vertices are
computed then (the port's ``mano_forward`` on the MANO model's device) into
a disk-backed memmap, and the object rotations go through one batched
``rot.rodrigues``: ``get_sample`` is host-side indexing only.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Optional

import numpy as np
import torch

from hocon_torch.data.fphab import _mark_supervised, fit_vertices, sequence_pair
from hocon_torch.data.meshes import decimate_mesh
from hocon_torch.data.queries import BaseQueries

COORD_FLIP = np.diag([1.0, -1.0, -1.0]).astype(np.float32)

# MANO kinematic order (+5 tips) -> standard evaluation order.
MANO_TO_STANDARD = (
    0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18, 10, 11, 12, 19, 7, 8, 9, 20
)

# Keys the fit-vertex cache files; differs from the reference's tag, so the
# two packages never read each other's vertices.
FIT_CACHE_TAG = b"ho3d-fit-verts-torch-v1"


def load_xyz_points(path: str) -> np.ndarray:
    return np.loadtxt(path, dtype=np.float32)[:, :3]


def _mano_digest(mano) -> bytes:
    """The MANO model's arrays as a digest (the port's ManoModel carries no
    asset digest): another model gives another cache file."""
    h = hashlib.sha256()
    for name in ("v_template", "shapedirs", "posedirs", "joint_regressor", "skin_weights",
                 "hands_components", "hands_mean"):
        h.update(getattr(mano, name).detach().cpu().numpy().tobytes())
    return h.digest()


class HO3D:
    """Pose-dataset-protocol implementation for HO-3D v2."""

    def __init__(
        self,
        root: str,
        split: str = "train",
        ycb_root: Optional[str] = None,
        fraction: float = 1.0,
        use_objects: bool = False,
        pair_spacing: int = 8,
        pair_fixed_spacing: bool = False,
        mano=None,
        decimate_objects_to: Optional[int] = None,
        cache_dir: Optional[str] = None,
    ):
        """``mano``: optional ManoModel; with it, train-split samples carry GT
        hand vertices from the per-frame MANO fits (handPose / handBeta /
        handTrans). ``cache_dir``: where the fit-vertex memmap lives (the
        reference's: ``HOCON_CACHE_DIR``, else ``~/.cache/hocon``, if None)."""
        self.root = root
        self.split = split
        self.pair_spacing = pair_spacing
        self.pair_fixed_spacing = pair_fixed_spacing
        self.use_objects = use_objects
        self.mano = mano
        self.decimate_objects_to = decimate_objects_to
        self.ycb_root = ycb_root or os.path.join(root, "models_root")
        self.cache_dir = cache_dir or os.environ.get(
            "HOCON_CACHE_DIR", os.path.expanduser("~/.cache/hocon"))

        split_dir = "train" if split == "train" else "evaluation"
        list_file = os.path.join(root, "train.txt" if split == "train" else "evaluation.txt")
        entries = []
        if os.path.exists(list_file):
            with open(list_file) as f:
                entries = [ln.strip() for ln in f if ln.strip()]
        else:  # fall back to a directory walk
            base = os.path.join(root, split_dir)
            for seq in sorted(os.listdir(base)):
                meta_dir = os.path.join(base, seq, "meta")
                if not os.path.isdir(meta_dir):
                    continue
                for fn in sorted(os.listdir(meta_dir)):
                    entries.append(f"{seq}/{os.path.splitext(fn)[0]}")

        self.split_dir = split_dir
        self.entries = entries
        self._obj_cache: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        self._parse_metas()
        self._precompute_fit_verts()
        self._precompute_obj_poses()

        # Group by sequence for pair sampling / fraction marking.
        self._seq_bounds = []
        seq_lengths = []
        last_seq, start = None, 0
        for i, e in enumerate(entries):
            seq = e.split("/")[0]
            if seq != last_seq:
                if last_seq is not None:
                    self._seq_bounds.append((start, i - start))
                    seq_lengths.append(i - start)
                last_seq, start = seq, i
        if last_seq is not None:
            self._seq_bounds.append((start, len(entries) - start))
            seq_lengths.append(len(entries) - start)

        self.supervised = (
            _mark_supervised(seq_lengths, fraction)
            if split == "train"
            else np.ones(len(entries), bool)
        )
        self._sample_seq = np.zeros(len(entries), np.int64)
        for si, (s, c) in enumerate(self._seq_bounds):
            self._sample_seq[s:s + c] = si

    def available_queries(self) -> set:
        qs = {BaseQueries.IMAGE, BaseQueries.JOINTS2D, BaseQueries.JOINTS3D,
              BaseQueries.CAMINTR, BaseQueries.SIDE, BaseQueries.CENTER3D}
        if self.mano is not None and self.split == "train":
            qs.add(BaseQueries.VERTS3D)
        if self.use_objects:
            qs |= {BaseQueries.OBJVERTS3D, BaseQueries.OBJVERTSCAN,
                   BaseQueries.OBJFACES, BaseQueries.OBJPOSE,
                   BaseQueries.OBJCORNERS}
        return qs

    def __len__(self):
        return len(self.entries)

    def _load_object(self, name: str) -> tuple[np.ndarray, Optional[np.ndarray]]:
        if name not in self._obj_cache:
            base = os.path.join(self.ycb_root, "models", name)
            obj_path = os.path.join(base, "textured_simple.obj")
            if os.path.exists(obj_path):
                verts, faces = _load_obj(obj_path)
                if self.decimate_objects_to:
                    verts, faces = decimate_mesh(verts, faces, self.decimate_objects_to)
            else:
                verts = load_xyz_points(os.path.join(base, "points.xyz"))
                faces = None
            self._obj_cache[name] = (verts, faces)
        return self._obj_cache[name]

    def _meta_path(self, entry: str) -> str:
        seq, fid = entry.split("/")
        return os.path.join(self.root, self.split_dir, seq, "meta", fid + ".pkl")

    def _rgb_path(self, entry: str) -> str:
        seq, fid = entry.split("/")
        base = os.path.join(self.root, self.split_dir, seq, "rgb", fid)
        for ext in (".png", ".jpg", ".jpeg"):
            if os.path.exists(base + ext):
                return base + ext
        return base + ".png"

    def _parse_metas(self):
        """One pass over all meta pickles into compact arrays."""
        n = len(self.entries)
        self._camintr = np.zeros((n, 3, 3), np.float32)
        self._joints_cam = np.zeros((n, 21, 3), np.float32)
        self._pose48 = np.zeros((n, 48), np.float32)
        self._betas = np.zeros((n, 10), np.float32)
        self._trans = np.zeros((n, 3), np.float32)
        self._has_fit = np.zeros(n, bool)
        self._obj_rvec = np.zeros((n, 3), np.float32)
        self._obj_tvec = np.zeros((n, 3), np.float32)
        self._has_obj = np.zeros(n, bool)
        self._obj_name: list[Optional[str]] = [None] * n
        reorder = list(MANO_TO_STANDARD)
        for i, entry in enumerate(self.entries):
            with open(self._meta_path(entry), "rb") as f:
                meta = pickle.load(f, encoding="latin1")
            self._camintr[i] = np.asarray(meta["camMat"], np.float32)
            joints = meta.get("handJoints3D")
            if joints is not None and np.asarray(joints).ndim == 2:
                self._joints_cam[i] = np.asarray(joints, np.float32)[reorder] @ COORD_FLIP.T
            elif joints is not None:  # evaluation split: root joint only
                root = np.asarray(joints, np.float32) @ COORD_FLIP.T
                self._joints_cam[i] = np.tile(root[None], (21, 1))
            if meta.get("handPose") is not None and meta.get("handBeta") is not None:
                self._has_fit[i] = True
                self._pose48[i] = np.asarray(meta["handPose"], np.float32)
                self._betas[i] = np.asarray(meta["handBeta"], np.float32)
                self._trans[i] = np.asarray(meta.get("handTrans", np.zeros(3)), np.float32)
            if meta.get("objName") is not None:
                self._has_obj[i] = True
                self._obj_name[i] = meta["objName"]
                self._obj_rvec[i] = np.asarray(meta["objRot"], np.float32).ravel()
                self._obj_tvec[i] = np.asarray(meta["objTrans"], np.float32).ravel()

    def _fit_cache_path(self, rows: np.ndarray) -> str:
        """Content-keyed cache file for the fit vertices: the fit inputs of
        the fitted rows and the MANO model's arrays, under ``FIT_CACHE_TAG``."""
        h = hashlib.sha256()
        h.update(FIT_CACHE_TAG)
        h.update(_mano_digest(self.mano))
        for arr in (self._pose48[rows], self._betas[rows], self._trans[rows]):
            h.update(np.ascontiguousarray(arr).tobytes())
        return os.path.join(self.cache_dir, f"ho3d-fits-{h.hexdigest()[:16]}.f32")

    def _precompute_fit_verts(self, chunk: int = 1024):
        """The MANO forward over every fitted frame, once, into a disk-backed
        memmap (the full train split is ~66k frames x 778 x 3 f32, ~620 MB,
        which stays out of resident memory), reused by later constructions
        and reopened by unpickled copies (``__getstate__``)."""
        n = len(self.entries)
        self._fit_row = np.full(n, -1, np.int64)
        self._fit_verts = None
        self._fit_path = None
        self._fit_shape = None
        if self.mano is None or not self._has_fit.any():
            return

        rows = np.nonzero(self._has_fit)[0]
        m = len(rows)
        self._fit_shape = (m, self.mano.n_verts, 3)
        self._fit_path = self._fit_cache_path(rows)
        nbytes = m * self.mano.n_verts * 3 * 4
        if not (os.path.exists(self._fit_path) and os.path.getsize(self._fit_path) == nbytes):
            os.makedirs(os.path.dirname(self._fit_path), exist_ok=True)
            tmp = self._fit_path + f".tmp{os.getpid()}"
            out = np.memmap(tmp, np.float32, "w+", shape=self._fit_shape)
            for s0 in range(0, m, chunk):
                sel = rows[s0:s0 + chunk]
                v = fit_vertices(self.mano, self._pose48[sel], self._betas[sel],
                                 self._trans[sel], chunk)
                out[s0:s0 + len(sel)] = v @ COORD_FLIP.T  # OpenGL fit frame -> CV camera frame
            out.flush()
            del out
            os.replace(tmp, self._fit_path)  # atomic against a concurrent construction
        self._fit_verts = np.memmap(self._fit_path, np.float32, "r", shape=self._fit_shape)
        self._fit_row[rows] = np.arange(m)

    def __getstate__(self):
        """Pickle without the fit-vertex memmap (a worker would otherwise
        receive a dense copy; the unpickled copy reopens the file) and
        without the MANO model, whose tensors may live on the card: the
        unpickled copy serves ``get_sample`` and ``sample_pair``, which are
        host code."""
        d = self.__dict__.copy()
        d["mano"] = None
        if isinstance(d.get("_fit_verts"), np.memmap):
            d["_fit_verts"] = None
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        if self._fit_verts is None and self._fit_path is not None:
            self._fit_verts = np.memmap(self._fit_path, np.float32, "r", shape=self._fit_shape)

    def _precompute_obj_poses(self):
        """One batched Rodrigues (on the host) over every object rotation."""
        from hocon_torch.geometry.rot import rodrigues

        n = len(self.entries)
        self._obj_pose = np.zeros((n, 4, 4), np.float32)
        rows = np.nonzero(self._has_obj)[0]
        if not len(rows):
            return
        rots = rodrigues(torch.from_numpy(self._obj_rvec[rows])).numpy()
        pose = np.tile(np.eye(4, dtype=np.float32), (len(rows), 1, 1))
        pose[:, :3, :3] = COORD_FLIP @ rots
        pose[:, :3, 3] = self._obj_tvec[rows] @ COORD_FLIP.T
        self._obj_pose[rows] = pose

    def get_sample(self, i: int) -> dict:
        """Host-side array indexing only: no device work, no meta reads."""
        entry = self.entries[i]
        has_fit = bool(self._has_fit[i])
        verts_cam = None
        if self._fit_row[i] >= 0:  # fitted frames with a MANO model
            # Materialize the 9 KB row out of the disk-backed memmap.
            verts_cam = np.array(self._fit_verts[self._fit_row[i]])
        out = {
            "image_path": self._rgb_path(entry),
            "joints3d_cam": self._joints_cam[i],
            "verts3d_cam": verts_cam,
            "camintr": self._camintr[i],
            "obj_verts_can": None,
            "obj_faces": None,
            "obj_pose": None,
            "supervised": bool(self.supervised[i]),
            "seq_id": entry.split("/")[0],
            "frame_idx": int(entry.split("/")[1]),
            "side": "right",
            "mano_pose": self._pose48[i] if has_fit else None,
            "mano_betas": self._betas[i] if has_fit else None,
        }
        if self.use_objects and self._has_obj[i]:
            verts, faces = self._load_object(self._obj_name[i])
            out.update(obj_verts_can=verts, obj_faces=faces, obj_pose=self._obj_pose[i])
        return out

    def sample_pair(self, i: int, rng: np.random.Generator) -> tuple[int, int]:
        return sequence_pair(self, i, rng)


def _load_obj(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Minimal Wavefront OBJ loader (v / f lines only)."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                faces.append([int(tok.split("/")[0]) - 1 for tok in line.split()[1:4]])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)
