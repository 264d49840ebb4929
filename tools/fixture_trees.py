"""Write small FPHAB and HO-3D trees in the official layouts.

The datasets themselves are not in the repository. The port's tests and
``chip_smoke.py`` build trees of their own with these writers: the files,
names and formats the parsers read (``hocon/data/fphab.py``,
``hocon/data/ho3d.py`` and their ports), with the content the caller
chooses. Frames are given as encoded bytes (a JPEG or a PNG), so a test
can write them with cv2 and ``chip_smoke.py`` with nvJPEG.

FPHAB (``root/``):
  Video_files/<subject>/<action>/<seq>/color/color_%04d.jpeg
  Hand_pose_annotation_v1/<subject>/<action>/<seq>/skeleton.txt
  Object_6D_pose_annotation_v1_1/<subject>/<action>/<seq>/object_pose.txt
  Object_models/<name>_model/<name>_model.ply
  fhbhands_fits/<subject>/<action>/<seq>/fits.pkl
HO-3D (``root/``):
  <train|evaluation>/<seq>/rgb/%04d.png, <train|evaluation>/<seq>/meta/%04d.pkl
  models_root/models/<objName>/textured_simple.obj (or points.xyz)
MANO (``write_mano_pkl``): MANO_RIGHT.pkl / MANO_LEFT.pkl as the official
  assets store them, chumpy objects and a sparse joint regressor included.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import sys
import types

import numpy as np


def box_mesh(half: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
    """A closed 12-face box of half-size ``half``, wound outward."""
    v = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                  [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], np.float32) * half
    f = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
                  [1, 2, 6], [1, 6, 5], [2, 3, 7], [2, 7, 6], [3, 0, 4], [3, 4, 7]], np.int32)
    return v, f


def sphere_mesh(n_points: int, radius: float = 1.0, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """A dense closed mesh: the convex hull of ``n_points`` random points on
    a sphere (2 * n_points - 4 faces), as scanned object models are dense."""
    from scipy.spatial import ConvexHull

    pts = np.random.default_rng(seed).standard_normal((n_points, 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    return (pts * radius).astype(np.float32), ConvexHull(pts).simplices.astype(np.int32)


def _makedirs_for(path: str) -> str:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return path


def write_ply(path: str, verts: np.ndarray, faces: np.ndarray, binary: bool = False) -> None:
    """A PLY mesh, ASCII or binary little-endian (float x y z, uchar-count
    int faces)."""
    head = ("ply\nformat {} 1.0\nelement vertex {}\nproperty float x\nproperty float y\n"
            "property float z\nelement face {}\nproperty list uchar int vertex_indices\n"
            "end_header\n").format("binary_little_endian" if binary else "ascii",
                                   len(verts), len(faces))
    with open(_makedirs_for(path), "wb") as f:
        f.write(head.encode("ascii"))
        if binary:
            f.write(np.asarray(verts, "<f4").tobytes())
            rec = np.zeros(len(faces), [("n", "u1"), ("idx", "<i4", 3)])
            rec["n"], rec["idx"] = 3, faces
            f.write(rec.tobytes())
        else:
            for v in verts:
                f.write(f"{v[0]} {v[1]} {v[2]}\n".encode())
            for fc in faces:
                f.write(f"3 {fc[0]} {fc[1]} {fc[2]}\n".encode())


def write_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """A Wavefront OBJ mesh (v and f lines, 1-based, with texture slots)."""
    with open(_makedirs_for(path), "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for fc in faces:
            f.write("f " + " ".join(f"{i + 1}/{i + 1}" for i in fc) + "\n")


def write_fphab_sequence(root: str, subject: str, action: str, seq: str,
                         skeletons_mm: np.ndarray, frames: list[bytes],
                         object_poses: np.ndarray | None = None,
                         fits: dict | None = None) -> None:
    """One FPHAB sequence: ``skeletons_mm`` (N, 21, 3) world-frame joints in
    FPHAB's joint order, ``frames`` N encoded images, ``object_poses``
    (N, 4, 4) object -> world (mm), ``fits`` ``{frame: {"pose", "shape",
    "trans"}}``."""
    rel = os.path.join(subject, action, seq)
    with open(_makedirs_for(os.path.join(root, "Hand_pose_annotation_v1", rel,
                                         "skeleton.txt")), "w") as f:
        for i, joints in enumerate(skeletons_mm):
            f.write(f"{i} " + " ".join(f"{v:.4f}" for v in np.ravel(joints)) + "\n")
    for i, data in enumerate(frames):
        path = os.path.join(root, "Video_files", rel, "color", f"color_{i:04d}.jpeg")
        with open(_makedirs_for(path), "wb") as f:
            f.write(data)
    if object_poses is not None:
        path = os.path.join(root, "Object_6D_pose_annotation_v1_1", rel, "object_pose.txt")
        with open(_makedirs_for(path), "w") as f:
            for i, pose in enumerate(object_poses):
                f.write(f"{i} " + " ".join(f"{v:.4f}" for v in np.ravel(pose)) + "\n")
    if fits is not None:
        with open(_makedirs_for(os.path.join(root, "fhbhands_fits", rel, "fits.pkl")), "wb") as f:
            pickle.dump(fits, f)


def write_ho3d_frame(root: str, split_dir: str, seq: str, index: int, meta: dict,
                     frame: bytes, ext: str = ".png") -> None:
    """One HO-3D frame: its meta pickle and its encoded image."""
    base = os.path.join(root, split_dir, seq)
    with open(_makedirs_for(os.path.join(base, "meta", f"{index:04d}.pkl")), "wb") as f:
        pickle.dump(meta, f)
    with open(_makedirs_for(os.path.join(base, "rgb", f"{index:04d}{ext}")), "wb") as f:
        f.write(frame)


@contextlib.contextmanager
def _stand_in_modules(modules: dict):
    """``sys.modules`` entries replaced by ``modules`` inside the block only."""
    saved = {name: sys.modules.get(name) for name in modules}
    sys.modules.update(modules)
    try:
        yield
    finally:
        for name, mod in saved.items():
            if mod is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = mod


def write_mano_pkl(path: str, arrays: dict) -> None:
    """MANO assets in the official pickle's layout (protocol 2): ``arrays``
    holds v_template, shapedirs, posedirs, joint_regressor, skin_weights,
    hands_components, hands_mean and faces (``synthetic_mano_arrays``'
    names). As in the published files, shapedirs, posedirs, weights and
    v_template are chumpy ``Ch`` objects (their payload under ``x``, ``r``,
    ``a`` and ``v``: each key the loaders read), ``J_regressor`` is a
    ``scipy.sparse.csc.csc_matrix`` (the module path of the scipy the assets
    were written with) and ``f`` is uint32. Stand-ins for ``chumpy.ch.Ch``
    and that csc class are registered in ``sys.modules`` only while
    dumping, so a reader needs neither chumpy nor the old scipy path."""
    import scipy.sparse

    ch_mod = types.ModuleType("chumpy.ch")
    ch_mod.Ch = type("Ch", (), {"__module__": "chumpy.ch"})
    chumpy = types.ModuleType("chumpy")
    chumpy.ch = ch_mod
    csc_mod = types.ModuleType("scipy.sparse.csc")
    csc_mod.csc_matrix = type("csc_matrix", (), {"__module__": "scipy.sparse.csc"})

    def stand_in(cls, state: dict):
        obj = cls.__new__(cls)
        obj.__dict__.update(state)
        return obj

    regressor = scipy.sparse.csc_matrix(np.asarray(arrays["joint_regressor"], np.float64))
    raw = {
        "v_template": stand_in(ch_mod.Ch, {"v": np.asarray(arrays["v_template"], np.float64)}),
        "shapedirs": stand_in(ch_mod.Ch, {"x": np.asarray(arrays["shapedirs"], np.float64)}),
        "posedirs": stand_in(ch_mod.Ch, {"r": np.asarray(arrays["posedirs"], np.float64)}),
        "weights": stand_in(ch_mod.Ch, {"a": np.asarray(arrays["skin_weights"], np.float64)}),
        "J_regressor": stand_in(csc_mod.csc_matrix, dict(regressor.__dict__)),
        "hands_components": np.asarray(arrays["hands_components"], np.float64),
        "hands_mean": np.asarray(arrays["hands_mean"], np.float64),
        "f": np.asarray(arrays["faces"], np.uint32),
        "kintree_table": np.array([[4294967295, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14],
                                   list(range(16))], np.int64),
        "bs_style": "lbs",
        "bs_type": "lrotmin",
    }
    stand_ins = {"chumpy": chumpy, "chumpy.ch": ch_mod, "scipy.sparse.csc": csc_mod}
    with _stand_in_modules(stand_ins), open(_makedirs_for(path), "wb") as fh:
        pickle.dump(raw, fh, protocol=2)
