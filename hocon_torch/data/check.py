"""Dataset layout self-check (``--check_data``).

Port of ``hocon/data/check.py``, printing the same lines: walk the parsed
tree, pull ONE sample per sequence through the full HandDataset pipeline
(decode, crop, augment), and print shapes, value ranges and anomaly flags,
so a mis-laid-out download or a wrong convention shows in seconds, before
the first training epoch.
"""

from __future__ import annotations

import os

import numpy as np

from hocon_torch.data.queries import TransQueries


def _seq_first_indices(pose_ds) -> list[int]:
    """One representative (first) sample index per sequence."""
    if hasattr(pose_ds, "_seq_bounds"):
        return [start for start, _ in pose_ds._seq_bounds]
    if hasattr(pose_ds, "frames_per_video"):  # synthetic
        n = len(pose_ds)
        return list(range(0, n, pose_ds.frames_per_video))
    return list(range(min(len(pose_ds), 8)))


def _fmt_range(x: np.ndarray) -> str:
    x = np.asarray(x, np.float64)
    return f"[{x.min():+.3f}, {x.max():+.3f}]"


def check_dataset(hand_ds, name: str = "train", max_seqs: int = 0,
                  out=print) -> int:
    """Run the self-check. Returns the number of anomalies found.

    ``hand_ds``: a HandDataset (pair or frame mode).
    ``max_seqs``: cap on sequences checked (0 = all).
    """
    pose_ds = getattr(hand_ds, "pose_dataset", hand_ds)
    idxs = _seq_first_indices(pose_ds)
    if max_seqs:
        idxs = idxs[:max_seqs]
    out(
        f"[check_data:{name}] {type(pose_ds).__name__}: "
        f"{len(pose_ds)} samples, {len(idxs)} sequences checked"
    )
    if hasattr(pose_ds, "supervised"):
        sup = np.asarray(pose_ds.supervised)
        out(
            f"[check_data:{name}] supervised frames: {int(sup.sum())}"
            f"/{len(sup)} ({100.0 * sup.mean():.2f}%)"
        )
    n_bad = 0
    for si, i in enumerate(idxs):
        raw = pose_ds.get_sample(i)
        seq = raw.get("seq_id", si)
        problems = []
        path = raw.get("image_path")
        if path is not None and not os.path.exists(path):
            problems.append(f"image missing: {path}")
        j3 = np.asarray(raw["joints3d_cam"], np.float64)
        if not np.isfinite(j3).all():
            problems.append("non-finite joints3d_cam")
        if not j3.any():
            # The depth/behind-camera checks below are gated on j3.any();
            # all-zero joints (annotations present but unparsed — a primary
            # mis-layout symptom) must be an anomaly of its own, not a
            # silent skip of every downstream check.
            problems.append(
                "joints3d_cam all zeros — hand annotations missing or "
                "unparsed (wrong meta layout/keys?)"
            )
        if j3.any() and not (0.05 < np.abs(j3[:, 2]).mean() < 5.0):
            problems.append(
                f"hand depth {j3[:, 2].mean():.3f} outside [0.05, 5] m — "
                "check mm/m scaling or camera convention"
            )
        if j3.any() and j3[:, 2].mean() < 0:
            problems.append(
                "hand behind camera (mean z < 0) — check coordinate flip"
            )
        k = np.asarray(raw["camintr"], np.float64)
        if k[2, 2] != 1.0 or k[0, 0] <= 0:
            problems.append(f"suspicious intrinsics diag {np.diag(k)}")
        v = raw.get("verts3d_cam")
        if v is not None:
            v = np.asarray(v, np.float64)
            if not np.isfinite(v).all():
                problems.append("non-finite verts3d_cam")
            elif j3.any() and np.abs(v.mean(0) - j3.mean(0)).max() > 0.3:
                problems.append(
                    "MANO fit verts >30 cm from joints — fit/skeleton "
                    "frames disagree"
                )
        ov = raw.get("obj_verts_can")
        desc = (
            f"seq {seq}: joints3d z {_fmt_range(j3[:, 2])} m, "
            f"fx={k[0, 0]:.1f}"
        )
        if v is not None:
            desc += f", verts {v.shape}"
        if ov is not None:
            ov = np.asarray(ov)
            of = raw.get("obj_faces")
            # obj_faces can be None (e.g. a YCB model dir with only a point
            # cloud) — report it as an anomaly, don't crash the diagnostic.
            desc += f", obj {ov.shape[0]}v/{len(of) if of is not None else 0}f"
            if of is None:
                problems.append("object has vertices but no faces "
                                "(mesh file missing? point-cloud fallback)")
            pose = np.asarray(raw["obj_pose"], np.float64)
            if not np.isfinite(pose).all():
                problems.append("non-finite obj_pose")
            rot = pose[:3, :3]
            if abs(np.linalg.det(rot) - 1.0) > 0.01:
                problems.append(
                    f"obj_pose rotation det {np.linalg.det(rot):.3f} != 1"
                )
        # Through the full pipeline (decode + crop + tensorize).
        try:
            s = hand_ds[i]
            frame = s["ref"] if "ref" in s else s
            img = frame[TransQueries.IMAGE.value]
            j2 = frame[TransQueries.JOINTS2D.value]
            desc += f", crop {img.shape} {_fmt_range(img)}"
            if not np.isfinite(img).all():
                problems.append("non-finite image crop")
            h = img.shape[0]
            inside = (
                (j2[:, 0] > -0.25 * h) & (j2[:, 0] < 1.25 * h)
                & (j2[:, 1] > -0.25 * h) & (j2[:, 1] < 1.25 * h)
            )
            if inside.mean() < 0.5:
                problems.append(
                    f"only {int(inside.sum())}/21 projected joints near "
                    "the crop — check intrinsics/extrinsics"
                )
        except Exception as e:  # surface, keep walking
            problems.append(f"pipeline error: {type(e).__name__}: {e}")
        out(f"[check_data:{name}]   {desc}")
        for p in problems:
            out(f"[check_data:{name}]   !! {p}")
        n_bad += len(problems)
    out(
        f"[check_data:{name}] {'OK' if not n_bad else f'{n_bad} ANOMALIES'}"
    )
    return n_bad
