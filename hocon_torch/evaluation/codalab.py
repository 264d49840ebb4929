"""HO-3D CodaLab submission dump.

Port of ``hocon/evaluation/codalab.py``: per-frame predicted joints and
vertices in meters, in the OpenGL camera convention (y and z flipped
against the CV frame the model predicts in), written as ``pred.json`` —
two parallel lists ``[xyz_pred_list, verts_pred_list]``, the joints in the
dataset's annotation (MANO) order — and zipped for the CodaLab server.

``MANO_TO_STANDARD`` is the port's own copy of the HO-3D constant
(``hocon/data/ho3d.py``), whose parser is not ported yet.
"""

from __future__ import annotations

import json
import os
import zipfile

import numpy as np

# HO-3D annotation order (MANO kinematic order + appended fingertips) ->
# the standard evaluation order used everywhere else.
MANO_TO_STANDARD = (
    0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18, 10, 11, 12, 19, 7, 8, 9, 20
)

_FLIP = np.diag([1.0, -1.0, -1.0])

# standard evaluation order -> HO-3D annotation (MANO) order.
STANDARD_TO_MANO = np.argsort(np.asarray(MANO_TO_STANDARD))


def dump_ho3d_codalab(
    joints_cam: np.ndarray,  # (N, 21, 3) meters, CV convention, standard order
    verts_cam: np.ndarray,  # (N, 778, 3) meters, CV convention
    out_dir: str,
    zip_name: str = "pred.zip",
) -> str:
    """Write pred.json (+zip). Returns the zip path."""
    os.makedirs(out_dir, exist_ok=True)
    joints = np.asarray(joints_cam)[:, STANDARD_TO_MANO] @ _FLIP.T
    verts = np.asarray(verts_cam) @ _FLIP.T
    xyz_pred_list = [j.round(6).tolist() for j in joints]
    verts_pred_list = [v.round(6).tolist() for v in verts]
    json_path = os.path.join(out_dir, "pred.json")
    with open(json_path, "w") as f:
        json.dump([xyz_pred_list, verts_pred_list], f)
    zip_path = os.path.join(out_dir, zip_name)
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as z:
        z.write(json_path, "pred.json")
    return zip_path
