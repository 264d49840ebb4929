"""Synthetic object mesh for the main path.

Port of ``uv_sphere`` from ``hocon/data/synthetic.py``: the UV sphere that
stands in for a decimated YCB-scale object (1280 requested faces give the
1300-face mesh the reference benchmark renders beside the hand), plus the
synthetic camera and object scale of that dataset.
"""

from __future__ import annotations

import numpy as np

from hocon_torch.data.meshes import orient_faces_outward

OBJ_SCALE = 0.06  # object size of the synthetic dataset (meters)


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
