"""Mesh utilities the main path needs.

Port of ``bbox_corners`` and ``orient_faces_outward`` from
``hocon/data/meshes.py`` (numpy only): the object's bounding-box corners
(the HO-3D corner-error label), and the rewinding that makes
``cross(v1 - v0, v2 - v0)`` point out of the mesh, as backface culling
assumes.
"""

from __future__ import annotations

import numpy as np


def bbox_corners(verts: np.ndarray) -> np.ndarray:
    """(V, 3) -> the 8 axis-aligned bounding-box corners (8, 3), in the
    reference's order: binary counting over (x, y, z) min/max."""
    v = np.asarray(verts, np.float32)
    lo, hi = v.min(axis=0), v.max(axis=0)
    out = np.empty((8, 3), np.float32)
    for c in range(8):
        out[c] = [
            (lo, hi)[(c >> 2) & 1][0],
            (lo, hi)[(c >> 1) & 1][1],
            (lo, hi)[c & 1][2],
        ]
    return out


def orient_faces_outward(
    verts: np.ndarray, faces: np.ndarray
) -> np.ndarray:
    """Rewind faces so every connected component is coherent and outward.

    The rasterizer's backface culling (``raster.face_valid``) assumes the
    standard convention: ``cross(v1-v0, v2-v0)`` points OUT of the mesh.
    Real scan meshes (YCB, FPHAB PLYs) are usually coherent but not
    guaranteed, and vertex-clustering decimation can fold an occasional
    face; this normalizes orientation in two passes:

      1. COHERENCE: breadth-first over the face-adjacency graph, flipping
         faces so every interior edge is traversed in opposite directions
         by its two faces (the manifold consistency condition). Non-manifold
         edges (>2 incident faces) are resolved greedily.
      2. OUTWARDNESS: per CLOSED connected component (every undirected
         edge shared by exactly two faces), if the signed volume
         ``sum det(v0, v1, v2) / 6`` is negative the whole component flips
         — exact and origin-independent for watertight surfaces. OPEN
         components (boundary or non-manifold edges) have no well-defined
         "outward", and the signed-volume test is origin-dependent there
         (a coherent patch offset from the origin can read as "inward"
         wholesale, which backface culling would then silently erase from
         the render); instead they keep the orientation the dataset
         authored: the component flips only if pass 1 inverted more than
         half of its faces relative to the input winding.

    Returns a new (F, 3) int32 array; verts are untouched. O(F log F).
    """
    faces = np.asarray(faces, np.int64)
    nf = len(faces)
    if nf == 0:
        return faces.astype(np.int32)
    verts = np.asarray(verts, np.float64)

    # Directed edges per face: (F, 3, 2) -> flat (3F, 2).
    e = np.stack(
        [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=1
    ).reshape(-1, 2)
    # dir_bool: stored direction relative to the canonical (min, max) order.
    dir_bool = e[:, 0] < e[:, 1]
    key = np.sort(e, axis=1)
    order = np.lexsort((key[:, 1], key[:, 0]))
    ks = key[order]
    same = np.all(ks[1:] == ks[:-1], axis=1)
    # Adjacency pairs: consecutive identical undirected edges (manifold
    # edges produce exactly one pair; non-manifold chains produce a path,
    # which the BFS resolves greedily).
    pa, pb = order[:-1][same], order[1:][same]
    fa, fb = pa // 3, pb // 3
    same_dir = dir_bool[pa] == dir_bool[pb]

    # Face adjacency in CSR-ish form.
    deg = np.zeros(nf, np.int64)
    np.add.at(deg, fa, 1)
    np.add.at(deg, fb, 1)
    ptr = np.concatenate([[0], np.cumsum(deg)])
    nbr = np.empty(ptr[-1], np.int64)
    nbr_same = np.empty(ptr[-1], bool)
    cur = ptr[:-1].copy()
    for u, v, s in zip(fa, fb, same_dir):
        nbr[cur[u]], nbr_same[cur[u]] = v, s
        cur[u] += 1
        nbr[cur[v]], nbr_same[cur[v]] = u, s
        cur[v] += 1

    flipped = np.zeros(nf, bool)
    visited = np.zeros(nf, bool)
    comp_of = np.full(nf, -1, np.int64)
    ncomp = 0
    for seed in range(nf):
        if visited[seed]:
            continue
        visited[seed] = True
        comp_of[seed] = ncomp
        stack = [seed]
        while stack:
            f = stack.pop()
            for i in range(ptr[f], ptr[f + 1]):
                g = nbr[i]
                if visited[g]:
                    continue
                visited[g] = True
                comp_of[g] = ncomp
                # Same STORED direction on the shared edge means the two
                # faces disagree; equal flip states must then differ.
                flipped[g] = flipped[f] ^ nbr_same[i]
                stack.append(g)
        ncomp += 1

    out = faces.copy()
    out[flipped] = out[flipped][:, ::-1]

    # Closedness per component: every undirected edge incident to exactly
    # two faces. Signed volume is only meaningful (origin-independent)
    # for closed components.
    uniq_edges, inv, edge_count = np.unique(
        key, axis=0, return_inverse=True, return_counts=True
    )
    face_open = np.zeros(nf, bool)
    bad_edge = edge_count[inv] != 2  # per directed-edge slot, (3F,)
    np.logical_or.at(face_open, np.arange(3 * nf) // 3, bad_edge)
    comp_open = np.zeros(ncomp, bool)
    np.logical_or.at(comp_open, comp_of, face_open)

    # Outwardness for closed components via signed volume (positive =
    # outward for the cross(v1-v0, v2-v0)-points-out convention).
    tri = verts[out]
    vol6 = np.einsum(
        "fi,fi->f", tri[:, 0], np.cross(tri[:, 1], tri[:, 2])
    )
    comp_vol = np.zeros(ncomp)
    np.add.at(comp_vol, comp_of, vol6)

    # Open components: keep the dataset-authored orientation — flip only
    # if coherence pass 1 inverted a majority of the component's faces.
    comp_nf = np.zeros(ncomp, np.int64)
    np.add.at(comp_nf, comp_of, 1)
    comp_nflip = np.zeros(ncomp, np.int64)
    np.add.at(comp_nflip, comp_of, flipped.astype(np.int64))

    flip_comp = np.where(
        comp_open, comp_nflip * 2 > comp_nf, comp_vol < 0
    )
    sel = flip_comp[comp_of]
    out[sel] = out[sel][:, ::-1]
    return out.astype(np.int32)
