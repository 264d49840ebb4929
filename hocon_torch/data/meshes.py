"""Mesh utilities: bounding-box corners, outward winding, decimation.

Port of ``hocon/data/meshes.py`` (numpy only, so the same input gives the
same arrays bit for bit): the object's bounding-box corners (the HO-3D
corner-error label), the rewinding that makes ``cross(v1 - v0, v2 - v0)``
point out of the mesh, as backface culling assumes, and the
vertex-clustering decimation that brings a scanned object model (FPHAB's
PLYs, YCB's ``textured_simple.obj``: ~10-20k faces) to the rasterizer's
face budget.
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


def _cluster_once(
    verts: np.ndarray, faces: np.ndarray, pitch: float
) -> tuple[np.ndarray, np.ndarray]:
    lo = verts.min(axis=0)
    cells = np.floor((verts - lo) / max(pitch, 1e-12)).astype(np.int64)
    # Unique cell id per vertex -> cluster index.
    _, cluster, counts = np.unique(
        cells, axis=0, return_inverse=True, return_counts=True
    )
    # Cluster centroids.
    centroids = np.zeros((len(counts), 3), np.float64)
    np.add.at(centroids, cluster, verts)
    centroids /= counts[:, None]
    new_faces = cluster[faces]
    # Drop degenerate faces (any two corners merged).
    keep = (
        (new_faces[:, 0] != new_faces[:, 1])
        & (new_faces[:, 1] != new_faces[:, 2])
        & (new_faces[:, 0] != new_faces[:, 2])
    )
    new_faces = new_faces[keep]
    # Drop duplicate faces (ignoring winding-preserving rotation).
    if len(new_faces):
        key = np.sort(new_faces, axis=1)
        _, first = np.unique(key, axis=0, return_index=True)
        new_faces = new_faces[np.sort(first)]
    return centroids.astype(np.float32), new_faces.astype(np.int32)


def _compact(
    verts: np.ndarray, faces: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Drop vertices not referenced by any face; reindex faces."""
    used = np.unique(faces)
    remap = np.full(len(verts), -1, np.int64)
    remap[used] = np.arange(len(used))
    return verts[used], remap[faces]


def decimate_mesh(
    verts: np.ndarray,
    faces: np.ndarray,
    target_faces: int,
    max_iters: int = 32,
    target_verts: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Reduce (verts, faces) to <= target_faces AND <= target_verts.

    The returned faces are orientation-normalized (coherent, outward —
    see ``orient_faces_outward``): scan meshes arrive with no winding
    guarantee and clustering can fold an occasional face, while the
    renderer's backface culling assumes outward winding.

    Both budgets are GUARANTEED (callers size rasterizer/padding buffers
    from them — over-budget meshes would be truncated downstream into faces
    with out-of-range vertex indices); ``target_verts`` defaults to
    ``target_faces`` (a closed 2-manifold has V = F/2 + 2, so the face
    budget is a comfortable vertex bound once unreferenced vertices are
    compacted away). Returns the input unchanged when it already fits.
    Search: the grid pitch starts at 1/64 of the bbox diagonal and grows by
    sqrt(2) until the budgets are met; if a step overshoots to an empty
    mesh, the pitch is bisected into the (over-budget, empty) gap (the
    lower bracket falls back to an effectively-zero pitch when even the
    first step emptied the mesh). If no pitch fits (pathological geometry),
    the largest-area faces of the coarsest over-budget clustering are kept,
    shrinking the kept set until the referenced-vertex budget also holds —
    a valid sub-mesh, never out-of-range indices.
    """
    v, f = _decimate_mesh_impl(verts, faces, target_faces, max_iters,
                               target_verts)
    return v, orient_faces_outward(v, f)


def _decimate_mesh_impl(
    verts: np.ndarray,
    faces: np.ndarray,
    target_faces: int,
    max_iters: int = 32,
    target_verts: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int64)
    tv = target_faces if target_verts is None else target_verts

    def fits(v, f):
        return len(f) <= target_faces and len(v) <= tv

    if fits(verts, faces):
        return verts, faces.astype(np.int32)
    v0, f0 = _compact(verts, faces)
    if fits(v0, f0):
        return v0, f0.astype(np.int32)
    diag = float(np.linalg.norm(verts.max(axis=0) - verts.min(axis=0)))
    pitch = diag / 64.0
    best_over = None  # coarsest clustering still over budget
    lo = hi = None  # lo: pitch known over budget; hi: known empty/fits
    for _ in range(max_iters):
        v, f = _cluster_once(verts, faces, pitch)
        if len(f):
            v, f = _compact(v, f)
        if len(f) and fits(v, f):
            return v, f.astype(np.int32)
        if len(f) == 0:
            hi = pitch
            break
        best_over = (v, f)  # coarsest-so-far: fewest faces over budget
        lo = pitch
        pitch *= 1.4142135623730951  # sqrt(2): gentle coarsening
    if hi is not None:
        if lo is None:
            # Even the first pitch emptied the mesh: an effectively-zero
            # pitch reproduces the (over-budget) input — a valid bracket.
            lo = hi * 1e-7
            best_over = best_over or (v0, f0)
        for _ in range(24):  # bisect into the (over-budget, empty) gap
            mid = 0.5 * (lo + hi)
            v, f = _cluster_once(verts, faces, mid)
            if len(f) == 0:
                hi = mid
                continue
            v, f = _compact(v, f)
            if fits(v, f):
                return v, f.astype(np.int32)
            lo, best_over = mid, (v, f)  # non-empty but over budget
    # No pitch fits: hard-trim the coarsest over-budget clustering to the
    # largest-area faces; shrink until the vertex budget holds too.
    v, f = best_over if best_over is not None else (v0, f0)
    fv = v[f]
    area2 = np.linalg.norm(
        np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0]), axis=1
    )
    order = np.argsort(-area2)
    k = min(target_faces, len(f))
    while k > 0:
        vk, fk = _compact(v, f[np.sort(order[:k])])
        if len(vk) <= tv:
            return vk, fk.astype(np.int32)
        k = int(k * 0.8)  # geometric shrink; terminates (1 face = 3 verts)
    return v[:0], f[:0].astype(np.int32)
