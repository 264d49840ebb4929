"""The cell's inputs, made from ``--seed`` on the device: the MANO stand-in's
arrays, the configuration's model's weights and the pool of frame-pair
batches.

The synthetic scene follows the repository's synthetic dataset: per video,
MANO pose, root rotation and translation interpolated between two seeded
draws; an object (a UV sphere standing in for a decimated YCB mesh, or
none) at a fixed offset from the wrist; every frame rendered at the crop
size with the plain soft rasterizer in procedural vertex colours (sigma
0.7, gamma 1/40, grey 0.15 background). Each pair is an annotated
reference frame and a target frame up to ``pair_spacing`` frames away in
the same video; each view is a square crop 1.3 times the hand's 2D extent
with scale and centre jitter, resampled bilinearly, its intrinsics and
labels moved with it, ImageNet-normalised, as the port's ``BatchLoader``
hands them to the step.

All random draws come from ``torch.Generator``s on the device seeded from
``--seed``, in a few large calls; the same seed gives the same tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference import families
from reference import render as ref_render
from reference.model import mano_forward, persp_project

N_VERTS, N_JOINTS = 778, 16
OBJ_OFFSET = (0.0, 0.04, 0.02)
BOX_VERTS = [[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
             [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]]
BOX_FACES = [[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
             [2, 3, 7], [2, 7, 6], [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7]]


def generator(seed: int, stream: int, device) -> torch.Generator:
    """One of the run's independent streams: mano (0), weights (1), scene (2)."""
    return torch.Generator(device=device).manual_seed(int(seed) * 8 + stream)


def mano_arrays(seed: int, device) -> dict:
    """The MANO stand-in at MANO's widths (778 vertices, 16 joints, 10 shape
    and 45 pose dimensions): a Fibonacci-sphere hand blob triangulated by
    its convex hull, a hand-like joint chain, soft-nearest joint regressor
    and distance-based skinning; seeded blend shapes, PCA basis and mean
    pose."""
    from scipy.spatial import ConvexHull

    idx = np.arange(N_VERTS, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * idx / N_VERTS)
    theta = np.pi * (1.0 + 5.0 ** 0.5) * idx
    pts = np.stack([np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi), np.cos(phi)], -1)
    v_template = (pts * np.array([0.09, 0.05, 0.015])).astype(np.float32)
    faces = ConvexHull(pts).simplices.astype(np.int64)
    tri = pts[faces]
    flip = (np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]) * tri.mean(1)).sum(-1) < 0
    faces[flip] = faces[flip][:, ::-1]
    joints = np.zeros((N_JOINTS, 3), np.float32)
    joints[0] = [-0.07, 0.0, 0.0]
    for chain, y in (((1, 2, 3), 0.02), ((4, 5, 6), 0.0), ((7, 8, 9), -0.04),
                     ((10, 11, 12), -0.02), ((13, 14, 15), 0.045)):
        for k, j in enumerate(chain):
            joints[j] = [-0.02 + 0.035 * (k + 1), y, 0.0]
    d = np.linalg.norm(v_template[None] - joints[:, None], axis=-1)
    jreg = np.exp(-((d / 0.01) ** 2))
    jreg /= jreg.sum(axis=1, keepdims=True) + 1e-9
    w = np.exp(-((d.T / 0.03) ** 2)) + 1e-6
    w /= w.sum(axis=1, keepdims=True)

    g = generator(seed, 0, device)
    f32 = dict(device=device, dtype=torch.float32)
    draws = torch.randn(N_VERTS * 3 * 145 + 45 * 45 + 45, generator=g, **f32)
    shapedirs = draws[: N_VERTS * 30].reshape(N_VERTS, 3, 10) * 0.002
    posedirs = draws[N_VERTS * 30: N_VERTS * 435].reshape(N_VERTS, 3, 135) * 0.0005
    comps = torch.linalg.qr(draws[N_VERTS * 435: N_VERTS * 435 + 2025].reshape(45, 45))[0]
    return {
        "v_template": torch.from_numpy(v_template).to(**f32),
        "shapedirs": shapedirs.contiguous(),
        "posedirs": posedirs.contiguous(),
        "joint_regressor": torch.from_numpy(jreg.astype(np.float32)).to(**f32),
        "skin_weights": torch.from_numpy(w.astype(np.float32)).to(**f32),
        "hands_components": comps.contiguous(),
        "hands_mean": draws[-45:] * 0.1,
        "faces": torch.from_numpy(faces).to(device),
    }


def weights(cfg: dict, seed: int, device) -> dict:
    """The configuration's model's state dict, drawn by its family
    (``reference/families/<family>.py:weights``) from the weights stream."""
    return families.load(cfg).weights(cfg, generator(seed, 1, device), device)


def uv_sphere(target_faces: int):
    """Unit UV sphere with ~``target_faces`` triangles, wound outward."""
    nlon = max(8, int(round(math.sqrt(target_faces / 2.0))))
    nlat = max(3, int(round(target_faces / (2.0 * nlon))) + 1)
    theta = np.pi * np.arange(1, nlat) / nlat
    phi = 2.0 * np.pi * np.arange(nlon) / nlon
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    rings = np.stack([st * np.cos(phi)[None], st * np.sin(phi)[None],
                      np.broadcast_to(ct, (nlat - 1, nlon))], -1).reshape(-1, 3)
    verts = np.concatenate([rings, [[0.0, 0.0, 1.0]], [[0.0, 0.0, -1.0]]]).astype(np.float32)
    top, bot = len(rings), len(rings) + 1
    faces = []
    for j in range(nlon):  # pole fans
        faces.append([top, (j + 1) % nlon, j])
        faces.append([bot, (nlat - 2) * nlon + j, (nlat - 2) * nlon + (j + 1) % nlon])
    for i in range(nlat - 2):
        for j in range(nlon):
            a, b = i * nlon + j, i * nlon + (j + 1) % nlon
            c, d = (i + 1) * nlon + j, (i + 1) * nlon + (j + 1) % nlon
            faces += [[a, d, b], [a, c, d]]
    faces = np.asarray(faces, np.int64)
    tri = verts[faces]
    out = (np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]) * tri.mean(1)).sum(-1) < 0
    faces[out] = faces[out][:, ::-1]
    return verts, faces


def object_mesh(data: dict):
    """(canonical vertices (Vo, 3) in meters, faces (Fo, 3)) or None."""
    kind = data["object"]
    if kind == "none":
        return None
    if kind == "box":
        return np.asarray(BOX_VERTS, np.float32) * 0.5 * data["object_size"], np.asarray(BOX_FACES)
    verts, faces = uv_sphere(data["object_faces"])
    return verts * (0.5 * data["object_size"]), faces


def vertex_colors(nv: int, device) -> torch.Tensor:
    i = torch.arange(nv, dtype=torch.float32, device=device)
    return torch.stack([0.5 + 0.5 * torch.sin(i * 0.7), 0.5 + 0.5 * torch.sin(i * 1.3 + 1.0),
                        0.5 + 0.5 * torch.sin(i * 2.9 + 2.0)], dim=-1)


@torch.no_grad()
def render_frames(verts, faces, camintr, size: int, frames_per_call: int = 8) -> torch.Tensor:
    """(N, S, S, 3) f32 frames in [0, 1] of camera-space meshes (N, V, 3)."""
    colors = vertex_colors(verts.shape[1], verts.device)
    out = []
    for i in range(0, len(verts), frames_per_call):
        v, k = verts[i:i + frames_per_call], camintr[i:i + frames_per_call]
        sil, attr, _ = ref_render.soft_rasterize(
            persp_project(v, k), v[..., 2], faces, colors.expand(len(v), -1, -1), (size, size),
            sigma=0.7, gamma=1.0 / 40.0, backface_cull=False, pixel_rows=32, checkpoint=False)
        out.append(torch.clamp(attr, 0.0, 1.0) * sil[..., None] + 0.15 * (1.0 - sil[..., None]))
    return torch.cat(out)


@torch.no_grad()
def crop(frames, box):
    """Bilinear square crops (N, S, S, 3) of ``frames`` at ``box`` (N, 3):
    (x0, y0, side) in frame pixels; outside the frame reads background."""
    n, s = frames.shape[0], frames.shape[1]
    t = (torch.arange(s, device=frames.device, dtype=frames.dtype) + 0.5) / s
    xs = box[:, 0, None] + t[None] * box[:, 2, None]  # frame pixel coordinates
    ys = box[:, 1, None] + t[None] * box[:, 2, None]
    grid = torch.stack([xs[:, None, :].expand(n, s, s), ys[:, :, None].expand(n, s, s)], -1)
    grid = grid / s * 2.0 - 1.0
    img = torch.nn.functional.grid_sample(frames.permute(0, 3, 1, 2) - 0.15, grid,
                                          mode="bilinear", padding_mode="zeros",
                                          align_corners=False)
    return img.permute(0, 2, 3, 1) + 0.15


@torch.no_grad()
def batch_pool(cfg: dict, mano: dict, seed: int, device) -> list[dict]:
    """``pool`` batches of ``pairs_per_step`` frame pairs, device-resident."""
    d, kind = cfg["data"], cfg["model"]
    g = generator(seed, 2, device)
    nv, nt, size = d["videos"], d["frames_per_video"], d["image_size"]
    n = nv * nt
    f32 = dict(device=device, dtype=torch.float32)

    def randn(*shape):
        return torch.randn(shape, generator=g, **f32)

    def rand(*shape):
        return torch.rand(shape, generator=g, **f32)

    pose0 = randn(nv, 15) * 0.3
    pose1 = pose0 + randn(nv, 15) * 0.4
    root0 = randn(nv, 3) * 0.3
    root1 = root0 + randn(nv, 3) * 0.3
    trans0 = torch.cat([rand(nv, 2) * 0.06 - 0.03, rand(nv, 1) * 0.15 + 0.55], dim=1)
    trans1 = trans0 + rand(nv, 3) * 0.08 - 0.04
    t = torch.linspace(0.0, 1.0, nt, **f32)[None, :, None]

    def lerp(a, b):
        return (a[:, None] * (1 - t) + b[:, None] * t).reshape(n, -1)

    verts, joints = mano_forward(mano, lerp(pose0, pose1), torch.zeros(n, 10, **f32),
                                 lerp(root0, root1))
    tr = lerp(trans0, trans1)
    verts, joints = verts + tr[:, None], joints + tr[:, None]
    faces = mano["faces"]
    obj = object_mesh(d)
    if obj is not None:
        obj_can = torch.from_numpy(obj[0]).to(**f32)
        obj_faces = torch.from_numpy(obj[1]).to(device)
        obj_verts = obj_can[None] + (joints[:, 0] + verts.new_tensor(OBJ_OFFSET))[:, None]
        scene_v = torch.cat([verts, obj_verts], dim=1)
        scene_f = torch.cat([faces, obj_faces + N_VERTS])
    else:
        scene_v, scene_f = verts, faces
    f = 1.6 * size
    k0 = torch.tensor([[f, 0.0, size / 2], [0.0, f, size / 2], [0.0, 0.0, 1.0]], **f32)
    frames = render_frames(scene_v, scene_f, k0.expand(n, 3, 3), size)

    # Annotated frames: every ``annotated_every``-th of each video, from its first.
    local = torch.arange(n, device=device) % nt
    annotated = (local % d["annotated_every"]) == 0
    rows = cfg["traffic"]["pool"] * d["pairs_per_step"]
    pick = torch.randint(0, n, (rows,), generator=g, device=device)
    # The reference frame is the annotated frame nearest a uniform pick; the
    # target lies 1 to ``pair_spacing`` frames before or after it.
    every = d["annotated_every"]
    base, at = pick - pick % nt, pick % nt
    ref_local = torch.clamp((at + every // 2) // every * every, max=(nt - 1) // every * every)
    mag = torch.randint(1, d["pair_spacing"] + 1, (rows,), generator=g, device=device)
    sign = torch.where(rand(rows) < 0.5, 1, -1)
    tgt_local = torch.clamp(ref_local + sign * mag, 0, nt - 1)
    tgt_local = torch.where(tgt_local == ref_local, torch.clamp(ref_local + 1, max=nt - 1),
                            tgt_local)
    ref, tgt = base + ref_local, base + tgt_local

    def view(idx):
        m = len(idx)
        j3, v3 = joints[idx], verts[idx]
        j2 = persp_project(j3, k0.expand(m, 3, 3))
        lo, hi = j2.amin(dim=1), j2.amax(dim=1)
        side = (hi - lo).amax(dim=1) * 1.3 * (1.0 + (rand(m) * 2 - 1) * 0.1)
        centre = (lo + hi) / 2 + (rand(m, 2) * 2 - 1) * 0.1 * side[:, None]
        box = torch.cat([centre - side[:, None] / 2, side[:, None]], dim=1)
        scale = size / side
        k = torch.zeros(m, 3, 3, **f32)
        k[:, 0, 0] = k[:, 1, 1] = f * scale
        k[:, 0, 2] = (size / 2 - box[:, 0]) * scale
        k[:, 1, 2] = (size / 2 - box[:, 1]) * scale
        k[:, 2, 2] = 1.0
        img = crop(frames[idx], box)
        mean, std = img.new_tensor(ref_render.IMAGENET_MEAN), img.new_tensor(ref_render.IMAGENET_STD)
        center = j3[:, 9]
        out = {
            "image": ((img - mean) / std).contiguous(),
            "camintr": k,
            "joints2d": persp_project(j3, k),
            "joints3d": (j3 - center[:, None]) * 1000.0,
            "verts3d": (v3 - center[:, None]) * 1000.0,
            "center3d": center,
            "sup_mask": annotated[idx].float(),
        }
        if obj is not None and kind["with_object"]:
            ov = obj_verts[idx]
            out.update(objverts3d=(ov - center[:, None]) * 1000.0,
                       obj_verts_mask=torch.ones(ov.shape[:2], **f32),
                       obj_verts_can=obj_can[None].expand(m, -1, -1).contiguous(),
                       obj_faces=obj_faces[None].expand(m, -1, -1).to(torch.int32).contiguous())
        return out

    refs, tgts = view(ref), view(tgt)
    p = d["pairs_per_step"]
    return [{"ref": {k: v[i * p:(i + 1) * p].contiguous() for k, v in refs.items()},
             "tgt": {k: v[i * p:(i + 1) * p].contiguous() for k, v in tgts.items()}}
            for i in range(cfg["traffic"]["pool"])]
