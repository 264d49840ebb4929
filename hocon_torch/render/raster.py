"""Soft differentiable rasterizer: shared plane math and the public entry.

Port of ``hocon/render/raster.py``. Per triangle f and pixel q:

    d2(q, f) = signed squared distance to the triangle (px^2, + inside)
    p(q, f)  = sigmoid(d2 / sigma^2)                soft coverage
    sil(q)   = 1 - prod_f (1 - p)                   soft silhouette
    attr(q)  = softmax over faces + background of log p - zbar / gamma,
               applied to the interpolated attributes (background: 0, zbar 1)
    vis(q)   = 1 - background softmax share

Every per-pixel quantity is affine in (x, y), so each face carries rows of
plane coefficients (``FacePlanes``) that kernel K1
(``hocon_torch.render.raster_cuda``) evaluates per pixel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_DEGENERATE_EPS = 1e-12
_AREA_EPS = 1e-6  # faces with |2 * area| at or below this (px^2) are culled
N_GEOM_ROWS = 10  # s(3) + u(3) + L(3) + zbar(1)
# Backface culling keeps near-tangent backfaces: cull only above this
# fraction of the mean |2 * area| (the reference's calibrated margin).
BACKFACE_MARGIN_FRAC = 0.25


class RasterOutput(NamedTuple):
    sil: torch.Tensor  # (B, H, W) soft silhouette in [0, 1]
    attr: torch.Tensor  # (B, H, W, C) aggregated vertex attributes
    depth: torch.Tensor  # (B, H, W) aggregated normalized depth in [0, 1]
    vis: torch.Tensor  # (B, H, W) 1 - background share of the softmax


class FacePlanes(NamedTuple):
    """Per-face affine rows, value(x, y) = row . (x, y, 1); R = 10 + C.

    rows 0-2: signed distance to edge line k (+ inside); rows 3-5: the
    along-edge coordinate; rows 6-8: constant edge lengths; row 9: zbar;
    rows 10+: user attributes.
    """

    rows: torch.Tensor  # (B, F, 10 + C, 3)
    valid: torch.Tensor  # (B, F) 1.0 for kept faces


def normalize_depth(verts_z: torch.Tensor, margin: float = 0.05) -> torch.Tensor:
    """Camera z to [0, 1] per batch element, with bounds held constant."""
    zmin = torch.amin(verts_z, dim=-1, keepdim=True).detach()
    zmax = torch.amax(verts_z, dim=-1, keepdim=True).detach()
    span = torch.clamp(zmax - zmin, min=1e-6)
    return (verts_z - zmin) / span * (1.0 - 2.0 * margin) + margin


def gather_faces(arr: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """(B, V, D) per-vertex data -> (B, F, 3, D) for (F, 3) or (B, F, 3) faces."""
    if faces.dim() == 2:
        return arr[:, faces]
    bidx = torch.arange(arr.shape[0], device=arr.device)[:, None, None]
    return arr[bidx, faces]


def face_det2d(fv: torch.Tensor) -> torch.Tensor:
    """Signed 2 x area from screen-space face verts (..., 3, 2).

    Differences first, so faces with repeated vertices give exactly 0.
    """
    return (fv[..., 1, 0] - fv[..., 0, 0]) * (fv[..., 2, 1] - fv[..., 0, 1]) - (
        fv[..., 2, 0] - fv[..., 0, 0]
    ) * (fv[..., 1, 1] - fv[..., 0, 1])


def face_valid(fv: torch.Tensor, backface_cull: bool = False) -> torch.Tensor:
    """Kept faces (bool): non-degenerate, and with ``backface_cull`` not
    clearly counter-clockwise in the y-down pixel frame (margin measured
    against the mean |det| over non-degenerate faces only)."""
    det = face_det2d(fv)
    absdet = torch.abs(det)
    valid = absdet > _AREA_EPS
    if backface_cull:
        n_valid = torch.clamp(torch.sum(valid, dim=-1, keepdim=True), min=1)
        margin = BACKFACE_MARGIN_FRAC * (
            torch.sum(torch.where(valid, absdet, 0.0), dim=-1, keepdim=True)
            / n_valid
        )
        valid = valid & (det < margin)
    return valid


def face_planes(
    verts_pix: torch.Tensor,
    verts_zbar: torch.Tensor,
    faces: torch.Tensor,
    attrs: torch.Tensor | None,
    backface_cull: bool = False,
) -> FacePlanes:
    """Affine plane rows for every face.

    verts_pix (B, V, 2) pixels; verts_zbar (B, V) in [0, 1]; faces (F, 3) or
    (B, F, 3); attrs optional (B, V, C).
    """
    payload = [verts_pix, verts_zbar[..., None]]
    if attrs is not None:
        payload.append(attrs)
    fall = gather_faces(torch.cat(payload, dim=-1), faces)
    fv = fall[..., :2]  # (B, F, 3, 2)
    fz = fall[..., 2]  # (B, F, 3)
    ones = torch.ones_like(fz)
    mat = torch.stack([fv[..., 0], fv[..., 1], ones], dim=-2)  # (B, F, 3, 3)

    a, b, c = mat[..., 0, 0], mat[..., 0, 1], mat[..., 0, 2]
    d, e, f = mat[..., 1, 0], mat[..., 1, 1], mat[..., 1, 2]
    g, h, i = mat[..., 2, 0], mat[..., 2, 1], mat[..., 2, 2]
    adj = torch.stack(
        [
            torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
            torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
            torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1),
        ],
        dim=-2,
    )
    det = face_det2d(fv)
    valid = face_valid(fv, backface_cull).to(verts_pix.dtype)
    safe_det = torch.where(torch.abs(det) > _AREA_EPS, det, torch.ones_like(det))
    minv = adj / safe_det[..., None, None]  # rows give barycentric coords

    grad_norm = torch.sqrt(minv[..., 0] ** 2 + minv[..., 1] ** 2 + _DEGENERATE_EPS)
    edge_rows = minv / grad_norm[..., None]

    v_a = fv[:, :, [1, 2, 0], :]  # edge k runs v_{k+1} -> v_{k+2}
    v_b = fv[:, :, [2, 0, 1], :]
    e_vec = v_b - v_a
    e_len = torch.sqrt(torch.sum(e_vec**2, dim=-1) + _DEGENERATE_EPS)
    e_hat = e_vec / e_len[..., None]
    u_rows = torch.cat(
        [e_hat, -torch.sum(v_a * e_hat, dim=-1, keepdim=True)], dim=-1
    )
    zero = torch.zeros_like(e_len)
    l_rows = torch.stack([zero, zero, e_len], dim=-1)

    z_row = torch.einsum("bfk,bfkc->bfc", fz, minv)[..., None, :]
    rows = [edge_rows, u_rows, l_rows, z_row]
    if attrs is not None:
        fattr = fall[..., 3:]  # (B, F, 3, C)
        rows.append(torch.einsum("bfkc,bfkm->bfcm", fattr, minv))
    return FacePlanes(rows=torch.cat(rows, dim=-2), valid=valid)


def soft_rasterize(
    verts_pix: torch.Tensor,
    verts_z: torch.Tensor,
    faces: torch.Tensor,
    attrs: torch.Tensor | None = None,
    image_size: tuple[int, int] = (256, 256),
    sigma: float = 1.0,
    gamma: float = 1.0 / 40.0,
    backend: str = "auto",
    backface_cull: bool = False,
) -> RasterOutput:
    """Soft-rasterize a batch of meshes (the reference's public entry).

    verts_pix (B, V, 2) pixels; verts_z (B, V) camera depth; faces (F, 3) or
    (B, F, 3); attrs optional (B, V, C). ``backend="auto"`` is the
    y-sorted, chunk-culled path of kernel K1 (its plain PyTorch version for
    CPU tensors); the reference's unculled "xla" path is not ported yet.
    """
    if backend != "auto":
        raise ValueError(f"soft_rasterize backend {backend!r}: only 'auto' is ported")
    from hocon_torch.render.raster_cuda import (
        default_config,
        rasterize_planes,
        sort_faces_by_y,
    )

    if attrs is None:
        attrs = verts_pix.new_zeros(verts_pix.shape[:2] + (0,))
    zbar = normalize_depth(verts_z)
    # Sort the integer faces by screen y first, so the plane rows are built
    # already in kernel order and nothing differentiable is permuted.
    faces_sorted, face_bbox = sort_faces_by_y(
        verts_pix, faces, backface_cull=backface_cull
    )
    planes = face_planes(verts_pix, zbar, faces_sorted, attrs,
                         backface_cull=backface_cull)
    return rasterize_planes(
        planes, face_bbox, image_size=image_size, sigma=sigma, gamma=gamma,
        config=default_config(),
    )
