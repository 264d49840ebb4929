"""Soft differentiable rasterizer: shared plane math and the public entry.

Port of ``hocon/render/raster.py``. Per triangle f and pixel q:

    d2(q, f) = signed squared distance to the triangle (px^2, + inside)
    p(q, f)  = sigmoid(d2 / sigma^2)                soft coverage
    sil(q)   = 1 - prod_f (1 - p)                   soft silhouette
    attr(q)  = softmax over faces + background of log p - zbar / gamma,
               applied to the interpolated attributes (background: 0, zbar 1)
    vis(q)   = 1 - background softmax share

Every per-pixel quantity is affine in (x, y), so each face carries rows of
plane coefficients (``FacePlanes``) that kernels K1 and K2
(``hocon_torch.render.raster_cuda``) evaluate per pixel, or that the
unculled streaming ``rasterize_planes_xla`` evaluates in plain PyTorch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from hocon_torch.utils.trace import span

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


def _pixel_grid(h: int, w: int, dtype, device) -> torch.Tensor:
    """Homogeneous pixel-centre coordinates (x, y, 1), shape (3, H*W)."""
    ys = (torch.arange(h, dtype=dtype, device=device) + 0.5)[:, None].expand(h, w)
    xs = (torch.arange(w, dtype=dtype, device=device) + 0.5)[None, :].expand(h, w)
    x, y = xs.reshape(-1), ys.reshape(-1)
    return torch.stack([x, y, torch.ones_like(x)], dim=0)


def _aggregate_chunk(planes_chunk, valid_chunk, pix, sigma, gamma):
    """One face chunk against one pixel block.

    planes_chunk (B, FC, R, 3); valid_chunk (B, FC); pix (3, P). Returns
    log_neg (B, P) = sum_f log(1 - p_f), the softmax logits
    l (B, FC, P) = log(p_f) - zbar_f / gamma, and the interpolated
    [attrs; zbar] (B, FC, C+1, P).
    """
    vals = torch.einsum("bfrk,kp->bfrp", planes_chunk, pix)  # (B, FC, R, P)
    s = vals[:, :, 0:3]  # signed distance to the edge lines
    u = vals[:, :, 3:6]  # along-edge coordinate
    length = vals[:, :, 6:9]  # constant edge lengths
    overhang = torch.clamp(torch.maximum(-u, u - length), min=0.0)
    dist2_out = torch.amin(s * s + overhang * overhang, dim=2)  # (B, FC, P)
    d_in = torch.amin(s, dim=2)
    signed_sq = torch.where(d_in > 0, d_in * d_in, -dist2_out)
    signed_sq = torch.where(valid_chunk[..., None] > 0, signed_sq, -1e18)
    logits = signed_sq / (sigma * sigma)
    # One softplus serves both: log(sigmoid(x)) = -sp, log(1 - sigmoid(x))
    # = -(x + sp), with sp = softplus(-x).
    sp = F.softplus(-logits)
    log_neg = -(logits + sp)
    zbar = torch.clamp(vals[:, :, 9], 0.0, 1.0)  # extrapolation clamped
    l = -sp - zbar / gamma
    interp = torch.cat([vals[:, :, 10:], zbar[:, :, None]], dim=2)
    return log_neg.sum(dim=1), l, interp


def _scan_step(log_neg, m, num, den, planes_chunk, valid_chunk, pix, sigma, gamma):
    """One face chunk of the streaming max-renormalized softmax."""
    ln, l, interp = _aggregate_chunk(planes_chunk, valid_chunk, pix, sigma, gamma)
    m_new = torch.maximum(m, torch.amax(l, dim=1))
    scale = torch.exp(m - m_new)
    w = torch.exp(l - m_new[:, None])  # (B, FC, P)
    num = num * scale[:, None] + torch.einsum("bfp,bfcp->bcp", w, interp)
    den = den * scale + w.sum(dim=1)
    return log_neg + ln, m_new, num, den


def rasterize_planes_xla(
    planes: FacePlanes,
    image_size: tuple[int, int],
    sigma: float,
    gamma: float,
    face_chunk: int = 128,
    pixel_rows: int = 16,
) -> RasterOutput:
    """Streaming, unculled rasterization of face planes in plain PyTorch.

    Port of ``hocon/render/raster.py:rasterize_planes_xla``: for each block
    of ``pixel_rows`` rows, a loop over face chunks carries the
    silhouette's log sum and a max-renormalized softmax. Autograd
    differentiates it; each chunk step is recomputed in the backward
    (``torch.utils.checkpoint``, where the reference has ``jax.checkpoint``),
    or the backward would hold the full face x pixel tensors.
    """
    rows, valid = planes.rows, planes.valid
    b, f, r, _ = rows.shape
    n_attr = r - (N_GEOM_ROWS - 1)  # zbar + C user attrs
    h, w = image_size
    dtype, dev = rows.dtype, rows.device

    f_pad = (-f) % face_chunk  # padded faces are invalid: no-ops
    if f_pad:
        rows = F.pad(rows, (0, 0, 0, 0, 0, f_pad))
        valid = F.pad(valid, (0, f_pad))
    n_chunks = rows.shape[1] // face_chunk
    rows_c = rows.reshape(b, n_chunks, face_chunk, r, 3)
    valid_c = valid.reshape(b, n_chunks, face_chunk)

    h_pad = (-h) % pixel_rows
    grid = _pixel_grid(h + h_pad, w, dtype, dev).reshape(3, -1, pixel_rows * w)
    l_bg = -1.0 / gamma  # background entry: p = 1, zbar = 1, attrs 0

    log_negs, aggs, viss = [], [], []
    for blk in range(grid.shape[1]):
        pix = grid[:, blk]
        p_sz = pix.shape[-1]
        num = torch.zeros((b, n_attr, p_sz), dtype=dtype, device=dev)
        num[:, -1] = 1.0
        carry = (
            torch.zeros((b, p_sz), dtype=dtype, device=dev),
            torch.full((b, p_sz), l_bg, dtype=dtype, device=dev),
            num,
            torch.ones((b, p_sz), dtype=dtype, device=dev),
        )
        for k in range(n_chunks):
            carry = checkpoint(
                _scan_step, *carry, rows_c[:, k], valid_c[:, k], pix, sigma, gamma,
                use_reentrant=False,
            )
        log_neg, m, num, den = carry
        log_negs.append(log_neg)
        viss.append(1.0 - torch.exp(l_bg - m) / den)
        aggs.append(num / den[:, None])
    log_neg = torch.cat(log_negs, dim=1).reshape(b, h + h_pad, w)[:, :h]
    vis = torch.cat(viss, dim=1).reshape(b, h + h_pad, w)[:, :h]
    agg = torch.cat(aggs, dim=2).reshape(b, n_attr, h + h_pad, w)[:, :, :h]
    return RasterOutput(
        sil=1.0 - torch.exp(log_neg),
        attr=agg[:, :-1].permute(0, 2, 3, 1),
        depth=agg[:, -1],
        vis=vis,
    )


BACKENDS = ("auto", "xla", "pallas")


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
    (B, F, 3); attrs optional (B, V, C). ``backend="auto"`` (or
    ``"pallas"``, the reference's name for its kernel path) is the
    y-sorted, chunk-culled path of kernels K1 / K2 (their plain PyTorch
    versions for CPU tensors); ``"xla"`` is the unculled streaming
    ``rasterize_planes_xla``, which autograd differentiates (the
    reference's default off the TPU).
    """
    if backend not in BACKENDS:
        raise ValueError(f"soft_rasterize backend {backend!r}: expected one of {BACKENDS}")
    from hocon_torch.render.raster_cuda import (
        default_config,
        rasterize_planes,
        sort_faces_by_y,
    )

    with span("render.prep"):
        if attrs is None:
            attrs = verts_pix.new_zeros(verts_pix.shape[:2] + (0,))
        zbar = normalize_depth(verts_z)
        if backend == "xla":
            planes = face_planes(verts_pix, zbar, faces, attrs, backface_cull=backface_cull)
        else:
            # Sort the integer faces by screen y first, so the plane rows are
            # built already in kernel order and nothing differentiable is
            # permuted.
            faces_sorted, face_bbox = sort_faces_by_y(
                verts_pix, faces, backface_cull=backface_cull
            )
            planes = face_planes(verts_pix, zbar, faces_sorted, attrs,
                                 backface_cull=backface_cull)
    if backend == "xla":
        with span("render.raster"):
            return rasterize_planes_xla(planes, image_size, sigma, gamma)
    return rasterize_planes(
        planes, face_bbox, image_size=image_size, sigma=sigma, gamma=gamma,
        config=default_config(),
    )
