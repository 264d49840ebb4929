"""Kernel K1: the soft-rasterizer forward, its schedule and its plain version.

Port of ``hocon/render/raster_pallas.py`` (forward half). The integer face
indices are sorted by screen y (``sort_faces_by_y``), the plane rows are
packed into per-face coefficient rows with inert padding and per-chunk
margin bounds (``pack_sorted_planes``), each 8-row block gets the range of
chunks that can reach it (``chunk_ranges``), and ``raster_fwd`` renders.

``raster_fwd`` launches ``hocon_torch/csrc/raster_fwd.cu`` for CUDA tensors
and runs ``raster_fwd_plain`` for CPU tensors; its launch count is
``raster_fwd.launches``. The kernel replaces
``hocon/render/raster_pallas.py:_raster_kernel``; its source note says what
bounds it on the card and how its design answers that.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from hocon_torch.render.raster import (
    N_GEOM_ROWS,
    FacePlanes,
    RasterOutput,
    face_valid,
    gather_faces,
)

FACE_CHUNK = 32  # faces per culling chunk
ROW_BLOCK = 8  # rows per chunk-range entry
LANE_BLOCK = 256  # widest culling cell in columns; wider images use 128
# Coverage at 3.5 sigma from a face is ~4.8e-6, below the 2e-5 silhouette
# parity; chunk bounds carry this margin.
CUTOFF_SIGMAS = 3.5
_BIG_NEG = -1e4  # inert-face edge constant; its square stays in f32 range
# Fixed-reference softmax when 1 / gamma <= this: every weight exp(l) and
# the background weight exp(-1 / gamma) stay inside f32 range.
FIXED_M_MAX_INV_GAMMA = 60.0
KERNEL_ATTRS = 2  # attribute channels the CUDA kernel is built for


class RasterConfig(NamedTuple):
    """Kernel schedule: faces per culling chunk, widest lane block."""

    face_chunk: int
    lane_block: int


def default_config() -> RasterConfig:
    return RasterConfig(FACE_CHUNK, LANE_BLOCK)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def lane_block(wp: int, widest: int = LANE_BLOCK) -> int:
    """Culling-cell width for a padded width ``wp`` (a multiple of 128)."""
    return wp if wp <= widest else 128


def padded_size(image_size: tuple[int, int]) -> tuple[int, int]:
    """(Hp, Wp): rows to a multiple of 8, columns to a multiple of 128."""
    h, w = image_size
    return _round_up(h, ROW_BLOCK), _round_up(w, 128)


@torch.no_grad()
def sort_faces_by_y(
    verts_pix: torch.Tensor,
    faces: torch.Tensor,
    backface_cull: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort integer faces by screen-space y centre; culled faces go last.

    Returns faces_sorted (B, F, 3) int64 and face_bbox (B, F, 4)
    [ymin, ymax, xmin, xmax] in sorted order. The sort is stable, as
    ``jnp.argsort`` is, so faces with tied keys keep their order.
    """
    vp = verts_pix.detach()
    if faces.dim() == 2:
        faces = faces[None].expand((vp.shape[0],) + faces.shape)
    faces = faces.long()
    fv = gather_faces(vp, faces)  # (B, F, 3, 2)
    valid = face_valid(fv, backface_cull)
    ymin = torch.amin(fv[..., 1], dim=-1)
    ymax = torch.amax(fv[..., 1], dim=-1)
    inf = torch.full_like(ymin, math.inf)
    ycenter = torch.where(valid, 0.5 * (ymin + ymax), inf)
    ycenter = torch.where(torch.isnan(ycenter), inf, ycenter)
    order = torch.argsort(ycenter, dim=1, stable=True)
    faces_sorted = torch.gather(faces, 1, order[:, :, None].expand(-1, -1, 3))
    bbox = torch.stack(
        [ymin, ymax, torch.amin(fv[..., 0], dim=-1), torch.amax(fv[..., 0], dim=-1)],
        dim=-1,
    )
    bbox = torch.gather(bbox, 1, order[:, :, None].expand(-1, -1, 4))
    return faces_sorted, bbox


def pack_sorted_planes(
    planes: FacePlanes,
    face_bbox: torch.Tensor,
    sigma: float,
    face_chunk: int = FACE_CHUNK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Coefficient rows and per-chunk culling bounds for the kernel.

    ``planes`` and ``face_bbox`` come from faces already in
    ``sort_faces_by_y`` order. Returns coeffs (B, Fp, 3R) f32, culled faces and the
    padding to a chunk multiple made inert (the three edge rows constant
    -1e4: zero coverage everywhere), and bounds (B, NC, 4) f32, each chunk's
    [ymin, ymax, xmin, xmax] over its kept faces widened by 3.5 sigma.
    """
    rows, valid = planes.rows, planes.valid
    b, f, r, _ = rows.shape
    bbox = face_bbox.detach()
    v = valid[..., None, None] > 0
    inert_edge = rows.new_tensor([0.0, 0.0, _BIG_NEG])
    edge = torch.where(v, rows[:, :, :3], inert_edge)
    rest = torch.where(v, rows[:, :, 3:], torch.zeros_like(rows[:, :, 3:]))
    coeffs = torch.cat([edge, rest], dim=2).reshape(b, f, r * 3)

    fp = _round_up(f, face_chunk)
    if fp > f:
        pad = coeffs.new_zeros((b, fp - f, r * 3))
        pad[:, :, [2, 5, 8]] = _BIG_NEG
        coeffs = torch.cat([coeffs, pad], dim=1)

    nc = fp // face_chunk
    margin = CUTOFF_SIGMAS * sigma

    def chunk_reduce(vals, fill, reducer):
        vals = torch.where(valid > 0, vals, torch.full_like(vals, fill))
        vals = torch.cat([vals, vals.new_full((b, fp - f), fill)], dim=1)
        return reducer(vals.reshape(b, nc, face_chunk), dim=-1)

    cymin = chunk_reduce(bbox[..., 0], math.inf, torch.amin) - margin
    cymax = chunk_reduce(bbox[..., 1], -math.inf, torch.amax) + margin
    cxmin = chunk_reduce(bbox[..., 2], math.inf, torch.amin) - margin
    cxmax = chunk_reduce(bbox[..., 3], -math.inf, torch.amax) + margin
    bounds = torch.stack([cymin, cymax, cxmin, cxmax], dim=-1)
    return coeffs.float().contiguous(), bounds.float().contiguous()


def chunk_ranges(bounds: torch.Tensor, hp: int) -> torch.Tensor:
    """Per 8-row block [k_start, k_end) into the y-sorted chunk list.

    Faces are y-sorted, so the chunks whose y-interval meets a row block
    form one index range; (0, 0) where none does. Returns (B, NYB, 2) int32.
    """
    nyb = hp // ROW_BLOCK
    y0 = (
        torch.arange(nyb, device=bounds.device, dtype=torch.float32) * ROW_BLOCK
    )[None, None, :]
    ov = (y0 + ROW_BLOCK > bounds[..., 0:1]) & (y0 < bounds[..., 1:2])
    nc = ov.shape[1]
    any_k = ov.any(dim=1)
    ovi = ov.to(torch.int32)
    first = torch.argmax(ovi, dim=1)  # first maximal index, as jnp.argmax
    last = nc - 1 - torch.argmax(ovi.flip(1), dim=1)
    zero = torch.zeros_like(first)
    ks = torch.where(any_k, first, zero)
    ke = torch.where(any_k, last + 1, zero)
    return torch.stack([ks, ke], dim=-1).to(torch.int32)


def cell_hits(bounds, krange, hp, wp, xb):
    """(B, NC, NYB, NXB) bool: chunk k is evaluated in cell (row block,
    lane block) — inside the block's chunk range and overlapping it."""
    dev = bounds.device
    nc = bounds.shape[1]
    y0 = torch.arange(hp // ROW_BLOCK, device=dev, dtype=torch.float32) * ROW_BLOCK
    x0 = torch.arange(wp // xb, device=dev, dtype=torch.float32) * xb
    hit_y = (y0 + ROW_BLOCK > bounds[..., 0:1]) & (y0 < bounds[..., 1:2])
    hit_x = (x0 + xb > bounds[..., 2:3]) & (x0 < bounds[..., 3:4])
    k = torch.arange(nc, device=dev)[None, :, None]
    in_range = (k >= krange[:, None, :, 0]) & (k < krange[:, None, :, 1])
    return (hit_y & in_range)[..., :, None] & hit_x[..., None, :]


def raster_fwd_plain(
    coeffs: torch.Tensor,
    bounds: torch.Tensor,
    krange: torch.Tensor,
    image_size: tuple[int, int],
    sigma: float,
    gamma: float,
    config: RasterConfig,
):
    """K1's plain PyTorch version, at the kernel's interface.

    Loops over chunks in order; a chunk updates exactly the cells
    (8-row block x lane block) that the kernel evaluates it in, with the
    reference kernel's per-chunk arithmetic. Returns the padded
    (sil (B,Hp,Wp), attr (B,C+1,Hp,Wp), vis (B,Hp,Wp), mden (B,2,Hp,Wp)).
    """
    b, fp, r3 = coeffs.shape
    r = r3 // 3
    n_user = r - N_GEOM_ROWS
    hp, wp = padded_size(image_size)
    xb = lane_block(wp, config.lane_block)
    fc = config.face_chunk
    dev, f32 = coeffs.device, coeffs.dtype  # f32 on the main path
    fixed_m = (1.0 / gamma) <= FIXED_M_MAX_INV_GAMMA
    inv_sigma_sq = 1.0 / (sigma * sigma)
    inv_gamma = 1.0 / gamma
    l_bg = -1.0 / gamma
    w_bg = math.exp(-1.0 / gamma)

    if fixed_m:
        acc0 = torch.ones((b, hp, wp), device=dev, dtype=f32)
        m = torch.zeros((b, hp, wp), device=dev, dtype=f32)
        den = torch.full((b, hp, wp), w_bg, device=dev, dtype=f32)
        numz = den.clone()
    else:
        acc0 = torch.zeros((b, hp, wp), device=dev, dtype=f32)
        m = torch.full((b, hp, wp), l_bg, device=dev, dtype=f32)
        den = torch.ones((b, hp, wp), device=dev, dtype=f32)
        numz = den.clone()
    num = torch.zeros((b, n_user, hp, wp), device=dev, dtype=f32)

    xs_all = torch.arange(wp, device=dev, dtype=f32) + 0.5
    ys_all = torch.arange(hp, device=dev, dtype=f32) + 0.5
    bounds = bounds.float()
    hits = cell_hits(bounds, krange, hp, wp, xb)  # (B, NC, NYB, NXB)
    hits_host = hits.any(dim=0).cpu()  # which cells any batch item needs
    for k in range(bounds.shape[1]):
        cells = hits_host[k].nonzero()
        if len(cells) == 0:
            continue
        y_lo, x_lo = cells.min(dim=0).values.tolist()
        y_hi, x_hi = (cells.max(dim=0).values + 1).tolist()
        ys = slice(y_lo * ROW_BLOCK, y_hi * ROW_BLOCK)
        xs = slice(x_lo * xb, x_hi * xb)
        take = hits[:, k, y_lo:y_hi, x_lo:x_hi]
        take = take.repeat_interleave(ROW_BLOCK, 1).repeat_interleave(xb, 2)

        a = coeffs[:, k * fc:(k + 1) * fc].reshape(b, fc, r, 3)
        x = xs_all[xs][None, None, None, :]
        y = ys_all[ys][None, None, :, None]

        def row(i):
            return a[:, :, i, 0, None, None] * x + (
                a[:, :, i, 1, None, None] * y + a[:, :, i, 2, None, None]
            )  # (B, FC, rows, cols)

        s = [row(0), row(1), row(2)]
        d_in = torch.minimum(torch.minimum(s[0], s[1]), s[2])
        dist2 = None
        for e in range(3):
            u = row(3 + e)
            length = a[:, :, 6 + e, 2, None, None]
            ov = torch.clamp(torch.maximum(-u, u - length), min=0.0)
            d2 = s[e] * s[e] + ov * ov
            dist2 = d2 if dist2 is None else torch.minimum(dist2, d2)
        signed_sq = torch.where(d_in > 0, d_in * d_in, -dist2)
        logits = signed_sq * inv_sigma_sq
        zbar = torch.clamp(row(9), 0.0, 1.0)

        def put(acc, value):  # update only the cells that evaluate chunk k
            acc[..., ys, xs] = torch.where(take, value, acc[..., ys, xs])

        if fixed_m:
            e2 = torch.exp(-torch.abs(logits))
            rr = 1.0 / (1.0 + e2)
            pos = logits >= 0
            sig = torch.where(pos, rr, rr * e2)
            oms = torch.where(pos, rr * e2, rr)
            w = sig * torch.exp(-zbar * inv_gamma)
            scale = 1.0
            put(acc0, acc0[:, ys, xs] * torch.prod(oms, dim=1))
        else:
            sp = torch.nn.functional.softplus(-logits)
            l = -sp - zbar * inv_gamma
            m_old = m[:, ys, xs]
            m_new = torch.maximum(m_old, l.amax(dim=1))
            scale = torch.exp(m_old - m_new)
            w = torch.exp(l - m_new[:, None])
            put(acc0, acc0[:, ys, xs] + (-(logits + sp)).sum(dim=1))
            put(m, m_new)
        put(den, den[:, ys, xs] * scale + w.sum(dim=1))
        put(numz, numz[:, ys, xs] * scale + (w * zbar).sum(dim=1))
        for c in range(n_user):
            put(num[:, c], num[:, c, ys, xs] * scale + (w * row(10 + c)).sum(dim=1))

    inv_den = 1.0 / den
    if fixed_m:
        sil = 1.0 - acc0
        vis = 1.0 - w_bg * inv_den
    else:
        sil = 1.0 - torch.exp(acc0)
        vis = 1.0 - torch.exp(l_bg - m) * inv_den
    attr = torch.cat([num, numz[:, None]], dim=1) * inv_den[:, None]
    return sil, attr, vis, torch.stack([m, den], dim=1)


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    from hocon_torch.utils import cuda_build

    lib = cuda_build.load("raster_fwd")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hocon_raster_fwd.argtypes = [p] * 7 + [i] * 8 + [f] * 4 + [i, p]
    lib.hocon_raster_fwd.restype = i
    return lib


def raster_fwd_cuda(coeffs, bounds, krange, image_size, sigma, gamma, config):
    """Launch K1 on CUDA tensors (the interface of ``raster_fwd_plain``)."""
    b, fp, r3 = coeffs.shape
    n_user = r3 // 3 - N_GEOM_ROWS
    hp, wp = padded_size(image_size)
    nc = bounds.shape[1]
    if n_user != KERNEL_ATTRS:
        raise ValueError(
            f"raster_fwd kernel is built for {KERNEL_ATTRS} attribute channels "
            f"(the warp's reference-pixel coordinates), got {n_user}"
        )
    if fp != nc * config.face_chunk:
        raise ValueError(f"{fp} padded faces is not {nc} chunks of {config.face_chunk}")
    if config.face_chunk * r3 * 4 > 48 * 1024:
        raise ValueError("raster_fwd: a chunk's coefficients exceed 48 KB of shared memory")
    if tuple(krange.shape) != (b, hp // ROW_BLOCK, 2):
        raise ValueError(f"krange shape {tuple(krange.shape)} for {b} x {hp} rows")
    for name, t, dtype in (
        ("coeffs", coeffs, torch.float32),
        ("bounds", bounds, torch.float32),
        ("krange", krange, torch.int32),
    ):
        if t.dtype != dtype or not t.is_contiguous() or t.device != coeffs.device:
            raise ValueError(f"raster_fwd: {name} must be contiguous {dtype} on {coeffs.device}")
    opts = dict(device=coeffs.device, dtype=torch.float32)
    sil = torch.empty((b, hp, wp), **opts)
    attr = torch.empty((b, n_user + 1, hp, wp), **opts)
    vis = torch.empty((b, hp, wp), **opts)
    mden = torch.empty((b, 2, hp, wp), **opts)
    stream = torch.cuda.current_stream(coeffs.device).cuda_stream
    err = _kernel_lib().hocon_raster_fwd(
        krange.data_ptr(), bounds.data_ptr(), coeffs.data_ptr(),
        sil.data_ptr(), attr.data_ptr(), vis.data_ptr(), mden.data_ptr(),
        b, hp, wp, nc, fp, n_user, config.face_chunk,
        lane_block(wp, config.lane_block),
        1.0 / (sigma * sigma), 1.0 / gamma, -1.0 / gamma, math.exp(-1.0 / gamma),
        int((1.0 / gamma) <= FIXED_M_MAX_INV_GAMMA), stream,
    )
    if err != 0:
        raise RuntimeError(f"raster_fwd kernel launch failed: cudaError {err}")
    raster_fwd.launches += 1
    return sil, attr, vis, mden


def raster_fwd(
    coeffs: torch.Tensor,
    bounds: torch.Tensor,
    image_size: tuple[int, int],
    sigma: float,
    gamma: float,
    config: RasterConfig | None = None,
):
    """K1: render packed faces; returns the padded (sil, attr, vis, mden).

    CUDA tensors launch the kernel (or raise); CPU tensors run
    ``raster_fwd_plain``. ``raster_fwd.launches`` counts kernel launches.
    """
    config = config or default_config()
    hp, _ = padded_size(image_size)
    krange = chunk_ranges(bounds, hp)
    if coeffs.is_cuda:
        return raster_fwd_cuda(coeffs, bounds, krange, image_size, sigma, gamma, config)
    return raster_fwd_plain(coeffs, bounds, krange, image_size, sigma, gamma, config)


raster_fwd.launches = 0


def rasterize_planes(
    planes: FacePlanes,
    face_bbox: torch.Tensor,
    image_size: tuple[int, int] = (256, 256),
    sigma: float = 1.0,
    gamma: float = 1.0 / 40.0,
    config: RasterConfig | None = None,
) -> RasterOutput:
    """Rasterize y-sorted face planes (with their (B, F, 4) bboxes) through
    K1 and crop the padding."""
    config = config or default_config()
    n_attr = planes.rows.shape[2] - (N_GEOM_ROWS - 1)  # user attrs + depth
    coeffs, bounds = pack_sorted_planes(planes, face_bbox, sigma, config.face_chunk)
    h, w = image_size
    sil, attr, vis, _ = raster_fwd(coeffs, bounds, image_size, sigma, gamma, config)
    attr = attr[:, :, :h, :w]
    return RasterOutput(
        sil=sil[:, :h, :w],
        attr=attr[:, : n_attr - 1].permute(0, 2, 3, 1),
        depth=attr[:, n_attr - 1],
        vis=vis[:, :h, :w],
    )
