"""Kernels K1 and K2: the soft-rasterizer forward and backward, their
schedule and their plain versions.

Port of ``hocon/render/raster_pallas.py``. The integer face indices are
sorted by screen y (``sort_faces_by_y``), the plane rows are packed into
per-face coefficient rows with inert padding and per-chunk margin bounds
(``pack_sorted_planes``), each 8-row block gets the range of chunks that
can reach it (``chunk_ranges``), ``raster_fwd`` renders and ``raster_bwd``
chains the output cotangents back to the coefficients. ``RasterizeSorted``
pairs the two as one ``torch.autograd.Function``, as the reference's
``custom_vjp`` does.

``raster_fwd`` / ``raster_bwd`` launch ``hocon_torch/csrc/raster_fwd.cu`` /
``raster_bwd.cu`` for CUDA tensors and run ``raster_fwd_plain`` /
``raster_bwd_plain`` for CPU tensors; their launch counts are
``raster_fwd.launches`` and ``raster_bwd.launches``. The kernels replace
``hocon/render/raster_pallas.py:_raster_kernel`` and ``_raster_bwd_kernel``;
their source notes say what bounds them on the card and how their designs
answer that. ``far_faces`` / ``far_segments`` mirror, op for op, the rule
by which both kernels skip the (face, tile) pairs that add exactly 0 (K2's
32-pixel row segments, K1's 8 x 8 tiles), and ``needed_pairs`` counts the
pairs that do not, pixel by pixel; only the tests and ``chip_smoke.py``
call them.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from hocon_torch.render.raster import (
    N_GEOM_ROWS,
    FacePlanes,
    RasterOutput,
    face_valid,
    gather_faces,
)
from hocon_torch.utils.trace import span

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
# Attribute channels the CUDA kernels are built for: K1 renders the warp's
# two reference-view pixel coordinates and the synthetic dataset's three
# vertex colours; K2 differentiates the warp render only.
K1_ATTRS = (2, 3)
K2_ATTRS = 2
# The kernels' skip rule (``far_faces``, hocon_torch/csrc/far_bound.cuh): a
# face is far from a tile of pixels when its logits there are below
# -far_logit and no pixel is inside; each row's corner values are widened by
# ROW_TOL times the row's magnitude. K2 tests 1 x SEGMENT row segments at
# FAR_LOGIT (expf overflows, so the f32 coverage sigmoid is exactly 0); K1
# tests K1_TILE tiles at ``k1_far_logit(gamma)`` (its source note derives
# both thresholds).
SEGMENT = 32
FAR_LOGIT = 89.0
ROW_TOL = 2.0**-20
K1_TILE = (8, 8)
K1_FAR_LOGIT = 110.0


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


class _ChunkCells(NamedTuple):
    """One chunk of the plain versions and the pixels K1 evaluates it at."""

    k: int
    ys: slice  # rows of the rectangle around its cells
    xs: slice  # columns of that rectangle
    take: torch.Tensor  # (B, rows, cols): pixels in cells that evaluate it
    a: torch.Tensor  # its plane rows (B, FC, R, 3)
    x: torch.Tensor  # pixel-centre x (1, 1, 1, cols)
    y: torch.Tensor  # pixel-centre y (1, 1, rows, 1)

    def row(self, i: int) -> torch.Tensor:
        """Plane row i at the rectangle's pixels, (B, FC, rows, cols)."""
        a = self.a
        return a[:, :, i, 0, None, None] * self.x + (
            a[:, :, i, 1, None, None] * self.y + a[:, :, i, 2, None, None]
        )


def _chunk_cells(coeffs, bounds, krange, image_size, config):
    """Yield a ``_ChunkCells`` for every chunk that some cell (8-row block x
    lane block) evaluates, in chunk order, in the dtype of ``coeffs``."""
    b, _, r3 = coeffs.shape
    hp, wp = padded_size(image_size)
    xb = lane_block(wp, config.lane_block)
    fc = config.face_chunk
    xs_all = torch.arange(wp, device=coeffs.device, dtype=coeffs.dtype) + 0.5
    ys_all = torch.arange(hp, device=coeffs.device, dtype=coeffs.dtype) + 0.5
    hits = cell_hits(bounds.float(), krange, hp, wp, xb)  # (B, NC, NYB, NXB)
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
        a = coeffs[:, k * fc:(k + 1) * fc].reshape(b, fc, r3 // 3, 3)
        yield _ChunkCells(k, ys, xs, take, a, xs_all[xs][None, None, None, :],
                          ys_all[ys][None, None, :, None])


def _face_logits(cell: _ChunkCells, inv_sigma_sq: float) -> torch.Tensor:
    """Coverage logits of the chunk's faces at the cell's pixels (B, FC,
    rows, cols): the signed squared distance to the triangle over sigma^2,
    as the reference kernel evaluates it."""
    row, a = cell.row, cell.a
    s = [row(0), row(1), row(2)]
    d_in = torch.minimum(torch.minimum(s[0], s[1]), s[2])
    dist2 = None
    for e in range(3):
        u = row(3 + e)
        length = a[:, :, 6 + e, 2, None, None]
        ov = torch.clamp(torch.maximum(-u, u - length), min=0.0)
        d2 = s[e] * s[e] + ov * ov
        dist2 = d2 if dist2 is None else torch.minimum(dist2, d2)
    return torch.where(d_in > 0, d_in * d_in, -dist2) * inv_sigma_sq


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
    b, _, r3 = coeffs.shape
    n_user = r3 // 3 - N_GEOM_ROWS
    hp, wp = padded_size(image_size)
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

    for cell in _chunk_cells(coeffs, bounds, krange, image_size, config):
        ys, xs, take, row = cell.ys, cell.xs, cell.take, cell.row
        logits = _face_logits(cell, inv_sigma_sq)
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
    lib.hocon_raster_fwd.argtypes = [p] * 7 + [i] * 8 + [f] * 5 + [i, p]
    lib.hocon_raster_fwd.restype = i
    return lib


def k1_far_logit(gamma: float) -> float:
    """K1's threshold: a pair whose logits are below minus this adds exactly
    nothing to K1's sums. 110 on the fixed-m path (expf is exactly 0 below
    ~-103.97); 110 + 1/gamma on the streaming one, whose weights are
    relative to a running maximum that starts at the background's
    -1/gamma."""
    fixed_m = (1.0 / gamma) <= FIXED_M_MAX_INV_GAMMA
    return K1_FAR_LOGIT if fixed_m else K1_FAR_LOGIT + 1.0 / gamma


def raster_fwd_cuda(coeffs, bounds, krange, image_size, sigma, gamma, config, *,
                    far_logit=None):
    """Launch K1 on CUDA tensors (the interface of ``raster_fwd_plain``).

    ``far_logit`` (default ``k1_far_logit(gamma)``) is the kernel's skip
    threshold; ``math.inf`` evaluates every pair. Only ``chip_smoke.py``
    and ``tools/`` pass it, to show that the two give the same bits.
    """
    b, fp, r3 = coeffs.shape
    n_user = r3 // 3 - N_GEOM_ROWS
    hp, wp = padded_size(image_size)
    nc = bounds.shape[1]
    if n_user not in K1_ATTRS:
        raise ValueError(
            f"raster_fwd kernel is built for {K1_ATTRS} attribute channels "
            f"(the warp's reference-pixel coordinates, vertex colours), got {n_user}"
        )
    if config.face_chunk != FACE_CHUNK or fp != nc * FACE_CHUNK:
        raise ValueError(
            f"raster_fwd kernel is built for chunks of {FACE_CHUNK} faces, got "
            f"{fp} padded faces in {nc} chunks of {config.face_chunk}"
        )
    if tuple(krange.shape) != (b, hp // ROW_BLOCK, 2):
        raise ValueError(f"krange shape {tuple(krange.shape)} for {b} x {hp} rows")
    for name, t, dtype in (
        ("coeffs", coeffs, torch.float32),
        ("bounds", bounds, torch.float32),
        ("krange", krange, torch.int32),
    ):
        if t.dtype != dtype or not t.is_contiguous() or t.device != coeffs.device:
            raise ValueError(f"raster_fwd: {name} must be contiguous {dtype} on {coeffs.device}")
    if r3 % 4 == 0 and coeffs.data_ptr() % 16:
        raise ValueError("raster_fwd: coeffs must start on a 16-byte boundary (float4 loads)")
    if far_logit is None:
        far_logit = k1_far_logit(gamma)
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
        1.0 / (sigma * sigma), 1.0 / gamma, -1.0 / gamma, math.exp(-1.0 / gamma), far_logit,
        int((1.0 / gamma) <= FIXED_M_MAX_INV_GAMMA), stream,
    )
    if err != 0:
        raise RuntimeError(f"raster_fwd kernel launch failed: cudaError {err}")
    raster_fwd.launches += 1
    raster_fwd.launches_by_attrs[n_user] = raster_fwd.launches_by_attrs.get(n_user, 0) + 1
    return sil, attr, vis, mden


def raster_fwd(
    coeffs: torch.Tensor,
    bounds: torch.Tensor,
    krange: torch.Tensor,
    image_size: tuple[int, int],
    sigma: float,
    gamma: float,
    config: RasterConfig | None = None,
):
    """K1: render packed faces with their ``chunk_ranges``; returns the
    padded (sil, attr, vis, mden).

    CUDA tensors launch the kernel (or raise); CPU tensors run
    ``raster_fwd_plain``. ``raster_fwd.launches`` counts kernel launches,
    ``raster_fwd.launches_by_attrs`` the same per attribute count C.
    """
    fn = raster_fwd_cuda if coeffs.is_cuda else raster_fwd_plain
    return fn(coeffs, bounds, krange, image_size, sigma, gamma, config or default_config())


raster_fwd.launches = 0
raster_fwd.launches_by_attrs = {}


def _rcp123(cnt: torch.Tensor) -> torch.Tensor:
    """1 / cnt for tie counts that are exactly 1, 2 or 3."""
    return torch.where(cnt == 1.0, 1.0, torch.where(cnt == 2.0, 0.5, 1.0 / 3.0)).to(cnt.dtype)


def raster_bwd_plain(
    coeffs: torch.Tensor,
    bounds: torch.Tensor,
    krange: torch.Tensor,
    sil: torch.Tensor,
    attr: torch.Tensor,
    vis: torch.Tensor,
    mden: torch.Tensor,
    gsil: torch.Tensor,
    gattr: torch.Tensor,
    gvis: torch.Tensor,
    image_size: tuple[int, int],
    sigma: float,
    gamma: float,
    config: RasterConfig,
) -> torch.Tensor:
    """K2's plain PyTorch version, at the kernel's interface.

    Inputs are K1's inputs, its four padded outputs and the padded
    cotangents gsil / gvis (B, Hp, Wp) and gattr (B, C+1, Hp, Wp). Loops over
    chunks; a chunk contributes from exactly the cells (8-row block x lane
    block) that K1 evaluated it in, with ``_raster_bwd_kernel``'s per-(face,
    pixel) arithmetic term for term: the recomputed forward, the softmax
    competition, the silhouette, the strict 0 < zraw < 1 clip mask, the
    1/2/3 tie split of the minima and the overhang branches. Each row r of
    a face gets (sum dval * x, sum dval * y, sum dval) over those pixels.
    Returns dcoeffs (B, Fp, 3R) in the dtype of ``coeffs``.
    """
    b, fp, r3 = coeffs.shape
    r = r3 // 3
    n_user = r - N_GEOM_ROWS
    fc = config.face_chunk
    dev, dt = coeffs.device, coeffs.dtype
    inv_sigma_sq = 1.0 / (sigma * sigma)
    inv_gamma = 1.0 / gamma

    # Per-pixel state shared by all faces, as the kernel derives it.
    gs1 = gsil * (1.0 - sil)
    m = mden[:, 0]
    inv_den = 1.0 / mden[:, 1]
    g_z, out_z = gattr[:, n_user], attr[:, n_user]
    gv = gvis * (1.0 - vis)

    dcoeffs = torch.zeros((b, fp, r, 3), device=dev, dtype=dt)
    for cell in _chunk_cells(coeffs, bounds, krange, image_size, config):
        ys, xs, a, row, x, y = cell.ys, cell.xs, cell.a, cell.row, cell.x, cell.y
        take = cell.take[:, None]

        def px(t):  # per-pixel state of the cells, broadcast over faces
            return t[:, None, ys, xs]

        s = [row(0), row(1), row(2)]
        d_in = torch.minimum(torch.minimum(s[0], s[1]), s[2])
        us, lens, ovs, c2s = [], [], [], []
        for e in range(3):
            u = row(3 + e)
            length = a[:, :, 6 + e, 2, None, None]
            ov = torch.clamp(torch.maximum(-u, u - length), min=0.0)
            us.append(u)
            lens.append(length)
            ovs.append(ov)
            c2s.append(s[e] * s[e] + ov * ov)
        dist2 = torch.minimum(torch.minimum(c2s[0], c2s[1]), c2s[2])
        inside = d_in > 0
        signed_sq = torch.where(inside, d_in * d_in, -dist2)
        logits = signed_sq * inv_sigma_sq
        zraw = row(9)
        z = torch.clamp(zraw, 0.0, 1.0)
        sig = torch.sigmoid(logits)
        # exp(l - m) as sig * exp(-z / gamma - m), its exponent clamped at 80
        # (a face >= 8.9 sigma away, far beyond the culling cutoff).
        e_w = torch.clamp(-z * inv_gamma - px(m), max=80.0)
        what = sig * torch.exp(e_w) * px(inv_den)

        grads = {}
        ssum = px(g_z) * (z - px(out_z)) + px(gv)
        for c in range(n_user):
            g_c = px(gattr[:, c])
            ssum = ssum + g_c * (row(10 + c) - px(attr[:, c]))
            grads[10 + c] = what * g_c  # direct attribute-row gradient
        dl = what * ssum
        dx = px(gs1) * sig + dl * (1.0 - sig)
        clip_mask = ((zraw > 0.0) & (zraw < 1.0)).to(dt)
        grads[9] = (what * px(g_z) - dl * inv_gamma) * clip_mask

        dss = dx * inv_sigma_sq  # dL / d(signed_sq)
        insf = inside.to(dt)
        in_masks = [(sk == d_in).to(dt) for sk in s]
        o_masks = [(c2 == dist2).to(dt) for c2 in c2s]
        in_sel = _rcp123(in_masks[0] + in_masks[1] + in_masks[2]) * insf
        o_sel = _rcp123(o_masks[0] + o_masks[1] + o_masks[2]) * (1.0 - insf)
        for e in range(3):
            sel_in = in_masks[e] * in_sel
            sel_out = o_masks[e] * o_sel
            grads[e] = (2.0 * d_in * sel_in - 2.0 * s[e] * sel_out) * dss
            a_side = -us[e]
            b_side = us[e] - lens[e]
            take_b = ((b_side >= a_side) & (b_side > 0)).to(dt)
            take_a = ((a_side > b_side) & (a_side > 0)).to(dt)
            dov = -2.0 * ovs[e] * sel_out * dss  # dL / d(overhang)
            grads[3 + e] = dov * (take_b - take_a)
            grads[6 + e] = dov * (-take_b)

        out = dcoeffs[:, cell.k * fc:(cell.k + 1) * fc]
        for i, dval in grads.items():
            dval = torch.where(take, dval, 0.0)
            out[:, :, i, 0] = (dval * x).sum(dim=(2, 3))
            out[:, :, i, 1] = (dval * y).sum(dim=(2, 3))
            out[:, :, i, 2] = dval.sum(dim=(2, 3))
    return dcoeffs.reshape(b, fp, r3)


def _row_span(a, i, xa, xb, ya, yb):
    """Row i of the faces ``a`` (B, FC, R, 3) over the rectangles of pixel
    centres [xa, xb] x [ya, yb] (0 <= xa <= xb, 0 <= ya <= yb): (lo, hi,
    tol), ``row_span`` of hocon_torch/csrc/far_bound.cuh op for op in the
    dtype of ``a``."""
    a0, a1, a2 = (a[:, :, i, j, None, None] for j in range(3))
    base_a = a1 * ya + a2
    base_b = a1 * yb + a2
    corners = (a0 * xa + base_a, a0 * xb + base_a, a0 * xa + base_b, a0 * xb + base_b)
    lo = torch.fmin(torch.fmin(corners[0], corners[1]), torch.fmin(corners[2], corners[3]))
    hi = torch.fmax(torch.fmax(corners[0], corners[1]), torch.fmax(corners[2], corners[3]))
    mag = (a0.abs() * xb + a1.abs() * yb) + a2.abs()
    return lo, hi, mag * ROW_TOL


def far_faces(coeffs, bounds, krange, image_size, sigma, config, tile=(1, SEGMENT),
              far_logit=FAR_LOGIT):
    """(B, Fp, Hp / th, Wp / tw) bool for ``tile`` = (th, tw): the skip rule
    of hocon_torch/csrc/far_bound.cuh for each face and tile of the cells
    that K1 evaluated its chunk in (False elsewhere), computed op for op as
    the kernels compute it. K2's rule is the default, 1 x 32 row segments
    at ``FAR_LOGIT``; K1's is ``K1_TILE`` at ``k1_far_logit(gamma)``.

    A face is far from a tile when, from its rows at the tile's corners
    widened by ``ROW_TOL`` times each row's magnitude, every edge's lower
    bound on s^2 + ov^2 over sigma^2 exceeds ``far_logit`` and some edge is
    <= 0 over the whole tile (no pixel is inside). Only the tests and
    ``chip_smoke.py`` call this; the kernels decide on the card.
    """
    b, fp, _ = coeffs.shape
    hp, wp = padded_size(image_size)
    th, tw = tile
    fc = config.face_chunk
    inv_sigma_sq = torch.tensor(1.0 / (sigma * sigma), dtype=coeffs.dtype, device=coeffs.device)
    zero = torch.zeros((), dtype=coeffs.dtype, device=coeffs.device)
    far = torch.zeros((b, fp, hp // th, wp // tw), dtype=torch.bool, device=coeffs.device)
    for cell in _chunk_cells(coeffs, bounds, krange, image_size, config):
        a = cell.a
        xa, xb = cell.x[..., ::tw], cell.x[..., tw - 1::tw]
        ya, yb = cell.y[..., ::th, :], cell.y[..., th - 1::th, :]
        lb, outside = None, None
        for e in range(3):
            s_lo, s_hi, s_tol = _row_span(a, e, xa, xb, ya, yb)
            u_lo, u_hi, u_tol = _row_span(a, 3 + e, xa, xb, ya, yb)
            length = a[:, :, 6 + e, 2, None, None]
            s_lb = torch.fmax(torch.fmax(s_lo, -s_hi) - s_tol, zero)
            ov_lb = torch.fmax(torch.fmax(-u_hi, u_lo - length) - u_tol, zero)
            lb_e = s_lb * s_lb + ov_lb * ov_lb
            out_e = s_hi + s_tol <= 0
            lb = lb_e if lb is None else torch.fmin(lb, lb_e)
            outside = out_e if outside is None else outside | out_e
        take = cell.take[:, None, ::th, ::tw]  # the cells that evaluate the chunk
        rows = slice(cell.ys.start // th, cell.ys.stop // th)
        cols = slice(cell.xs.start // tw, cell.xs.stop // tw)
        far[:, cell.k * fc:(cell.k + 1) * fc, rows, cols] = (
            outside & (lb * inv_sigma_sq > far_logit) & take)
    return far


def far_segments(coeffs, bounds, krange, image_size, sigma, config):
    """(B, NC, Hp, Wp / 32) bool: the row segments K2 skips for each chunk,
    those where all of the chunk's faces are ``far_faces``."""
    far = far_faces(coeffs, bounds, krange, image_size, sigma, config)
    b, fp, hp, n_seg = far.shape
    fc = config.face_chunk
    return far.reshape(b, fp // fc, fc, hp, n_seg).all(dim=2)


@torch.no_grad()
def needed_pairs(coeffs, bounds, krange, image_size, sigma, gamma, config) -> tuple[int, int]:
    """Of the (face, pixel) pairs in the cells that K1 evaluates each chunk
    in, those whose f32 contribution is not exactly zero, counted per pixel
    from the plain version's own logits, with no tile rule: (K1's, K2's).

    K1's: on the fixed-m path, 1 - p != 1 or the weight != 0; on the
    streaming path, log(1 - p) != 0 or the weight relative to the
    background exp(l - l_bg) != 0 (a larger running maximum only shrinks
    it). K2's: the coverage sigmoid 1 / (1 + exp(-logits)) != 0, without
    which every term of the pair's gradient is +-0. Only ``chip_smoke.py``
    calls this, for the kernels' bounds.
    """
    inv_sigma_sq = 1.0 / (sigma * sigma)
    inv_gamma = 1.0 / gamma
    k1 = k2 = 0
    for cell in _chunk_cells(coeffs, bounds, krange, image_size, config):
        logits = _face_logits(cell, inv_sigma_sq)
        zbar = torch.clamp(cell.row(9), 0.0, 1.0)
        if (1.0 / gamma) <= FIXED_M_MAX_INV_GAMMA:
            e2 = torch.exp(-torch.abs(logits))
            rr = 1.0 / (1.0 + e2)
            pos = logits >= 0
            sig = torch.where(pos, rr, rr * e2)
            oms = torch.where(pos, rr * e2, rr)
            live = (oms != 1.0) | (sig * torch.exp(-zbar * inv_gamma) != 0.0)
        else:
            sp = torch.nn.functional.softplus(-logits)
            l = -sp - zbar * inv_gamma
            live = (logits + sp != 0.0) | (torch.exp(l + inv_gamma) != 0.0)
        take = cell.take[:, None]
        k1 += int((live & take).sum())
        k2 += int(((1.0 / (1.0 + torch.exp(-logits)) != 0.0) & take).sum())
    return k1, k2


@functools.cache
def _bwd_kernel_lib() -> ctypes.CDLL:
    from hocon_torch.utils import cuda_build

    lib = cuda_build.load("raster_bwd")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hocon_raster_bwd.argtypes = [p] * 11 + [i] * 7 + [f] * 2 + [p]
    lib.hocon_raster_bwd.restype = i
    return lib


def raster_bwd_cuda(coeffs, bounds, krange, sil, attr, vis, mden, gsil, gattr, gvis,
                    image_size, sigma, gamma, config):
    """Launch K2 on CUDA tensors (the interface of ``raster_bwd_plain``)."""
    b, fp, r3 = coeffs.shape
    n_user = r3 // 3 - N_GEOM_ROWS
    hp, wp = padded_size(image_size)
    nc = bounds.shape[1]
    if n_user != K2_ATTRS:
        raise ValueError(
            f"raster_bwd kernel is built for {K2_ATTRS} attribute channels "
            f"(the warp's reference-pixel coordinates), got {n_user}"
        )
    if config.face_chunk != FACE_CHUNK or fp != nc * FACE_CHUNK:
        raise ValueError(
            f"raster_bwd kernel is built for chunks of {FACE_CHUNK} faces, got "
            f"{fp} padded faces in {nc} chunks of {config.face_chunk}"
        )
    if tuple(krange.shape) != (b, hp // ROW_BLOCK, 2):
        raise ValueError(f"krange shape {tuple(krange.shape)} for {b} x {hp} rows")
    shapes = {
        "coeffs": (coeffs, torch.float32, (b, fp, r3)),
        "bounds": (bounds, torch.float32, (b, nc, 4)),
        "krange": (krange, torch.int32, (b, hp // ROW_BLOCK, 2)),
        "sil": (sil, torch.float32, (b, hp, wp)),
        "attr": (attr, torch.float32, (b, n_user + 1, hp, wp)),
        "vis": (vis, torch.float32, (b, hp, wp)),
        "mden": (mden, torch.float32, (b, 2, hp, wp)),
        "gsil": (gsil, torch.float32, (b, hp, wp)),
        "gattr": (gattr, torch.float32, (b, n_user + 1, hp, wp)),
        "gvis": (gvis, torch.float32, (b, hp, wp)),
    }
    for name, (t, dtype, shape) in shapes.items():
        if (t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous()
                or t.device != coeffs.device):
            raise ValueError(
                f"raster_bwd: {name} must be a contiguous {dtype} {shape} on "
                f"{coeffs.device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    dcoeffs = torch.empty((b, fp, r3), device=coeffs.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(coeffs.device).cuda_stream
    err = _bwd_kernel_lib().hocon_raster_bwd(
        krange.data_ptr(), bounds.data_ptr(), coeffs.data_ptr(),
        sil.data_ptr(), attr.data_ptr(), vis.data_ptr(), mden.data_ptr(),
        gsil.data_ptr(), gattr.data_ptr(), gvis.data_ptr(), dcoeffs.data_ptr(),
        b, hp, wp, nc, fp, n_user, lane_block(wp, config.lane_block),
        1.0 / (sigma * sigma), 1.0 / gamma, stream,
    )
    if err != 0:
        raise RuntimeError(f"raster_bwd kernel launch failed: cudaError {err}")
    raster_bwd.launches += 1
    return dcoeffs


def raster_bwd(
    coeffs: torch.Tensor,
    bounds: torch.Tensor,
    krange: torch.Tensor,
    sil: torch.Tensor,
    attr: torch.Tensor,
    vis: torch.Tensor,
    mden: torch.Tensor,
    gsil: torch.Tensor,
    gattr: torch.Tensor,
    gvis: torch.Tensor,
    image_size: tuple[int, int],
    sigma: float,
    gamma: float,
    config: RasterConfig | None = None,
) -> torch.Tensor:
    """K2: dL/dcoeffs (B, Fp, 3R) from K1's inputs, its padded outputs and
    their cotangents.

    CUDA tensors launch the kernel (or raise); CPU tensors run
    ``raster_bwd_plain``. ``raster_bwd.launches`` counts kernel launches.
    """
    fn = raster_bwd_cuda if coeffs.is_cuda else raster_bwd_plain
    return fn(coeffs, bounds, krange, sil, attr, vis, mden, gsil, gattr, gvis,
              image_size, sigma, gamma, config or default_config())


raster_bwd.launches = 0


class RasterizeSorted(torch.autograd.Function):
    """K1 forward, K2 backward: the reference's ``_rasterize_sorted``.

    ``forward(coeffs, bounds, image_size, sigma, gamma, config)`` returns
    the cropped (sil (B,H,W), attr (B,C+1,H,W), vis (B,H,W)); the backward
    gives dcoeffs and nothing for the (scheduling-only) bounds. Outputs a
    loss does not use reach the backward as zeros, as in the reference.
    """

    @staticmethod
    def forward(ctx, coeffs, bounds, image_size, sigma, gamma, config):
        krange = chunk_ranges(bounds, padded_size(image_size)[0])
        sil, attr, vis, mden = raster_fwd(coeffs, bounds, krange, image_size, sigma, gamma,
                                          config)
        ctx.save_for_backward(coeffs, bounds, krange, sil, attr, vis, mden)
        ctx.args = (image_size, sigma, gamma, config)
        h, w = image_size
        return sil[:, :h, :w], attr[:, :, :h, :w], vis[:, :h, :w]

    @staticmethod
    def backward(ctx, gsil, gattr, gvis):
        coeffs, bounds, krange, sil, attr, vis, mden = ctx.saved_tensors
        image_size, sigma, gamma, config = ctx.args
        h, w = image_size
        hp, wp = sil.shape[1:]
        pad = (0, wp - w, 0, hp - h)  # zero cotangents on the padding

        def padded(g):
            return F.pad(g.float(), pad).contiguous()

        dcoeffs = raster_bwd(
            coeffs, bounds, krange, sil, attr, vis, mden, padded(gsil), padded(gattr),
            padded(gvis), image_size, sigma, gamma, config,
        )
        return dcoeffs, None, None, None, None, None


def rasterize_planes(
    planes: FacePlanes,
    face_bbox: torch.Tensor,
    image_size: tuple[int, int] = (256, 256),
    sigma: float = 1.0,
    gamma: float = 1.0 / 40.0,
    config: RasterConfig | None = None,
) -> RasterOutput:
    """Rasterize y-sorted face planes (with their (B, F, 4) bboxes) through
    K1 (forward) and K2 (backward)."""
    config = config or default_config()
    n_attr = planes.rows.shape[2] - (N_GEOM_ROWS - 1)  # user attrs + depth
    with span("render.prep"):
        coeffs, bounds = pack_sorted_planes(planes, face_bbox, sigma, config.face_chunk)
    with span("render.raster"):
        sil, attr, vis = RasterizeSorted.apply(coeffs, bounds, image_size, sigma, gamma,
                                               config)
        return RasterOutput(
            sil=sil,
            attr=attr[:, : n_attr - 1].permute(0, 2, 3, 1),
            depth=attr[:, n_attr - 1],
            vis=vis,
        )
