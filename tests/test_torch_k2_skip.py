"""K2's skip rule (``raster_cuda.far_faces`` / ``far_segments``) is exact.

K2 skips a 32-pixel row segment when every face of the chunk is far from
it: a bound from the face's rows at the segment's two ends says that its
f32 coverage sigmoid 1 / (1 + exp(-logits)) is exactly 0 at every pixel.
The kernel decides on the card; ``far_faces`` computes the same rule op for
op. Here, on the CPU, every (face, pixel) pair that the rule marks must
have that sigmoid exactly 0 and no pixel inside, with the rows evaluated
as the plain version evaluates them and rounded once (as the kernel's
fused multiply-adds do); the rule must skip something; and the plain
backward with the skipped pairs left out must equal the full one. Scenes:
``chip_smoke.py``'s hand + sphere with backface culling at 64 and 128 px,
faces with large coefficients placed near the threshold, and a rim sliver.
"""

import numpy as np
import pytest
import torch

import chip_smoke as CS
import hocon_torch.render.raster as TR
import hocon_torch.render.raster_cuda as TRC

torch.set_num_threads(1)

PAIRS = 2
SEG = TRC.SEGMENT


def _row_plain(cell, i):
    return cell.row(i)


def _row_once(cell, i):
    """Row i with one rounding to f32, as fma(a0, x, fma(a1, y, a2))."""
    a, f64 = cell.a.double(), torch.float64
    val = a[:, :, i, 0, None, None] * cell.x.to(f64) + (
        a[:, :, i, 1, None, None] * cell.y.to(f64) + a[:, :, i, 2, None, None])
    return val.float()


ROW_FORMS = {"plain rows": _row_plain, "rows rounded once": _row_once}


def _logits(cell, row, sigma):
    """The kernel's logits and d_in over the cell's rectangle, (B, FC,
    rows, cols), in the dtype of the rows."""
    s = [row(cell, e) for e in range(3)]
    d_in = torch.minimum(torch.minimum(s[0], s[1]), s[2])
    dist2 = None
    for e in range(3):
        u = row(cell, 3 + e)
        length = cell.a[:, :, 6 + e, 2, None, None]
        ov = torch.clamp(torch.maximum(-u, u - length), min=0.0)
        c2 = s[e] * s[e] + ov * ov
        dist2 = c2 if dist2 is None else torch.minimum(dist2, c2)
    logits = torch.where(d_in > 0, d_in * d_in, -dist2) * np.float32(1.0 / (sigma * sigma))
    return logits, d_in


def _check_far_pairs(coeffs, bounds, krange, size, sigma, row):
    """Every pair the rule marks: sigmoid exactly 0, not inside. Returns
    the number of (face, segment) marks checked."""
    cfg = TRC.default_config()
    far = TRC.far_faces(coeffs, bounds, krange, size, sigma, cfg)
    fc, n = cfg.face_chunk, 0
    for cell in TRC._chunk_cells(coeffs, bounds, krange, size, cfg):
        segs = slice(cell.xs.start // SEG, cell.xs.stop // SEG)
        marks = far[:, cell.k * fc:(cell.k + 1) * fc, cell.ys, segs]
        if not marks.any():
            continue
        n += int(marks.sum())
        logits, d_in = _logits(cell, row, sigma)
        assert logits.dtype == torch.float32
        sig = 1.0 / (1.0 + torch.exp(-logits))  # the kernel's sigmoid form
        pix = marks.repeat_interleave(SEG, dim=-1)
        assert bool((sig[pix] == 0).all()), f"chunk {cell.k}: a skipped pair has coverage"
        assert bool((d_in[pix] <= 0).all()), f"chunk {cell.k}: a skipped pixel is inside"
    return n


@pytest.fixture(scope="module", params=[64, 128])
def scene(request):
    res = request.param
    tgt, ref, faces, k = CS.make_scene(torch, "cpu", pairs=PAIRS, res=res)
    coeffs, bounds, krange = CS.raster_inputs(torch, tgt, ref, faces, k, res)
    return res, coeffs, bounds, krange


@pytest.mark.parametrize("form", list(ROW_FORMS))
def test_skipped_pairs_have_zero_coverage(scene, form):
    res, coeffs, bounds, krange = scene
    n = _check_far_pairs(coeffs, bounds, krange, (res, res), CS.SIGMA, ROW_FORMS[form])
    assert n > 0


def test_far_segments_skip_a_share_and_no_inside_pixel(scene):
    """The rule is not vacuous: it skips a share of the segments K2 walks,
    and no skipped segment holds a pixel inside any face of its chunk."""
    res, coeffs, bounds, krange = scene
    cfg, size = TRC.default_config(), (res, res)
    hp, wp = TRC.padded_size(size)
    xb = TRC.lane_block(wp)
    walked = int(TRC.cell_hits(bounds, krange, hp, wp, xb).sum()) * TRC.ROW_BLOCK * (xb // SEG)
    skip = TRC.far_segments(coeffs, bounds, krange, size, CS.SIGMA, cfg)
    assert skip.shape == (PAIRS, bounds.shape[1], hp, wp // SEG)
    assert 0.2 * walked < int(skip.sum()) < walked
    for cell in TRC._chunk_cells(coeffs, bounds, krange, size, cfg):
        segs = slice(cell.xs.start // SEG, cell.xs.stop // SEG)
        pix = skip[:, cell.k, cell.ys, segs].repeat_interleave(SEG, dim=-1)
        _, d_in = _logits(cell, _row_plain, CS.SIGMA)
        assert not bool((d_in > 0).any(dim=1)[pix].any()), f"chunk {cell.k}"


@pytest.mark.parametrize("gamma", CS.GAMMAS)
def test_plain_backward_without_skipped_pairs_is_unchanged(scene, gamma, monkeypatch):
    """``raster_bwd_plain`` with the skipped segments taken out of each
    chunk's cells gives the same dcoeffs as over every pair (``torch.equal``,
    which holds -0 equal to +0: a skipped pair adds only +-0)."""
    res, coeffs, bounds, krange = scene
    cfg, size = TRC.default_config(), (res, res)
    fwd = TRC.raster_fwd_plain(coeffs, bounds, krange, size, CS.SIGMA, gamma, cfg)
    rng = np.random.default_rng(1)
    sup = (fwd[0] > 1e-3).float()

    def noise(t):
        return torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32))

    state = (*fwd, noise(fwd[0]) * sup, noise(fwd[1]) * sup[:, None], noise(fwd[0]) * sup)
    args = (coeffs, bounds, krange, *state, size, CS.SIGMA, gamma, cfg)
    full = TRC.raster_bwd_plain(*args)

    skip = TRC.far_segments(coeffs, bounds, krange, size, CS.SIGMA, cfg)
    cells = TRC._chunk_cells

    def kept_cells(*a):
        for cell in cells(*a):
            segs = slice(cell.xs.start // SEG, cell.xs.stop // SEG)
            gone = skip[:, cell.k, cell.ys, segs].repeat_interleave(SEG, dim=-1)
            yield cell._replace(take=cell.take & ~gone)

    monkeypatch.setattr(TRC, "_chunk_cells", kept_cells)
    kept = TRC.raster_bwd_plain(*args)
    assert torch.equal(kept, full)
    assert bool(full.abs().sum() > 0)


def _hand_made(faces_rows, res):
    """Coefficients for (F, 10 + C, 3) face rows at one view: padded to
    whole chunks with inert faces, every chunk's bounds the whole image."""
    f = faces_rows.shape[0]
    fp = -(-f // TRC.FACE_CHUNK) * TRC.FACE_CHUNK
    pad = torch.zeros((fp - f,) + faces_rows.shape[1:], dtype=torch.float32)
    pad[:, 0:3, 2] = -1e4
    coeffs = torch.cat([faces_rows, pad]).reshape(1, fp, -1).contiguous()
    nc = fp // TRC.FACE_CHUNK
    bounds = torch.tensor([[-5.0, res + 5.0, -5.0, res + 5.0]] * nc).reshape(1, nc, 4)
    krange = TRC.chunk_ranges(bounds, TRC.padded_size((res, res))[0])
    return coeffs, bounds, krange


def _near_threshold_faces(scale, n=2000, res=64, seed=0):
    """Faces whose edge 0 is least, in magnitude, at one end of a random
    row segment, with s^2 / sigma^2 there in [80, 160] (around the threshold
    89), and whose rows are scaled by ``scale``: at 1e4 the row constants
    reach ~1e6, where f32 spacing is 0.06. Edge 0 is <= 0 on the segment for
    half of them and >= 0 for the rest; the other edges are far negative
    (no pixel inside) and the along-edge rows put every pixel within its
    edge (overhang 0), so the bound is edge 0's alone."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((n, TR.N_GEOM_ROWS + 2, 3), np.float64)
    for i in range(n):
        y = rng.integers(0, res) + 0.5
        left = rng.random() < 0.5  # the end is the segment's left or right end
        x_end = rng.integers(0, res // SEG) * SEG + (0 if left else SEG - 1) + 0.5
        target = np.sqrt(rng.uniform(80.0, 160.0))
        ang = rng.uniform(-np.pi / 2, np.pi / 2)
        nx, ny = np.cos(ang) * (1 if left else -1), np.sin(ang)
        # s0 = -target at the end, falling along (nx, ny), into the segment.
        row = np.array([-scale * nx, -scale * ny, -target + scale * (nx * x_end + ny * y)])
        rows[i, 0] = row if rng.random() < 0.5 else -row
        rows[i, 1:3, 2] = -1e4
        for e in range(3):
            a = rng.uniform(0, 2 * np.pi)
            t = np.array([np.cos(a), np.sin(a)])
            # u = L / 2 at the end, |du| <= 31 scale on the segment, L = 200 scale.
            rows[i, 3 + e] = scale * np.array([t[0], t[1], 100.0 - t @ [x_end, y]])
            rows[i, 6 + e, 2] = 200.0 * scale
        rows[i, 9:] = rng.standard_normal((3, 3))
    return torch.from_numpy(rows).float()


@pytest.mark.parametrize("form", list(ROW_FORMS))
@pytest.mark.parametrize("scale", [1.0, 1e2, 1e4])
def test_skip_rule_holds_at_the_threshold_with_large_coefficients(scale, form):
    """Every mark is exact, and some marks lie close to the threshold: in
    float64 the least -logit of the marked face on the segment is within
    2 % of 89 (at 1e4 the margin keeps marks further away)."""
    res = 64
    coeffs, bounds, krange = _hand_made(_near_threshold_faces(scale, res=res), res)
    size = (res, res)
    assert _check_far_pairs(coeffs, bounds, krange, size, CS.SIGMA, ROW_FORMS[form]) > 0
    cfg = TRC.default_config()
    far = TRC.far_faces(coeffs, bounds, krange, size, CS.SIGMA, cfg)
    close = 0
    for cell in TRC._chunk_cells(coeffs.double(), bounds, krange, size, cfg):
        segs = slice(cell.xs.start // SEG, cell.xs.stop // SEG)
        marks = far[:, cell.k * 32:(cell.k + 1) * 32, cell.ys, segs]
        logits, _ = _logits(cell, _row_plain, CS.SIGMA)
        least = -logits.reshape(marks.shape + (SEG,)).amax(dim=-1)
        close += int((marks & (least < 89.0 * 1.02)).sum())
    assert close > 0 or scale == 1e4


def test_skip_rule_fails_without_its_row_margin(monkeypatch):
    """The check has teeth: with the rows' margin ``ROW_TOL`` set to 0, the
    rule marks faces at 1e4 whose once-rounded rows give a nonzero
    coverage at the segment's end."""
    res = 64
    coeffs, bounds, krange = _hand_made(_near_threshold_faces(1e4, res=res), res)
    monkeypatch.setattr(TRC, "ROW_TOL", 0.0)
    with pytest.raises(AssertionError, match="has coverage"):
        _check_far_pairs(coeffs, bounds, krange, (res, res), CS.SIGMA, _row_once)


def test_skip_rule_on_a_rim_sliver():
    """A nearly collinear face (|2 x area| 0.016 px^2 over a 55 px edge),
    whose plane rows come from a ~1/det cancellation, among the inert
    padding: the rule marks some of its segments, none wrongly."""
    res = 64
    vp = torch.tensor([[[5.2, 20.1], [60.7, 20.9], [33.0, 20.501]]])
    vz = torch.tensor([[0.4, 0.5, 0.6]])
    faces = torch.tensor([[0, 1, 2]])
    fs, bbox = TRC.sort_faces_by_y(vp, faces)
    planes = TR.face_planes(vp, vz, fs, vp * 0.01)
    det = float(TR.face_det2d(TR.gather_faces(vp, fs))[0, 0].abs())
    assert 1e-6 < det < 0.05 and bool(planes.valid.all())
    coeffs, bounds = TRC.pack_sorted_planes(planes, bbox, CS.SIGMA)
    bounds = torch.tensor([[[-5.0, res + 5.0, -5.0, res + 5.0]]])  # every cell
    krange = TRC.chunk_ranges(bounds, TRC.padded_size((res, res))[0])
    for form in ROW_FORMS.values():
        assert _check_far_pairs(coeffs, bounds, krange, (res, res), CS.SIGMA, form) > 0
    far = TRC.far_faces(coeffs, bounds, krange, (res, res), CS.SIGMA, TRC.default_config())
    hp, wp = TRC.padded_size((res, res))
    assert 0 < int(far[0, 0].sum()) < hp * wp // SEG  # far from some segments, not all
