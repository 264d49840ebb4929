"""K1's skip rule (``raster_cuda.far_faces`` at ``K1_TILE``) is exact.

K1 skips a (face, 8 x 8 tile) pair when a bound from the face's rows at
the tile's corners says that its logits are below -``k1_far_logit(gamma)``
at every pixel and no pixel is inside. The kernel decides on the card;
``far_faces`` computes the same rule op for op. Here, on the CPU, every
pair that the rule marks must add exactly nothing under the body of its
path, at every pixel of the tile, with the rows evaluated as the plain
version evaluates them and rounded once (as fused multiply-adds do): on
the fixed-m path (gamma 1/40) exp(-|logits|) == 0 with logits < 0; on the
streaming path (gamma 1/100) also softplus(-logits) == -logits and
exp(l - l_bg) == 0, l = -softplus(-logits) - zbar / gamma. The plain
forward with the marked pairs left out must equal the full one bit for
bit, and match ``hocon``'s Pallas kernel in interpret mode. Scenes:
``chip_smoke.py``'s hand + sphere with backface culling at 64 and 128 px,
faces with large coefficients placed at the threshold, and a rim sliver.
The check fails without the rows' margin, and without the 1/gamma term of
the streaming threshold.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as CS
import hocon.render.raster_pallas as RP
import hocon_torch.render.raster as TR
import hocon_torch.render.raster_cuda as TRC

torch.set_num_threads(1)

PAIRS = 2
TH, TW = TRC.K1_TILE
SIL_ATOL, ATOL, ATTR_RTOL = 2e-5, 2e-4, 1e-4  # tests/test_torch_raster.py
GAMMAS = {"fixed_m": CS.GAMMAS[0], "streaming": CS.GAMMAS[1]}


def _row_plain(cell, i):
    return cell.row(i)


def _row_once(cell, i):
    """Row i with one rounding to f32, as fma(a0, x, fma(a1, y, a2)) would
    give without its inner rounding."""
    a, f64 = cell.a.double(), torch.float64
    val = a[:, :, i, 0, None, None] * cell.x.to(f64) + (
        a[:, :, i, 1, None, None] * cell.y.to(f64) + a[:, :, i, 2, None, None])
    return val.float()


ROW_FORMS = {"plain rows": _row_plain, "rows rounded once": _row_once}


class _RowsAs:
    """A chunk's cells whose rows come from ``row_fn`` (for ``_face_logits``)."""

    def __init__(self, cell, row_fn):
        self.a, self._cell, self._row_fn = cell.a, cell, row_fn

    def row(self, i):
        return self._row_fn(self._cell, i)


def _pixels(marks):
    """(B, FC, rows / TH, cols / TW) tile marks at every pixel of the tiles."""
    return marks.repeat_interleave(TH, dim=2).repeat_interleave(TW, dim=3)


def _check_far_tiles(coeffs, bounds, krange, size, sigma, gamma, row):
    """Every (face, pixel) pair of a marked (face, tile) adds exactly
    nothing under its path's body. Returns the number of marks checked."""
    cfg = TRC.default_config()
    far = TRC.far_faces(coeffs, bounds, krange, size, sigma, cfg, tile=TRC.K1_TILE,
                        far_logit=TRC.k1_far_logit(gamma))
    fc, n = cfg.face_chunk, 0
    inv_gamma = 1.0 / gamma
    l_bg = torch.tensor(-1.0 / gamma, dtype=torch.float32)
    for cell in TRC._chunk_cells(coeffs, bounds, krange, size, cfg):
        rows = slice(cell.ys.start // TH, cell.ys.stop // TH)
        cols = slice(cell.xs.start // TW, cell.xs.stop // TW)
        marks = far[:, cell.k * fc:(cell.k + 1) * fc, rows, cols]
        if not marks.any():
            continue
        n += int(marks.sum())
        logits = TRC._face_logits(_RowsAs(cell, row), 1.0 / (sigma * sigma))
        assert logits.dtype == torch.float32
        pix = _pixels(marks)
        lg = logits[pix]
        e2 = torch.exp(-lg.abs())
        assert bool((lg < 0).all()), f"chunk {cell.k}: a skipped pixel is inside"
        assert bool((e2 == 0).all()), f"chunk {cell.k}: a skipped pair has coverage"
        if (1.0 / gamma) > TRC.FIXED_M_MAX_INV_GAMMA:  # the streaming body
            sp = torch.clamp(-lg, min=0.0) + torch.log1p(e2)
            assert bool((sp == -lg).all()), f"chunk {cell.k}: log(1 - p) of a skipped pair"
            zbar = torch.clamp(row(cell, 9), 0.0, 1.0)[pix]
            w = torch.exp((-sp - zbar * inv_gamma) - l_bg)
            assert bool((w == 0).all()), f"chunk {cell.k}: a skipped pair has softmax weight"
    return n


@pytest.fixture(scope="module", params=[64, 128])
def scene(request):
    res = request.param
    tgt, ref, faces, k = CS.make_scene(torch, "cpu", pairs=PAIRS, res=res)
    coeffs, bounds, krange = CS.raster_inputs(torch, tgt, ref, faces, k, res)
    return res, coeffs, bounds, krange


@pytest.mark.parametrize("path", list(GAMMAS))
@pytest.mark.parametrize("form", list(ROW_FORMS))
def test_skipped_pairs_add_nothing(scene, form, path):
    res, coeffs, bounds, krange = scene
    n = _check_far_tiles(coeffs, bounds, krange, (res, res), CS.SIGMA, GAMMAS[path],
                         ROW_FORMS[form])
    assert n > 0


class _Skipping:
    """A chunk's cells whose marked (face, pixel) pairs read the edge rows of
    the inert padding face (-1e4: logits ~ -1e8, which adds exactly nothing
    on either path): the plain forward without those pairs."""

    def __init__(self, cell, gone):
        self._cell, self._gone = cell, gone

    def __getattr__(self, name):
        return getattr(self._cell, name)

    def row(self, i):
        val = self._cell.row(i)
        if i >= 3:
            return val
        return torch.where(self._gone, torch.tensor(-1e4, dtype=val.dtype), val)


def _skipped_forward(coeffs, bounds, krange, size, gamma, monkeypatch):
    """``raster_fwd_plain`` with the pairs K1's rule marks left out, and the
    number of (face, pixel) pairs left out."""
    cfg = TRC.default_config()
    far = TRC.far_faces(coeffs, bounds, krange, size, CS.SIGMA, cfg, tile=TRC.K1_TILE,
                        far_logit=TRC.k1_far_logit(gamma))
    cells, fc, gone_pairs = TRC._chunk_cells, cfg.face_chunk, []

    def skipping_cells(*args):
        for cell in cells(*args):
            rows = slice(cell.ys.start // TH, cell.ys.stop // TH)
            cols = slice(cell.xs.start // TW, cell.xs.stop // TW)
            gone = _pixels(far[:, cell.k * fc:(cell.k + 1) * fc, rows, cols])
            gone_pairs.append(int((gone & cell.take[:, None]).sum()))
            yield _Skipping(cell, gone)

    with monkeypatch.context() as patch:
        patch.setattr(TRC, "_chunk_cells", skipping_cells)
        out = TRC.raster_fwd_plain(coeffs, bounds, krange, size, CS.SIGMA, gamma, cfg)
    return out, sum(gone_pairs)


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("path", list(GAMMAS))
def test_plain_forward_without_skipped_pairs_is_unchanged(scene, path, monkeypatch):
    """The skipped plain forward has the bits of the full one (-0 and +0
    told apart), and the rule leaves out a share of the pairs."""
    res, coeffs, bounds, krange = scene
    size, gamma = (res, res), GAMMAS[path]
    full = TRC.raster_fwd_plain(coeffs, bounds, krange, size, CS.SIGMA, gamma,
                                TRC.default_config())
    skipped, n_gone = _skipped_forward(coeffs, bounds, krange, size, gamma, monkeypatch)
    for name, f, s in zip(("sil", "attr", "vis", "mden"), full, skipped):
        assert torch.equal(_bits(s), _bits(f)), name
    assert n_gone > 0.2 * CS.cell_pairs(torch, bounds, krange, res)
    assert float(full[0].max()) > 0.5


@pytest.mark.parametrize("path", list(GAMMAS))
def test_skipped_plain_forward_matches_pallas_kernel(path, monkeypatch):
    """The skipped plain forward against ``hocon``'s ``_raster_kernel`` in
    interpret mode on the same coefficients (hand + sphere at 64 px), at the
    bars of tests/test_torch_raster.py. The pixel-coordinate channels are
    held where the silhouette is non-trivial, as the reference's own
    kernel tests hold its attributes: on an empty pixel next to a rim
    sliver they are a softmax over far faces whose sliver rows every f32
    evaluation rounds its own way (there the plain version lands up to
    ~1.2e-3 px from a float64 evaluation of the same coefficients, and the
    reference's kernel elsewhere). The warp masks those pixels out."""
    res, gamma = 64, GAMMAS[path]
    tgt, ref, faces, k = CS.make_scene(torch, "cpu", pairs=PAIRS, res=res)
    coeffs, bounds, krange = CS.raster_inputs(torch, tgt, ref, faces, k, res)
    got, _ = _skipped_forward(coeffs, bounds, krange, (res, res), gamma, monkeypatch)
    want = RP._forward_padded(jnp.asarray(coeffs.numpy()), jnp.asarray(bounds.numpy()),
                              (res, res), CS.SIGMA, gamma, 3, RP.default_config())
    covered = got[0].numpy() > 1e-3
    assert covered.mean() > 0.05
    for name, g, w in zip(("sil", "attr", "vis", "mden"), got, want):
        g, w = g.numpy(), np.asarray(w)
        if name == "mden":  # m and log(den) carry zbar / gamma
            np.testing.assert_allclose(g[:, 0], w[:, 0], atol=ATOL / gamma, rtol=0, err_msg="m")
            np.testing.assert_allclose(g[:, 1], w[:, 1], rtol=ATOL / gamma, atol=0, err_msg="den")
        elif name == "attr":
            np.testing.assert_allclose(g[:, -1], w[:, -1], atol=ATOL, err_msg="depth")
            for c in range(g.shape[1] - 1):
                np.testing.assert_allclose(g[:, c][covered], w[:, c][covered], atol=ATOL,
                                           rtol=ATTR_RTOL, err_msg=f"coordinate {c}")
        else:
            np.testing.assert_allclose(g, w, atol=SIL_ATOL if name == "sil" else ATOL,
                                       err_msg=name)


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


def _near_threshold_faces(scale, threshold, n=2000, res=64, seed=0):
    """Faces whose edge 0 is least, in magnitude, at one corner of a random
    K1 tile, with s^2 / sigma^2 there in [threshold - 30, threshold + 50],
    and whose rows are scaled by ``scale``: at 1e4 the row constants reach
    ~1e6, where f32 spacing is 0.06. Edge 0 is <= 0 on the tile for half of
    them and >= 0 for the rest; the other edges are far negative (no pixel
    inside) and the along-edge rows put every pixel within its edge
    (overhang 0), so the bound is edge 0's alone."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((n, TR.N_GEOM_ROWS + 2, 3), np.float64)
    for i in range(n):
        right, down = rng.random() < 0.5, rng.random() < 0.5  # which corner
        x_c = rng.integers(0, res // TW) * TW + (TW - 1 if right else 0) + 0.5
        y_c = rng.integers(0, res // TH) * TH + (TH - 1 if down else 0) + 0.5
        target = np.sqrt(rng.uniform(threshold - 30.0, threshold + 50.0))
        ang = rng.uniform(0.0, np.pi / 2)
        # (nx, ny) points from the corner into the tile: s0 falls along it.
        nx, ny = np.cos(ang) * (-1 if right else 1), np.sin(ang) * (-1 if down else 1)
        row = np.array([-scale * nx, -scale * ny, -target + scale * (nx * x_c + ny * y_c)])
        rows[i, 0] = row if rng.random() < 0.5 else -row
        rows[i, 1:3, 2] = -1e4
        for e in range(3):
            a = rng.uniform(0, 2 * np.pi)
            t = np.array([np.cos(a), np.sin(a)])
            # u = L / 2 at the corner, |du| <= 10 scale on the tile, L = 200 scale.
            rows[i, 3 + e] = scale * np.array([t[0], t[1], 100.0 - t @ [x_c, y_c]])
            rows[i, 6 + e, 2] = 200.0 * scale
        rows[i, 9:] = rng.standard_normal((3, 3))
    return torch.from_numpy(rows).float()


@pytest.mark.parametrize("path", list(GAMMAS))
@pytest.mark.parametrize("form", list(ROW_FORMS))
@pytest.mark.parametrize("scale", [1.0, 1e2, 1e4])
def test_skip_rule_holds_at_the_threshold_with_large_coefficients(scale, form, path):
    """Every mark is exact, and some marks lie close to the threshold: in
    float64 the least -logit of the marked face on the tile is within 2 %
    of it (at 1e4 the margin keeps marks further away)."""
    res, gamma = 64, GAMMAS[path]
    threshold = TRC.k1_far_logit(gamma)
    coeffs, bounds, krange = _hand_made(_near_threshold_faces(scale, threshold, res=res), res)
    size = (res, res)
    assert _check_far_tiles(coeffs, bounds, krange, size, CS.SIGMA, gamma, ROW_FORMS[form]) > 0
    cfg = TRC.default_config()
    far = TRC.far_faces(coeffs, bounds, krange, size, CS.SIGMA, cfg, tile=TRC.K1_TILE,
                        far_logit=threshold)
    close = 0
    for cell in TRC._chunk_cells(coeffs.double(), bounds, krange, size, cfg):
        marks = far[:, cell.k * 32:(cell.k + 1) * 32]
        logits = TRC._face_logits(cell, 1.0 / CS.SIGMA**2)
        b, fc, h, w = logits.shape
        tiles = logits.reshape(b, fc, h // TH, TH, w // TW, TW)
        least = -tiles.amax(dim=(3, 5))
        close += int((marks & (least < threshold * 1.02)).sum())
    assert close > 0 or scale == 1e4


def test_skip_rule_fails_without_its_row_margin(monkeypatch):
    """The check has teeth: with the rows' margin ``ROW_TOL`` set to 0, the
    rule marks faces at 1e5 whose once-rounded rows give a nonzero
    coverage at the tile's corner."""
    res, gamma = 64, GAMMAS["fixed_m"]
    faces = _near_threshold_faces(1e5, TRC.k1_far_logit(gamma), res=res)
    coeffs, bounds, krange = _hand_made(faces, res)
    monkeypatch.setattr(TRC, "ROW_TOL", 0.0)
    with pytest.raises(AssertionError, match="has coverage"):
        _check_far_tiles(coeffs, bounds, krange, (res, res), CS.SIGMA, gamma, _row_once)


def test_streaming_threshold_needs_its_inverse_gamma_term(scene, monkeypatch):
    """The check has teeth: with the streaming path's threshold cut to the
    fixed-m path's 110, marked faces of the hand + sphere keep a softmax
    weight against the background."""
    res, coeffs, bounds, krange = scene
    monkeypatch.setattr(TRC, "k1_far_logit", lambda gamma: TRC.K1_FAR_LOGIT)
    with pytest.raises(AssertionError, match="has softmax weight"):
        _check_far_tiles(coeffs, bounds, krange, (res, res), CS.SIGMA, GAMMAS["streaming"],
                         _row_plain)


def test_skip_rule_on_a_rim_sliver():
    """A nearly collinear face (|2 x area| 0.016 px^2 over a 55 px edge),
    whose plane rows come from a ~1/det cancellation, among the inert
    padding: the rule marks some of its tiles, none wrongly."""
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
    for gamma in GAMMAS.values():
        for form in ROW_FORMS.values():
            assert _check_far_tiles(coeffs, bounds, krange, (res, res), CS.SIGMA, gamma, form) > 0
        far = TRC.far_faces(coeffs, bounds, krange, (res, res), CS.SIGMA, TRC.default_config(),
                            tile=TRC.K1_TILE, far_logit=TRC.k1_far_logit(gamma))
        hp, wp = TRC.padded_size((res, res))
        assert 0 < int(far[0, 0].sum()) < (hp // TH) * (wp // TW)  # some tiles, not all


def test_far_from_a_tile_is_far_from_each_of_its_rows():
    """The rectangle bound is conservative against its own rows: a face the
    rule marks for an 8 x 8 tile it also marks for each 1 x 8 row of that
    tile (K2's form of the rule, one row at a time), and it marks more
    rows than tiles; at an infinite threshold it marks nothing."""
    res = 64
    tgt, ref, faces, k = CS.make_scene(torch, "cpu", pairs=1, res=res)
    coeffs, bounds, krange = CS.raster_inputs(torch, tgt, ref, faces, k, res)
    cfg, size = TRC.default_config(), (res, res)
    logit = TRC.k1_far_logit(GAMMAS["fixed_m"])
    tiles = TRC.far_faces(coeffs, bounds, krange, size, CS.SIGMA, cfg, tile=TRC.K1_TILE,
                          far_logit=logit)
    rows = TRC.far_faces(coeffs, bounds, krange, size, CS.SIGMA, cfg, tile=(1, TW),
                         far_logit=logit)
    assert bool(tiles.any())
    assert not bool((tiles.repeat_interleave(TH, dim=2) & ~rows).any())
    assert int(rows.sum()) > TH * int(tiles.sum())
    none = TRC.far_faces(coeffs, bounds, krange, size, CS.SIGMA, cfg, tile=TRC.K1_TILE,
                         far_logit=float("inf"))
    assert not bool(none.any())
