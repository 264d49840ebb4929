"""``hocon_torch.data.images.read_image`` vs ``cv2.imread`` (IMREAD_COLOR, BGR -> RGB).

PNG, decoded on the host by zlib and numpy: every row filter (written by
``encode_png``, which forces one filter per row) for 8-bit grey, grey +
alpha, RGB and RGBA, and cv2's own PNGs at several compression levels, all
bit for bit cv2's; interlaced, 16-bit and palette PNGs raise. JPEG on the
CPU (PIL): bit for bit the committed cv2 decodes of ``tests/data/jpeg/``
(``tools/make_jpeg_fixtures.py``). The format follows the file's first
bytes, not its name. A CUDA request without CUDA raises and never reaches
PIL; nvJPEG itself runs on the card only (``chip_smoke.py``). The plain
version of the card's colour stage (``ycc_to_rgb_plain``: libjpeg-turbo's
chroma upsampling and YCbCr -> RGB) gives cv2's bits from libjpeg's own
full-resolution planes, and its upsampling equals a line-by-line copy of
libjpeg's ``h2v2_fancy_upsample`` / ``h2v1_fancy_upsample`` loops.
"""

import os
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest
import torch

from hocon_torch.data import images as I

torch.set_num_threads(1)

JPEG_DIR = os.path.join(os.path.dirname(__file__), "data", "jpeg")
JPEG_FIXTURES = ("odd_420", "odd_444")


def _cv2_read(path):
    return cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


def _image(rng, h, w, ch):
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx[..., None] * 3 + yy[..., None] * 5 + np.arange(ch) * 40) % 256
    noise = rng.integers(-30, 31, (h, w, ch))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


_FILTERS = {"none": 0, "sub": 1, "up": 2, "average": 3, "paeth": 4, "mixed": None}
_KINDS = {"grey": 1, "grey_alpha": 2, "rgb": 3, "rgba": 4}


@pytest.mark.parametrize("kind", list(_KINDS))
@pytest.mark.parametrize("filt", list(_FILTERS))
def test_png_every_filter_and_kind_is_cv2s(kind, filt, tmp_path):
    ch = _KINDS[kind]
    px = _image(np.random.default_rng(ch), 37, 53, ch)
    data = I.encode_png(px, _FILTERS[filt])
    # The encoder really wrote the filter types asked for.
    inflated = zlib.decompress(data[data.index(b"IDAT") + 4:])
    types = np.frombuffer(inflated, np.uint8).reshape(37, -1)[:, 0]
    want_types = np.arange(37) % 5 if _FILTERS[filt] is None else np.full(37, _FILTERS[filt])
    np.testing.assert_array_equal(types, want_types)
    path = tmp_path / "f.png"
    path.write_bytes(data)
    got = I.read_image(str(path), "cpu")
    np.testing.assert_array_equal(got, _cv2_read(str(path)))
    np.testing.assert_array_equal(got, np.repeat(px[..., :1], 3, 2) if ch <= 2 else px[..., :3])
    assert got.dtype == np.uint8 and got.flags.c_contiguous


@pytest.mark.parametrize("level", [0, 1, 3, 6, 9])
@pytest.mark.parametrize("size", [(480, 640), (17, 1), (1, 29), (251, 333)])
def test_cv2_pngs_decode_bit_for_bit(level, size, tmp_path):
    """cv2 (libpng) chooses the row filters itself (adaptively)."""
    rgb = _image(np.random.default_rng(level), *size, 3)
    path = str(tmp_path / "cv.png")
    assert cv2.imwrite(path, rgb[..., ::-1], [cv2.IMWRITE_PNG_COMPRESSION, level])
    np.testing.assert_array_equal(I.read_image(path, "cpu"), _cv2_read(path))


def _with_ihdr(data: bytes, depth=None, ctype=None, interlace=None) -> bytes:
    """PNG bytes with IHDR fields replaced (CRC recomputed)."""
    start = data.index(b"IHDR")
    w, h, d, c, comp, filt, lace = struct.unpack(">IIBBBBB", data[start + 4:start + 17])
    body = struct.pack(">IIBBBBB", w, h, d if depth is None else depth,
                       c if ctype is None else ctype, comp, filt,
                       lace if interlace is None else interlace)
    crc = struct.pack(">I", zlib.crc32(b"IHDR" + body))
    return data[:start + 4] + body + crc + data[start + 21:]


def _png16(tmp_path):
    path = str(tmp_path / "deep.png")
    cv2.imwrite(path, np.full((4, 5, 3), 40000, np.uint16))
    return open(path, "rb").read()


_UNSUPPORTED = {
    "interlaced": (lambda t: _with_ihdr(I.encode_png(np.zeros((4, 5, 3), np.uint8)),
                                        interlace=1), "interlaced"),
    "16_bit": (_png16, "bit depth 16"),
    "palette": (lambda t: _with_ihdr(I.encode_png(np.zeros((4, 5), np.uint8)), ctype=3),
                "palette"),
    "bad_crc": (lambda t: I.encode_png(np.zeros((4, 5, 3), np.uint8))[:-5] + b"\0IEND",
                "CRC"),
    "bad_filter": (lambda t: _refilter(I.encode_png(np.zeros((4, 5, 3), np.uint8)), 7),
                   "filter type 7"),
}


def _refilter(data: bytes, ftype: int) -> bytes:
    """PNG bytes whose first row's filter byte is ``ftype``."""
    start = data.index(b"IDAT")
    (length,) = struct.unpack(">I", data[start - 4:start])
    scan = bytearray(zlib.decompress(data[start + 4:start + 4 + length]))
    scan[0] = ftype
    body = zlib.compress(bytes(scan))
    chunk = (struct.pack(">I", len(body)) + b"IDAT" + body
             + struct.pack(">I", zlib.crc32(b"IDAT" + body)))
    return data[:start - 4] + chunk + data[start + 8 + length:]


@pytest.mark.parametrize("case", list(_UNSUPPORTED))
def test_unsupported_pngs_raise(case, tmp_path):
    make, match = _UNSUPPORTED[case]
    path = tmp_path / "bad.png"
    path.write_bytes(make(tmp_path))
    with pytest.raises(ValueError, match=match):
        I.read_image(str(path), "cpu")


@pytest.mark.parametrize("name", JPEG_FIXTURES)
def test_cpu_jpeg_is_the_committed_cv2_decode(name):
    path = os.path.join(JPEG_DIR, f"{name}.jpeg")
    want = np.load(os.path.join(JPEG_DIR, f"{name}.npy"))
    got = I.read_image(path, "cpu")
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, _cv2_read(path))  # the fixture is cv2's decode


def test_format_follows_the_first_bytes_not_the_name(tmp_path):
    jpeg = open(os.path.join(JPEG_DIR, "odd_420.jpeg"), "rb").read()
    px = _image(np.random.default_rng(0), 9, 7, 3)
    (tmp_path / "frame.png").write_bytes(jpeg)
    (tmp_path / "frame.jpeg").write_bytes(I.encode_png(px))
    (tmp_path / "frame.bmp").write_bytes(b"BM" + bytes(60))
    np.testing.assert_array_equal(I.read_image(str(tmp_path / "frame.png"), "cpu"),
                                  np.load(os.path.join(JPEG_DIR, "odd_420.npy")))
    np.testing.assert_array_equal(I.read_image(str(tmp_path / "frame.jpeg"), "cpu"), px)
    with pytest.raises(ValueError, match="neither PNG nor JPEG"):
        I.read_image(str(tmp_path / "frame.bmp"), "cpu")


def test_cuda_request_without_cuda_raises_and_skips_pil(monkeypatch):
    """No fallback: a CUDA request (explicit, or the default None) raises
    before any decoder runs, and PIL is never asked."""
    import PIL.Image

    def boom(*a, **k):
        raise AssertionError("PIL reached on a CUDA request")

    monkeypatch.setattr(PIL.Image, "open", boom)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = os.path.join(JPEG_DIR, "odd_444.jpeg")
    for device in ("cuda", "cuda:0", None):
        with pytest.raises(RuntimeError, match="CUDA"):
            I.read_image(path, device)
    with pytest.raises(ValueError, match="CUDA device"):
        I.decode_jpeg_cuda(b"\xff\xd8\xff", "cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        I.encode_jpeg(torch.zeros((4, 4, 3), dtype=torch.uint8))
    assert I.ycc_to_rgb_cuda.launches == 0


def test_cpu_jpeg_without_pil_raises_import_error(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        I.read_image(os.path.join(JPEG_DIR, "odd_420.jpeg"), "cpu")


def test_hand_dataset_reads_frames_on_its_decode_device(tmp_path):
    """``_load_image``: an in-memory frame as it is, else ``image_path`` read
    on the config's decode device."""
    from hocon_torch.data.hand_dataset import _load_image

    px = _image(np.random.default_rng(3), 6, 8, 3)
    path = tmp_path / "f.png"
    path.write_bytes(I.encode_png(px))
    np.testing.assert_array_equal(_load_image({"image_path": str(path)}, "cpu"), px)
    assert _load_image({"image": px, "image_path": "missing"}, "cpu") is px
    with pytest.raises(FileNotFoundError):
        _load_image({"image_path": str(tmp_path / "missing.png")}, "cpu")


@pytest.mark.parametrize("name", JPEG_FIXTURES)
def test_ycc_to_rgb_plain_is_libjpegs_colour_conversion(name):
    """libjpeg-turbo's own planes, upsampled by it (PIL's YCbCr draft mode):
    the plain colour stage gives cv2's decode bit for bit."""
    from PIL import Image

    with Image.open(os.path.join(JPEG_DIR, f"{name}.jpeg")) as im:
        im.draft("YCbCr", im.size)
        assert im.mode == "YCbCr"
        ycc = torch.from_numpy(np.asarray(im).copy())
    got = I.ycc_to_rgb_plain(ycc[..., 0].contiguous(), ycc[..., 1].contiguous(),
                             ycc[..., 2].contiguous(), 1, 1)
    np.testing.assert_array_equal(got.numpy(), np.load(os.path.join(JPEG_DIR, f"{name}.npy")))


def _libjpeg_h2v2(plane):
    """jdsample.c h2v2_fancy_upsample, loop by loop; the rows above the
    first and below the last are copies of them (jdmainct.c context rows)."""
    ch, cw = plane.shape
    rows = [plane[0]] + list(plane) + [plane[-1]]
    out = np.zeros((2 * ch, 2 * cw), np.int64)
    for inrow in range(ch):
        for v in range(2):
            in0 = rows[inrow + 1].astype(np.int64)
            in1 = (rows[inrow] if v == 0 else rows[inrow + 2]).astype(np.int64)
            o = out[2 * inrow + v]
            this, nxt = in0[0] * 3 + in1[0], in0[1] * 3 + in1[1]
            o[0], o[1] = (this * 4 + 8) >> 4, (this * 3 + nxt + 7) >> 4
            last, this = this, nxt
            for c in range(1, cw - 1):
                nxt = in0[c + 1] * 3 + in1[c + 1]
                o[2 * c], o[2 * c + 1] = (this * 3 + last + 8) >> 4, (this * 3 + nxt + 7) >> 4
                last, this = this, nxt
            o[2 * cw - 2], o[2 * cw - 1] = (this * 3 + last + 8) >> 4, (this * 4 + 7) >> 4
    return out


def _libjpeg_h2v1(plane):
    """jdsample.c h2v1_fancy_upsample, loop by loop."""
    ch, cw = plane.shape
    out = np.zeros((ch, 2 * cw), np.int64)
    for r in range(ch):
        p, o = plane[r].astype(np.int64), out[r]
        o[0], o[1] = p[0], (p[0] * 3 + p[1] + 2) >> 2
        for c in range(1, cw - 1):
            o[2 * c], o[2 * c + 1] = (p[c] * 3 + p[c - 1] + 1) >> 2, (p[c] * 3 + p[c + 1] + 2) >> 2
        o[2 * cw - 2], o[2 * cw - 1] = (p[cw - 1] * 3 + p[cw - 2] + 1) >> 2, p[cw - 1]
    return out


def _libjpeg_rgb(y, cb, cr):
    """jdcolor.c ycc_rgb_convert with its tables."""
    y, cb, cr = (a.astype(np.int64) for a in (y, cb, cr))
    fix = lambda x: int(x * 65536 + 0.5)  # noqa: E731
    r = y + ((fix(1.402) * (cr - 128) + 32768) >> 16)
    g = y + ((-fix(0.34414) * (cb - 128) + 32768 - fix(0.71414) * (cr - 128)) >> 16)
    b = y + ((fix(1.772) * (cb - 128) + 32768) >> 16)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


_SUBSAMPLED = {
    # name: (H, W, hs, vs)
    "420_odd": (25, 37, 2, 2),
    "420_even": (16, 24, 2, 2),
    "422_odd": (13, 31, 2, 1),
    "420_one_row": (2, 11, 2, 2),
}


@pytest.mark.parametrize("case", list(_SUBSAMPLED))
def test_ycc_upsampling_is_libjpegs_loops(case):
    h, w, hs, vs = _SUBSAMPLED[case]
    rng = np.random.default_rng(h * w)
    y = rng.integers(0, 256, (h, w), np.uint8)
    ch, cw = -(-h // vs), -(-w // hs)
    cb, cr = (rng.integers(0, 256, (ch, cw), np.uint8) for _ in range(2))
    up = _libjpeg_h2v2 if vs == 2 else _libjpeg_h2v1
    want = _libjpeg_rgb(y, up(cb)[:h, :w], up(cr)[:h, :w])
    got = I.ycc_to_rgb_plain(*(torch.from_numpy(a) for a in (y, cb, cr)), hs, vs)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="not a CUDA device"):  # the kernel: CUDA planes only
        I.ycc_to_rgb_cuda(*(torch.from_numpy(a) for a in (y, cb, cr)), hs, vs)
    assert I.ycc_to_rgb_cuda.launches == 0


def test_ycc_grey_and_narrow_planes_replicate():
    """Grey: three equal channels. Chroma planes of 2 columns or fewer are
    replicated, not filtered (libjpeg's h2v2_upsample)."""
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.integers(0, 256, (5, 4), np.uint8))
    np.testing.assert_array_equal(I.ycc_to_rgb_plain(y, None, None).numpy(),
                                  np.repeat(y.numpy()[..., None], 3, 2))
    cb, cr = (rng.integers(0, 256, (3, 2), np.uint8) for _ in range(2))
    box = lambda p: np.repeat(np.repeat(p, 2, 0), 2, 1)[:5, :4]  # noqa: E731
    got = I.ycc_to_rgb_plain(y, torch.from_numpy(cb), torch.from_numpy(cr), 2, 2)
    np.testing.assert_array_equal(got.numpy(), _libjpeg_rgb(y.numpy(), box(cb), box(cr)))


def test_jpeg_library_links_nvjpeg_and_is_keyed_by_it(monkeypatch):
    """``csrc/jpeg.cu`` builds with the sources, linked with -lnvjpeg, and its
    link flags are part of its library's name: another flag, another build."""
    from hocon_torch.utils import cuda_build

    assert "jpeg" in cuda_build.SOURCES and "jpeg" not in cuda_build.KERNELS
    assert cuda_build.LINK_FLAGS["jpeg"] == ("-lnvjpeg",)
    flags = cuda_build._link_flags("jpeg", "toolkit/bin/nvcc")
    assert flags[0] == "-lnvjpeg" and flags[-1].startswith("-rpath,")
    assert cuda_build._link_flags("raster_fwd", "toolkit/bin/nvcc") == []
    before = cuda_build.lib_path("jpeg")
    monkeypatch.setitem(cuda_build.LINK_FLAGS, "jpeg", ("-lnvjpeg_static",))
    assert cuda_build.lib_path("jpeg") != before
    assert cuda_build.lib_path("jpeg").name.startswith("jpeg-")
