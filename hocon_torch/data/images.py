"""Frames read from disk without cv2: PNG on the host, JPEG through nvJPEG.

The reference reads a frame with ``cv2.cvtColor(cv2.imread(path,
cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)`` (``hocon/data/hand_dataset.py:
_load_image``). ``read_image`` returns the same uint8 (H, W, 3) RGB array
and, as cv2 does, chooses the format by the file's first bytes, not by its
name:

- PNG (HO-3D's ``rgb/*.png``), on any device, on the host: the chunks are
  parsed, the IDAT data inflated with ``zlib`` and the five row filters
  undone in numpy. 8-bit grey, grey + alpha, RGB and RGBA, non-interlaced,
  give cv2's bits: grey becomes three equal channels and alpha is dropped,
  as ``IMREAD_COLOR`` does. Other kinds (interlaced, 16-bit, palette, grey
  below 8 bits) raise ``ValueError``.
- JPEG (FPHAB's ``color_XXXX.jpeg``): for a CUDA device, nvJPEG decodes to
  the Y, Cb and Cr planes on the card, the ``jpeg_ycc_rgb`` kernel
  (``csrc/jpeg.cu``) upsamples and converts them as libjpeg-turbo does, and
  the frame is copied to the host. nvJPEG's inverse DCT is not
  libjpeg-turbo's, so its values differ from cv2's by a few levels
  (``chip_smoke.py`` holds them to a stated bar). For the CPU, PIL decodes (bit for bit cv2's on the repo's
  fixtures, ``tests/test_torch_images.py``); without PIL it raises
  ``ImportError``. A CUDA request never goes through PIL, and a failed
  nvJPEG call raises with its status code.

Not reproduced: cv2 turns a JPEG by its EXIF orientation tag; the datasets'
frames carry none.

``encode_png`` writes the PNGs the tests and ``chip_smoke.py`` decode, with
a chosen filter on every row; ``encode_jpeg`` encodes on the card with
nvJPEG (fixture frames in ``chip_smoke.py`` and ``tools/``).
"""

from __future__ import annotations

import ctypes
import functools
import io
import struct
import threading
import zlib

import numpy as np
import torch

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SOI = b"\xff\xd8\xff"
# PNG colour type -> bytes per pixel at 8 bits (3, palette, is refused).
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_PNG_KIND = {0: "grey", 2: "RGB", 3: "palette", 4: "grey + alpha", 6: "RGBA"}


def read_image(path: str, device: str | torch.device | None = None) -> np.ndarray:
    """The frame at ``path`` as uint8 (H, W, 3) RGB, as cv2 reads it.

    ``device`` is where a JPEG is decoded (None = CUDA, as the port's entry
    points; a CUDA device without CUDA raises). PNG decodes on the host.
    """
    from hocon_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"read_image on {dev}: CUDA is not available")
    with open(path, "rb") as fh:
        data = fh.read()
    if data.startswith(PNG_SIGNATURE):
        return decode_png(data)
    if data.startswith(JPEG_SOI):
        if dev.type == "cuda":
            with torch.cuda.stream(_context(dev).stream):  # see _Context
                return decode_jpeg_cuda(data, dev).cpu().numpy()
        if dev.type == "cpu":
            return decode_jpeg_cpu(data)
        raise ValueError(f"read_image: no JPEG decoder for device {dev}")
    raise ValueError(f"{path}: neither PNG nor JPEG (first bytes {data[:8]!r})")


# ---------------------------------------------------------------------- PNG


def _png_chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: truncated or bad CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG: no IEND chunk")


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 (H, W, 3) RGB, bit for bit ``cv2.imread``'s
    ``IMREAD_COLOR`` after ``BGR2RGB``."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG (signature)")
    header, idat = None, []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, ctype, compression, filtering, interlace = header
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"PNG colour type {ctype} ({_PNG_KIND.get(ctype, 'unknown')}) "
                         "is not supported: grey, grey + alpha, RGB or RGBA only")
    if depth != 8:
        raise ValueError(f"PNG bit depth {depth} is not supported: 8 bits only")
    if interlace:
        raise ValueError("interlaced (Adam7) PNG is not supported")
    if compression or filtering:
        raise ValueError(f"PNG compression {compression} / filter method {filtering}: "
                         "the standard has 0 only")
    bpp = _PNG_CHANNELS[ctype]
    scan = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if scan.size != h * (1 + w * bpp):
        raise ValueError(f"PNG: {scan.size} bytes of image data, want {h * (1 + w * bpp)}")
    px = _unfilter(scan.reshape(h, 1 + w * bpp), h, w, bpp)
    if bpp <= 2:  # grey (+ alpha): three equal channels
        return np.repeat(px[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(px[:, :, :3])


def _unfilter(scan: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters: (h, 1 + w * bpp) filtered -> (h, w, bpp).

    None, Sub (a prefix sum mod 256) and Up (one vector add) depend on the
    row above and the row itself only, so they run row by row. Average and
    Paeth depend on the reconstructed left neighbour: the rows from the
    first to the last of them are walked by anti-diagonals (``_unfilter_band``).
    """
    ftype = scan[:, 0]
    if h and int(ftype.max()) > 4:
        raise ValueError(f"PNG row filter type {int(ftype.max())}: the standard has 0-4")
    raw = scan[:, 1:].reshape(h, w, bpp)
    out = np.empty((h, w, bpp), np.uint8)
    prev = np.zeros((w, bpp), np.uint8)
    left_dep = np.nonzero(ftype >= 3)[0]
    first, last = (int(left_dep[0]), int(left_dep[-1]) + 1) if len(left_dep) else (h, h)
    for r in range(first):
        prev = out[r] = _unfilter_row(raw[r], int(ftype[r]), prev)
    if first < last:
        out[first:last] = _unfilter_band(raw[first:last], ftype[first:last], prev)
        prev = out[last - 1]
    for r in range(last, h):
        prev = out[r] = _unfilter_row(raw[r], int(ftype[r]), prev)
    return out


def _unfilter_row(raw: np.ndarray, ftype: int, prev: np.ndarray) -> np.ndarray:
    if ftype == 0:
        return raw
    if ftype == 1:  # uint8 sums wrap mod 256
        return np.cumsum(raw, axis=0, dtype=np.uint8)
    return raw + prev  # Up


def _unfilter_band(raw: np.ndarray, ftype: np.ndarray, prev: np.ndarray) -> np.ndarray:
    """Rows of any filter type, ``prev`` the reconstructed row above them.

    Pixel (r, c) depends on (r, c-1), (r-1, c) and (r-1, c-1), so every
    pixel of one anti-diagonal r + c = const depends only on the two
    diagonals before it. The band is stored skewed, pixel (r, c) at
    ``t[c + r + 2, r + 1]`` (row 0 is ``prev``, and the slots of column -1
    stay 0), so each diagonal is one contiguous slice of ``t``.
    """
    n, w, bpp = raw.shape
    rr, cc = np.meshgrid(np.arange(n), np.arange(w), indexing="ij")
    t = np.zeros((n + w + 1, n + 1, bpp), np.int16)
    t[np.arange(w) + 1, 0] = prev
    x = np.zeros_like(t)
    x[cc + rr + 2, rr + 1] = raw
    f = ftype.astype(np.int16)[:, None]
    mixed = bool((ftype < 3).any())
    for d in range(2, n + w + 1):
        r0, r1 = max(0, d - w - 1), min(n - 1, d - 2)
        fr = f[r0:r1 + 1]
        a = t[d - 1, r0 + 1:r1 + 2]  # left
        b = t[d - 1, r0:r1 + 1]  # up
        c = t[d - 2, r0:r1 + 1]  # up-left
        pred = np.where(fr == 4, _paeth(a, b, c), (a + b) >> 1)
        if mixed:
            pred = np.where(fr == 1, a, np.where(fr == 2, b, np.where(fr == 0, 0, pred)))
        t[d, r0 + 1:r1 + 2] = (x[d, r0 + 1:r1 + 2] + pred) & 255
    return t[cc + rr + 2, rr + 1].astype(np.uint8)


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def encode_png(pixels: np.ndarray, filters=None) -> bytes:
    """uint8 (H, W) grey or (H, W, C) with C = 1 (grey), 2 (grey + alpha),
    3 (RGB) or 4 (RGBA) -> PNG bytes, non-interlaced.

    ``filters``: the filter type of every row (a sequence of H values in
    0-4), one type for all rows, or None for the types 0-4 in turn.
    """
    px = np.asarray(pixels, np.uint8)
    if px.ndim == 2:
        px = px[:, :, None]
    h, w, ch = px.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    if filters is None:
        filters = np.arange(h) % 5
    ftype = np.broadcast_to(np.asarray(filters, np.int64), (h,))
    x = px.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    preds = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, _paeth(a, b, c)])
    pred = np.take_along_axis(preds, ftype[None, :, None, None], axis=0)[0]
    rows = ((x - pred) & 255).astype(np.uint8).reshape(h, w * ch)
    scan = np.concatenate([ftype.astype(np.uint8)[:, None], rows], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(scan.tobytes()))
            + chunk(b"IEND", b""))


# --------------------------------------------------------------------- JPEG


def decode_jpeg_cpu(data: bytes) -> np.ndarray:
    """JPEG bytes -> uint8 (H, W, 3) RGB through PIL (the CPU path)."""
    try:
        from PIL import Image
    except ImportError as err:
        raise ImportError("decoding JPEG on the CPU needs PIL; on a CUDA device "
                          "read_image decodes with nvJPEG") from err
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


@functools.cache
def _jpeg_lib() -> ctypes.CDLL:
    from hocon_torch.utils import cuda_build

    lib = cuda_build.load("jpeg")
    vp, size, i32 = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int
    pint = ctypes.POINTER(i32)
    lib.hocon_jpeg_open.argtypes = [ctypes.POINTER(vp)]
    lib.hocon_jpeg_close.argtypes = [vp]
    lib.hocon_jpeg_info.argtypes = [vp, ctypes.c_char_p, size, pint, pint, pint, pint]
    lib.hocon_jpeg_decode_planes.argtypes = [vp, ctypes.c_char_p, size, vp, i32, vp, vp, i32, vp]
    lib.hocon_jpeg_ycc_rgb.argtypes = [vp, i32, vp, vp, i32, i32, i32, i32, i32, vp, i32, i32, vp]
    lib.hocon_jpeg_encode.argtypes = [vp, vp, i32, i32, i32, i32, ctypes.POINTER(size), vp]
    lib.hocon_jpeg_bitstream.argtypes = [vp, ctypes.c_char_p, ctypes.POINTER(size), vp]
    return lib


def _check(status: int, what: str) -> None:
    if status:
        kind = f"CUDA error {status - 1000}" if status >= 1000 else f"nvjpegStatus_t {status}"
        raise RuntimeError(f"{what} failed: {kind}")


class _Context:
    """An nvJPEG handle and decoder state (``csrc/jpeg.cu``), one per thread:
    a decoder state serves one thread at a time. Closed with its thread.

    ``stream`` is the thread's own non-blocking stream: ``read_image``
    decodes and copies to the host on it, so that a decode in
    ``BatchLoader``'s prefetch thread does not queue behind the train step's
    kernels on the default stream."""

    def __init__(self, device: torch.device):
        self.lib = _jpeg_lib()
        self.ptr = ctypes.c_void_p()
        with torch.cuda.device(device):
            _check(self.lib.hocon_jpeg_open(ctypes.byref(self.ptr)), "nvjpegCreateSimple")
            self.stream = torch.cuda.Stream(device)

    def __del__(self):
        if self.ptr:
            self.lib.hocon_jpeg_close(self.ptr)


_local = threading.local()


def _context(device: torch.device) -> _Context:
    key = device.index if device.index is not None else torch.cuda.current_device()
    contexts = _local.__dict__.setdefault("contexts", {})
    if key not in contexts:
        contexts[key] = _Context(torch.device("cuda", key))
    return contexts[key]


def ycc_to_rgb_plain(y: torch.Tensor, cb: torch.Tensor | None, cr: torch.Tensor | None,
                     hs: int = 1, vs: int = 1) -> torch.Tensor:
    """Decoded JPEG planes -> uint8 (H, W, 3) RGB, as libjpeg-turbo (cv2)
    makes them: Y (H, W); Cb and Cr (ceil(H / vs), ceil(W / hs)), or None for
    a grey JPEG. Chroma is upsampled with libjpeg's "fancy" triangle filter
    (``jdsample.c``: 3/4 of the nearer sample and 1/4 of the farther in each
    subsampled direction, its rounding constants, neighbours clamped to the
    plane; planes of 2 columns or fewer replicated) and converted in its
    16-bit fixed point (``jdcolor.c``). The plain version of the
    ``jpeg_ycc_rgb`` kernel (``csrc/jpeg.cu``)."""
    luma = y.to(torch.int32)
    if cb is None:
        return luma.to(torch.uint8)[..., None].expand(*luma.shape, 3).contiguous()
    h, w = luma.shape
    dev = y.device
    xs, ys = torch.arange(w, device=dev), torch.arange(h, device=dev)

    def upsample(plane: torch.Tensor) -> torch.Tensor:
        p = plane.to(torch.int32)
        ch, cw = p.shape
        cx, cy = (xs >> 1 if hs == 2 else xs), (ys >> 1 if vs == 2 else ys)
        if hs == 1 or cw <= 2:
            return p[cy][:, cx]
        odd_x = (xs & 1).bool()
        side = torch.where(odd_x, (cx + 1).clamp(max=cw - 1), (cx - 1).clamp(min=0))
        if vs == 1:
            return (3 * p[cy][:, cx] + p[cy][:, side] + torch.where(odd_x, 2, 1)) >> 2
        far = torch.where((ys & 1).bool(), (cy + 1).clamp(max=ch - 1), (cy - 1).clamp(min=0))
        colsum = 3 * p[cy] + p[far]  # (h, cw): the nearer row 3/4, the farther 1/4
        return (3 * colsum[:, cx] + colsum[:, side] + torch.where(odd_x, 7, 8)) >> 4

    cbx, crx = upsample(cb) - 128, upsample(cr) - 128
    rgb = torch.stack([luma + ((91881 * crx + 32768) >> 16),
                       luma + ((-22554 * cbx - 46802 * crx + 32768) >> 16),
                       luma + ((116130 * cbx + 32768) >> 16)], dim=-1)
    return rgb.clamp(0, 255).to(torch.uint8)


def ycc_to_rgb_cuda(y: torch.Tensor, cb: torch.Tensor | None, cr: torch.Tensor | None,
                    hs: int = 1, vs: int = 1) -> torch.Tensor:
    """The ``jpeg_ycc_rgb`` kernel: ``ycc_to_rgb_plain`` on the card, from
    contiguous uint8 planes on one CUDA device. ``ycc_to_rgb_cuda.launches``
    counts its launches, one per nvJPEG decode."""
    planes = [t for t in (y, cb, cr) if t is not None]
    if not y.is_cuda:
        raise ValueError(f"ycc_to_rgb_cuda: planes on {y.device}, not a CUDA device")
    for t in planes:
        if t.dtype != torch.uint8 or t.ndim != 2 or not t.is_contiguous() or t.device != y.device:
            raise ValueError("ycc_to_rgb_cuda: planes must be contiguous 2-D uint8 on one device")
    if (cb is None) != (cr is None) or (cb is not None and cb.shape != cr.shape):
        raise ValueError("ycc_to_rgb_cuda: Cb and Cr come together, of one shape")
    h, w = y.shape
    ch, cw = cb.shape if cb is not None else (0, 0)
    if cb is not None and (ch, cw) != (-(-h // vs), -(-w // hs)):
        raise ValueError(f"ycc_to_rgb_cuda: chroma {tuple(cb.shape)} for {h}x{w} at {hs}x{vs}")
    out = torch.empty((h, w, 3), dtype=torch.uint8, device=y.device)
    with torch.cuda.device(y.device):
        err = _jpeg_lib().hocon_jpeg_ycc_rgb(
            y.data_ptr(), w, cb.data_ptr() if cb is not None else None,
            cr.data_ptr() if cr is not None else None, cw, cw, ch, hs, vs, out.data_ptr(), w, h,
            torch.cuda.current_stream(y.device).cuda_stream)
    _check(err, "jpeg_ycc_rgb launch")
    ycc_to_rgb_cuda.launches += 1
    return out


ycc_to_rgb_cuda.launches = 0


def jpeg_planes_cuda(data: bytes, device: str | torch.device = "cuda") -> tuple:
    """nvJPEG's decode of JPEG bytes into its planes on ``device``: (Y, Cb,
    Cr, hs, vs) with Cb = Cr = None for a grey JPEG (see ``ycc_to_rgb_plain``).
    Raises ``ValueError`` for a subsampling other than 4:4:4, 4:2:2 and
    4:2:0, or a component count other than 1 and 3."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"nvJPEG decodes on a CUDA device, not {dev}")
    with torch.cuda.device(dev):
        ctx = _context(dev)
        comps, css = ctypes.c_int(), ctypes.c_int()
        widths, heights = (ctypes.c_int * 4)(), (ctypes.c_int * 4)()
        _check(ctx.lib.hocon_jpeg_info(ctx.ptr, data, len(data), ctypes.byref(comps),
                                       ctypes.byref(css), widths, heights),
               "nvjpegGetImageInfo")
        h, w = heights[0], widths[0]
        if comps.value not in (1, 3):
            raise ValueError(f"JPEG with {comps.value} components: grey or YCbCr only")
        y = torch.empty((h, w), dtype=torch.uint8, device=dev)
        cb = cr = None
        hs = vs = 1
        if comps.value == 3:
            ch, cw = heights[1], widths[1]
            hs, vs = -(-w // cw), -(-h // ch)
            if (hs, vs) not in ((1, 1), (2, 1), (2, 2)) or (heights[2], widths[2]) != (ch, cw):
                raise ValueError(f"JPEG chroma subsampling {hs}x{vs} (nvjpegChromaSubsampling_t "
                                 f"{css.value}): 4:4:4, 4:2:2 or 4:2:0 only")
            cb = torch.empty((ch, cw), dtype=torch.uint8, device=dev)
            cr = torch.empty_like(cb)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _check(ctx.lib.hocon_jpeg_decode_planes(
            ctx.ptr, data, len(data), y.data_ptr(), w, cb.data_ptr() if cb is not None else None,
            cr.data_ptr() if cr is not None else None, cb.shape[1] if cb is not None else 0,
            stream), "nvjpegDecode")
    return y, cb, cr, hs, vs


def decode_jpeg_cuda(data: bytes, device: str | torch.device = "cuda") -> torch.Tensor:
    """JPEG bytes -> uint8 (H, W, 3) RGB on ``device``: nvJPEG's planes, then
    ``jpeg_ycc_rgb`` (libjpeg-turbo's upsampling and colour conversion), on
    the current stream."""
    return ycc_to_rgb_cuda(*jpeg_planes_cuda(data, device))


def encode_jpeg(rgb: torch.Tensor, quality: int = 90, subsampling: str = "420") -> bytes:
    """uint8 (H, W, 3) RGB on a CUDA device -> baseline JPEG bytes, encoded
    by nvJPEG at ``quality`` with 4:2:0 (``"420"``) or no (``"444"``) chroma
    subsampling."""
    if rgb.device.type != "cuda" or rgb.dtype != torch.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError("encode_jpeg takes a uint8 (H, W, 3) tensor on a CUDA device, got "
                         f"{tuple(rgb.shape)} {rgb.dtype} on {rgb.device}")
    if subsampling not in ("420", "444"):
        raise ValueError(f"subsampling {subsampling!r}: '420' or '444'")
    rgb = rgb.contiguous()
    h, w = rgb.shape[:2]
    with torch.cuda.device(rgb.device):
        ctx = _context(rgb.device)
        stream = torch.cuda.current_stream(rgb.device).cuda_stream
        n = ctypes.c_size_t()
        _check(ctx.lib.hocon_jpeg_encode(ctx.ptr, rgb.data_ptr(), w, h, int(quality),
                                         int(subsampling == "420"), ctypes.byref(n), stream),
               "nvjpegEncodeImage")
        buf = ctypes.create_string_buffer(n.value)
        _check(ctx.lib.hocon_jpeg_bitstream(ctx.ptr, buf, ctypes.byref(n), stream),
               "nvjpegEncodeRetrieveBitstream")
    return buf.raw[:n.value]
