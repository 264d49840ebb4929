"""Kernels K3 and K4: the border-clamped bilinear sampler forward and
backward, and their plain versions.

``sample_fwd(image, coords)`` samples an NHWC image (B, H, W, C) at pixel
coordinates (B, Hq, Wq, 2), (0.5, 0.5) being the centre of the first
pixel, with the border clamp of ``hocon/render/warp.py``
``bilinear_sample_gather``. ``sample_bwd(image, coords, g)`` is its
gradient with respect to the coordinates, with the Pallas kernel's
semantics (right-hand slope at integer coordinates, zero where a coordinate
was clamped); the image gets none. ``BilinearSample`` pairs the two.

CUDA tensors launch ``hocon_torch/csrc/sample_fwd.cu`` /
``sample_bwd.cu``, which replace ``hocon/render/sample_pallas.py``
``_sample_kernel`` / ``_sample_bwd_kernel``; CPU tensors run
``sample_fwd_plain`` / ``sample_bwd_plain``. ``sample_fwd.launches`` and
``sample_bwd.launches`` count kernel launches.

Layout: the kernels read the public layouts as they are (NHWC image,
interleaved (x, y) coords) and write (B, Hq, Wq, C) / (B, Hq, Wq, 2), so
the wrappers transpose nothing. The TPU kernels' channel-major image and
bf16 cast were choices for its matrix unit and are not carried over: the
image stays f32.
"""

from __future__ import annotations

import ctypes
import functools

import torch


def sample_fwd_plain(image: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """K3's plain PyTorch version: a port of ``bilinear_sample_gather``."""
    b, h, w, c = image.shape
    x = coords[..., 0] - 0.5
    y = coords[..., 1] - 0.5
    x0i = torch.clamp(torch.floor(x).to(torch.int64), 0, w - 2)
    y0i = torch.clamp(torch.floor(y).to(torch.int64), 0, h - 2)
    fx = torch.clamp(x - x0i, 0.0, 1.0)[..., None]
    fy = torch.clamp(y - y0i, 0.0, 1.0)[..., None]
    flat = image.reshape(b, h * w, c)
    bidx = torch.arange(b, device=image.device).view((b,) + (1,) * (x.dim() - 1))

    def tap(dy, dx):
        return flat[bidx, (y0i + dy) * w + (x0i + dx)]  # (B, Hq, Wq, C)

    top = tap(0, 0) * (1 - fx) + tap(0, 1) * fx
    bot = tap(1, 0) * (1 - fx) + tap(1, 1) * fx
    return top * (1 - fy) + bot * fy


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    from hocon_torch.utils import cuda_build

    lib = cuda_build.load("sample_fwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hocon_sample_fwd.argtypes = [p] * 3 + [i] * 6 + [p]
    lib.hocon_sample_fwd.restype = i
    return lib


def sample_fwd_cuda(image: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Launch K3 on CUDA tensors (the interface of ``sample_fwd_plain``)."""
    b, h, w, c = image.shape
    bq, hq, wq, two = coords.shape
    if bq != b or two != 2:
        raise ValueError(f"coords {tuple(coords.shape)} for image {tuple(image.shape)}")
    if h < 2 or w < 2:
        raise ValueError("sample_fwd needs an image of at least 2 x 2 pixels")
    for name, t in (("image", image), ("coords", coords)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != image.device:
            raise ValueError(f"sample_fwd: {name} must be contiguous f32 on {image.device}")
    if coords.data_ptr() % 8:
        raise ValueError("sample_fwd: coords must be 8-byte aligned (float2 reads)")
    out = torch.empty((b, hq, wq, c), device=image.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(image.device).cuda_stream
    err = _kernel_lib().hocon_sample_fwd(
        image.data_ptr(), coords.data_ptr(), out.data_ptr(),
        b, h, w, c, hq, wq, stream,
    )
    if err != 0:
        raise RuntimeError(f"sample_fwd kernel launch failed: cudaError {err}")
    sample_fwd.launches += 1
    return out


def sample_fwd(image: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """K3: bilinear sample of ``image`` (B,H,W,C) at ``coords`` (B,Hq,Wq,2).

    CUDA tensors launch the kernel (or raise); CPU tensors run
    ``sample_fwd_plain``.
    """
    if image.is_cuda:
        return sample_fwd_cuda(image, coords)
    return sample_fwd_plain(image, coords)


sample_fwd.launches = 0


def sample_bwd_plain(image: torch.Tensor, coords: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K4's plain PyTorch version: d(sample)/d(coords) contracted with the
    cotangent ``g`` (B, Hq, Wq, C), written out in closed form.

    gx = sum_c g_c (rows_c[x0+1] - rows_c[x0]) with rows the y-lerped
    columns, gy the same with the x-lerp weights on the row differences; at
    integer coordinates the right-hand slope; 0 where ``coord - 0.5`` is not
    strictly inside (0, W-1) (resp. (0, H-1)). Returns (B, Hq, Wq, 2).
    """
    b, h, w, c = image.shape
    x = coords[..., 0] - 0.5
    y = coords[..., 1] - 0.5
    x0i = torch.clamp(torch.floor(x).to(torch.int64), 0, w - 2)
    y0i = torch.clamp(torch.floor(y).to(torch.int64), 0, h - 2)
    fx = torch.clamp(x - x0i, 0.0, 1.0)[..., None]
    fy = torch.clamp(y - y0i, 0.0, 1.0)[..., None]
    flat = image.reshape(b, h * w, c)
    bidx = torch.arange(b, device=image.device).view((b,) + (1,) * (x.dim() - 1))

    def tap(dy, dx):
        return flat[bidx, (y0i + dy) * w + (x0i + dx)]  # (B, Hq, Wq, C)

    v00, v01, v10, v11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    r0 = v00 * (1 - fy) + v10 * fy
    r1 = v01 * (1 - fy) + v11 * fy
    gx = (g * (r1 - r0)).sum(dim=-1)
    gy = (g * ((v10 - v00) * (1 - fx) + (v11 - v01) * fx)).sum(dim=-1)
    gx = torch.where((x > 0) & (x < w - 1), gx, 0.0)
    gy = torch.where((y > 0) & (y < h - 1), gy, 0.0)
    return torch.stack([gx, gy], dim=-1)


@functools.cache
def _bwd_kernel_lib() -> ctypes.CDLL:
    from hocon_torch.utils import cuda_build

    lib = cuda_build.load("sample_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hocon_sample_bwd.argtypes = [p] * 4 + [i] * 6 + [p]
    lib.hocon_sample_bwd.restype = i
    return lib


def sample_bwd_cuda(image: torch.Tensor, coords: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch K4 on CUDA tensors (the interface of ``sample_bwd_plain``)."""
    b, h, w, c = image.shape
    bq, hq, wq, two = coords.shape
    if bq != b or two != 2:
        raise ValueError(f"coords {tuple(coords.shape)} for image {tuple(image.shape)}")
    if tuple(g.shape) != (b, hq, wq, c):
        raise ValueError(f"cotangent {tuple(g.shape)} for output {(b, hq, wq, c)}")
    if h < 2 or w < 2:
        raise ValueError("sample_bwd needs an image of at least 2 x 2 pixels")
    for name, t in (("image", image), ("coords", coords), ("g", g)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != image.device:
            raise ValueError(f"sample_bwd: {name} must be contiguous f32 on {image.device}")
    if coords.data_ptr() % 8:
        raise ValueError("sample_bwd: coords must be 8-byte aligned (float2 reads)")
    dcoords = torch.empty((b, hq, wq, 2), device=image.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(image.device).cuda_stream
    err = _bwd_kernel_lib().hocon_sample_bwd(
        image.data_ptr(), coords.data_ptr(), g.data_ptr(), dcoords.data_ptr(),
        b, h, w, c, hq, wq, stream,
    )
    if err != 0:
        raise RuntimeError(f"sample_bwd kernel launch failed: cudaError {err}")
    sample_bwd.launches += 1
    return dcoords


def sample_bwd(image: torch.Tensor, coords: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K4: the coordinate gradient (B, Hq, Wq, 2) of ``sample_fwd``.

    CUDA tensors launch the kernel (or raise); CPU tensors run
    ``sample_bwd_plain``.
    """
    if image.is_cuda:
        return sample_bwd_cuda(image, coords, g)
    return sample_bwd_plain(image, coords, g)


sample_bwd.launches = 0


class BilinearSample(torch.autograd.Function):
    """K3 forward, K4 backward; the image is data and gets no gradient."""

    @staticmethod
    def forward(ctx, image, coords):
        ctx.save_for_backward(image, coords)
        return sample_fwd(image, coords)

    @staticmethod
    def backward(ctx, g):
        image, coords = ctx.saved_tensors
        return None, sample_bwd(image, coords, g.float().contiguous())
