"""Kernel K3: the border-clamped bilinear sampler forward and its plain version.

``sample_fwd(image, coords)`` samples an NHWC image (B, H, W, C) at pixel
coordinates (B, Hq, Wq, 2), (0.5, 0.5) being the centre of the first
pixel, with the border clamp of ``hocon/render/warp.py``
``bilinear_sample_gather``. CUDA tensors launch
``hocon_torch/csrc/sample_fwd.cu``, which replaces
``hocon/render/sample_pallas.py:_sample_kernel``; CPU tensors run
``sample_fwd_plain``. ``sample_fwd.launches`` counts kernel launches.

Layout: the kernel reads the public layouts as they are (NHWC image,
interleaved (x, y) coords) and writes (B, Hq, Wq, C), so the wrapper
transposes nothing. The TPU kernel's channel-major image and bf16 cast were
choices for its matrix unit and are not carried over: the image stays f32.
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
