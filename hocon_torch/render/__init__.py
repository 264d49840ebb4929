"""Differentiable rendering: soft rasterizer (K1), sampler (K3), SSIM, warp.

- ``raster``      — plane math shared by every backend and ``soft_rasterize``.
- ``raster_cuda`` — the y-sorted chunk schedule and kernel K1.
- ``sample_cuda`` — kernel K3, the border-clamped bilinear sampler.
- ``ssim``        — windowed SSIM.
- ``warp``        — the frame-pair photometric-consistency warp and loss.

No atomics anywhere: every output element has one owner, so results are
reproducible run to run.
"""

from hocon_torch.render.raster import RasterOutput, soft_rasterize
