"""Differentiable rendering: soft rasterizer (K1 / K2), sampler (K3 / K4),
SSIM, warp.

- ``raster``      — plane math shared by every backend, the unculled
  streaming ``rasterize_planes_xla`` and ``soft_rasterize``.
- ``raster_cuda`` — the y-sorted chunk schedule, kernels K1 (forward) and
  K2 (backward) and the autograd Function pairing them.
- ``sample_cuda`` — kernels K3 and K4, the border-clamped bilinear sampler
  and its coordinate gradient.
- ``ssim``        — windowed SSIM.
- ``warp``        — the frame-pair photometric-consistency warp and loss.

No atomics anywhere: every output element has one owner, so results are
reproducible run to run.
"""

from hocon_torch.render.raster import RasterOutput, soft_rasterize
