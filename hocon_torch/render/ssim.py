"""Windowed SSIM for the photometric-consistency loss.

Port of ``hocon/render/ssim.py``: the separable Gaussian window runs as two
banded-matrix products, which reproduce a zero-padded SAME convolution.
Under a data-parallel ``mesh`` the masked DSSIM is this rank's share of the
global batch's (``hocon_torch.train.sharding``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from hocon_torch.train.sharding import Mesh, batch_mean, global_sum

_C1 = 0.01**2
_C2 = 0.03**2


@functools.lru_cache(maxsize=16)
def _band_matrix_np(n: int, window_size: int, sigma: float) -> np.ndarray:
    """(n, n) banded Gaussian-blur matrix == zero-padded SAME conv."""
    half = (window_size - 1) / 2.0
    x = np.arange(window_size, dtype=np.float64) - half
    g = np.exp(-(x**2) / (2.0 * sigma**2))
    g /= g.sum()
    m = np.zeros((n, n), np.float64)
    r = (window_size - 1) // 2
    for t in range(window_size):
        off = t - r
        rows = np.arange(max(0, -off), min(n, n - off))
        m[rows, rows + off] += g[t]
    return m.astype(np.float32)


def _window_mean_cf(x: torch.Tensor, window_size: int, sigma: float) -> torch.Tensor:
    """Gaussian window mean of channels-first (B, C, H, W)."""
    h, w = x.shape[-2], x.shape[-1]
    opts = dict(device=x.device, dtype=x.dtype)
    gw = torch.from_numpy(_band_matrix_np(w, window_size, sigma)).to(**opts)
    gh = torch.from_numpy(_band_matrix_np(h, window_size, sigma)).to(**opts)
    return gh @ (x @ gw.T)


def ssim(
    img_a: torch.Tensor,
    img_b: torch.Tensor,
    window_size: int = 11,
    sigma: float = 1.5,
) -> torch.Tensor:
    """Per-pixel SSIM (B, H, W), mean over channels, of NHWC images."""
    a = img_a.permute(0, 3, 1, 2)
    b = img_b.permute(0, 3, 1, 2)
    mu_a = _window_mean_cf(a, window_size, sigma)
    mu_b = _window_mean_cf(b, window_size, sigma)
    mu_aa = mu_a * mu_a
    mu_bb = mu_b * mu_b
    mu_ab = mu_a * mu_b
    var_a = _window_mean_cf(a * a, window_size, sigma) - mu_aa
    var_b = _window_mean_cf(b * b, window_size, sigma) - mu_bb
    cov = _window_mean_cf(a * b, window_size, sigma) - mu_ab
    num = (2.0 * mu_ab + _C1) * (2.0 * cov + _C2)
    den = (mu_aa + mu_bb + _C1) * (var_a + var_b + _C2)
    return torch.mean(num / den, dim=1)


def ssim_loss(
    img_a: torch.Tensor,
    img_b: torch.Tensor,
    mask: torch.Tensor | None = None,
    window_size: int = 11,
    mesh: Mesh | None = None,
) -> torch.Tensor:
    """Masked DSSIM: mean over masked pixels of (1 - SSIM) / 2."""
    d = (1.0 - ssim(img_a, img_b, window_size=window_size)) * 0.5
    if mask is None:
        return batch_mean(d, mesh)
    return torch.sum(d * mask) / (global_sum(torch.sum(mask), mesh) + 1e-6)
