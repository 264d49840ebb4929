"""Frame-pair photometric-consistency warp.

Port of ``hocon/render/warp.py``: render the target view carrying
reference-frame pixel coordinates (K1, backward K2), sample the reference
image there (K3, backward K4), and compare with masked SSIM + L1.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hocon_torch.geometry.project import persp_project
from hocon_torch.render.raster import RasterOutput, soft_rasterize
from hocon_torch.render.sample_cuda import BilinearSample, sample_fwd_plain
from hocon_torch.render.ssim import ssim_loss
from hocon_torch.train.sharding import Mesh, global_sum


def bilinear_sample(
    image: torch.Tensor, coords: torch.Tensor, image_grad: bool = False
) -> torch.Tensor:
    """Sample ``image`` (B, H, W, C) at pixel ``coords`` (B, Hq, Wq, 2).

    By default the image is data, as in the reference's contract: the
    sample goes through K3 and its coordinate gradient through K4. With
    ``image_grad=True`` it goes through the gather formulation, which
    autograd differentiates in the image too (the reference's non-TPU
    route; plain PyTorch on every device). The border clamp is that of
    ``bilinear_sample_gather``.
    """
    if image_grad:
        return sample_fwd_plain(image.float(), coords.float())
    coords = coords.float().contiguous()
    if coords.data_ptr() % 16:  # a view at an odd offset: K3 reads float4
        coords = coords.clone()
    return BilinearSample.apply(image.detach().float().contiguous(), coords)


class WarpOutput(NamedTuple):
    warped: torch.Tensor  # (B, H, W, C) ref image warped into the target view
    mask: torch.Tensor  # (B, H, W) silhouette * visibility
    raster: RasterOutput  # target-view render (flow coords in .attr)


def render_warp(
    verts_tgt: torch.Tensor,
    verts_ref: torch.Tensor,
    faces: torch.Tensor,
    camintr_tgt: torch.Tensor,
    camintr_ref: torch.Tensor,
    ref_image: torch.Tensor,
    image_size: tuple[int, int],
    sigma: float = 1.0,
    gamma: float = 1.0 / 40.0,
    backend: str = "auto",
    backface_cull: bool = True,
) -> WarpOutput:
    """Warp ``ref_image`` into the target view through the meshes.

    verts_tgt / verts_ref (B, V, 3) are the same vertices in target and
    reference camera coordinates; faces (F, 3) or (B, F, 3).
    """
    tgt_pix = persp_project(verts_tgt, camintr_tgt)
    ref_pix = persp_project(verts_ref, camintr_ref)  # the flow texture
    out = soft_rasterize(
        tgt_pix, verts_tgt[..., 2], faces, attrs=ref_pix, image_size=image_size,
        sigma=sigma, gamma=gamma, backend=backend, backface_cull=backface_cull,
    )
    warped = bilinear_sample(ref_image, out.attr)
    return WarpOutput(warped=warped, mask=out.sil * out.vis, raster=out)


def photometric_loss(
    warped: torch.Tensor,
    target: torch.Tensor,
    mask: torch.Tensor,
    lambda_ssim: float = 0.85,
    lambda_l1: float = 0.15,
    window_size: int = 11,
    mesh: Mesh | None = None,
) -> tuple[torch.Tensor, dict]:
    """Masked SSIM + L1 between (B, H, W, C) images in [0, 1].

    The (B, H, W) mask weights the loss and carries no gradient, or the
    loss would be minimised by shrinking the mesh out of the frame. Under a
    data-parallel ``mesh`` both terms are this rank's shares of the global
    batch's, normalised by the global mask sum.
    """
    mask = mask.detach()
    msum = global_sum(torch.sum(mask), mesh) + 1e-6
    l1_map = torch.mean(torch.abs(warped - target), dim=-1)
    l1 = torch.sum(l1_map * mask) / msum
    dssim = ssim_loss(warped, target, mask=mask, window_size=window_size, mesh=mesh)
    loss = lambda_ssim * dssim + lambda_l1 * l1
    return loss, {"photo_l1": l1, "photo_dssim": dssim, "photo_total": loss}
