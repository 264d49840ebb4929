"""Warp panels for debugging consistency training.

Port of ``hocon/visualize/warpvis.py``: the rendered mask, the reference
image warped into the target view, and the target, for the first rows of
a frame-pair batch under the current weights. On a CUDA model one panel
call renders once (kernel K1 at 2 attribute channels) and samples once
(K3); it runs no backward.
"""

from __future__ import annotations

import numpy as np
import torch

from hocon_torch.device import resolve_device
from hocon_torch.render.warp import render_warp
from hocon_torch.train.steps import _combined_mesh, _device_images, _mode, batch_to_device
from hocon_torch.visualize.samplevis import _unnormalize, sample_vis


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@torch.no_grad()
def warp_panels(
    model, mano, state, pair_batch: dict, image_size: tuple[int, int],
    backend: str = "auto", consist_gt_refs: bool = True,
    sigma: float = 1.0, gamma: float = 1.0 / 40.0, backface_cull: bool = True,
    max_rows: int = 4, device: str | torch.device | None = None,
) -> tuple[dict, dict, dict]:
    """The arguments ``save_warp_panels`` draws, as numpy arrays:
    ``(batch, preds, warp)`` with the target crops (and GT 2D joints where
    the batch has them), the predicted target 2D joints, and the panels
    ``mask`` (n, H, W), ``warped`` and ``target`` (n, H, W, 3) in [0, 1],
    for the first ``n = min(max_rows, B)`` pairs.

    The model runs in eval mode (``state.model``, which must be ``model``)
    on the ref and the tgt views; the renderer's ``sigma`` / ``gamma`` /
    ``backface_cull`` / ``backend`` must be the train step's, or the panels
    show another renderer than the one being debugged.
    """
    if state.model is not model:
        raise ValueError("the train state holds another model than the panels were asked for")
    dev = resolve_device(device)
    ref, tgt = pair_batch["ref"], pair_batch["tgt"]
    if np.ndim(tgt["image"]) == 5:
        tgt = {k: v[:, 0] for k, v in tgt.items()}  # the clip's first target
    # Only max_rows rows are drawn: cut before the forward and the render.
    n = min(max_rows, int(ref["image"].shape[0]))
    ref = {k: v[:n] for k, v in ref.items()}
    tgt = {k: v[:n] for k, v in tgt.items()}
    ref_d, tgt_d = batch_to_device(ref, dev), batch_to_device(tgt, dev)

    with _mode(model, False):
        out_ref = model(_device_images(ref_d["image"]), ref_d["camintr"], mano,
                        ref_d.get("obj_verts_can"))
        out_tgt = model(_device_images(tgt_d["image"]), tgt_d["camintr"], mano,
                        tgt_d.get("obj_verts_can"))
    verts_tgt, faces = _combined_mesh(out_tgt, tgt_d, mano, use_gt_hand=False)
    verts_ref, _ = _combined_mesh(out_ref, ref_d, mano, use_gt_hand=consist_gt_refs)
    ref_img01 = torch.as_tensor(_unnormalize(_host(ref["image"])), dtype=torch.float32,
                                device=dev)
    warp_out = render_warp(
        verts_tgt, verts_ref, faces, tgt_d["camintr"], ref_d["camintr"], ref_img01,
        image_size=image_size, sigma=sigma, gamma=gamma, backend=backend,
        backface_cull=backface_cull,
    )
    warp = {
        "mask": _host(warp_out.mask),
        "warped": _host(warp_out.warped),
        "target": _unnormalize(_host(tgt["image"])),
    }
    preds = {"joints2d": _host(out_tgt["joints2d"])}
    batch_np = {"image": _host(tgt["image"])}
    if tgt.get("joints2d") is not None:
        batch_np["joints2d"] = _host(tgt["joints2d"])
    return batch_np, preds, warp


def save_warp_panels(
    model, mano, state, pair_batch: dict, save_path: str,
    image_size: tuple[int, int], backend: str = "auto",
    consist_gt_refs: bool = True,
    sigma: float = 1.0, gamma: float = 1.0 / 40.0,
    backface_cull: bool = True,
    max_rows: int = 4,
    device: str | torch.device | None = None,
) -> str | None:
    """Draw ``warp_panels`` with ``sample_vis`` into ``save_path``; returns
    the path, or None where matplotlib cannot be imported."""
    batch_np, preds, warp = warp_panels(
        model, mano, state, pair_batch, image_size, backend=backend,
        consist_gt_refs=consist_gt_refs, sigma=sigma, gamma=gamma,
        backface_cull=backface_cull, max_rows=max_rows, device=device,
    )
    return sample_vis(batch_np, preds, save_path, max_rows=max_rows, warp=warp)
