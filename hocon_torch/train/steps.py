"""Train and eval steps.

Port of ``hocon/train/steps.py``: ``warp_loss`` is the body of
``make_warp_train_step``'s ``loss_fn`` (one HOCNet pass over [ref; tgt],
masked supervised losses, the photometric warp through kernels K1 / K3,
whose backward runs K2 / K4), with the same arguments and term names;
``make_warp_train_step`` and ``make_train_step`` add the backward and the
update (``hocon_torch.train.state``); ``eval_step`` is the forward of
``make_eval_step``, which wraps it as a ``(state, batch)`` step for
``epoch_pass``. Batches are dicts in the reference's layout (NHWC images,
uint8 or normalized float), as numpy arrays or tensors.

Model mode stands for the reference's ``train`` flag: the train steps put
the model in training mode (``train=True``), so a HOCNet with
``freeze_batchnorm=False`` normalises with the batch's statistics (the warp
step's from the joint [ref; tgt] batch) and updates its running ones;
``warp_loss`` alone and ``eval_step`` run in eval mode, on the running
statistics, and restore the mode they found. With the default frozen batch
norm both modes compute the same.

Under a data-parallel ``mesh`` (``hocon_torch.train.sharding``) the batch
is this rank's shard of a global batch: each loss term is the rank's share
of the global term, the logged terms are summed over the ranks and the
gradients are summed before the update, so every rank takes one process's
step on the global batch.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import numpy as np
import torch

from hocon_torch.data.augment import IMAGENET_MEAN, IMAGENET_STD
from hocon_torch.device import resolve_device
from hocon_torch.geometry.mano import ManoModel
from hocon_torch.geometry.project import persp_project, transform_points
from hocon_torch.models.losses import total_supervised_loss
from hocon_torch.render.raster import soft_rasterize
from hocon_torch.render.warp import WarpOutput, bilinear_sample, photometric_loss
from hocon_torch.train.sharding import Mesh, batch_mean, reduce_terms
from hocon_torch.train.state import OptimizerSpec, TrainState, apply_gradients
from hocon_torch.utils.trace import span


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """Arrays and tensors of a (nested) batch dict onto ``device``."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, dict):
            out[k] = batch_to_device(v, device)
        elif isinstance(v, torch.Tensor):
            out[k] = v.to(device)
        elif isinstance(v, np.ndarray) or np.isscalar(v):
            out[k] = torch.as_tensor(np.asarray(v), device=device)
        else:
            out[k] = v
    return out


@contextlib.contextmanager
def _mode(model: torch.nn.Module, train: bool):
    """Run the block with ``model`` in training (True) or eval mode, then
    restore the mode it was in."""
    was = model.training
    model.train(train)
    try:
        yield
    finally:
        model.train(was)


def _gt_from_batch(batch: dict) -> dict:
    gt = {}
    for src, dst in (
        ("joints3d", "joints_c_mm"),
        ("verts3d", "verts_c_mm"),
        ("joints2d", "joints2d"),
        ("objverts3d", "obj_verts_c_mm"),
        ("obj_verts_mask", "obj_verts_mask"),
    ):
        if src in batch:
            gt[dst] = batch[src]
    return gt


def _device_images(img: torch.Tensor) -> torch.Tensor:
    """uint8 crops -> ImageNet-normalized f32; float images pass through."""
    if img.dtype == torch.uint8:
        img = img.float() / 255.0
        return (img - img.new_tensor(IMAGENET_MEAN)) / img.new_tensor(IMAGENET_STD)
    return img


def _unnormalize(img: torch.Tensor) -> torch.Tensor:
    return torch.clamp(
        img * img.new_tensor(IMAGENET_STD) + img.new_tensor(IMAGENET_MEAN), 0.0, 1.0
    )


def _combined_mesh(out: dict, batch: dict, mano: ManoModel, use_gt_hand: bool):
    """Hand (+ object) camera-space mesh of one view, with per-sample faces."""
    if use_gt_hand and "verts3d" in batch:
        hand = batch["verts3d"] / 1000.0 + batch["center3d"][:, None]
    else:
        hand = out["verts_cam"]
    b = hand.shape[0]
    faces = mano.faces[None].expand((b,) + mano.faces.shape)
    if "obj_verts_cam" in out and "obj_faces" in batch:
        verts = torch.cat([hand, out["obj_verts_cam"]], dim=1)
        # Padded object faces are (0, 0, 0); offsetting keeps them
        # degenerate, so the rasterizer culls them.
        ofaces = batch["obj_faces"].long() + hand.shape[1]
        return verts, torch.cat([faces, ofaces], dim=1)
    return hand, faces


def _avg_pool(x: torch.Tensor, d: int) -> torch.Tensor:
    """Non-overlapping d x d mean over dims 1, 2 (VALID: ragged edge dropped)."""
    b, h, w = x.shape[:3]
    hh, ww = h // d, w // d
    x = x[:, : hh * d, : ww * d]
    return x.reshape((b, hh, d, ww, d) + x.shape[3:]).sum(dim=(2, 4)) / (d * d)


def warp_loss(
    model: torch.nn.Module,
    mano: ManoModel,
    batch: dict,
    image_size: tuple[int, int],
    hand_lambdas: dict | None = None,
    obj_lambdas: dict | None = None,
    lambda_consist: float = 1.0,
    consist_gt_refs: bool = True,
    sigma: float = 1.0,
    gamma: float = 1.0 / 40.0,
    backend: str = "auto",
    photo_downscale: int = 1,
    backface_cull: bool = True,
    device: str | torch.device | None = None,
    train: bool = False,
    mesh: Mesh | None = None,
) -> tuple[torch.Tensor, dict]:
    """Photometric-consistency loss of a {"ref", "tgt"} pair batch.

    Returns ``(total, terms)`` with the reference's term names. k-frame
    clips (tgt leaves shaped (B, K-1, ...)) fold the targets into the batch.
    ``train`` runs the model in training mode (the train step's forward),
    else in eval mode; the model's mode is restored after. Under ``mesh``
    the loss and terms are this rank's shares of the global batch's.
    """
    dev = resolve_device(device)
    with span("step.inputs"):
        batch = batch_to_device(batch, dev)
        ref, tgt = dict(batch["ref"]), dict(batch["tgt"])
        ref["image"] = _device_images(ref["image"])
        tgt["image"] = _device_images(tgt["image"])
        b = ref["image"].shape[0]
        if tgt["image"].dim() == 5:
            k1 = tgt["image"].shape[1]
            tgt = {k: v.reshape((b * k1,) + v.shape[2:]) for k, v in tgt.items()}

            def tile(x):
                return x.repeat_interleave(k1, dim=0)
        else:
            def tile(x):
                return x

        obj = None
        if "obj_verts_can" in ref:
            obj = torch.cat([ref["obj_verts_can"], tgt["obj_verts_can"]])
    with _mode(model, train):
        out = model(
            torch.cat([ref["image"], tgt["image"]]),
            torch.cat([ref["camintr"], tgt["camintr"]]),
            mano,
            obj,
        )
    out_ref = {k: v[:b] for k, v in out.items()}
    out_tgt = {k: v[b:] for k, v in out.items()}

    with span("loss.supervised"):
        sup_ref, terms_ref = total_supervised_loss(
            out_ref, _gt_from_batch(ref), ref["sup_mask"],
            hand_lambdas=hand_lambdas, obj_lambdas=obj_lambdas, mesh=mesh,
        )
        sup_tgt, _ = total_supervised_loss(
            out_tgt, _gt_from_batch(tgt), tgt["sup_mask"],
            hand_lambdas=hand_lambdas, obj_lambdas=obj_lambdas, mesh=mesh,
        )

    # Render each target view carrying reference-frame pixel coordinates,
    # warp the reference image there, compare with the target image.
    with span("render.prep"):
        verts_tgt, faces = _combined_mesh(out_tgt, tgt, mano, use_gt_hand=False)
        verts_ref, _ = _combined_mesh(out_ref, ref, mano, use_gt_hand=consist_gt_refs)
        tgt_pix = persp_project(verts_tgt, tgt["camintr"])
        ref_pix = persp_project(tile(verts_ref), tile(ref["camintr"]))
    raster = soft_rasterize(
        tgt_pix, verts_tgt[..., 2], faces, attrs=ref_pix, image_size=image_size,
        sigma=sigma, gamma=gamma, backend=backend, backface_cull=backface_cull,
    )
    with span("render.sample"):
        coords, mask = raster.attr, raster.sil * raster.vis
        tgt_img = _unnormalize(tgt["image"])
        if photo_downscale > 1:
            d = photo_downscale
            coords, mask, tgt_img = (_avg_pool(coords, d), _avg_pool(mask, d),
                                     _avg_pool(tgt_img, d))
        warped = bilinear_sample(tile(_unnormalize(ref["image"])), coords)
    with span("render.photo"):
        photo, photo_terms = photometric_loss(warped, tgt_img, mask, mesh=mesh)
        warp_out = WarpOutput(warped=warped, mask=mask, raster=raster)
        mask_area = batch_mean(torch.sum(warp_out.mask, dim=(1, 2)), mesh)

    total = sup_ref + sup_tgt + lambda_consist * photo
    terms = {f"ref_{k}": v for k, v in terms_ref.items()}
    terms.update(photo_terms)
    terms["loss_total"] = total
    terms["mask_area"] = mask_area
    return total, terms


def _update(state: TrainState, loss: torch.Tensor, terms: dict,
            mesh: Mesh | None = None) -> tuple[TrainState, dict]:
    """Backward, clip, optimizer and schedule step; the terms, summed over
    the ``mesh``'s ranks, gain ``grad_norm`` (the gradients' global norm
    before clipping)."""
    with span("step.backward"):
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
    with span("optim.update"):
        terms = reduce_terms({k: v.detach() for k, v in terms.items()}, mesh)
        terms["grad_norm"] = apply_gradients(state, mesh)
    return state, terms


def _check_state(state: TrainState, model: torch.nn.Module) -> None:
    if state.model is not model:
        raise ValueError("the train state holds another model than the step was made for")


def make_train_step(
    model: torch.nn.Module,
    mano: ManoModel,
    optimizer: OptimizerSpec,
    hand_lambdas: dict | None = None,
    obj_lambdas: dict | None = None,
    device: str | torch.device | None = None,
    mesh: Mesh | None = None,
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """Supervised train step: (state, batch) -> (state, terms).

    ``state`` is ``create_train_state(model, optimizer)``; it is updated in
    place and returned, as the reference returns its new state. Under
    ``mesh`` the batch is this rank's shard of the global batch.
    """
    dev = resolve_device(device)

    def step(state: TrainState, batch: dict):
        with span("step.sup", str(state.step)):
            _check_state(state, model)
            model.train()
            with span("step.inputs"):
                batch = batch_to_device(batch, dev)
            out = model(_device_images(batch["image"]), batch["camintr"], mano,
                        batch.get("obj_verts_can"))
            with span("loss.supervised"):
                loss, terms = total_supervised_loss(
                    out, _gt_from_batch(batch), batch["sup_mask"],
                    hand_lambdas=hand_lambdas, obj_lambdas=obj_lambdas, mesh=mesh,
                )
            return _update(state, loss, terms, mesh)

    return step


def make_warp_train_step(
    model: torch.nn.Module,
    mano: ManoModel,
    optimizer: OptimizerSpec,
    image_size: tuple[int, int],
    hand_lambdas: dict | None = None,
    obj_lambdas: dict | None = None,
    lambda_consist: float = 1.0,
    consist_gt_refs: bool = True,
    sigma: float = 1.0,
    gamma: float = 1.0 / 40.0,
    backend: str = "auto",
    photo_downscale: int = 1,
    backface_cull: bool = True,
    device: str | torch.device | None = None,
    mesh: Mesh | None = None,
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """Frame-pair photometric-consistency train step: ``warp_loss``, its
    backward (K2 / K4 under the raster and the sampler), then the update.
    Returns (state, terms) with the reference's term names. Under ``mesh``
    the batch is this rank's shard of the global batch."""
    dev = resolve_device(device)

    def step(state: TrainState, batch: dict):
        with span("step.warp", str(state.step)):
            _check_state(state, model)
            model.train()
            loss, terms = warp_loss(
                model, mano, batch, image_size, hand_lambdas=hand_lambdas,
                obj_lambdas=obj_lambdas, lambda_consist=lambda_consist,
                consist_gt_refs=consist_gt_refs, sigma=sigma, gamma=gamma,
                backend=backend, photo_downscale=photo_downscale,
                backface_cull=backface_cull, device=dev, train=True, mesh=mesh,
            )
            return _update(state, loss, terms, mesh)

    return step


@torch.no_grad()
def eval_step(
    model: torch.nn.Module,
    mano: ManoModel,
    batch: dict,
    device: str | torch.device | None = None,
) -> dict:
    """Eval forward: the predictions ``make_eval_step`` returns, with the
    model in eval mode (batch norm on its running statistics)."""
    dev = resolve_device(device)
    with span("step.inputs"):
        batch = batch_to_device(batch, dev)
    with _mode(model, False):
        out = model(
            _device_images(batch["image"]), batch["camintr"], mano,
            batch.get("obj_verts_can"),
        )
    preds = {k: out[k] for k in
             ("joints_c_mm", "verts_c_mm", "joints2d", "joints_cam", "verts_cam")}
    if "obj_verts_c_mm" in out:
        preds["obj_verts_c_mm"] = out["obj_verts_c_mm"]
        if "obj_corners_can" in batch:
            corners_cam = transform_points(
                batch["obj_corners_can"], out["obj_rot"], out["obj_trans"]
            )
            preds["obj_corners_c_mm"] = (corners_cam - out["center_cam"]) * 1000.0
    return preds


def make_eval_step(
    model: torch.nn.Module,
    mano: ManoModel,
    device: str | torch.device | None = None,
) -> Callable[[TrainState, dict], dict]:
    """``eval_step`` as a (state, batch) -> predictions step, the signature
    ``epoch_pass`` calls in eval mode."""
    dev = resolve_device(device)

    def step(state: TrainState, batch: dict) -> dict:
        with span("step.eval", str(state.step)):
            _check_state(state, model)
            return eval_step(model, mano, batch, device=dev)

    return step
