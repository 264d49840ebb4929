"""The train steps in plain PyTorch: the benchmark's reference.

``run_steps`` builds the configuration's model (its family's reference,
``reference/families/``) from the benchmark's weights and takes the cell's
first steps on the benchmark's batches: the forward, the masked supervised
losses, in a warp cell the photometric warp (plane prep, soft raster,
bilinear sample, masked SSIM + L1) over [ref; tgt], autograd's backward,
and Adam as optax states it (f32 bias corrections). It returns
what the comparison reads: each step's loss, the first step's terms, each
leaf's first gradient norm and each leaf's change after the last step.

Imports nothing of ``hocon``, ``hocon_torch`` or JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import families, render
from reference.model import persp_project

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _masked_mean(per_sample, mask):
    return torch.sum(per_sample * mask) / (torch.sum(mask) + 1e-6)


def _mse(pred, gt):
    return torch.mean((pred - gt) ** 2, dim=(1, 2))


def supervised_loss(out: dict, batch: dict, lam: dict) -> tuple[torch.Tensor, dict]:
    """Hand 3D / 2D terms and the object's vertices over annotated samples,
    shape and pose regularisers over every sample."""
    mask = batch["sup_mask"]
    terms = {
        "loss_hand_verts3d": _masked_mean(_mse(out["verts_c_mm"], batch["verts3d"]), mask),
        "loss_hand_joints3d": _masked_mean(_mse(out["joints_c_mm"], batch["joints3d"]), mask),
        "loss_hand_joints2d": _masked_mean(_mse(out["joints2d"], batch["joints2d"]), mask),
    }
    total = (lam["verts3d"] * terms["loss_hand_verts3d"]
             + lam["joints3d"] * terms["loss_hand_joints3d"]
             + lam["joints2d"] * terms["loss_hand_joints2d"])
    total = total + lam["shape"] * torch.mean(torch.sum(out["betas"] ** 2, dim=-1))
    total = total + lam["pose"] * torch.mean(torch.sum(out["pose_pca"] ** 2, dim=-1))
    if "obj_verts_c_mm" in out:
        vm = batch["obj_verts_mask"][..., None]
        err = (out["obj_verts_c_mm"] - batch["objverts3d"]) ** 2
        per = torch.sum(err * vm, dim=(1, 2)) / (torch.sum(vm, dim=(1, 2)) * 3.0 + 1e-6)
        terms["loss_obj_verts3d"] = _masked_mean(per, mask)
        total = total + lam["obj_verts3d"] * terms["loss_obj_verts3d"]
    return total, terms


def _mesh(out: dict, view: dict, mano: dict, use_gt: bool):
    hand = view["verts3d"] / 1000.0 + view["center3d"][:, None] if use_gt else out["verts_cam"]
    faces = mano["faces"][None].expand((hand.shape[0],) + mano["faces"].shape)
    if "obj_verts_cam" in out:
        return (torch.cat([hand, out["obj_verts_cam"]], dim=1),
                torch.cat([faces, view["obj_faces"].long() + hand.shape[1]], dim=1))
    return hand, faces


def warp_loss(model, mano, batch, cfg) -> tuple[torch.Tensor, dict]:
    tr, lam = cfg["training"], cfg["training"]["lambdas"]
    ref, tgt = batch["ref"], batch["tgt"]
    b = ref["image"].shape[0]
    obj = torch.cat([ref["obj_verts_can"], tgt["obj_verts_can"]]) if "obj_verts_can" in ref else None
    out = model(torch.cat([ref["image"], tgt["image"]]), torch.cat([ref["camintr"], tgt["camintr"]]),
                mano, obj)
    out_ref = {k: v[:b] for k, v in out.items()}
    out_tgt = {k: v[b:] for k, v in out.items()}
    sup_ref, terms_ref = supervised_loss(out_ref, ref, lam)
    sup_tgt, _ = supervised_loss(out_tgt, tgt, lam)
    verts_tgt, faces = _mesh(out_tgt, tgt, mano, use_gt=False)
    verts_ref, _ = _mesh(out_ref, ref, mano, use_gt=tr["consist_gt_refs"])
    sil, coords, vis = render.soft_rasterize(
        persp_project(verts_tgt, tgt["camintr"]), verts_tgt[..., 2], faces,
        persp_project(verts_ref, ref["camintr"]), (cfg["data"]["image_size"],) * 2,
        tr["sigma"], tr["gamma"], tr["backface_cull"], cells=True, pixel_rows=64)
    mask = sil * vis
    warped = render.bilinear_sample(render.unnormalize(ref["image"]), coords)
    photo, photo_terms = render.photometric_loss(warped, render.unnormalize(tgt["image"]), mask)
    total = sup_ref + sup_tgt + tr["lambda_consist"] * photo
    terms = {f"ref_{k}": v for k, v in terms_ref.items()}
    terms.update(photo_terms, photo_total=photo, mask_area=torch.mean(torch.sum(mask, dim=(1, 2))))
    return total, terms


def sup_loss(model, mano, batch, cfg) -> tuple[torch.Tensor, dict]:
    view = batch["ref"]
    out = model(view["image"], view["camintr"], mano, view.get("obj_verts_can"))
    return supervised_loss(out, view, cfg["training"]["lambdas"])


class Adam:
    """optax.adam: bias corrections 1 - b^t evaluated in f32."""

    def __init__(self, params, lr: float):
        self.params, self.lr, self.t = list(params), lr, 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self):
        self.t += 1
        one, n = np.float32(1.0), np.float32(self.t)
        bc1 = float(one - np.float32(ADAM_B1) ** n)
        bc2 = float(one - np.float32(ADAM_B2) ** n)
        for p, mu, nu in zip(self.params, self.mu, self.nu):
            g = p.grad
            mu.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
            nu.mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
            p.sub_(self.lr * (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS))


def run_steps(cfg: dict, kind: str, mano: dict, weights: dict, batches: list,
              device, tf32: bool = False) -> dict:
    """The cell's first ``len(batches)`` steps from ``weights``. ``tf32``
    computes the float32 parts in TF32 (the control)."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        model = families.load(cfg).Model(cfg).to(device)
        model.load_state_dict(weights, strict=True)
        leaves = dict(model.named_parameters())
        start = {k: p.detach().clone() for k, p in leaves.items()}
        opt = Adam(leaves.values(), cfg["training"]["lr"])
        loss_fn = warp_loss if kind == "warp" else sup_loss
        losses, terms1, grads1 = [], None, None
        for t, batch in enumerate(batches):
            for p in leaves.values():
                p.grad = None
            loss, terms = loss_fn(model, mano, batch, cfg)
            loss.backward()
            for p in leaves.values():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            if t == 0:
                terms1 = {k: float(v.detach()) for k, v in terms.items()}
                grads1 = {k: float(torch.linalg.vector_norm(p.grad)) for k, p in leaves.items()}
            losses.append(float(loss.detach()))
            opt.step()
        change = {k: float(torch.linalg.vector_norm(p.detach() - start[k]))
                  for k, p in leaves.items()}
        return {"losses": losses, "terms1": terms1, "grads1": grads1, "change": change}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
