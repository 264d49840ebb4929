"""The ``hamer`` family's port: ``hocon_torch``'s HaMeR. Loading the family
imports the port's model, so a checkout whose port has no HaMeR fails
there, before any device work."""

from __future__ import annotations

import torch

from hocon_torch.models.hamer import HaMeR


def port_model(cfg: dict, device):
    """HaMeR as a training run builds it (``--model hamer``): the
    configuration's widths, the trunk and the decoder's transformer in its
    dtype (bf16 autocast), weights made on ``device``."""
    m = cfg["model"]
    return HaMeR(image_size=cfg["data"]["image_size"], patch=m["patch"], vit_dim=m["vit_dim"],
                 vit_depth=m["vit_depth"], vit_heads=m["vit_heads"],
                 vit_mlp_ratio=m["vit_mlp_dim"] // m["vit_dim"], dec_dim=m["dec_dim"],
                 dec_depth=m["dec_depth"], dec_heads=m["dec_heads"],
                 dec_dim_head=m["dec_dim_head"], dec_mlp_dim=m["dec_mlp_dim"],
                 cam_scale_init=m["cam_scale_init"], center_idx=m["center_idx"],
                 dtype=getattr(torch, m["trunk_dtype"]), seed=0, device=device)
