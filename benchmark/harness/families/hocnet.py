"""The ``hocnet`` family's port: ``hocon_torch``'s HOCNet."""

from __future__ import annotations

import torch


def port_model(cfg: dict, device):
    """HOCNet as a training run builds it: the configuration's backbone, the
    trunk in its dtype (bf16 autocast), frozen batch norm."""
    from hocon_torch.models.hocnet import HOCNet

    m = cfg["model"]
    return HOCNet(ncomps=m["mano_ncomps"], center_idx=m["center_idx"],
                  with_object=m["with_object"], backbone=m["backbone"],
                  freeze_batchnorm=m["freeze_batchnorm"], z_init=m["z_init"],
                  dtype=getattr(torch, m["trunk_dtype"]), seed=0, device=device)
