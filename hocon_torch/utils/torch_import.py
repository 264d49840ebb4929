"""PyTorch weight import: torchvision ResNets and reference checkpoints.

Port of ``hocon/utils/torch_import.py``. Its purpose is the same: start
training from a torchvision (ImageNet) trunk like the reference, and load
a reference MeshRegNet checkpoint to evaluate it for MPJPE parity. In the
port each import is a key map from torchvision / reference names to the
model's own ``state_dict`` names, followed by an in-place copy into the
existing parameters and buffers, so that an optimizer already built over
them keeps holding them. Conv weights stay OIHW and Linear weights stay
(out, in): both sides are PyTorch layouts, nothing is transposed.

Key layout of a torchvision ResNet (optionally under a prefix, e.g. the
reference's ``base_net.``), and where each key lands in a ``HOCNet``:

- ``conv1.weight``, ``bn1.*`` -> ``trunk.conv_init``, ``trunk.bn_init``;
- ``layer{L}.{B}.conv{i}.weight``, ``layer{L}.{B}.bn{i}.*`` ->
  ``trunk.blocks.{k}.conv{i-1}``, ``trunk.blocks.{k}.bn{i-1}``, blocks
  numbered across stages (2 convs per ``BasicBlock``, 3 per
  ``Bottleneck``; the block type is the model's);
- ``layer{L}.{B}.downsample.{0,1}.*`` -> ``conv_proj``, ``norm_proj``;
- batch-norm ``weight``, ``bias``, ``running_mean``, ``running_var``;
  ``num_batches_tracked`` and the classifier ``fc.*`` are not read.

A missing source key raises ``KeyError`` and a shape mismatch
``ValueError``, before anything is copied: a silently partial import would
corrupt a parity claim.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from hocon_torch.models.backbone import Bottleneck

_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def _as_f32(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().to(device="cpu", dtype=torch.float32)
    return torch.from_numpy(np.array(value, dtype=np.float32))


def _copy_plan(module: torch.nn.Module, plan: list) -> None:
    """Copy ``[(own key, source f32 tensor), ...]`` into ``module``'s
    parameters and buffers in place, after checking every shape."""
    own = dict(module.named_parameters())
    own.update(module.named_buffers())
    for key, value in plan:
        if key not in own:
            raise KeyError(f"the model has no parameter or buffer {key!r}")
        if tuple(own[key].shape) != tuple(value.shape):
            raise ValueError(
                f"shape mismatch at {key}: port {tuple(own[key].shape)} vs torch "
                f"{tuple(value.shape)}"
            )
    with torch.no_grad():
        for key, value in plan:
            own[key].copy_(value)


def _trunk_plan(state_dict: Mapping, trunk: torch.nn.Module, stage_sizes, prefix: str,
                dest: str = "") -> list:
    def src(key):
        full = prefix + key
        if full not in state_dict:
            raise KeyError(f"missing torch key {full!r}")
        return _as_f32(state_dict[full])

    plan = []

    def conv(own: str, torch_name: str):
        plan.append((f"{dest}{own}.weight", src(f"{torch_name}.weight")))

    def bn(own: str, torch_name: str):
        plan.extend((f"{dest}{own}.{leaf}", src(f"{torch_name}.{leaf}")) for leaf in _BN_LEAVES)

    conv("conv_init", "conv1")
    bn("bn_init", "bn1")
    n_convs = 3 if isinstance(trunk.blocks[0], Bottleneck) else 2
    k = 0
    for stage, n_blocks in enumerate(stage_sizes):
        for b in range(n_blocks):
            if k >= len(trunk.blocks):
                raise KeyError(f"stage sizes {tuple(stage_sizes)} name block {k}; the trunk "
                               f"has {len(trunk.blocks)}")
            tname = f"layer{stage + 1}.{b}"
            for ci in range(n_convs):
                conv(f"blocks.{k}.conv{ci}", f"{tname}.conv{ci + 1}")
                bn(f"blocks.{k}.bn{ci}", f"{tname}.bn{ci + 1}")
            if trunk.blocks[k].conv_proj is not None:
                conv(f"blocks.{k}.conv_proj", f"{tname}.downsample.0")
                bn(f"blocks.{k}.norm_proj", f"{tname}.downsample.1")
            k += 1
    return plan


def import_resnet_trunk(
    state_dict: Mapping,
    trunk: torch.nn.Module,
    stage_sizes=(2, 2, 2, 2),
    prefix: str = "",
) -> None:
    """Copy torchvision-ResNet weights into ``trunk`` (a port ``ResNet``),
    in place.

    ``state_dict`` maps names to tensors or numpy arrays. Raises
    ``KeyError`` on a missing source key and ``ValueError`` on a shape
    mismatch, leaving the trunk untouched.
    """
    _copy_plan(trunk, _trunk_plan(state_dict, trunk, stage_sizes, prefix))


# The reference's head layout (meshreg's manobranch / absolutebranch /
# meshregnet): each branch is a shared base MLP (Linear + ReLU) followed by
# per-output Linear regressors. HOCNet has a separate MLP per output, so
# the shared base weights are copied into each MLP that consumes them, which
# computes the same function. The Absolute and ObjPose heads add a constant
# depth ``z_init`` to their raw output, so the imported final biases are
# shifted by -z_init to keep the composed function the reference's.

def default_head_table(ncomps: int = 15, z_init: float = 0.6) -> list:
    """``[(port module path, torch prefix, bias offset | None), ...]`` for
    HOCNet's heads.

    ``z_init`` must be the model's (``HOCNet.absolute_head.z_init``): it is
    folded into the imported final biases, and a wrong value shifts depth
    with no shape error to catch it. ``import_hocnet`` passes the model's.
    """
    del ncomps  # shapes come from the arrays; kept for the reference's signature
    zoff = np.array([0.0, 0.0, -z_init], np.float32)
    return [
        ("mano_head.pose_mlp.layers.0", "mano_branch.base_layer.0", None),
        ("mano_head.pose_mlp.layers.1", "mano_branch.base_layer.2", None),
        ("mano_head.pose_mlp.layers.2", "mano_branch.pose_reg", None),
        ("mano_head.shape_mlp.layers.0", "mano_branch.base_layer.0", None),
        ("mano_head.shape_mlp.layers.1", "mano_branch.base_layer.2", None),
        ("mano_head.shape_mlp.layers.2", "mano_branch.shape_reg", None),
        ("absolute_head.trans_mlp.layers.0", "absolute_branch.base_layer.0", None),
        ("absolute_head.trans_mlp.layers.1", "absolute_branch.final_layer", zoff),
        ("obj_head.objtrans_mlp.layers.0", "obj_branch.base_layer.0", None),
        ("obj_head.objtrans_mlp.layers.1", "obj_branch.trans_reg", zoff),
        ("obj_head.objrot_mlp.layers.0", "obj_branch.base_layer.0", None),
        ("obj_head.objrot_mlp.layers.1", "obj_branch.rot_reg", None),
    ]


def import_hocnet(
    model: torch.nn.Module,
    state_dict: Mapping,
    trunk_prefix: str = "base_net.",
    head_table: list | None = None,
    stage_sizes=(2, 2, 2, 2),
    strict_heads: bool = True,
) -> None:
    """Import a full reference MeshRegNet checkpoint into a port ``HOCNet``,
    in place: the trunk and the Mano / Absolute / object heads through
    ``default_head_table`` (pass ``head_table`` where the real key names
    differ).

    With ``strict_heads=False``, head entries whose torch keys are absent
    are skipped (a hand-only checkpoint into a hand + object model); heads
    the model does not have (no object head) are always skipped. The bias
    fold uses the model's own ``z_init``. The object rotation needs
    ``obj_rot_param="axisang"``: the reference regresses axis-angle, and
    the 6d head's output width raises a shape mismatch.
    """
    plan = _trunk_plan(state_dict, model.trunk, stage_sizes, trunk_prefix, dest="trunk.")
    table = head_table if head_table is not None else default_head_table(
        z_init=model.absolute_head.z_init)
    for path, torch_prefix, bias_offset in table:
        if getattr(model, path.split(".")[0], None) is None:
            continue  # a model variant without this head (e.g. no object)
        wk, bk = torch_prefix + ".weight", torch_prefix + ".bias"
        if wk not in state_dict or bk not in state_dict:
            if strict_heads:
                raise KeyError(f"missing torch keys {wk!r}/{bk!r}")
            continue
        bias = _as_f32(state_dict[bk])
        if bias_offset is not None:
            bias = bias + torch.from_numpy(np.asarray(bias_offset, np.float32))
        plan += [(f"{path}.weight", _as_f32(state_dict[wk])), (f"{path}.bias", bias)]
    _copy_plan(model, plan)


def load_torch_checkpoint(path: str) -> dict:
    """A torch ``.pth`` / ``.pt`` file as ``{name: tensor}`` on the CPU:
    the ``state_dict`` entry when there is one, ``"module."`` removed from
    the names (``DataParallel`` wrappers), non-tensor entries dropped."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    return {k.replace("module.", ""): v.detach() for k, v in ckpt.items()
            if isinstance(v, torch.Tensor)}


def import_trunk_into_hocnet(
    model: torch.nn.Module, state_dict: Mapping, prefix: str = "", stage_sizes=(2, 2, 2, 2),
) -> None:
    """Replace a ``HOCNet``'s trunk weights with a torchvision ResNet's, in
    place."""
    import_resnet_trunk(state_dict, model.trunk, stage_sizes=stage_sizes, prefix=prefix)
