"""Weight files in the layouts the importer reads, drawn from a numpy seed.

``torchvision_resnet`` is a torchvision ResNet's ``state_dict`` (``conv1``,
``bn1``, ``layer{L}.{B}.conv{i}`` / ``bn{i}`` / ``downsample.{0,1}``,
``fc``), with random batch-norm statistics; ``reference_checkpoint`` is a
reference MeshRegNet checkpoint's (the trunk under ``base_net.``, then the
Mano / Absolute / object branches: a shared base MLP and per-output
regressors, the object rotation as axis-angle). Both are tensors on the
CPU, ready for ``torch.save``; no torchvision and no download.

``torchvision_name(port_key, stage_sizes, bottleneck)`` maps a port trunk
key back to its torchvision name, written out apart from
``hocon_torch.utils.torch_import`` so that a check does not reuse the map
it checks.
"""

from __future__ import annotations

import re

import numpy as np
import torch

WIDTHS = (64, 128, 256, 512)
BN_LEAVES = ("weight", "bias", "running_mean", "running_var")
HEADS = {  # reference name: (in, out) for a 512-feature trunk, 15 PCA components
    "mano_branch.base_layer.0": (512, 512),
    "mano_branch.base_layer.2": (512, 512),
    "mano_branch.pose_reg": (512, 18),
    "mano_branch.shape_reg": (512, 10),
    "absolute_branch.base_layer.0": (512, 512),
    "absolute_branch.final_layer": (512, 3),
    "obj_branch.base_layer.0": (512, 512),
    "obj_branch.trans_reg": (512, 3),
    "obj_branch.rot_reg": (512, 3),
}


def torchvision_resnet(seed: int, stage_sizes=(2, 2, 2, 2), bottleneck: bool = False) -> dict:
    """A torchvision ResNet's ``state_dict``: conv weights with variance
    1 / fan_in, batch-norm scales near 1, biases and means near 0,
    variances in [0.5, 1.5]; ``num_batches_tracked`` and ``fc`` included."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(name, cout, cin, k):
        w = rng.standard_normal((cout, cin, k, k)) / np.sqrt(cin * k * k)
        sd[f"{name}.weight"] = torch.from_numpy(w.astype(np.float32))

    def bn(name, c):
        for leaf, value in (("weight", rng.normal(1.0, 0.05, c)), ("bias", rng.normal(0.0, 0.05, c)),
                            ("running_mean", rng.normal(0.0, 0.05, c)),
                            ("running_var", rng.uniform(0.5, 1.5, c))):
            sd[f"{name}.{leaf}"] = torch.from_numpy(value.astype(np.float32))
        sd[f"{name}.num_batches_tracked"] = torch.tensor(100)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for li, (width, n) in enumerate(zip(WIDTHS, stage_sizes)):
        cout = width * 4 if bottleneck else width
        for b in range(n):
            stride = 2 if li > 0 and b == 0 else 1
            name = f"layer{li + 1}.{b}"
            shapes = ([(width, cin, 1), (width, width, 3), (cout, width, 1)] if bottleneck
                      else [(width, cin, 3), (width, width, 3)])
            for i, (o, c, k) in enumerate(shapes, start=1):
                conv(f"{name}.conv{i}", o, c, k)
                bn(f"{name}.bn{i}", o)
            if stride != 1 or cin != cout:
                conv(f"{name}.downsample.0", cout, cin, 1)
                bn(f"{name}.downsample.1", cout)
            cin = cout
    sd["fc.weight"] = torch.from_numpy((rng.standard_normal((1000, cin)) * 0.01).astype(np.float32))
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def reference_checkpoint(seed: int) -> dict:
    """A reference MeshRegNet checkpoint's ``state_dict`` (ResNet-18 trunk
    under ``base_net.``, every branch of ``HEADS``)."""
    sd = {f"base_net.{k}": v for k, v in torchvision_resnet(seed).items()}
    rng = np.random.default_rng(seed + 1)
    for name, (cin, cout) in HEADS.items():
        sd[f"{name}.weight"] = torch.from_numpy(
            (rng.standard_normal((cout, cin)) * 0.05).astype(np.float32))
        sd[f"{name}.bias"] = torch.from_numpy((rng.standard_normal(cout) * 0.05).astype(np.float32))
    return sd


def torchvision_name(port_key: str, stage_sizes=(2, 2, 2, 2)) -> str:
    """The torchvision name of a port trunk key (``blocks.{k}.conv{i}`` ->
    ``layer{L}.{B}.conv{i+1}``, ``conv_proj`` / ``norm_proj`` ->
    ``downsample.0`` / ``.1``, ``conv_init`` / ``bn_init`` -> ``conv1`` /
    ``bn1``)."""
    stem = {"conv_init": "conv1", "bn_init": "bn1"}
    head, _, leaf = port_key.rpartition(".")
    if head in stem:
        return f"{stem[head]}.{leaf}"
    m = re.fullmatch(r"blocks\.(\d+)\.(conv|bn)(\d+|_proj)", head) or re.fullmatch(
        r"blocks\.(\d+)\.(norm)(_proj)", head)
    if m is None:
        raise KeyError(f"not a trunk key: {port_key!r}")
    k, kind, idx = int(m.group(1)), m.group(2), m.group(3)
    starts = np.cumsum((0,) + tuple(stage_sizes))
    stage = int(np.searchsorted(starts, k, side="right")) - 1
    block = f"layer{stage + 1}.{k - starts[stage]}"
    if idx == "_proj":
        return f"{block}.downsample.{0 if kind == 'conv' else 1}.{leaf}"
    return f"{block}.{kind}{int(idx) + 1}.{leaf}"
