"""Weight bridge: Flax HOCNet variables (numpy) -> port ``state_dict``.

The inverse of the Flax naming that ``hocon/models/*`` produces. Input is a
nested dict of numpy arrays, ``{"params": ..., "batch_stats": ...}``, as
``jax.device_get`` returns it; nothing here imports JAX. Mapping:

- ``<mod>/Conv_i/kernel`` (HWIO)  -> ``<mod>.conv{i}.weight`` (OIHW);
  ``conv_init`` and ``conv_proj`` keep their names;
- ``<mod>/BatchNorm_i/{scale,bias}`` and ``batch_stats/.../{mean,var}``
  -> ``<mod>.bn{i}.{weight,bias,running_mean,running_var}``; ``bn_init``
  and ``norm_proj`` keep their names;
- ``BasicBlock_k`` / ``Bottleneck_k`` -> ``blocks.k``;
- ``<mlp>/Dense_i/kernel`` (in, out) -> ``<mlp>.layers.{i}.weight`` (out, in).
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

_PARAM_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}


def _module_name(part: str) -> str:
    m = re.fullmatch(r"(BasicBlock|Bottleneck)_(\d+)", part)
    if m:
        return f"blocks.{m.group(2)}"
    m = re.fullmatch(r"Conv_(\d+)", part)
    if m:
        return f"conv{m.group(1)}"
    m = re.fullmatch(r"BatchNorm_(\d+)", part)
    if m:
        return f"bn{m.group(1)}"
    m = re.fullmatch(r"Dense_(\d+)", part)
    if m:
        return f"layers.{m.group(1)}"
    return part


def _walk(tree: Mapping, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def flax_to_state_dict(variables: Mapping) -> dict[str, np.ndarray]:
    """Flax ``{"params", "batch_stats"}`` numpy tree -> port state dict."""
    out = {}
    for collection, leaves in (
        ("params", _PARAM_LEAF), ("batch_stats", _STAT_LEAF),
    ):
        for path, arr in _walk(variables.get(collection, {})):
            *mods, leaf = path
            if leaf not in leaves:
                raise KeyError(f"unexpected Flax leaf {'/'.join(path)!r}")
            key = ".".join([_module_name(p) for p in mods] + [leaves[leaf]])
            if leaf == "kernel" and arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            elif leaf == "kernel":
                arr = arr.T  # (in, out) -> (out, in)
            out[key] = np.array(arr, dtype=np.float32, order="C")  # a writable copy
    return out


def load_flax_variables(model: torch.nn.Module, variables: Mapping) -> None:
    """Load Flax variables into ``model`` in place; every key must match."""
    sd = flax_to_state_dict(variables)
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise KeyError(f"weight bridge mismatch: missing {missing}, extra {extra}")
    for k, arr in sd.items():
        if tuple(own[k].shape) != arr.shape:
            raise ValueError(
                f"shape mismatch at {k}: port {tuple(own[k].shape)} vs Flax "
                f"{arr.shape}"
            )
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
