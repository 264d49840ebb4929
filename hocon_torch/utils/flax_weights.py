"""Weight bridge: Flax HOCNet variables (numpy) -> port ``state_dict``,
and optax Adam's state -> the port's train state.

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

``load_optax_adam_state`` maps Adam's moments the same way, so a port run
continues a JAX run's train state.
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


def load_optax_adam_state(state, mu: Mapping, nu: Mapping, count) -> None:
    """Continue optax Adam's state in a port ``TrainState`` built with
    ``make_optimizer("adam" | "adamw")``, in place.

    ``mu`` / ``nu`` are the Flax-params-shaped moment trees and ``count``
    the update count of optax's ``ScaleByAdamState``, as ``jax.device_get``
    returns them. They become ``OptaxAdam``'s ``exp_avg`` / ``exp_avg_sq``
    (through the parameter mapping above) and its per-group ``count``; each
    parameter's step tensor, the schedule and ``state.step`` move on by
    ``count`` updates, as ``count`` port updates would have moved them.
    """
    from hocon_torch.train.state import OptaxAdam

    opt = state.optimizer
    if not isinstance(opt, OptaxAdam):
        raise TypeError(f"optax Adam state needs OptaxAdam, not {type(opt).__name__}")
    count = int(np.asarray(count))
    moments = {name: flax_to_state_dict({"params": tree})
               for name, tree in (("exp_avg", mu), ("exp_avg_sq", nu))}
    with torch.no_grad():
        for k, p in state.model.named_parameters():
            st = opt.state[p]
            for name, sd in moments.items():
                if tuple(sd[k].shape) != tuple(p.shape):
                    raise ValueError(f"{name} of {k}: shape {sd[k].shape}, parameter "
                                     f"{tuple(p.shape)}")
                st[name].copy_(torch.from_numpy(sd[k]))
            st["step"].fill_(OptaxAdam._START_STEP + count)
    sched = state.schedule
    sched.last_epoch = count
    sched._last_lr = [base * fn(count) for fn, base in zip(sched.lr_lambdas, sched.base_lrs)]
    for group, lr in zip(opt.param_groups, sched._last_lr):
        group["count"] = count
        group["lr"] = lr
    state.step = count
