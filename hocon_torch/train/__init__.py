"""Train layer: the warp and supervised train steps, their optimizer and
state, the eval forward pass, the epoch loop, metric meters, checkpoints
and data parallelism.

The names below load their module on first access: the losses import
``train.sharding``, so importing the steps here would be circular.
"""

import importlib

_EXPORTS = {
    "make_mesh": "sharding", "replicate": "sharding", "shard_batch": "sharding",
    "TrainState": "state", "create_train_state": "state", "make_optimizer": "state",
    "eval_step": "steps", "make_eval_step": "steps", "make_train_step": "steps",
    "make_warp_train_step": "steps", "warp_loss": "steps",
}


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
