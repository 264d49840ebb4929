"""Train layer: the warp and supervised train steps, their optimizer and
state, the eval forward pass, the epoch loop, metric meters and
checkpoints."""

from hocon_torch.train.state import TrainState, create_train_state, make_optimizer
from hocon_torch.train.steps import (
    eval_step,
    make_eval_step,
    make_train_step,
    make_warp_train_step,
    warp_loss,
)
