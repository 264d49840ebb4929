"""Train layer: the warp and supervised train steps, their optimizer and
state, and the eval forward pass."""

from hocon_torch.train.state import TrainState, create_train_state, make_optimizer
from hocon_torch.train.steps import eval_step, make_train_step, make_warp_train_step, warp_loss
