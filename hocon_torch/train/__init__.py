"""Train layer: the warp-loss and eval forward passes."""

from hocon_torch.train.steps import eval_step, warp_loss
