"""Experiment utilities, ported from ``hocon.exp``."""

from hocon_torch.exp.args import save_args
