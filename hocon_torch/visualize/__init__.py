"""Qualitative visualisation: sample grids and warp panels (host-side
matplotlib)."""

from hocon_torch.visualize.samplevis import sample_vis
