"""Device selection for the port's entry points.

Entry points take an explicit ``device``. ``None`` means the card: the port
exists to run there, so a host without CUDA raises instead of quietly
running the plain PyTorch versions on the CPU. Tests pass ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``device``, or CUDA when None."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "hocon_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return torch.device("cuda")
