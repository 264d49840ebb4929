"""hocon_torch — hand-object reconstruction in PyTorch with CUDA kernels.

The PyTorch and CUDA counterpart of the JAX package ``hocon``, which stays
the numerical reference. Subpackages mirror ``hocon``'s names so each
counterpart is easy to find:

- ``hocon_torch.geometry`` — rotations, camera projection, the MANO layer.
- ``hocon_torch.models``   — ResNet trunk, regression heads, HOCNet, losses.
- ``hocon_torch.render``   — soft rasterizer (kernels K1, K2), bilinear
  sampler (kernels K3, K4), SSIM and the photometric-consistency warp.
- ``hocon_torch.train``    — the warp and supervised train steps, the
  optimizer, and the eval forward pass.
- ``hocon_torch.data``     — the meshes the main path renders.
- ``hocon_torch.utils``    — the Flax weight bridge and the CUDA build.

Entry points run on CUDA unless the caller passes ``device="cpu"``; see
``hocon_torch.device``. On a CPU tensor every kernel wrapper runs its plain
PyTorch version; on a CUDA tensor it launches its kernel or raises.
"""

from hocon_torch.device import resolve_device

__all__ = ["resolve_device"]
__version__ = "0.1.0"
