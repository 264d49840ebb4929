"""Models: ResNet trunk, regression heads, HOCNet, the ViT trunk and HaMeR, and
supervised losses."""

from hocon_torch.models.backbone import ResNet, resnet18, resnet34, resnet50
from hocon_torch.models.hamer import HaMeR
from hocon_torch.models.hocnet import HOCNet
from hocon_torch.models.losses import (
    hand_losses,
    object_losses,
    total_supervised_loss,
)
