"""The U-Net, Siamese U-Net and DeepLab v3+ families (PyTorch), the
U-Net's BN folding, the flax weight bridge, losses and metrics."""

from satellite_computervision_tpu_torch.models.blocks import (
    ASPP,
    ConvBlock,
    ConvBNAct,
    DecoderBlock,
    EncoderBlock,
)
from satellite_computervision_tpu_torch.models import losses, metrics
from satellite_computervision_tpu_torch.models.bridge import flax_to_torch
from satellite_computervision_tpu_torch.models.deeplab import (
    BottleneckBlock,
    DeepLabV3Plus,
    ResNetBackbone,
    export_torch_resnet_weights,
    load_torch_resnet_weights,
)
from satellite_computervision_tpu_torch.models.fold import fold_unet
from satellite_computervision_tpu_torch.models.siamese import SiameseUNet
from satellite_computervision_tpu_torch.models.unet import UNet, flax_init_, unet_parking, unet_solar

__all__ = [
    "ConvBNAct",
    "ConvBlock",
    "EncoderBlock",
    "DecoderBlock",
    "ASPP",
    "UNet",
    "SiameseUNet",
    "BottleneckBlock",
    "ResNetBackbone",
    "DeepLabV3Plus",
    "load_torch_resnet_weights",
    "export_torch_resnet_weights",
    "unet_solar",
    "unet_parking",
    "fold_unet",
    "flax_to_torch",
    "flax_init_",
    "losses",
    "metrics",
]
