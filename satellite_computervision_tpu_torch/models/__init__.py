"""The model families (PyTorch): U-Net, Siamese U-Net, DeepLab v3+,
ConvLSTM and LSTM autoencoder, ACNN and hierarchical ACNN, hybrid U-Net +
ConvLSTM, the Prithvi-EO-2.0 ViT with a segmentation head, SatlasPretrain's
multi-image Swin-v2 with its FPN and head; the U-Net's BN folding, the flax
weight bridge (both ways), losses and metrics."""

from satellite_computervision_tpu_torch.models.blocks import (
    ASPP,
    ConvBlock,
    ConvBNAct,
    DecoderBlock,
    EncoderBlock,
)
from satellite_computervision_tpu_torch.models import losses, metrics
from satellite_computervision_tpu_torch.models.acnn import ACNN, ACNNTrunk, HierarchicalACNN
from satellite_computervision_tpu_torch.models.bridge import flax_to_torch, torch_to_flax
from satellite_computervision_tpu_torch.models.deeplab import (
    BottleneckBlock,
    DeepLabV3Plus,
    ResNetBackbone,
    export_torch_resnet_weights,
    load_torch_resnet_weights,
)
from satellite_computervision_tpu_torch.models.convlstm import (
    ConvLSTM,
    ConvLSTMCell,
    LSTMAutoencoder,
    LSTMModel,
    LSTMStack,
    LSTMStack2,
)
from satellite_computervision_tpu_torch.models.fold import fold_unet
from satellite_computervision_tpu_torch.models.hybrid import HybridUNetLSTM, UNetTrunk
from satellite_computervision_tpu_torch.models.prithvi import PrithviSegmenter
from satellite_computervision_tpu_torch.models.satlas import SatlasSwinSegmenter
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
    "ConvLSTMCell",
    "ConvLSTM",
    "LSTMStack",
    "LSTMStack2",
    "LSTMModel",
    "LSTMAutoencoder",
    "ACNNTrunk",
    "ACNN",
    "HierarchicalACNN",
    "UNetTrunk",
    "HybridUNetLSTM",
    "PrithviSegmenter",
    "SatlasSwinSegmenter",
    "load_torch_resnet_weights",
    "export_torch_resnet_weights",
    "unet_solar",
    "unet_parking",
    "fold_unet",
    "flax_to_torch",
    "torch_to_flax",
    "flax_init_",
    "losses",
    "metrics",
]
