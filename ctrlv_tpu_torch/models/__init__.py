"""Models of the port: the Box2Video sampler's (UNet-ST, ControlNet, VAE,
CLIP) and the legacy ones (the bbox-cond UNet-ST with its
BBOXFrameAttention, KittiObjectNet, LayoutNet, the object-conditioned
UNet2D)."""

from .bbox_attention import BBOXFrameAttention
from .clip_vision import CLIPVisionConfig, CLIPVisionModelWithProjection, clip_preprocess
from .controlnet import ControlNetSpatioTemporal, controlnet_from_unet
from .kitti_object_net import KittiObjectNet
from .layout_net import LayoutNet, LayoutNetConfig
from .unet_2d import UNet2DConditionModel, UNet2DConfig
from .unet_st import (
    UNetSpatioTemporalConditionModel,
    UNetSpatioTemporalConditionModelWithBBoxCond,
    UNetSTConfig,
)
from .vae import AutoencoderKLTemporalDecoder, VAEConfig

__all__ = [
    "UNetSpatioTemporalConditionModel",
    "UNetSpatioTemporalConditionModelWithBBoxCond",
    "BBOXFrameAttention",
    "KittiObjectNet",
    "LayoutNet",
    "LayoutNetConfig",
    "UNet2DConditionModel",
    "UNet2DConfig",
    "UNetSTConfig",
    "ControlNetSpatioTemporal",
    "controlnet_from_unet",
    "AutoencoderKLTemporalDecoder",
    "VAEConfig",
    "CLIPVisionConfig",
    "CLIPVisionModelWithProjection",
    "clip_preprocess",
]
