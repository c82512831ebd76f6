"""Models of the Box2Video sampler: UNet-ST, ControlNet, VAE, CLIP."""

from .clip_vision import CLIPVisionConfig, CLIPVisionModelWithProjection, clip_preprocess
from .controlnet import ControlNetSpatioTemporal, controlnet_from_unet
from .unet_st import UNetSpatioTemporalConditionModel, UNetSTConfig
from .vae import AutoencoderKLTemporalDecoder, VAEConfig
