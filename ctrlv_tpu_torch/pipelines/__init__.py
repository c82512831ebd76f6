"""Pipelines of the port: stage 1, Box2Video and the two-stage overall run."""

from .common import SamplingConfig
from .overall import GUIDANCE_PAIRS, OverallPipeline, darkness_cleanup
from .video_control import StableVideoControlPipeline
from .video_diffusion import VideoDiffusionPipeline
