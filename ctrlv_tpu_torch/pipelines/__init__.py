from .common import SamplingConfig
from .video_control import StableVideoControlPipeline
