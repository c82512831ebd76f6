"""CLIP vision encoder with projection (ViT-H/14 at full size).

Counterpart of ``ctrlv_tpu/models/clip_vision.py``, with the module names of
transformers' ``CLIPVisionModelWithProjection`` (``vision_model.embeddings``,
``vision_model.encoder.layers.N`` ...), and ``clip_preprocess``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import dot_product_attention
from ..utils.resize import resize_matrix
from .layers import LayerNorm

CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1280
    intermediate_size: int = 5120
    num_hidden_layers: int = 32
    num_attention_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    projection_dim: int = 1024
    layer_norm_eps: float = 1e-5

    @classmethod
    def tiny(cls) -> "CLIPVisionConfig":
        return cls(
            hidden_size=32,
            intermediate_size=64,
            num_hidden_layers=2,
            num_attention_heads=2,
            image_size=28,
            patch_size=14,
            projection_dim=48,
        )


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        c = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.q_proj = nn.Linear(c, c)
        self.k_proj = nn.Linear(c, c)
        self.v_proj = nn.Linear(c, c)
        self.out_proj = nn.Linear(c, c)

    def forward(self, x):
        b, s, c = x.shape
        shape = (b, s, self.heads, c // self.heads)
        out = dot_product_attention(
            self.q_proj(x).reshape(shape), self.k_proj(x).reshape(shape),
            self.v_proj(x).reshape(shape),
        )
        return self.out_proj(out.reshape(b, s, c))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))  # exact erf gelu, as the reference


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            [CLIPEncoderLayer(cfg) for _ in range(cfg.num_hidden_layers)]
        )

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        c = cfg.hidden_size
        self.class_embedding = nn.Parameter(torch.randn(c) * 0.02)
        self.patch_embedding = nn.Conv2d(
            3, c, cfg.patch_size, stride=cfg.patch_size, bias=False
        )
        self.position_embedding = nn.Embedding((cfg.image_size // cfg.patch_size) ** 2 + 1, c)

    def forward(self, pixel_values):
        """(B, 3, H, W) -> (B, 1 + patches, C)."""
        patches = self.patch_embedding(pixel_values).flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(patches.dtype).expand(patches.shape[0], 1, -1)
        return torch.cat([cls, patches], dim=1) + self.position_embedding.weight[None]


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.encoder = CLIPEncoder(cfg)
        self.post_layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, pixel_values):
        x = self.encoder(self.pre_layrnorm(self.embeddings(pixel_values)))
        return self.post_layernorm(x[:, 0].contiguous())


class CLIPVisionModelWithProjection(nn.Module):
    def __init__(self, config: CLIPVisionConfig = CLIPVisionConfig()):
        super().__init__()
        self.config = config
        self.vision_model = CLIPVisionTransformer(config)
        self.visual_projection = nn.Linear(config.hidden_size, config.projection_dim, bias=False)

    def forward(self, pixel_values):
        """(B, S, S, 3) normalised pixels -> (B, projection_dim) image_embeds."""
        dtype = self.visual_projection.weight.dtype
        pooled = self.vision_model(pixel_values.to(dtype).permute(0, 3, 1, 2))
        return self.visual_projection(pooled)


def clip_preprocess(images, image_size: int = 224):
    """[-1, 1] (B, H, W, 3) frames -> CLIP-normalised (B, S, S, 3).

    Bicubic resize as ``jax.image.resize(..., "bicubic")`` does it (Keys
    cubic, a = -0.5, antialiased on a downscale), applied as two matmuls;
    ``F.interpolate(mode="bicubic")`` uses a = -0.75 and differs. Then
    rescale to [0, 1], clamp and CLIP mean/std.
    """
    _, h, w, _ = images.shape
    wh = torch.from_numpy(resize_matrix(h, image_size)).to(images.device, images.dtype)
    ww = torch.from_numpy(resize_matrix(w, image_size)).to(images.device, images.dtype)
    out = torch.einsum("bhwc,hy,wx->byxc", images, wh, ww)
    out = torch.clamp((out + 1.0) * 0.5, 0.0, 1.0)
    mean = torch.tensor(CLIP_IMAGE_MEAN, dtype=out.dtype, device=out.device)
    std = torch.tensor(CLIP_IMAGE_STD, dtype=out.dtype, device=out.device)
    return (out - mean) / std
