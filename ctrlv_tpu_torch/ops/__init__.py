"""Ops of the port: the attention kernels and their plain versions."""

from .attention import dot_product_attention
from .geglu_ff import gelu_erf
from .mha import (
    LAUNCHES,
    mha_attention,
    mha_attention_plain,
    mha_supported,
    plain_attention,
    reset_launch_counts,
    small_mha_attention,
    small_mha_attention_plain,
    small_mha_supported,
)
