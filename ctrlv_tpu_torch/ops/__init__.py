"""Ops of the port: the kernels' wrappers and their plain versions."""

from ._launch import LAUNCHES, plain_kernels, reset_launch_counts
from .attention import (
    dot_product_attention,
    flash_attention,
    flash_attention_plain,
    flash_supported,
    get_attention_impl,
    set_attention_impl,
)
from .geglu_ff import gelu_erf
# ``group_norm`` and ``layer_norm`` stay modules here: their functions carry
# the same names and are imported from the modules themselves.
from .group_norm import group_norm_plain, group_norm_supported, set_fused_group_norm
from .layer_norm import layer_norm_plain, layer_norm_supported, set_fused_layer_norm
from .mha import (
    mha_attention,
    mha_attention_plain,
    mha_supported,
    small_mha_attention,
    small_mha_attention_fm,
    small_mha_attention_fm_plain,
    small_mha_attention_plain,
    small_mha_fm_supported,
    small_mha_supported,
)
