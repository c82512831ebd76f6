"""The gelu of the GEGLU feed-forward, routed by dtype as in
``ctrlv_tpu/ops/geglu_ff.py::gelu_erf``.

bf16 takes the tanh form, which the JAX package uses there because it is
the erf form at bf16 precision (at most one bf16 ulp apart). Every other
dtype takes the erf form, computed in f32. A plain ``F.gelu`` on bf16 would
be the erf form and drift from the reference. The fused GEGLU kernel of
that module is off the JAX package's default path and is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu_erf(x):
    if x.dtype == torch.bfloat16:
        return F.gelu(x, approximate="tanh")
    xf = x.float()
    return (0.5 * xf * (1.0 + torch.erf(xf * 0.7071067811865476))).to(x.dtype)
