"""bf16 weight copies for sampling (port of
videometamaterials_tpu/utils.py:cast_params_for_inference).

Every parameter cast here is one the forward casts to the compute dtype at
its point of use (conv kernels and biases, resampling convs, attention
projections), so under bf16 compute sampling from the cast model equals
sampling from the fp32 one; each step then reads half the weight bytes.
The full-attention `to_qkv` stays float32: the temporal plans fold rotary
and the q-scale into it in float32 before the cast. Norm scales, the
time/conditioning MLPs, null tokens and the bias table feed float32 math
and stay float32 as well.
"""

from __future__ import annotations

import torch
from torch import nn

from videometamaterials_tpu_torch.models.unet3d import (
    Conv1x1,
    SpatialConv,
    SpatialConvTranspose,
)

_CAST_LINEARS = frozenset(("to_q", "to_k", "to_v", "to_out"))


@torch.no_grad()
def cast_params_for_inference(model: nn.Module,
                              dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """Cast the allowlisted parameters of `model` to `dtype` in place (for
    a model that only samples) and return it."""
    for name, module in model.named_modules():
        leaf = name.rsplit(".", 1)[-1]
        if isinstance(module, (SpatialConv, SpatialConvTranspose, Conv1x1)) \
                or (isinstance(module, nn.Linear) and leaf in _CAST_LINEARS):
            module.to(dtype)
    return model
