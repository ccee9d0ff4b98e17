"""Pseudo-3D (spatial-only) convolutions on (B, F, H, W, C) video tensors.

Port of videometamaterials_tpu/ops/conv.py. Frames fold into the batch and
the convolution runs as a 2D convolution on a `channels_last` view: the
(B*F, H, W, C) storage is viewed as NCHW without a copy.

Weights come in torch layouts: a forward conv takes (O, I, kh, kw), the
transposed conv takes ConvTranspose's (I, O, kh, kw). Padding is zeros, the
mode of the sampling path; the circular modes wait for a later slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _to_nchw(x: torch.Tensor) -> torch.Tensor:
    b, f, h, w, c = x.shape
    return x.reshape(b * f, h, w, c).permute(0, 3, 1, 2)


def _from_nchw(y: torch.Tensor, b: int, f: int) -> torch.Tensor:
    y = y.permute(0, 2, 3, 1)
    return y.reshape(b, f, *y.shape[1:])


def conv2d_spatial(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor | None, *, stride: int = 1,
                   padding: int | None = None) -> torch.Tensor:
    """Spatial conv over a (B, F, H, W, C) video; weight (O, I, kh, kw).
    `padding` defaults to (k - 1) // 2."""
    kh = weight.shape[-2]
    if padding is None:
        if kh % 2 == 0:
            raise ValueError("default padding needs an odd kernel")
        padding = kh // 2
    b, f = x.shape[:2]
    y = F.conv2d(_to_nchw(x), weight.to(x.dtype),
                 None if bias is None else bias.to(x.dtype),
                 stride=stride, padding=padding)
    return _from_nchw(y, b, f)


def conv_transpose2d_spatial(x: torch.Tensor, weight: torch.Tensor,
                             bias: torch.Tensor | None, *, stride: int = 2,
                             padding: int = 1) -> torch.Tensor:
    """Transposed spatial conv (the Upsample op: kernel 4, stride 2,
    padding 1 -> exact 2x), written as the input-dilated forward conv
    conv_transpose(x, W; s, p) == conv(dilate(x, s), flip(W)^T; k - 1 - p).
    weight: ConvTranspose layout (I, O, kh, kw)."""
    k = weight.shape[-1]
    b, f, h, w, c = x.shape
    # zeros between the pixels, built channels-last so the NCHW view of it
    # is a channels_last tensor
    dilated = x.new_zeros((b * f, (h - 1) * stride + 1, (w - 1) * stride + 1,
                           c))
    dilated[:, ::stride, ::stride] = x.reshape(b * f, h, w, c)
    w_fwd = weight.flip(2, 3).transpose(0, 1).to(x.dtype)
    y = F.conv2d(dilated.permute(0, 3, 1, 2), w_fwd,
                 None if bias is None else bias.to(x.dtype),
                 padding=k - 1 - padding)
    return _from_nchw(y, b, f)


def conv1x1(x: torch.Tensor, weight: torch.Tensor,
            bias: torch.Tensor | None = None) -> torch.Tensor:
    """Pointwise channel mix on channels-last tensors; weight (O, I)."""
    return F.linear(x, weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype))
