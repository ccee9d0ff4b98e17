"""Pseudo-3D (spatial-only) convolutions on (B, F, H, W, C) video tensors.

Port of videometamaterials_tpu/ops/conv.py. Frames fold into the batch and
the convolution runs as a 2D convolution on a `channels_last` view: the
(B*F, H, W, C) storage is viewed as NCHW without a copy.

Weights come in torch layouts: a forward conv takes (O, I, kh, kw), the
transposed conv takes ConvTranspose's (I, O, kh, kw). Three padding modes,
as the JAX package's (its ops/conv.py:12-19):
  'zeros'       symmetric zero padding (torch padding_mode='zeros')
  'circular'    periodic in both H and W: a wrap-pad by the padding, then
                a convolution without padding
  'circular_1d' periodic in W (horizontal) only, zeros in H
The transposed conv is an input-dilated forward convolution; in the
circular modes its input is wrap-padded by k - 1 - p first and the
dilated, wrapped input is cropped by s + p - 1 on each side (the
reference's transposed layer's crop).

A bf16 convolution with a bias that autograd does not record (sampling,
the validation loss) rounds once, after the bias, as the TPU's
convolution with its bias in the output fusion does: torch's bf16
`conv2d` rounds the product to bf16 and then adds the bias and rounds
again, whether the bias is passed to it or not, which on an H100 moves
28-34% of the outputs (scripts/torch_conv_rounding_probe.py); sampled that
way, the eulerian demo checkpoint overshoots its stress magnitude (gain
1.19 against the TPU run's 1.127; 1.14-1.15 with one rounding). The
operands multiply exactly in float32 with TF32 allowed (TF32 holds every
bf16 value), the float32 bias is added and the sum rounded once. Under
autograd (training) the convolution stays torch's: with one rounding
there the fused-plan gradient check of chip_smoke.py phase 5 missed its
limit (5.8e-2 against 5e-2).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from videometamaterials_tpu_torch.parallel.latency import halo_rows


PADDING_MODES = ("zeros", "circular", "circular_1d")


def _wrap_pad(x: torch.Tensor, pad: int, mode: str,
              rows: bool = True) -> torch.Tensor:
    """Pad H and W of an NCHW tensor by `pad` in a circular mode: both
    periodic, or W periodic and H zeros (the JAX _wrap_pad_2d). rows=False
    pads W alone: a height-split tensor's rows come with their halo."""
    if mode not in PADDING_MODES:
        raise ValueError(f"unknown padding mode {mode!r}")
    if mode == "zeros" or pad == 0:
        return x
    if mode == "circular" and rows:
        return F.pad(x, (pad, pad, pad, pad), mode="circular")
    x = F.pad(x, (pad, pad, 0, 0), mode="circular")
    return F.pad(x, (0, 0, pad, pad)) if rows else x


def _conv2d(x, weight, bias, *, stride: int, padding: int):
    """NCHW conv2d in x's dtype; bf16 with a bias and outside autograd:
    one rounding after the bias."""
    weight = weight.to(x.dtype)
    recorded = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, weight, bias))
    if bias is None or x.dtype != torch.bfloat16 or recorded:
        return F.conv2d(x, weight,
                        None if bias is None else bias.to(x.dtype),
                        stride=stride, padding=padding)
    cudnn = torch.backends.cudnn
    tf32 = cudnn.allow_tf32
    cudnn.allow_tf32 = True
    try:
        y = F.conv2d(x.float(), weight.float(), bias.float(), stride=stride,
                     padding=padding)
    finally:
        cudnn.allow_tf32 = tf32
    return y.to(x.dtype)


def _to_nchw(x: torch.Tensor) -> torch.Tensor:
    b, f, h, w, c = x.shape
    return x.reshape(b * f, h, w, c).permute(0, 3, 1, 2)


def _from_nchw(y: torch.Tensor, b: int, f: int) -> torch.Tensor:
    y = y.permute(0, 2, 3, 1)
    return y.reshape(b, f, *y.shape[1:])


def _with_halo(x, shard, rows: tuple[int, int], padding_mode: str):
    """x's rows with the halo `rows` (above, below) a height-split
    convolution reads: the neighbours' edge rows, zeros past the global
    edge, or under 'circular' the other edge's rows."""
    if padding_mode not in PADDING_MODES:
        raise ValueError(f"unknown padding mode {padding_mode!r}")
    return shard.halo(x, *rows, wrap=padding_mode == "circular")


def conv2d_spatial(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor | None, *, stride: int = 1,
                   padding: int | None = None,
                   padding_mode: str = "zeros", shard=None) -> torch.Tensor:
    """Spatial conv over a (B, F, H, W, C) video; weight (O, I, kh, kw).
    `padding` defaults to (k - 1) // 2. `shard` (parallel/latency.py): x
    holds one rank's rows of a height-split video, which the convolution
    reads with their halo; otherwise (None, or a frame split) the rows are
    whole."""
    kh = weight.shape[-2]
    if padding is None:
        if kh % 2 == 0:
            raise ValueError("default padding needs an odd kernel")
        padding = kh // 2
    b, f = x.shape[:2]
    split = shard is not None and shard.splits_height
    if split:
        x = _with_halo(x, shard, halo_rows(kh, stride, padding),
                       padding_mode)
    xn = _to_nchw(x)
    pad_h, pad_w = (0 if split else padding), padding
    if padding_mode != "zeros":
        xn, pad_h, pad_w = _wrap_pad(xn, padding, padding_mode,
                                     rows=not split), 0, 0
    return _from_nchw(_conv2d(xn, weight, bias, stride=stride,
                              padding=(pad_h, pad_w)), b, f)


def conv_transpose2d_spatial(x: torch.Tensor, weight: torch.Tensor,
                             bias: torch.Tensor | None, *, stride: int = 2,
                             padding: int = 1,
                             padding_mode: str = "zeros",
                             shard=None) -> torch.Tensor:
    """Transposed spatial conv (the Upsample op: kernel 4, stride 2,
    padding 1 -> exact 2x), written as the input-dilated forward conv
    conv_transpose(x, W; s, p) == conv(dilate(x, s), flip(W)^T; k - 1 - p).
    weight: ConvTranspose layout (I, O, kh, kw). In a circular mode the
    input is wrap-padded by k - 1 - p and the dilated result cropped by
    s + p - 1 a side (the JAX package's negative padding 1 - s - p).
    `shard`: x holds one rank's rows of a height-split video; its halo
    rows take the place of the padding of H, so the rank's outputs are
    rows [s start, s stop) of the whole output."""
    k = weight.shape[-1]
    edge = k - 1 - padding
    b, f = x.shape[:2]
    split = shard is not None and shard.splits_height
    if split:
        rows = halo_rows(k, stride, padding, transposed=True)
        if stride * rows[0] != edge:
            raise ValueError("a height split needs (k - 1 - p) to be a "
                             "multiple of the stride")
        x = _with_halo(x, shard, rows, padding_mode)
    xn = _to_nchw(x)
    if padding_mode != "zeros":
        xn = _wrap_pad(xn, edge, padding_mode, rows=not split)
    h, w = xn.shape[2:]
    c = xn.shape[1]
    # zeros between the pixels, built channels-last so the NCHW view of it
    # is a channels_last tensor
    dilated = x.new_zeros((b * f, (h - 1) * stride + 1, (w - 1) * stride + 1,
                           c))
    dilated[:, ::stride, ::stride] = xn.permute(0, 2, 3, 1)
    pad_h = pad_w = edge
    if padding_mode != "zeros":
        crop = stride + padding - 1
        crop_h = 0 if split else crop
        dilated = dilated[:, crop_h:dilated.shape[1] - crop_h,
                          crop:dilated.shape[2] - crop]
        pad_h = pad_w = 0
    if split:
        pad_h = 0
    w_fwd = weight.flip(2, 3).transpose(0, 1)
    return _from_nchw(_conv2d(dilated.permute(0, 3, 1, 2), w_fwd, bias,
                              stride=1, padding=(pad_h, pad_w)), b, f)


def conv1x1(x: torch.Tensor, weight: torch.Tensor,
            bias: torch.Tensor | None = None) -> torch.Tensor:
    """Pointwise channel mix on channels-last tensors; weight (O, I)."""
    return F.linear(x, weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype))
