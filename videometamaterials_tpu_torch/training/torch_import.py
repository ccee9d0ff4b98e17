"""Import a reference PyTorch `checkpoint.pt` into the port's state dict.

The reference publishes `checkpoint.pt` dicts {model, optimizer, steps,
ema} (vddp.py:1534-1561) whose `model` and `ema` entries are state dicts
of GaussianDiffusion(denoise_fn=Unet3D): the format of the paper's
published weights. The port's UNet3D keeps the reference's parameter
names and layouts (`convert.key_map`), so the import is a rename and a
check, the port's copy of videometamaterials_tpu/training/torch_import.py
for the configurations the port builds:

- the `module.` (DDP) and `denoise_fn.` prefixes are stripped;
- the diffusion's schedule buffers and rotary tables are skipped (the
  port recomputes them);
- the wrapped modules' names (`init_conv.conv.*`, `downs.N.4.conv.*`,
  `ups.N.4.conv_transpose.*`, `*.proj.conv.*`) map onto the plain ones;
- the reference's unused tensors are skipped: `to_q`, `to_k` and `to_v`
  of an attention the port builds without them (vddp.py:415-417), and
  the whole-curve CNN and GRU embedders where the model has none (they
  exist beside per-frame conditioning); a model of `per_frame_cond:
  false` takes them under their own names (`sign_emb_CNN.emb_model.*`,
  `sign_emb_GRU.emb_model.*`, nn.GRU's layout, both biases as given);
- a 1x1 Conv2d weight (O, I, 1, 1) takes the port's (O, I, 1, 1, 1);
- any other key the model lacks, and any parameter of the model the
  checkpoint lacks, raise a KeyError.

The checkpoint is read with `torch.load(..., weights_only=True)`.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

_SCHEDULE_BUFFERS = frozenset((
    "betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
    "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
    "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
    "posterior_variance", "posterior_log_variance_clipped",
    "posterior_mean_coef1", "posterior_mean_coef2",
))

# the reference's wrapped modules -> the port's plain names
_ALIASES = (
    (re.compile(r"^init_conv\.conv\."), "init_conv."),
    (re.compile(r"^(downs\.\d+\.4)\.conv\."), r"\1."),
    (re.compile(r"^(ups\.\d+\.4)\.conv_transpose\."), r"\1."),
    (re.compile(r"\.proj\.conv\."), ".proj."),
)
_UNUSED_QKV = re.compile(r"^(.*)\.to_[qkv]\.weight$")
_SIGNAL_EMB = re.compile(r"^sign_emb_(CNN|GRU)\.emb_model\.")


def strip_prefix(key: str) -> str:
    """The key without its leading `module.` and `denoise_fn.` prefixes."""
    while True:
        for prefix in ("module.", "denoise_fn."):
            if key.startswith(prefix):
                key = key[len(prefix):]
                break
        else:
            return key


def port_key(key: str) -> str:
    """The port's state-dict name of a reference key."""
    key = strip_prefix(key)
    for pattern, repl in _ALIASES:
        key = pattern.sub(repl, key)
    return key


def _unused(key: str, template: Mapping) -> bool:
    """A reference tensor the port's model has no use for."""
    if _SIGNAL_EMB.match(key):
        return True
    m = _UNUSED_QKV.match(key)
    # to_q/to_k/to_v of an attention the model has, built without them
    return bool(m) and any(f"{m.group(1)}.{name}.weight" in template
                           for name in ("to_qkv", "to_out"))


def import_state_dict(state: Mapping, template: Mapping[str, torch.Tensor]
                      ) -> dict[str, torch.Tensor]:
    """Map a reference state dict ({key: tensor or array}) onto the port's
    names and the shapes of `template` (the model's state_dict; meta
    tensors do): float32 tensors, one for each key of the template."""
    out: dict[str, torch.Tensor] = {}
    unknown = []
    for key, value in state.items():
        name = port_key(key)
        if name in _SCHEDULE_BUFFERS or ".rotary_emb." in name:
            continue
        if name not in template:
            if not _unused(name, template):
                unknown.append(key)
            continue
        tensor = (value.detach().cpu().float()
                  if isinstance(value, torch.Tensor)
                  else torch.as_tensor(np.asarray(value, dtype=np.float32)))
        want = tuple(template[name].shape)
        if tuple(tensor.shape) != want:
            # the same data where only unit axes differ: (O, I, 1, 1) of
            # a Conv2d against the port's (O, I, 1, 1, 1)
            if [d for d in tensor.shape if d != 1] != \
                    [d for d in want if d != 1]:
                raise ValueError(f"shape of {key!r}: checkpoint "
                                 f"{tuple(tensor.shape)}, model {want}")
            tensor = tensor.reshape(want)
        if name in out:
            raise KeyError(f"checkpoint key {key!r}: {name!r} given twice")
        out[name] = tensor.contiguous()
    if unknown:
        raise KeyError(f"checkpoint keys the model does not have: "
                       f"{unknown[:10]}")
    missing = sorted(set(template) - set(out))
    if missing:
        raise KeyError(f"model parameters the checkpoint lacks: "
                       f"{missing[:10]}")
    return out


def read_reference_checkpoint(path: str | Path, which: str = "ema") -> dict:
    """The state dict of entry `which` ('model' or 'ema') of a reference
    checkpoint.pt (a bare state dict is taken whole), on the CPU."""
    if which not in ("model", "ema"):
        raise ValueError(f"which must be 'model' or 'ema', not {which!r}")
    obj = torch.load(path, map_location="cpu", weights_only=True)
    state = obj[which] if which in obj else obj
    return {k: v.detach() for k, v in state.items()
            if isinstance(v, torch.Tensor)}


def load_reference_weights(path: str | Path, template: Mapping,
                           which: str = "ema") -> dict[str, torch.Tensor]:
    """import_state_dict of read_reference_checkpoint(path, which)."""
    return import_state_dict(read_reference_checkpoint(path, which),
                             template)
