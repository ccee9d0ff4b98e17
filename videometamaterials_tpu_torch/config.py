"""Model and trainer configuration for the port (own copy; no import of
the JAX package).

The fields of videometamaterials_tpu/config.py:ModelConfig (:23-113) that
sampling and the train step read, and the port's TrainerConfig (:123-160,
the fields the train step reads). The defaults are the flagship
`model.yaml`: dim 64, mults (1, 2, 4, 8), 8 heads x 32, per-frame
self-stacked conditioning, 3 channels x 11 frames x 96 x 96, bf16
activations over fp32 parameters, both fused kernel families on at every
level, and training on the unfused plans.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from pathlib import Path
from typing import Sequence

import torch


@dataclass(frozen=True)
class ModelConfig:
    selected_channels: Sequence[int] = (0, 1, 3)
    train_timesteps: int = 256
    sampling_timesteps: int = 256             # < train_timesteps = DDIM
    use_dynamic_thres: bool = True
    padding_mode: str = "zeros"
    unet_dim: int = 64
    unet_attn_dim_head: int = 32
    unet_attn_heads: int = 8
    unet_resnet_groups: int = 8
    unet_cond_to_time: str = "add"
    unet_temporal_att_cond: bool = True
    unet_use_sparse_linear_attn: bool = True
    per_frame_cond: bool = True               # forces self-stacked cond
    image_size: int = 96
    num_frames: int = 11
    dim_mults: Sequence[int] = (1, 2, 4, 8)
    init_kernel_size: int = 7
    dynamic_thres_percentile: float = 0.9
    compute_dtype: str = "bfloat16"           # activations; params fp32
    dynamic_thres_method: str = "bisect"      # 'bisect' | 'sort'
    cfg_rescale: float = 0.0                  # CFG-rescale phi, 0 = off
    cfg_shared_init: bool = True              # init stage once per CFG pair
    use_fused_linear_block: bool | str | int = "all"
    use_fused_temporal_block: bool | str | int = "all"
    bf16_inference_weights: bool = True
    batch_size: int = 4                       # per-device train batch
    learning_rate: float = 1e-4
    loss_type: str = "l1"                     # 'l1' | 'l2'
    # the fused blocks under grad: off = the train step runs the unfused
    # plans on the same parameters (the JAX Trainer's plan split)
    fused_blocks_in_training: bool = False
    # hand-written backward kernels for the fused blocks under grad
    # (instead of autograd through the plain twins)
    fused_bwd_kernels: bool = False
    # temporal backward plan: None (from fused_bwd_kernels) | 'recompute' |
    # 'kernel' | 'saved' (the forward kernel emits the softmax weights,
    # the backward starts from them)
    temporal_vjp: str | None = None

    def __post_init__(self):
        if self.loss_type not in ("l1", "l2"):
            raise ValueError(f"unknown loss_type {self.loss_type!r}")
        temporal_bwd_mode(self.temporal_vjp, self.fused_bwd_kernels)

    @property
    def channels(self) -> int:
        return len(self.selected_channels)

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16,
                "float32": torch.float32}[self.compute_dtype]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def temporal_bwd_mode(temporal_vjp: str | None,
                      fused_bwd_kernels: bool) -> str:
    """The fused temporal block's backward under grad, resolved as the JAX
    package does (fused_temporal_block.py:830-833): an explicit plan wins,
    else 'kernel' with fused_bwd_kernels and 'recompute' without."""
    if temporal_vjp is None:
        return "kernel" if fused_bwd_kernels else "recompute"
    if temporal_vjp not in ("recompute", "kernel", "saved"):
        raise ValueError(f"unknown temporal_vjp {temporal_vjp!r}")
    return temporal_vjp


@dataclass(frozen=True)
class TrainerConfig:
    """The trainer knobs the train step reads, with the JAX package's
    defaults (videometamaterials_tpu/config.py:123-160)."""

    ema_decay: float = 0.995
    ema_update_every: int = 10
    ema_start_step: int = 2000                # EMA reset before this step
    null_cond_prob: float = 0.1
    max_grad_norm: float | None = None        # optax clip_by_global_norm
    gradient_accumulate_every: int = 1
    prob_focus_present: float = 0.0
    seed: int = 0

    def __post_init__(self):
        if self.prob_focus_present > 0:
            raise NotImplementedError(
                "prob_focus_present > 0 needs the focus-present mask, not "
                "ported yet (ROADMAP.md Queue 1 item 9)")
        if self.gradient_accumulate_every > 1:
            raise NotImplementedError(
                "gradient_accumulate_every > 1 (optax.MultiSteps semantics) "
                "is not ported yet")

    def replace(self, **kw) -> "TrainerConfig":
        return dataclasses.replace(self, **kw)


# Keys of model.yaml the port does not read (data and artifacts, DDIM, the
# TPU scan chunking and temporal tiling, remat, the conditioning modes that
# per-frame conditioning overrides): accepted by the reader and dropped.
_UNREAD_KEYS = frozenset((
    "reference_frame", "ddim_sampling_eta", "unet_cond_attention",
    "unet_cond_att_GRU", "unet_cond_attention_tokens", "sample_scan_chunk",
    "temporal_s_tile", "remat_blocks",
))


def load_model_yaml(path: str | Path) -> ModelConfig:
    """Read a model.yaml. `yaml` is imported here only: the tests read the
    repo's model.yaml with it; nothing on the GPU path calls this."""
    import yaml

    raw = yaml.safe_load(Path(path).read_text()) or {}
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    unknown = set(raw) - known - _UNREAD_KEYS
    if unknown:
        raise ValueError(f"unknown config keys in {path}: {sorted(unknown)}")
    kw = {k: v for k, v in raw.items() if k in known}
    if "learning_rate" in kw:
        kw["learning_rate"] = float(kw["learning_rate"])
    for key in ("selected_channels", "dim_mults"):
        if key in kw:
            kw[key] = tuple(kw[key])
    return ModelConfig(**kw)


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The port's entry points run on the GPU unless the caller names a
    device. With no GPU and no explicit device they raise instead of quietly
    running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def set_precision() -> None:
    """fp32 products and convolutions in full fp32 (no TF32) on the card,
    so the fp32 parts of the model match the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
